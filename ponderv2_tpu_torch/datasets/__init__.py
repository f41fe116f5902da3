from .builder import DATASETS, build_dataset
from .dataloader import build_dataloader
from .transform import TRANSFORMS, Compose
from .utils import collate_fn, point_collate_fn

from . import defaults  # noqa: F401  (registers SyntheticDataset)
