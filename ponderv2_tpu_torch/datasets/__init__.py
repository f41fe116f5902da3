from .builder import DATASETS, build_dataset
from .transform import TRANSFORMS, Compose
from .utils import collate_fn

from . import defaults  # noqa: F401  (registers SyntheticDataset)
