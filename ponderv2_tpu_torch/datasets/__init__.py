from .builder import DATASETS, build_dataset
from .dataloader import build_dataloader
from .transform import TRANSFORMS, Compose
from .utils import collate_fn, point_collate_fn

# register the datasets: DefaultDataset, ConcatDataset and the synthetic
# ones; ScanNet(200), S3DIS, Structured3D and nuScenes
from . import defaults, nuscenes, s3dis, scannet, structure3d  # noqa: F401
