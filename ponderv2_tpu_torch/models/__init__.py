from .builder import MODELS, build_model

from . import default  # noqa: F401  (registers DefaultSegmentor)
from .sparse_unet import spunet, spunet_pdnorm  # noqa: F401  (SpUNet-v1m1, SpUNet-v1m3)
from .point_prompt_training import ppt  # noqa: F401  (PPT-v1m1, PPT-v1m2)
from .ponder import ponder_indoor, ponder_outdoor, unet3d  # noqa: F401  (PonderIndoor-v2,
#   PonderOutdoor-v2, UNet3D, SimpleConv3D)
from .point_group.point_group import PointGroup  # noqa: F401  (PG-v1m1)
