from .builder import MODELS, build_model

from . import default  # noqa: F401  (DefaultSegmentor, DefaultClassifier)
from .sparse_unet import mink_unet, spunet, spunet_pdnorm  # noqa: F401  (MinkUNet*,
#   SpUNet-v1m1, -v1m2, SpUNetNoSkipBase, SpUNet-v1m3)
from .point_prompt_training import ppt  # noqa: F401  (PPT-v1m1, PPT-v1m2)
from .ponder import ponder_indoor, ponder_outdoor, unet3d  # noqa: F401  (PonderIndoor-v2,
#   PonderOutdoor-v2, UNet3D, SimpleConv3D)
from .point_group.point_group import PointGroup  # noqa: F401  (PG-v1m1)
