from .builder import MODELS, build_model

from . import default  # noqa: F401  (registers DefaultSegmentor)
from .sparse_unet import spunet  # noqa: F401  (registers SpUNet-v1m1)
