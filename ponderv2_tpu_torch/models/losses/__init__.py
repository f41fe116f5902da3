from .builder import LOSSES, Criteria, build_criteria
from . import lovasz, misc  # noqa: F401  (register the losses)
