from .builder import HOOKS, build_hooks
from .default import HookBase
from . import misc  # noqa: F401
from . import evaluator  # noqa: F401
