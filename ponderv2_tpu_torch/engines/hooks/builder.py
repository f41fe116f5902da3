"""HOOKS registry (counterpart of ``ponderv2_tpu/engines/hooks/builder.py``)."""

from ...utils.registry import Registry

HOOKS = Registry("hooks")


def build_hooks(cfg_list):
    return [HOOKS.build(dict(c)) for c in (cfg_list or [])]
