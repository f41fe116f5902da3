"""Registry + build-from-config.

The whole framework is config-driven: a config dict carries a ``type`` key naming a
registered class/function, and the registry instantiates it with the remaining keys.
Mirrors the public behaviour of the reference registry
(``ponder/utils/registry.py:9-316``) with a fresh, minimal implementation.
A copy of ``ponderv2_tpu/utils/registry.py``.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A name -> class/function map with decorator-based registration.

    Example::

        MODELS = Registry("models")

        @MODELS.register_module()
        class SpUNet:
            ...

        model = MODELS.build(dict(type="SpUNet", channels=32))
    """

    def __init__(self, name: str, parent: Optional["Registry"] = None):
        self._name = name
        self._module_dict: Dict[str, Any] = {}
        self._children: Dict[str, "Registry"] = {}
        self.parent = parent
        if parent is not None:
            parent._children[name] = self

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Any]:
        return self._module_dict

    def __len__(self) -> int:
        return len(self._module_dict)

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={list(self._module_dict)})"

    def get(self, key: str) -> Optional[Any]:
        """Look up ``key`` here, then in children, then in the parent chain."""
        if key in self._module_dict:
            return self._module_dict[key]
        for child in self._children.values():
            if key in child._module_dict:
                return child._module_dict[key]
        if self.parent is not None:
            return self.parent.get(key)
        return None

    def _register(self, module: Any, name: Optional[str] = None, force: bool = False):
        if not callable(module):
            raise TypeError(f"module must be callable, got {type(module)}")
        names = [module.__name__] if name is None else (
            [name] if isinstance(name, str) else list(name)
        )
        for n in names:
            if not force and n in self._module_dict:
                raise KeyError(f"{n} is already registered in {self._name}")
            self._module_dict[n] = module
        return module

    def register_module(
        self,
        name: Optional[str] = None,
        force: bool = False,
        module: Optional[Any] = None,
    ) -> Callable:
        """Register a class/function, as a decorator or direct call."""
        if module is not None:
            return self._register(module, name=name, force=force)

        def _decorator(cls):
            return self._register(cls, name=name, force=force)

        return _decorator

    def build(self, cfg: Dict[str, Any], default_args: Optional[Dict] = None) -> Any:
        return build_from_cfg(cfg, self, default_args=default_args)


def build_from_cfg(
    cfg: Dict[str, Any],
    registry: Registry,
    default_args: Optional[Dict] = None,
) -> Any:
    """Instantiate ``registry.get(cfg['type'])`` with the remaining cfg keys.

    ``type`` may also be a callable already (bypasses the registry).
    """
    from collections.abc import Mapping

    if not isinstance(cfg, Mapping):
        raise TypeError(f"cfg must be a mapping, got {type(cfg)}")
    cfg = dict(cfg)  # accept FrozenDict/ConfigDict etc.
    if "type" not in cfg:
        if default_args is None or "type" not in default_args:
            raise KeyError(f"cfg must contain the key 'type': {cfg}")
    if not isinstance(registry, Registry):
        raise TypeError(f"registry must be a Registry, got {type(registry)}")

    args = dict(cfg)
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)

    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not registered in {registry.name}")
    elif callable(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"type must be a str or callable, got {type(obj_type)}")

    try:
        return obj_cls(**args)
    except Exception as e:  # re-raise with the class name for debuggability
        raise type(e)(f"{obj_cls.__name__}: {e}") from e
