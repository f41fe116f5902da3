"""Python-file config system with ``_base_`` inheritance and dotted CLI overrides.

Configs are plain ``.py`` files executed in an isolated namespace; every top-level
variable that does not start with ``_`` becomes a config key. A config may declare

    _base_ = ["../_base_/default_runtime.py"]

whose keys are deep-merged underneath its own. Matches the public behaviour of the
reference config system (``ponder/utils/config.py:70-694``) with a fresh
implementation. A copy of ``ponderv2_tpu/utils/config.py``, except that a
config's ``from ponderv2_tpu... import`` of the two data modules it names
(``PORTED_MODULES``) takes the port's copies, so configs load without JAX.
"""

from __future__ import annotations

import argparse
import builtins
import copy
import importlib
import os
import pprint
import sys
import types
from typing import Any, Dict, List, Optional


class ConfigDict(dict):
    """dict with attribute access; missing attributes raise AttributeError."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name)

    def __deepcopy__(self, memo):
        return ConfigDict(
            {copy.deepcopy(k, memo): copy.deepcopy(v, memo) for k, v in self.items()}
        )


def _to_config_dict(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigDict({k: _to_config_dict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_config_dict(v) for v in obj)
    return obj


def _deep_merge(base: Dict, override: Dict) -> Dict:
    """Merge ``override`` into ``base`` (override wins); dicts merge recursively.

    A dict value containing ``_delete_=True`` replaces the base value wholesale.
    """
    merged = dict(base)
    for k, v in override.items():
        if (
            isinstance(v, dict)
            and k in merged
            and isinstance(merged[k], dict)
            and not v.pop("_delete_", False)
        ):
            merged[k] = _deep_merge(merged[k], v)
        else:
            merged[k] = v
    return merged


# The JAX package's data modules that configs import (the PPT vocabulary, the
# ScanNet200 class tables), and the port's byte-equal copies of them: a
# config runs with these names resolved to the copies, so that it loads
# where JAX is not installed.
PORTED_MODULES = {
    "ponderv2_tpu.datasets.ppt_vocab": "ponderv2_tpu_torch.datasets.ppt_vocab",
    "ponderv2_tpu.datasets.preprocessing.scannet200_constants":
        "ponderv2_tpu_torch.datasets.preprocessing.scannet200_constants",
}


def _config_import(name, globals=None, locals=None, fromlist=(), level=0):
    """``__import__`` of a config file: ``from <a PORTED_MODULES name> import
    ...`` takes the port's copy; everything else imports as usual. Nothing is
    added to ``sys.modules`` under the JAX package's name."""
    if level == 0 and fromlist and name in PORTED_MODULES:
        return importlib.import_module(PORTED_MODULES[name])
    return builtins.__import__(name, globals, locals, fromlist, level)


def _exec_pyfile(filename: str) -> Dict[str, Any]:
    filename = os.path.abspath(os.path.expanduser(filename))
    if not os.path.isfile(filename):
        raise FileNotFoundError(f"config file not found: {filename}")
    with open(filename, "r") as f:
        source = f.read()
    module = types.ModuleType("_cfg_")
    module.__file__ = filename
    module.__builtins__ = {**builtins.__dict__, "__import__": _config_import}
    code = compile(source, filename, "exec")
    exec(code, module.__dict__)
    return {
        k: v
        for k, v in module.__dict__.items()
        if not k.startswith("__") and not isinstance(v, types.ModuleType)
    }


class Config:
    """An executed, merged config. Access keys as attributes or items."""

    def __init__(self, cfg_dict: Optional[Dict] = None, filename: Optional[str] = None):
        object.__setattr__(self, "_cfg_dict", _to_config_dict(cfg_dict or {}))
        object.__setattr__(self, "_filename", filename)

    # ---------------------------------------------------------------- loading
    @staticmethod
    def fromfile(filename: str) -> "Config":
        cfg_dict = Config._load_with_bases(filename)
        cfg_dict.pop("_base_", None)
        return Config(cfg_dict, filename=filename)

    @staticmethod
    def _load_with_bases(filename: str) -> Dict[str, Any]:
        cfg_dict = _exec_pyfile(filename)
        base = cfg_dict.pop("_base_", None)
        if base is None:
            return cfg_dict
        if isinstance(base, str):
            base = [base]
        merged: Dict[str, Any] = {}
        cfg_dir = os.path.dirname(os.path.abspath(os.path.expanduser(filename)))
        for b in base:
            b_dict = Config._load_with_bases(os.path.join(cfg_dir, b))
            merged = _deep_merge(merged, b_dict)
        return _deep_merge(merged, cfg_dict)

    # ------------------------------------------------------------- attributes
    @property
    def filename(self) -> Optional[str]:
        return self._filename

    def __getattr__(self, name: str) -> Any:
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name: str, value: Any) -> None:
        self._cfg_dict[name] = _to_config_dict(value)

    def __getitem__(self, name: str) -> Any:
        return self._cfg_dict[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self._cfg_dict[name] = _to_config_dict(value)

    def __contains__(self, name: str) -> bool:
        return name in self._cfg_dict

    def get(self, name: str, default: Any = None) -> Any:
        return self._cfg_dict.get(name, default)

    def setdefault(self, name: str, default: Any = None) -> Any:
        return self._cfg_dict.setdefault(name, _to_config_dict(default))

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def __iter__(self):
        return iter(self._cfg_dict)

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(dict(self._cfg_dict))

    def __reduce__(self):
        # pickled by value, as ``launch`` hands a config to the processes it spawns
        return Config, (self.to_dict(), self._filename)

    # ---------------------------------------------------------------- merging
    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """Apply dotted-key overrides, e.g. ``{"data.train.loop": 2}``; a
        number indexes a list, e.g. ``data.train.datasets.0.data_root``."""
        for full_key, value in options.items():
            d = self._cfg_dict
            parts = full_key.split(".")
            for part in parts[:-1]:
                if isinstance(d, list):
                    d = d[int(part)]
                    continue
                if part not in d or not isinstance(d[part], (dict, list)):
                    d[part] = ConfigDict()
                d = d[part]
            d[int(parts[-1]) if isinstance(d, list) else parts[-1]] = _to_config_dict(value)

    # ------------------------------------------------------------------- dump
    @property
    def pretty_text(self) -> str:
        return pprint.pformat(self.to_dict(), width=100, sort_dicts=False)

    def dump(self, filepath: str) -> None:
        """Write the flattened config back out as an executable python file."""
        os.makedirs(os.path.dirname(os.path.abspath(filepath)), exist_ok=True)
        lines = []
        for k, v in self._cfg_dict.items():
            lines.append(f"{k} = {pprint.pformat(v, width=100, sort_dicts=False)}")
        with open(filepath, "w") as f:
            f.write("\n".join(lines) + "\n")


class DictAction(argparse.Action):
    """argparse action parsing ``KEY=VALUE`` pairs with python-literal values.

    Values are parsed with ``ast.literal_eval`` when possible, with ``true/false``
    mapped to booleans; otherwise kept as strings. Supports nested keys via dots.
    """

    @staticmethod
    def _parse_value(val: str) -> Any:
        import ast

        low = val.lower()
        if low == "true":
            return True
        if low == "false":
            return False
        if low in ("none", "null"):
            return None
        try:
            return ast.literal_eval(val)
        except (ValueError, SyntaxError):
            return val

    def __call__(self, parser, namespace, values, option_string=None):
        options = getattr(namespace, self.dest, None) or {}
        for kv in values:
            key, sep, val = kv.partition("=")
            if not sep:
                raise argparse.ArgumentError(self, f"expected KEY=VALUE, got {kv!r}")
            options[key] = self._parse_value(val)
        setattr(namespace, self.dest, options)
