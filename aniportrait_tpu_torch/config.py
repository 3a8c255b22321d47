"""Config system, the port's copy of ``aniportrait_tpu/config.py``: YAML
files with attribute access, compatible with the reference's OmegaConf-style
configs (``configs/**/*.yaml``), and importable ``.py`` configs.  PyYAML is
imported only when a YAML file is read, so the module imports without it
(the card's machine may lack it; a ``Config`` built from a dict needs
nothing).
"""

from __future__ import annotations

import importlib.util
import os
from typing import Any, Iterator, Mapping

class Config(Mapping):
    """Nested dict with attribute access (OmegaConf-lite)."""

    def __init__(self, data: dict | None = None):
        object.__setattr__(self, "_data", {})
        for k, v in (data or {}).items():
            self._data[k] = _wrap(v)

    # Mapping protocol
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    # attribute access
    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def values(self):
        return self._data.values()

    def to_dict(self) -> dict:
        return {
            k: v.to_dict() if isinstance(v, Config) else v
            for k, v in self._data.items()
        }

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"

    def merge(self, other: "Config | dict") -> "Config":
        """Deep-merge ``other`` on top of self, returning a new Config."""
        out = Config(self.to_dict())
        for k, v in dict(other).items():
            if (
                k in out._data
                and isinstance(out._data[k], Config)
                and isinstance(v, (dict, Config))
            ):
                out._data[k] = out._data[k].merge(v)
            else:
                out._data[k] = _wrap(v)
        return out


def _wrap(v: Any) -> Any:
    if isinstance(v, Config):
        return v
    if isinstance(v, dict):
        return Config(v)
    if isinstance(v, (list, tuple)):
        return [_wrap(x) for x in v]
    return v


def load_config(path: str) -> Config:
    """Load a YAML or importable-.py config file."""
    if path.endswith((".yaml", ".yml")):
        import yaml

        with open(path) as f:
            return Config(yaml.safe_load(f) or {})
    if path.endswith(".py"):
        mod = import_filename(path)
        return Config({k: v for k, v in vars(mod).items() if not k.startswith("_")})
    raise ValueError(f"unsupported config file: {path}")


def import_filename(filename: str):
    """Import a python file as a module (reference src/utils/util.py:28-33)."""
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(filename))[0], filename
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
