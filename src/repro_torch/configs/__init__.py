"""Architecture registry of the port (``--arch <id>``): the configs this
slice serves, each an own copy of the reference's module."""

from __future__ import annotations

import importlib

_MODULES = {
    "sdar-8b": "sdar_8b",
    "tiny": "tiny",
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch '{name}'; known: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str, **kw):
    return _module(name).config(**kw)


def get_smoke_config(name: str, **kw):
    return _module(name).smoke_config(**kw)
