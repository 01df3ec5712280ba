"""Built-in level assets — shipped text worlds, loadable by name.

Counterpart of `griduniverse_tpu/levels/registry.py`. The port ships its own
byte-equal copies of the text files under `levels/assets/`.
"""

from __future__ import annotations

import os

from ..core.types import Level
from .text import load_level_file

_ASSET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


def builtin_level_names() -> list[str]:
    """Names of the shipped text worlds (sorted, without .txt)."""
    return sorted(
        fn[: -len(".txt")] for fn in os.listdir(_ASSET_DIR) if fn.endswith(".txt")
    )


def builtin_level_path(name: str) -> str:
    """Filesystem path of a shipped world."""
    path = os.path.join(_ASSET_DIR, name + ".txt")
    if not os.path.isfile(path):
        raise KeyError(
            f"unknown builtin level {name!r}; available: {builtin_level_names()}"
        )
    return path


def builtin_level(name: str, *, device=None) -> Level:
    """Load a shipped world by name → Level on `device`."""
    return load_level_file(builtin_level_path(name), device=device)
