"""Asset-root resolution (port of `3dworld_tpu/utils/assets.py`, copied
whole).

The reference loads real asset trees (textures/, text_data/,
universe/ship_defs) from its repo root; this framework works with or
without them (procedural fallbacks everywhere).  One env var,
``W3D_ASSET_ROOT``, points at a reference-style asset tree; when unset,
the conventional ``/root/reference`` checkout is used if present.
Setting ``W3D_ASSET_ROOT=""`` explicitly disables real assets so the
procedural fallbacks can be exercised even on a machine that has the
reference tree.
"""

from __future__ import annotations

import os

_CONVENTIONAL = "/root/reference"


def asset_root() -> str | None:
    """Root of the asset tree, or None when no tree is configured."""
    if "W3D_ASSET_ROOT" in os.environ:
        return os.environ["W3D_ASSET_ROOT"] or None
    return _CONVENTIONAL if os.path.isdir(_CONVENTIONAL) else None


def asset_path(*parts: str) -> str | None:
    """Join path components under the asset root; None when no root."""
    r = asset_root()
    return os.path.join(r, *parts) if r else None
