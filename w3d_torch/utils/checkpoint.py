"""Heightmap brush journal (port of `ModmapJournal` from
`3dworld_tpu/utils/checkpoint.py`).

The reference replays a heightmap "modmap" of brush edits with undo when a
scene loads its terrain from an image (tex_mod_map_manager_t,
heightmap.cpp:218-307).  `apply` runs in torch on the heightmap's device;
`save` and `load` keep the JAX package's `.npy` format ([E, 5] float32
rows of x, y, radius, delta, shape), so a journal written by either package
loads in the other.  The rest of the JAX module (pytree checkpoints) is not
ported.
"""

from __future__ import annotations

import numpy as np
import torch


class ModmapJournal:
    """A list of (x, y, radius, delta, shape) brush edits with undo;
    `apply` replays them on a heightmap."""

    def __init__(self):
        self.edits: list[tuple] = []

    def add(self, x: int, y: int, radius: int, delta: float, shape: int = 0):
        self.edits.append((x, y, radius, delta, shape))

    def undo(self):
        return self.edits.pop() if self.edits else None

    def apply(self, heightmap, device: torch.device | str | None = None) -> torch.Tensor:
        """The heightmap with every edit added: shape 0 a constant disc,
        1 a linear falloff, 2 a quadratic one.  `heightmap` is a tensor
        (the result stays on its device) or an array (put on `device`,
        the card unless given); float32 as the JAX package computes."""
        if isinstance(heightmap, torch.Tensor):
            hm = heightmap.to(torch.float32)
        else:
            hm = torch.as_tensor(np.asarray(heightmap, np.float32),
                                 device="cuda" if device is None else device)
        my, mx = hm.shape
        yi, xi = torch.meshgrid(torch.arange(my, dtype=torch.int32, device=hm.device),
                                torch.arange(mx, dtype=torch.int32, device=hm.device),
                                indexing="ij")
        for (x, y, r, delta, shape) in self.edits:
            d2 = (xi - x) ** 2 + (yi - y) ** 2
            if shape == 0:      # constant
                fall = (d2 <= r * r).to(hm.dtype)
            elif shape == 1:    # linear falloff
                fall = torch.clamp(1.0 - torch.sqrt(d2.to(hm.dtype)) / max(r, 1), min=0.0)
            else:               # quadratic
                fall = torch.clamp(1.0 - d2.to(hm.dtype) / max(r * r, 1), min=0.0)
            hm = hm + delta * fall
        return hm

    def save(self, path: str) -> None:
        # np.save appends '.npy' to bare paths; write through a file object
        # so save('x.modmap')/load('x.modmap') agree on the filename
        with open(path, "wb") as f:
            np.save(f, np.array(self.edits, np.float32).reshape(-1, 5))

    @classmethod
    def load(cls, path: str) -> "ModmapJournal":
        j = cls()
        with open(path, "rb") as f:
            rows = np.load(f).reshape(-1, 5)
        for row in rows:
            j.add(int(row[0]), int(row[1]), int(row[2]), float(row[3]), int(row[4]))
        return j
