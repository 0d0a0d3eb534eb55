"""Checkpoint / resume (port of `3dworld_tpu/utils/checkpoint.py`):
state trees to one `.npz`, and the heightmap brush journal.

`save_pytree` writes any tree of NamedTuples, dicts, lists, tuples and
tensors as `leaf_<i>` arrays plus a structure string under `__treedef__`;
`load_pytree` restores it into the structure of `like`, each leaf on
`like`'s device.  Leaves flatten in the JAX package's order (NamedTuple
fields in declaration order, dict keys sorted, None dropped), so a
checkpoint the JAX package wrote for the same structure loads here: its
`__treedef__` is JAX's own string, and in its place the leaf count and
each leaf's shape and dtype are checked against `like` (a JAX uint32 bit
mask loads into the port's int32 one, as `convert` carries it).

The reference replays a heightmap "modmap" of brush edits with undo when a
scene loads its terrain from an image (tex_mod_map_manager_t,
heightmap.cpp:218-307).  `apply` runs in torch on the heightmap's device;
`save` and `load` keep the JAX package's `.npy` format ([E, 5] float32
rows of x, y, radius, delta, shape), so a journal written by either package
loads in the other.
"""

from __future__ import annotations

import json

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, leaves: list) -> str:
    """Append `tree`'s leaves to `leaves` in the JAX order; return its
    structure string (`*` for a leaf)."""
    if tree is None:
        return "None"
    if _is_namedtuple(tree):
        parts = [f"{f}={_flatten(getattr(tree, f), leaves)}" for f in tree._fields]
        return f"{type(tree).__name__}({', '.join(parts)})"
    if isinstance(tree, dict):
        parts = [f"{k!r}: {_flatten(tree[k], leaves)}" for k in sorted(tree)]
        return "{" + ", ".join(parts) + "}"
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v, leaves) for v in tree]
        return ("[%s]" if isinstance(tree, list) else "(%s)") % ", ".join(parts)
    leaves.append(tree)
    return "*"


def _unflatten(like, it):
    """`like`'s structure with its leaves taken in order from `it`."""
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), it) for f in like._fields))
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], it) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, it) for v in like)
    return next(it)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree) -> None:
    """`tree` -> one compressed `.npz` (bitwise, every leaf read back to
    the host)."""
    leaves: list = []
    treedef = _flatten(tree, leaves)
    arrays = {f"leaf_{i}": _host(l) for i, l in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        json.dumps(treedef).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_pytree(path: str, like):
    """Restore a checkpoint into the structure of `like`: tensor leaves on
    the device of `like`'s leaf, other leaves as numpy arrays."""
    like_leaves: list = []
    treedef = _flatten(like, like_leaves)
    with np.load(path) as z:
        n = sum(1 for k in z.files if k.startswith("leaf_"))
        if n != len(like_leaves):
            raise ValueError(f"leaf count mismatch: {n} vs {len(like_leaves)}")
        arrs = [z[f"leaf_{i}"] for i in range(n)]
        stored = (json.loads(z["__treedef__"].tobytes().decode())
                  if "__treedef__" in z.files else None)
    if stored is not None and stored.startswith("PyTreeDef("):
        # written by the JAX package: its treedef string names JAX types,
        # so hold each leaf's shape and dtype against `like` instead
        for i, (a, l) in enumerate(zip(arrs, like_leaves)):
            want = _host(l)
            same_dtype = a.dtype == want.dtype or (
                a.dtype == np.uint32 and want.dtype == np.int32)
            if a.shape != want.shape or not same_dtype:
                raise ValueError(
                    f"checkpoint leaf {i} mismatch: stored {a.dtype}{list(a.shape)}, "
                    f"expected {want.dtype}{list(want.shape)}")
    elif stored is not None and stored != treedef:
        raise ValueError(f"checkpoint treedef mismatch:\n  stored: {stored}\n"
                         f"  expected: {treedef}")
    out = []
    for a, l in zip(arrs, like_leaves):
        if isinstance(l, torch.Tensor):
            if a.dtype == np.uint32:
                a = a.astype(np.int32)
            out.append(torch.as_tensor(a.copy(), device=l.device))
        else:
            out.append(a)
    return _unflatten(like, iter(out))


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
