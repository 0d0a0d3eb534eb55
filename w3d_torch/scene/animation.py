"""Skeletal animation: bone hierarchies + linear-blend skinning (port of
`3dworld_tpu/scene/animation.py`).

The reference supports skeletal animation through Assimp: <=4 bone
influences per vertex, animation channels with position/rotation/scale
keyframes evaluated per frame (model3d.h:205-254, assimp_wrap.cpp).

A skeleton is SoA arrays (parent ids, bind/inverse-bind matrices); a
pose evaluates on the host by composing local transforms down the
hierarchy (bone counts are tiny; numpy float32, as in the JAX package)
and skinning is tensor code on the device: each vertex's 4 bone
matrices gathered by index (the JAX package's one-hot matmul over the
bone rows was a TPU layout workaround) and applied in a fixed order of
elementwise products and sums, the same on the card and the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MAX_BONE_INFLUENCES = 4  # model3d.h bone limit


class Skeleton(NamedTuple):
    parent: np.ndarray        # [B] parent bone id (-1 root)
    inv_bind: np.ndarray      # [B, 4, 4] inverse bind matrices
    local_bind: np.ndarray    # [B, 4, 4] bind-pose local transforms


class SkinWeights(NamedTuple):
    bone_ids: torch.Tensor    # [V, 4] int32
    weights: torch.Tensor     # [V, 4] f32 (sum to 1)


class AnimChannel(NamedTuple):
    """Per-bone keyframes: times [K], translations [K, 3], rotations
    [K, 4] (quaternions), scales [K]."""

    times: np.ndarray
    trans: np.ndarray
    quats: np.ndarray
    scales: np.ndarray


def _quat_to_mat(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _slerp(q0, q1, t):
    d = np.dot(q0, q1)
    if d < 0:
        q1 = -q1
        d = -d
    if d > 0.9995:
        out = q0 + t * (q1 - q0)
    else:
        th = np.arccos(np.clip(d, -1, 1))
        out = (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)
    return out / np.linalg.norm(out)


def sample_channel(ch: AnimChannel, time: float):
    """Keyframe interpolation (position lerp, rotation slerp, scale lerp)."""
    times = ch.times
    t = float(np.clip(time, times[0], times[-1]))
    i = int(np.searchsorted(times, t, side="right") - 1)
    i = min(i, len(times) - 2) if len(times) > 1 else 0
    if len(times) == 1:
        return ch.trans[0], ch.quats[0], ch.scales[0]
    f = (t - times[i]) / max(times[i + 1] - times[i], 1e-9)
    tr = ch.trans[i] * (1 - f) + ch.trans[i + 1] * f
    q = _slerp(ch.quats[i], ch.quats[i + 1], f)
    s = ch.scales[i] * (1 - f) + ch.scales[i + 1] * f
    return tr, q, s


def evaluate_pose(skel: Skeleton, channels: dict, time: float,
                  device="cuda") -> torch.Tensor:
    """Global skinning matrices [B, 4, 4] at `time` on `device`: compose
    local transforms down the hierarchy, multiply by inverse bind."""
    B = len(skel.parent)
    local = skel.local_bind.copy()
    for b, ch in channels.items():
        tr, q, s = sample_channel(ch, time)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = _quat_to_mat(np.asarray(q)) * s
        m[:3, 3] = tr
        local[b] = m
    world = np.zeros_like(local)
    for b in range(B):  # parents precede children by construction
        p = skel.parent[b]
        world[b] = local[b] if p < 0 else world[p] @ local[b]
    return torch.as_tensor(world @ skel.inv_bind, device=device)


def skin_vertices(positions: torch.Tensor, skin: SkinWeights,
                  bone_mats: torch.Tensor) -> torch.Tensor:
    """Linear-blend skinning, batched over all vertices.

    positions [V, 3]; bone_mats [B, 4, 4].  Per-vertex: sum over the 4
    influences of w_i * (M_{b_i} p), the point homogeneous (w = 1).  The
    bone matrices' first three rows are gathered by index, each row's dot
    product summed x, y, z, then w, and the influences in order."""
    mats = bone_mats[:, :3, :][skin.bone_ids.long()]        # [V, 4inf, 3, 4]
    p = positions[:, None, None, :]                         # [V, 1, 1, 3]
    out = (mats[..., 0] * p[..., 0] + mats[..., 1] * p[..., 1]
           + mats[..., 2] * p[..., 2] + mats[..., 3])       # [V, 4inf, 3]
    w = skin.weights[..., None] * out
    return w[:, 0] + w[:, 1] + w[:, 2] + w[:, 3]


def make_simple_skeleton(num_bones: int, spacing: float = 0.2) -> tuple:
    """A test chain skeleton along +z with identity bind."""
    parent = np.arange(num_bones) - 1
    local = np.tile(np.eye(4, dtype=np.float32), (num_bones, 1, 1))
    local[1:, 2, 3] = spacing
    world = np.zeros_like(local)
    for b in range(num_bones):
        world[b] = local[b] if parent[b] < 0 else world[parent[b]] @ local[b]
    inv_bind = np.linalg.inv(world).astype(np.float32)
    return Skeleton(parent=parent, inv_bind=inv_bind, local_bind=local)
