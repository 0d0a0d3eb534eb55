"""Text mesh dump + full sim-state save/load (port of
`3dworld_tpu/terrain/state_io.py`; host numpy, copied).

The reference's save-state path (mesh_gen.cpp:895-1045): `read_mesh` /
`write_mesh` exchange a "<xsize> <ysize>" header plus row-major height
floats (scaled by mesh_file_scale + mesh_file_tz on read), and
`save_state`/`load_state` serialize the camera pose, scroll offsets,
RNG index + global LCG seeds, grid dims, and the full 90x5 sine table —
enough to regenerate the identical world.  Same formats here, so state
files round-trip between readers: a file either package writes is byte
for byte what the other writes.  `heights` and `sine_table` may be
tensors on any device; they are read back to the host first.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """A tensor (any device) or array -> float32 numpy."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def write_mesh(path: str, heights) -> None:
    """write_mesh (mesh_gen.cpp:936-966): text header + row floats."""
    h = _host(heights)
    my, mx = h.shape
    with open(path, "w") as f:
        f.write(f"{mx} {my}\n")
        for row in h:
            f.write(" ".join(f"{v:f}" for v in row) + " \n")


def read_mesh(path: str, expect_shape=None, mesh_file_scale: float = 1.0,
              mesh_file_tz: float = 0.0) -> np.ndarray:
    """read_mesh (mesh_gen.cpp:895-933): height = scale*file + tz."""
    with open(path) as f:
        toks = f.read().split()
    mx, my = int(toks[0]), int(toks[1])
    if expect_shape is not None and (my, mx) != tuple(expect_shape):
        raise ValueError(f"mesh size in file is {mx}x{my}, expected "
                         f"{expect_shape[1]}x{expect_shape[0]}")
    vals = np.asarray(toks[2:2 + mx * my], np.float32).reshape(my, mx)
    return mesh_file_scale * vals + mesh_file_tz


class SimState(NamedTuple):
    """The save_state header fields (mesh_gen.cpp:1010-1030)."""

    c_radius: float
    c_phi: float
    c_theta: float
    camera_origin: tuple        # (x, y, z)
    surface_pos: tuple          # (x, y, z)
    xoff: int
    yoff: int
    xoff2: int
    yoff2: int
    rand_gen_index: int
    rseed1: int
    rseed2: int
    mesh_x: int
    mesh_y: int
    num_freq_comp: int
    n_rand_sin2: int
    sine_table: np.ndarray      # [F_TABLE_SIZE, 5]


def save_state(path: str, st: SimState) -> None:
    with open(path, "w") as f:
        co, sp = st.camera_origin, st.surface_pos
        f.write(f"{st.c_radius} {st.c_phi} {st.c_theta} "
                f"{co[0]} {co[1]} {co[2]} {sp[0]} {sp[1]} {sp[2]} "
                f"{st.xoff} {st.yoff} {st.xoff2} {st.yoff2} "
                f"{st.rand_gen_index} {st.rseed1} {st.rseed2}\n"
                f"{st.mesh_x} {st.mesh_y} {st.num_freq_comp} "
                f"{st.n_rand_sin2}\n")
        for row in _host(st.sine_table):
            f.write(" ".join(f"{v:f}" for v in row) + " \n")


def load_state(path: str, expect_dims=None) -> SimState:
    with open(path) as f:
        toks = f.read().split()
    g = iter(toks)
    nxt = lambda t=float: t(next(g))
    c_radius, c_phi, c_theta = nxt(), nxt(), nxt()
    co = (nxt(), nxt(), nxt())
    sp = (nxt(), nxt(), nxt())
    xoff, yoff, xoff2, yoff2 = nxt(int), nxt(int), nxt(int), nxt(int)
    rgi, rs1, rs2 = nxt(int), nxt(int), nxt(int)
    mx, my, nfc, nrs = nxt(int), nxt(int), nxt(int), nxt(int)
    if expect_dims is not None and (mx, my, nfc, nrs) != tuple(expect_dims):
        raise ValueError("saved state is incompatible with the current "
                         f"configuration: {(mx, my, nfc, nrs)}")
    # F_TABLE_SIZE = NUM_FREQ_COMP * N_RAND_SIN2 rows of 5 floats each
    # (mesh_gen.cpp:30, load_state table loop mesh_gen.cpp:991-999)
    table = np.asarray([float(next(g)) for _ in range(nfc * nrs * 5)],
                       np.float32).reshape(-1, 5)
    if table.shape[0] != nfc * nrs:
        raise ValueError(f"sine table has {table.shape[0]} rows, "
                         f"expected F_TABLE_SIZE={nfc * nrs}")
    return SimState(c_radius, c_phi, c_theta, co, sp, xoff, yoff, xoff2,
                    yoff2, rgi, rs1, rs2, mx, my, nfc, nrs, table)
