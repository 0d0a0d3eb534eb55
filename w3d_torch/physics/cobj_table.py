"""Column layout of the packed [M, 32] cobj field table.

One row per cobj, the columns of `CF_COLUMNS` in order, zero padding up to
`CF_PAD`.  The narrow-phase kernel C and the fused substep kernel G read
this table (`ops/cuda/narrow_kernel.pack_cobj_fields` packs it), and so does
the fused substep's plain version (`physics/fused`).  The CUDA side states
the same column indices as constants in `csrc/cobj_shapes.cuh`;
`tests/test_torch_fused.py` holds them equal to these.
"""

CF_COLUMNS = ("shape", "p1x", "p1y", "p1z", "p2x", "p2y", "p2z", "r1", "r2",
              "npts",
              "pt0x", "pt0y", "pt0z", "pt1x", "pt1y", "pt1z",
              "pt2x", "pt2y", "pt2z", "pt3x", "pt3y", "pt3z",
              "pnx", "pny", "pnz", "elas", "fric")
CF_PAD = 32
CF_INDEX = {name: i for i, name in enumerate(CF_COLUMNS)}
