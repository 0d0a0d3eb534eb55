"""Building clock placement (port of the host placement half of
`3dworld_tpu/city/clocks.py`): the wall-mounted clock cube
(`add_clock_to_cube`, building_clocks.cpp:199-209) and the nightstand
clock facing the bed (`add_nightstand_clock` :211-227), seeded placement
that `room_content.furnish_rooms` calls.  The display state (7-segment
masks, hand angles, colon blink) is not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations


def wall_clock_cube(wall_pos: float, place_pos: float, zval: float,
                    fh: float, dim: int, dirn: int, digital: bool):
    """Wall-mounted clock cube (add_clock_to_cube
    building_clocks.cpp:199-209): face center `place_pos` along the
    wall, bottom 0.6 floor-spacings above `zval`; digital clocks are
    short and wide (0.08*fh tall, 4:1), analog round (0.25*fh)."""
    z1 = zval + 0.6 * fh
    height = (0.08 if digital else 0.25) * fh
    width = (4.0 if digital else 1.0) * height
    depth = 0.08 * width
    lo = [0.0, 0.0, z1]
    hi = [0.0, 0.0, z1 + height]
    lo[1 - dim] = place_pos - 0.5 * width
    hi[1 - dim] = place_pos + 0.5 * width
    if dirn:
        lo[dim], hi[dim] = wall_pos, wall_pos + depth
    else:
        lo[dim], hi[dim] = wall_pos - depth, wall_pos
    return (lo[0], lo[1], lo[2], hi[0], hi[1], hi[2])


def nightstand_clock_cube(ns_cube, bed_center, fh: float, rg):
    """Digital clock on a nightstand top, facing the bed
    (add_nightstand_clock building_clocks.cpp:211-227): width
    min(0.11*fh, 0.8*min nightstand side), height 0.42w, depth 0.2w,
    jittered across the top and shifted toward the bed side.  Returns
    (cube, dim, dir)."""
    x1, y1, z1, x2, y2, z2 = ns_cube
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    bdx, bdy = bed_center[0] - cx, bed_center[1] - cy
    dim = 0 if abs(bdx) >= abs(bdy) else 1
    dirn = 1 if (bdx if dim == 0 else bdy) > 0 else 0
    ns_w, ns_d = x2 - x1, y2 - y1
    width = min(0.11 * fh, 0.8 * min(ns_w, ns_d))
    height = 0.42 * width
    depth = 0.2 * width
    sz = (ns_w, ns_d)
    width_rand = 0.4 * (sz[1 - dim] - width)
    depth_rand = 0.25 * (sz[dim] - depth)
    dsign = 1.0 if dirn else -1.0
    c_lat = (cx, cy)[1 - dim] + width_rand * (2.0 * rg.randd() - 1.0)
    c_run = (cx, cy)[dim] + depth_rand * ((2.0 * rg.randd() - 1.0) + dsign)
    lo = [0.0, 0.0, z2]
    hi = [0.0, 0.0, z2 + height]
    lo[1 - dim], hi[1 - dim] = c_lat - 0.5 * width, c_lat + 0.5 * width
    lo[dim], hi[dim] = c_run - 0.5 * depth, c_run + 0.5 * depth
    return (lo[0], lo[1], lo[2], hi[0], hi[1], hi[2]), dim, dirn
