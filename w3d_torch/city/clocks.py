"""Building analog and digital clocks (port of
`3dworld_tpu/city/clocks.py`, building_clocks.cpp).

The reference renders wall/nightstand clocks whose state comes from a
shared `clock_time_t` (building_clocks.cpp:15-40): analog clocks get
hour/minute/second hand angles (:149-178), digital clocks get 7-segment
HH:MM[:SS] displays with a blanked leading hour zero and colons that
blink once a second (:126-156); the same 7-segment encoder drives
elevator floor displays ('G', 'B3', 'P2' —
`elevator_floor_to_7seg_digit_pair` :236-267).

The display state (digit segment masks, hand angles, colon blink) is
elementwise over tensors on the caller's device, so one call computes
every clock in the city; geometry placement (wall mount proportions
`add_clock_to_cube` :199-209, nightstand clocks facing the bed
`add_nightstand_clock` :211-227) is host-side seeded placement that
`room_content.furnish_rooms` calls.
"""

from __future__ import annotations

import numpy as np
import torch

# 7-segment encodings: 0-9, A, b, C, d, E, F, p, blank
# (building_clocks.cpp:63 num_to_segs; bit order a..g = bits 0..6)
SEG_MASKS = np.array([0x3F, 0x06, 0x5B, 0x4F, 0x66, 0x6D, 0x7D, 0x07,
                      0x7F, 0x6F, 0x77, 0x7C, 0x39, 0x5E, 0x79, 0x71,
                      0x73, 0x00], np.int32)
IDX_B, IDX_P, IDX_BLANK = 11, 16, 17


def clock_time(secs_of_day, use_12h: bool = True):
    """(hours, mins, secs) int32 from seconds-of-day (a tensor keeps its
    device); 12-hour conversion maps 0 -> 12 (clock_time_t::update)."""
    s = torch.as_tensor(secs_of_day).to(torch.int32)
    secs = s % 60
    mins = (s // 60) % 60
    hours = (s // 3600) % 24
    if use_12h:
        hours = hours % 12
        hours = torch.where(hours == 0, 12, hours)
    return hours, mins, secs


def hand_fracs(hours, mins, secs):
    """Analog hand positions in [0,1) of a full sweep
    (building_clocks.cpp:149: second_pos=s/60,
    minute_pos=(m+second_pos)/60, hour_pos=(h+minute_pos)/12)."""
    f32 = lambda v: torch.as_tensor(v).to(torch.float32)
    second_pos = f32(secs) / 60.0
    minute_pos = (f32(mins) + second_pos) / 60.0
    hour_pos = (f32(hours) % 12 + minute_pos) / 12.0
    return hour_pos, minute_pos, second_pos


def digit_pair(number, skip_leading_zero: bool = False):
    """Two digit indices for a 0-99 number; the tens digit blanks when
    skip_leading_zero and number < 10 (add_display_digit_pair)."""
    n = torch.as_tensor(number).to(torch.int32)
    tens = n // 10
    ones = n % 10
    if skip_leading_zero:
        tens = torch.where(n < 10, IDX_BLANK, tens)
    return tens, ones


def display_state(secs_of_day, show_seconds: bool = False,
                  use_12h: bool = True):
    """Digital clock display: ([..., 6] int32 segment masks for
    HH MM SS — SS blank when not shown) and the colon on/off flag
    (colons blink with the seconds parity only when seconds are shown,
    building_clocks.cpp:146).  Broadcasts over leading axes."""
    h, m, s = clock_time(secs_of_day, use_12h)
    masks = torch.as_tensor(SEG_MASKS, device=h.device)
    ht, ho = digit_pair(h, skip_leading_zero=True)
    mt, mo = digit_pair(m)
    if show_seconds:
        st, so = digit_pair(s)
        colon_on = (s & 1).to(torch.bool)
    else:
        st = so = torch.full_like(ht, IDX_BLANK)
        colon_on = torch.ones_like(ht, dtype=torch.bool)
    digits = torch.stack([ht, ho, mt, mo, st, so], dim=-1)
    return masks[digits.long()], colon_on


def elevator_floor_digits(label: str):
    """Digit indices for an elevator floor display: '[G]', '[digit]',
    '[digit digit]', or '[{B,P} digit]'
    (elevator_floor_to_7seg_digit_pair)."""
    if len(label) == 1:
        c = label[0]
        n = int(c) if c.isdigit() else 0  # 'G' shows as 0
        return (IDX_BLANK, n)
    if len(label) == 2:
        c1, c2 = label
        assert c2.isdigit(), label
        if c1.isdigit():
            n1 = int(c1)
        elif c1 in "Bb":
            n1 = IDX_B
        elif c1 in "Pp":
            n1 = IDX_P
        elif c1 == " ":
            n1 = IDX_BLANK
        else:
            raise ValueError(label)
        return (n1, int(c2))
    raise ValueError(f"bad elevator floor label: {label}")


# ---------------------------------------------------------------------------
# host-side placement


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
