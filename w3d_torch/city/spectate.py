"""Spectate mode: follow building people / pedestrians / cars (port of
`3dworld_tpu/city/spectate.py`; city_interact.cpp
`city_spectate_manager_t`).

Toggling spectate finds the closest agent within 4*CAMERA_RADIUS — the
building person when the player is inside a building, otherwise the
closer of the nearest pedestrian and nearest non-parked car
(city_interact.cpp:85-130 `toggle_enabled`); each frame the camera snaps
to the followed agent's eye position and view direction
(`set_camera_to_follow_person` :50-56, `next_frame` :131-170).  The
distance scans read the agent arrays back to the host (a toggle or a
chunk's camera, not per frame).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import traffic as CT

SPEC_NONE, SPEC_BAI, SPEC_PED, SPEC_CAR = range(4)
PED_EYE_F = 0.9     # eye height fraction of ped height (get_eye_pos)
CAR_EYE_F = 0.6     # camera height fraction above a followed car roof


class Spectate(NamedTuple):
    mode: int = SPEC_NONE
    ix: int = -1


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _closest_ix(px, py, xs, ys, dmax, mask=None):
    """Index of the closest agent within dmax, else -1
    (find_closest_person/find_closest_car)."""
    xs = _host(xs).astype(np.float32)
    ys = _host(ys).astype(np.float32)
    d2 = (xs - px) ** 2 + (ys - py) ** 2
    if mask is not None:
        d2 = np.where(_host(mask), np.inf, d2)
    if d2.size == 0:
        return -1, np.inf
    ix = int(np.argmin(d2))
    dmin = float(d2[ix])
    if dmin >= dmax * dmax:
        return -1, np.inf
    return ix, dmin


def toggle(spec: Spectate, px: float, py: float, cw,
           bldg_people_xy=None, camera_radius: float = 0.05) -> Spectate:
    """toggle_enabled: stop if following; otherwise follow the closest
    agent within 4*camera_radius — building people take precedence when
    `bldg_people_xy` is given (player inside a building), else the
    closer of nearest ped / nearest driving car.  `cw` has `cars`,
    `peds` and `graph`."""
    if spec.mode != SPEC_NONE:
        return Spectate()
    dmax = 4.0 * camera_radius
    if bldg_people_xy is not None:
        bx, by = bldg_people_xy
        ix, _ = _closest_ix(px, py, bx, by, dmax)
        return Spectate(SPEC_BAI, ix) if ix >= 0 else spec
    best = Spectate()
    best_d = np.inf
    if cw.peds is not None and cw.peds.x.shape[0] > 0:
        ix, d = _closest_ix(px, py, cw.peds.x, cw.peds.y, dmax)
        if ix >= 0:
            best, best_d = Spectate(SPEC_PED, ix), d
    if cw.cars is not None and cw.cars.seg.shape[0] > 0:
        cx, cy = CT.car_positions(cw.cars, cw.graph)
        ix, d = _closest_ix(px, py, cx, cy, dmax, mask=cw.cars.parked)  # skip parked
        if ix >= 0 and d < best_d:
            best = Spectate(SPEC_CAR, ix)
    return best


def camera_state(spec: Spectate, cw, bldg_people_xy=None,
                 ped_height: float = 0.04, car_height: float = 0.02):
    """next_frame: (x, y, z_off, dir_x, dir_y) of the followed agent's
    eye, or None when not spectating.  Cars face their travel
    direction; peds face their goal."""
    if spec.mode == SPEC_NONE or spec.ix < 0:
        return None
    if spec.mode == SPEC_BAI:
        if bldg_people_xy is None:
            return None
        bx, by = bldg_people_xy
        if spec.ix >= len(bx):
            return None
        return (float(bx[spec.ix]), float(by[spec.ix]),
                PED_EYE_F * ped_height, 1.0, 0.0)
    if spec.mode == SPEC_PED:
        p = cw.peds
        if spec.ix >= p.x.shape[0]:
            return None
        x = float(p.x[spec.ix])
        y = float(p.y[spec.ix])
        dx = float(p.gx[spec.ix]) - x
        dy = float(p.gy[spec.ix]) - y
        n = float(np.hypot(dx, dy)) or 1.0
        return (x, y, PED_EYE_F * ped_height, dx / n, dy / n)
    # SPEC_CAR
    cars = cw.cars
    if spec.ix >= cars.seg.shape[0]:
        return None
    cx, cy = CT.car_positions(cars, cw.graph)
    seg = int(cars.seg[spec.ix])
    dim = int(cw.graph.dim[seg])
    end = int(cars.end[spec.ix])
    ddx, ddy = CT._seg_dir_vec(torch.tensor(dim), torch.tensor(end))
    return (float(cx[spec.ix]), float(cy[spec.ix]),
            (1.0 + CAR_EYE_F) * car_height, float(ddx), float(ddy))
