"""Driver of the balls-over-a-scene configurations (`spheres_10k`): the
program's `models/physics_model` world, stepped frame by frame.

Set-up draws the balls' positions and velocities from the seed on the
device, builds the program's world from them, and steps `settle_steps`
frames (each ending in the host read of the live count) so that the balls
have landed.  A step is one `frame_step` of the configuration's substeps
and pair cadence; its host read is the live count (`status > 0`), as the
ground app reads it every frame.

The check holds frames against `reference/spheres.py`.  A pile of
thousands of balls is chaotic over many frames, so the reference
follows the program one frame at a time, from the program's own state
before that frame; the start (the state built from the draws) is held
apart, bit for bit, and so is the first frame from the reference's own
start.
"""

from __future__ import annotations

import torch

from w3d_torch.models import physics_model as PM
from w3d_torch.ops.cuda import build
from w3d_torch.ops.cuda import narrow_kernel as NK
from w3d_torch.ops.cuda import pairs_kernel as PK
from w3d_torch.ops.cuda import sample_kernel as SK
from w3d_torch.utils.constants import WorldConst

from benchmark.reference import spheres as R


def _fields(state) -> dict:
    return {f: getattr(state, f) for f in R.FIELDS}


class Spheres:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.device = cfg, device
        if device.type == "cuda":
            build.library()          # builds the kernels once per checkout
        n = cfg["num_objects"]
        sp = cfg["spawn"]
        gen = torch.Generator(device=device).manual_seed(seed)
        lo = torch.tensor(sp["lo"], dtype=torch.float32, device=device)
        span = torch.tensor(sp["hi"], dtype=torch.float32, device=device) - lo
        self.pos = lo + torch.rand((n, 3), generator=gen, device=device) * span
        self.vel = torch.randn((n, 3), generator=gen, device=device) * sp["vel_sigma"]
        self.world = WorldConst(mesh_x=cfg["mesh_x"], mesh_y=cfg["mesh_y"],
                                x_scene=cfg["x_scene"], y_scene=cfg["y_scene"],
                                z_scene=cfg["z_scene"])
        w = PM.build_spheres_world(self.pos, self.vel, world=self.world,
                                   obj_type=cfg["obj_type"], device=device)
        self.start = w.state
        self.first = None
        for _ in range(traffic["settle_steps"]):
            w = self._frame(w)
            self.read(w)
            if self.first is None:
                self.first = w.state
        self.w = self.prev = w
        self.kept: dict = {}
        self.last = None
        self.items_per_step = 1

    def _frame(self, w):
        c = self.cfg
        return PM.frame_step(w, substeps=c["substeps"], world=self.world,
                             obj_collisions=True, pair_every=c["pair_every"],
                             water=c["water"])

    def call(self, i: int):
        self.prev = self.w
        self.w = self._frame(self.prev)
        return self.w

    def read(self, out) -> int:
        return int((out.state.status > 0).sum())

    def keep(self, i: int, out, sampled: bool) -> None:
        pair = (self.prev.state, out.state)
        if sampled:
            self.kept[i] = pair
        self.last = (i, pair)

    def counters(self) -> dict:
        return {"sample": SK.KERNEL.launches, "narrow": NK.KERNEL.launches,
                "pairs": PK.KERNEL.launches}

    def close(self) -> None:
        self.w = self.prev = None

    def check(self, judge: str, work: bool) -> dict:
        """Readings of the program ("program") or of the control (the
        reference in bfloat16, "control") against the reference, at the
        worst of the frames checked; with `work`, the pair work of the
        kept frames."""
        ref = R.Frame(self.cfg, self.device)
        s0 = R.initial_state(self.pos, self.vel)
        start_off = 0.0
        if judge == "program":
            start_off = float(sum(not torch.equal(getattr(self.start, f), s0[f])
                                  for f in R.FIELDS))
        frames = [(None, s0, _fields(self.first))]
        frames += [(i, _fields(a), _fields(b)) for i, (a, b) in sorted(self.kept.items())]
        i_last, (a, b) = self.last
        if i_last not in self.kept:
            frames.append((i_last, _fields(a), _fields(b)))
        worst: dict = {"start_fields_off": start_off}
        failed_frames = 0
        pairs: list = []
        limits = self.cfg["check"]["limits"]
        for i, s_in, s_out in frames:
            w = pairs if (work and i in self.kept) else None
            expect = ref(s_in, work=w)
            cand = s_out if judge == "program" else ref(s_in, dtype=torch.bfloat16)
            r = R.readings(cand, expect)
            failed_frames += any(r.get(k, 0.0) > lim for k, lim in limits.items())
            for k, v in r.items():
                worst[k] = max(worst.get(k, 0.0), v)
        out = {"readings": worst, "failed": failed_frames}
        if work:
            out["work"] = {
                "banded_pairs": [(n, int(v), int(h)) for n, v, h in pairs],
                "narrow": (self.cfg["num_objects"], self.cfg["cobj_slots"],
                           self.cfg["live_cobjs"])}
        return out


def setup(cfg: dict, traffic: dict, seed: int, device: torch.device) -> Spheres:
    return Spheres(cfg, traffic, seed, device)
