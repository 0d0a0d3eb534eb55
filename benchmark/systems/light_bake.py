"""The system that runs the lighting-bake configurations (`spheres_lighting`):
the program's `lighting/bake.LightBake` over the spheres scene
(`models/physics_model.spheres_scene`, a plain `CobjSet`) and a flat mesh,
into a light grid of `mesh_x` x `mesh_y` x `light_layers` cells.

A step is one block of the sky part (the bake of the budget's first two
counts, npts x nrays): `LightBake.step()`, `block_rays` rays in batches of
`batch_rays`, ending in the host read of the bake's sky-weight total.
When a bake's sky part is done the next call starts a new bake from the
seed's next offset, so no call repeats its draws.  The
program's default draws (seeded generators on the device) are recorded as
they are made (`Recorder`, a `trace.DrawSource`).  Set-up builds the
kernels and the scene and steps `settle_steps` blocks, in which the
batches' CUDA graphs are captured (`trace.BATCHES`, counted as
`light_graph_*`).

The check holds each kept block (three drawn from the seed; the traced
run: the traced blocks) against `reference/lighting.py`: the grid's sky
channels are copied after every call, outside it, and the block's delta
(after less before) is compared with the reference's trace of the same
block from zero on the recorded draws (`reference.lighting.readings`).
The control deposits in bfloat16.  With `work`, the traced blocks'
deposited ray-bounces (`LightBake.counts`) and the grid's cells, for
`metrics/deposit_roofline`.
"""

from __future__ import annotations

import math

import torch

from w3d_torch.lighting import bake as LB
from w3d_torch.lighting import lmap as LM
from w3d_torch.lighting import trace as LT
from w3d_torch.models import physics_model as PM
from w3d_torch.ops.cuda import build
from w3d_torch.ops.cuda import sample_kernel as SK
from w3d_torch.scene import cobj as SC
from w3d_torch.utils.constants import WorldConst

from benchmark.reference import lighting as RL

SKY = ("sc_r", "sc_g", "sc_b", "sv")


class RecordingDraws(LT.TraceDraws):
    """A batch's draws as the program makes them, each kept as it is drawn."""

    def __init__(self, *a):
        super().__init__(*a)
        self.made: list = []

    def rays(self, *a, **kw):
        out = super().rays(*a, **kw)
        self.made.append(("rays", out))
        return out

    def bounce(self, b, n, params):
        out = super().bounce(b, n, params)
        self.made.append(("bounce", b, out))
        return out

    def compact(self, b, n):
        out = super().compact(b, n)
        self.made.append(("compact", b, out))
        return out


class Recorder(LT.DrawSource):
    """The program's default draws (generators seeded from each stream on
    the device), recorded since the last `clear()`."""

    def __init__(self, device):
        super().__init__(device)
        self.made: list = []

    def __call__(self, *parts: int) -> RecordingDraws:
        d = RecordingDraws(LT.stream_seed(*parts), self.device, self.gen_device)
        self.made.append(d)
        return d

    def clear(self) -> list:
        out, self.made = self.made, []
        return out


def batches(made: list) -> list:
    """A block's recorded draws as the reference takes them: per batch, the
    ray draws' five, then each bounce's scatter pair and each compaction's
    keys."""
    out = []
    for rays, trace in zip(made[0::2], made[1::2]):
        d = {"rays": [m[1] for m in rays.made], "bounce": [], "compact": {}}
        for m in trace.made:
            if m[0] == "bounce":
                d["bounce"].append((m[2].u, m[2].v))
            else:
                d["compact"][m[1]] = m[2]
        out.append(d)
    return out


def _require(cfg: dict, params: LT.TraceParams) -> None:
    """The configuration's trace settings that the program holds as its
    production parameters, gated by the scene."""
    t = cfg["trace"]
    have = {"max_bounces": params.max_bounces, "samples_per_segment": params.samples_per_segment,
            "samples_later": params.samples_later, "compact": params.compact,
            "compact_shift": params.compact_shift, "line_length": params.line_length,
            "mesh_steps": params.mesh_steps, "exact_mesh": params.exact_mesh,
            "transmission": params.transmission, "specular": params.specular_enabled}
    off = {k: (t[k], v) for k, v in have.items() if t[k] != v}
    if off:
        raise ValueError(f"the program runs other settings (configuration, program): {off}")


class Sky:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.seed, self.device = cfg, seed, device
        if device.type == "cuda":
            # the configuration states float32 without TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            build.library()          # builds the kernels once per checkout
        self.world = WorldConst(mesh_x=cfg["mesh_x"], mesh_y=cfg["mesh_y"],
                                mesh_z=cfg["light_layers"], x_scene=cfg["x_scene"],
                                y_scene=cfg["y_scene"], z_scene=cfg["z_scene"])
        self.cobjs = SC.pack_cobjs(PM.spheres_scene(), device=device)
        self.mesh = torch.full((cfg["mesh_y"], cfg["mesh_x"]), cfg["mesh_z"],
                               dtype=torch.float32, device=device)
        self.draws = Recorder(device)
        self.bakes = 0
        self.finished = dict.fromkeys(LB.COUNTS, 0)     # the counts of the bakes before
        self.bake = self._new_bake()
        _require(cfg, self.bake.params[LM.LIGHTING_SKY])
        self.prev = None            # the sky channels after the last call
        self.kept: dict = {}        # block -> (before, after, draws)
        self.counted: dict = {}     # block -> deposit_rays
        self._c0 = None
        for i in range(traffic["settle_steps"]):
            out = self.call(i)
            self.read(out)
            self._advance(out)
        self.draws.clear()
        self.items_per_step = cfg["block_rays"]

    def _new_bake(self) -> LB.LightBake:
        c = self.cfg
        grid = LM.make_light_grid(self.world, device=self.device)
        bake = LB.LightBake(grid, self.cobjs, self.mesh, c["num_light_rays"][:2],
                            world=self.world, seed=self.seed + self.bakes,
                            params=LB.PRODUCTION, block_rays=c["block_rays"],
                            batch_rays=c["batch_rays"], draws=self.draws)
        self.bakes += 1
        return bake

    def call(self, i: int):
        if self.bake.done:
            for k, v in self.bake.counts.items():
                self.finished[k] += v
            self.bake = self._new_bake()
            self.prev = None
        self.draws.clear()
        self._c0 = dict(self.bake.counts)
        return self.bake.step()

    def read(self, out) -> float:
        return float(out.sv.sum())

    def _advance(self, out):
        after = torch.stack([getattr(out, f) for f in SKY])
        before, self.prev = self.prev, after
        return before, after

    def keep(self, i: int, out, sampled: bool) -> None:
        before, after = self._advance(out)
        if sampled:
            c = self.bake.counts
            self.kept[i] = (before, after, self.draws.clear())
            self.counted[i] = c["deposit_rays"] - self._c0["deposit_rays"]

    def counters(self) -> dict:
        now = self.bake.counts
        return {**{k: v + now[k] for k, v in self.finished.items()}, "bakes": self.bakes,
                "sample": SK.KERNEL.launches,
                **{"light_" + k: v for k, v in LT.BATCHES.counts.items()}}

    def close(self) -> None:
        self.prev = None
        self.bake = None

    def check(self, judge: str, work: bool) -> dict:
        """Readings of the program ("program") or of the control (the
        reference's deposits in bfloat16: "control") against the
        reference: the worst of the kept blocks."""
        cfg = self.cfg
        limits = cfg["check"]["limits"]
        sc = RL.Scene(cfg, self.device)
        worst: dict = {}
        failed = 0
        for i, (before, after, made) in sorted(self.kept.items()):
            bs = batches(made)
            if any(len(b["bounce"]) != sc.bounces for b in bs):
                # the program drew for another number of bounces
                failed += 1
                worst = dict.fromkeys(limits, math.inf)
                continue
            ref = RL.trace_block(sc, bs)
            if judge == "program":
                delta = after.double() - (0.0 if before is None else before.double())
            else:
                delta = RL.trace_block(sc, bs, dtype=torch.bfloat16).double()
            r = RL.readings(delta, ref, after, len(bs), cfg["check"]["rtol"],
                            cfg["check"]["atol"])
            failed += any(r[k] > lim for k, lim in limits.items())
            for k, v in r.items():
                worst[k] = max(worst.get(k, 0.0), v)
        out = {"readings": worst, "failed": int(failed)}
        if work:
            out["work"] = {"deposit": {"rays": [self.counted[i] for i in sorted(self.counted)],
                                       "cells": sc.cells}}
        return out


def setup(cfg: dict, traffic: dict, seed: int, device: torch.device) -> Sky:
    return Sky(cfg, traffic, seed, device)
