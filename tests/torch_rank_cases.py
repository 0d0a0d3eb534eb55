"""What each rank runs in the sharded-port tests (tests/test_torch_parallel.py,
test_torch_pairs_sharded.py, test_torch_lighting_sharded.py).

`parallel.launch.run_ranks` spawns the ranks, and a spawned child imports
the module of its target; the test modules import jax, so the rank
functions live here, in a module that imports only torch and the port.
Each takes the rank's `Mesh` and the inputs the test made in the parent
(port tensors on the CPU) and returns the gathered results of every case.
"""

from __future__ import annotations

import torch

from w3d_torch.entry import make_sharded_combined_step
from w3d_torch.lighting import lmap as LM
from w3d_torch.lighting import parallel as LPAR
from w3d_torch.lighting.trace import DrawSource, TraceDraws
from w3d_torch.models import physics_model as PM
from w3d_torch.models import terrain_model as TMOD
from w3d_torch.parallel import halo as PH
from w3d_torch.parallel import pad_to_multiple
from w3d_torch.parallel.mesh import gather_leading, local_block
from w3d_torch.parallel.pairs import make_halo_pair_fn, make_step_objects_sharded


class TapeDraws(TraceDraws):
    """Draws recorded from another `TraceDraws` (`inner`), call by call, or
    replayed from such a recording (`tape`)."""

    def __init__(self, inner: TraceDraws | None = None, tape: list | None = None):
        self.inner = inner
        self.tape = [] if tape is None else list(tape)
        self.device = torch.device("cpu")

    def _take(self, name, *args):
        if self.inner is None:
            return self.tape.pop(0)
        value = getattr(self.inner, name)(*args)
        self.tape.append(value)
        return value

    def rays(self, splits, i, shape, kind="uniform", lo=0.0, hi=1.0):
        return self._take("rays", splits, i, shape, kind, lo, hi)

    def bounce(self, b, n, params):
        return self._take("bounce", b, n, params)

    def compact(self, b, n):
        return self._take("compact", b, n)


class TapeSource(DrawSource):
    """A `DrawSource` that records the streams `make(*parts)` gives, or
    replays `tapes` ({parts: recorded draws})."""

    def __init__(self, make=None, tapes: dict | None = None):
        self.make = make
        self.tapes = {} if tapes is None else tapes

    def __call__(self, *parts):
        if self.make is None:
            return TapeDraws(tape=self.tapes[parts])
        d = TapeDraws(inner=self.make(*parts))
        self.tapes[parts] = d.tape
        return d


def fail_on_rank_one(mesh):
    if mesh.rank == 1:
        raise ValueError("rank one fails")
    return mesh.rank


def parallel_cases(mesh, inp: dict) -> dict:
    """The mesh helpers, ring shifts, the AO halo context, the shadow scans
    and the sharded tile step."""
    torch.set_num_threads(1)
    out = {"mesh": (mesh.rank, mesh.size, mesh.backend, str(mesh.device)),
           "pad": pad_to_multiple(10, mesh.size)}
    x = inp["rows"]
    out["block"] = local_block(x, mesh)
    out["gathered_state"] = gather_leading(local_block(inp["state"], mesh), mesh)
    me = torch.full((3,), float(mesh.rank))
    out["shift"] = {s: PH.halo_shift(me, mesh, s) for s in (1, -1, 2)}
    ctx = PH.make_halo_context(mesh, inp["halo"])(local_block(inp["ctx_z"], mesh))
    out["ctx"] = gather_leading(ctx, mesh)
    out["shadows"] = {}
    for name, (z, light, mode, init) in inp["shadow_cases"].items():
        run = PH.make_sharded_shadow_scan(mesh, light, inp["cell_w"], mode=mode)
        out["shadows"][name] = gather_leading(run(local_block(z, mesh), init), mesh)
    mcfg, world = inp["tile_cfg"]
    step = TMOD.make_sharded_tile_step(mesh, mcfg, world)
    out["tiles"] = gather_leading(step(*inp["tile_args"]), mesh)
    return out


def pair_cases(mesh, inp: dict) -> dict:
    """The halo pair function, sharded frames with pairs, the frame step
    without collisions and the sharded combined step."""
    torch.set_num_threads(1)
    out = {}
    window = inp["window"]
    deltas = make_halo_pair_fn(mesh, window)(*local_block(inp["cols"], mesh))
    out["pairs"] = gather_leading(tuple(deltas), mesh)
    try:
        make_halo_pair_fn(mesh, inp["cols"][0].shape[0])(*local_block(inp["cols"], mesh))
        out["wide_window"] = None
    except ValueError as e:
        out["wide_window"] = str(e)

    sw, world = inp["world"], inp["world_const"]
    step = make_step_objects_sharded(mesh, substeps=inp["substeps"], world=world,
                                     window=window, pair_every=inp["pair_every"],
                                     water=False)
    slab = local_block(sw.state, mesh)
    frames = []
    for _ in range(inp["frames"]):
        slab = step(slab, sw.env, sw.cobjs, sw.table)
        frames.append(gather_leading(slab, mesh))
    out["frames"] = frames

    fstep = PM.make_sharded_frame_step(mesh, substeps=inp["substeps"], world=world,
                                       obj_collisions=False)
    out["free"] = gather_leading(fstep(sw._replace(state=local_block(sw.state, mesh))).state,
                                 mesh)

    mcfg, tw, csw, cargs = inp["combined"]
    cstep = make_sharded_combined_step(mesh, mcfg, tw, substeps=inp["substeps"],
                                       window=window)
    tiles, st = cstep(*cargs, local_block(csw.state, mesh), csw)
    out["combined"] = (gather_leading(tiles, mesh), gather_leading(st, mesh))
    return out


def lighting_cases(mesh, inp: dict) -> dict:
    """The sky bake, a global bake onto its result, a ray count that is not a
    multiple of the ranks, and the sky bake again (run to run)."""
    torch.set_num_threads(1)
    src = TapeSource(tapes=inp["tapes"])
    kw = dict(params=inp["params"], world=inp["world"], draws=src)
    grid = LM.make_light_grid(inp["world"], device="cpu")
    cobjs, hf = inp["cobjs"], inp["mesh_hf"]
    out = {}
    for name, (kind, num_rays, batch, seed, base) in inp["bakes"].items():
        g = grid if base is None else out[base]
        if kind == "sky":
            out[name] = LPAR.compute_sky_lighting_sharded(mesh, g, cobjs, hf, num_rays,
                                                          seed=seed, batch=batch, **kw)
        else:
            out[name] = LPAR.compute_global_lighting_sharded(
                mesh, g, cobjs, hf, num_rays, inp["sun_dir"], seed=seed, batch=batch, **kw)
    out["traffic"] = (mesh.traffic.calls, mesh.traffic.bytes)
    return out
