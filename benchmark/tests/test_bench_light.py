"""The lighting-bake cell (`lighting_bake.sky`): on the CPU at a tiny size
(a 32 x 32 x 8 grid, bakes of 32,768 sky rays in blocks of two 8,192-ray
batches, so every batch compacts), a clean run comes out correct with its
control failing a limit, a traced run carries the bake's counters, and
each fault of `benchmark/light_faults.py` (a bounce fewer, the compaction
without its weight boost) comes out not correct under the cell's own
limits; on the card (`gpu`), a short run at the cell's own size, untraced
and traced, is correct, the control fails a limit, and the traced run
reports the cell's per-layer metrics.  The reference loads nothing of the
port, and the cell's system module nothing of JAX.  `tiled_city.hover` is
the walk's traffic with the camera held still.

    python3 -m pytest benchmark/tests -m gpu -q
"""

import pytest

from benchmark import harness, light_faults
from benchmark.systems import inf_terrain as SI
from benchmark.tests.test_bench_stream import _modules

CELL = "lighting_bake.sky"
TINY = {"config": {"mesh_x": 32, "mesh_y": 32, "light_layers": 8, "num_light_rays": [64, 512, 0, 0],
                   "batch_rays": 8192, "block_rays": 16384},
        "traffic": {"settle_steps": 1, "check_from": 4, "check_sample": 3, "trace_after": 2,
                    "trace_steps": 2}}
LAYER = ("intersect_device_ms.sky", "deposit_device_ms.sky", "deposit_roofline",
         "kernels_per_frame.sky", "device_idle_share.sky")


def _run(trace=False, **kw) -> dict:
    return harness.run_cell(CELL, 2**31 + 5, 1.0, trace, device="cpu", overrides=TINY, **kw)


@pytest.mark.parametrize("trace", [False, True])
def test_clean_run_is_correct(trace):
    r = _run(trace, calibrate=True)
    assert r["correct"] and r["failed"] == 0
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    assert any(r["control"][k] > lim for k, lim in limits.items()), r["control"]
    if trace:       # two traced blocks of two batches
        c = r["counters"]
        assert c["blocks"] == 2 and c["batches"] == 4 and c["rays"] == 32768
        assert c["deposit_rays"] > c["rays"] and c["deposit_samples"] > 4 * c["deposit_rays"]
    else:
        assert {"frame_ms", "frame_ms_p95", "setup_s"} <= set(r["metrics"])


@pytest.mark.parametrize("fault", sorted(light_faults.FAULTS))
def test_a_broken_bake_is_not_correct(fault):
    with light_faults.planted(fault):
        r = _run()
    assert not r["correct"] and r["failed"] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [False, True])
def test_sky_on_the_card(card, trace):
    r = harness.run_cell(CELL, 3_000_000_000 + trace, 3.0, trace, device=str(card),
                         overrides={"traffic": {"check_from": 2, "check_sample": 1}},
                         calibrate=True)
    assert r["correct"] and r["failed"] == 0
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    assert any(r["control"][k] > lim for k, lim in limits.items()), r["control"]
    assert r["device"]["platform"] == "gpu"
    if trace:
        assert set(LAYER) <= set(r["metrics"]), r["metrics"]
        assert r["counters"]["blocks"] == 2 and r["counters"]["rays"] == 2_000_000
    else:
        assert {"frame_ms", "frame_ms_p95", "setup_s"} <= set(r["metrics"])


def test_hover_holds_the_camera():
    """Over 20,000 frames the hover's camera moves under 1e-4 tile; the
    walk's moves more than 10."""
    cfg = harness.read_json(f"{harness.ROOT}/benchmark/configs/tiled_city_128.json")
    for mix, lo, hi in (("hover", 0.0, 1e-4), ("walk", 10.0, 1e9)):
        traffic = harness.read_json(f"{harness.BENCH_DIR}/traffic/{mix}.json")
        path = SI.Path(cfg, traffic, 7)
        (x0, y0), (x1, y1) = path(0), path(20_000)
        moved = abs(x1 - x0) / path.tw + abs(y1 - y0) / path.th
        assert lo <= moved < hi, (mix, moved)


def test_the_light_reference_loads_nothing_of_the_port():
    mods = _modules("import benchmark.reference.lighting")
    assert "torch" in mods and not mods & (set(harness.FORBIDDEN) | {"w3d_torch"})


def test_the_light_system_loads_nothing_of_jax():
    mods = _modules("import benchmark.systems.light_bake, benchmark.light_faults")
    assert "w3d_torch" in mods and not mods & set(harness.FORBIDDEN)
