"""The live tiled-terrain cell (`tiled_terrain_128.stream`): on the CPU at
tile 16, a clean run comes out correct and each fault of
`benchmark/stream_faults.py` (no shadows, AO's halo filled with the
tile's edge, a batch adopted in the frame that makes it) comes out not
correct under the cell's own limits; on the card (`gpu`), a short run of
the cell at its own size, untraced and traced, is correct, the control
fails a limit, and the traced run reports the cell's per-layer metrics.
The reference loads nothing of the port, and the cell's system module nothing of JAX.
No two configurations share both their source and their `reduced` keys.

    python3 -m pytest benchmark/tests -m gpu -q
"""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness, stream_faults

CELL = "tiled_terrain_128.stream"
TINY = {"config": {"tile_size": 16, "erosion_iters_tt": 64},
        "traffic": {"row_tiles": 3, "sweep_rows": 2, "check_from": 24, "check_sample": 2}}
LAYER = ("tile_gen_host_ms.stream", "shadow_device_ms.stream", "ao_device_ms.stream",
         "kernels_per_frame.stream", "device_idle_share.stream")


def _run(**kw) -> dict:
    return harness.run_cell(CELL, 2**31 + 5, 0.5, False, device="cpu", overrides=TINY, **kw)


def test_clean_run_is_correct():
    r = _run()
    assert r["correct"] and r["failed"] == 0
    assert {"frame_ms", "frame_ms_p95", "setup_s"} <= set(r["metrics"])


@pytest.mark.parametrize("fault", sorted(stream_faults.FAULTS))
def test_a_broken_stream_is_not_correct(fault):
    with stream_faults.planted(fault):
        r = _run()
    assert not r["correct"] and r["failed"] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [False, True])
def test_stream_on_the_card(card, trace):
    r = harness.run_cell(CELL, 3_000_000_000 + trace, 3.0, trace, device=str(card),
                         calibrate=True)
    assert r["correct"] and r["failed"] == 0
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    assert any(r["control"][k] > lim for k, lim in limits.items()), r["control"]
    assert r["device"]["platform"] == "gpu"
    if trace:       # a traced run reports the per-layer metrics only
        assert set(LAYER) <= set(r["metrics"]), r["metrics"]
        assert r["counters"]["batches"] == 2 and r["counters"]["erosion"] == 4
    else:
        assert {"frame_ms", "frame_ms_p95", "setup_s"} <= set(r["metrics"])


def _modules(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(','.join("
                          "sorted({n.split('.')[0] for n in sys.modules})))"],
                         cwd=harness.ROOT, env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    return set(out.stdout.strip().splitlines()[-1].split(","))


def test_the_stream_reference_loads_nothing_of_the_port():
    mods = _modules("import benchmark.reference.inf_terrain")
    assert "torch" in mods and not mods & (set(harness.FORBIDDEN) | {"w3d_torch"})


def test_the_stream_driver_loads_nothing_of_jax():
    mods = _modules("import benchmark.systems.inf_terrain, benchmark.stream_faults")
    assert "w3d_torch" in mods and not mods & set(harness.FORBIDDEN)


def test_each_configuration_has_a_source_of_its_own():
    """Two deployments named by one source need sources that differ: the
    live stream's names the part of `tiled_mesh.cpp` that defines it."""
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        configs = json.load(f)["configs"]
    keys = [(c["source"], tuple(sorted(c["reduced"]))) for c in configs]
    assert len(set(keys)) == len(keys)
    for c in configs:
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            assert json.load(f).get("source", c["source"]) == c["source"]
