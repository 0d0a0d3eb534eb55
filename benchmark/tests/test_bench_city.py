"""The live tiled-city cell (`tiled_city.walk`): on the CPU at a tiny size
(2 cities of 24 cells, 64 cars, 1,024 pedestrians, a tower of 12 people,
tile 16), a clean run comes out correct and each fault of
`benchmark/city_faults.py` (pedestrians ignoring their neighbours, red
lights stopping nobody, cars never braking) comes out not correct under
the cell's own limits; on the card (`gpu`), a short run at the cell's own
size, untraced and traced, is correct, the control fails a limit, and the
traced run reports the cell's per-layer metrics.  The city reference
loads nothing of the port, and the cell's system module nothing of JAX.

The tiny city settles 1,200 frames and holds 1,024 pedestrians so that
some of them reach a crosswalk inside the checked windows: with fewer,
a red light may hold nobody there.

    python3 -m pytest benchmark/tests -m gpu -q
"""

import pytest

from benchmark import city_faults, harness
from benchmark.tests.test_bench_stream import _modules

CELL = "tiled_city.walk"
TINY = {"config": {"tile_size": 16, "erosion_iters_tt": 64, "num_cities": 2, "city_size": 24,
                   "city_map": 128, "num_cars": 64, "num_peds": 1024, "tower_people": 12},
        "traffic": {"row_tiles": 3, "sweep_rows": 2, "settle_steps": 1200, "check_from": 48,
                    "check_sample": 4}}
LAYER = ("city_device_ms.walk", "ped_device_ms.walk", "car_device_ms.walk",
         "reroute_host_ms.walk", "host_sync_ms.walk", "kernels_per_frame.walk",
         "device_idle_share.walk")


def _run(**kw) -> dict:
    return harness.run_cell(CELL, 2**31 + 5, 2.0, False, device="cpu", overrides=TINY, **kw)


def test_clean_run_is_correct():
    r = _run(calibrate=True)
    assert r["correct"] and r["failed"] == 0
    assert {"frame_ms", "frame_ms_p95", "setup_s"} <= set(r["metrics"])
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    assert any(r["control"][k] > lim for k, lim in limits.items()), r["control"]


@pytest.mark.parametrize("fault", sorted(city_faults.FAULTS))
def test_a_broken_city_is_not_correct(fault):
    with city_faults.planted(fault):
        r = _run()
    assert not r["correct"] and r["failed"] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [False, True])
def test_city_on_the_card(card, trace):
    r = harness.run_cell(CELL, 3_000_000_000 + trace, 3.0, trace, device=str(card),
                         calibrate=True)
    assert r["correct"] and r["failed"] == 0
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    assert any(r["control"][k] > lim for k, lim in limits.items()), r["control"]
    assert r["device"]["platform"] == "gpu"
    if trace:       # a traced run reports the per-layer metrics only
        assert set(LAYER) <= set(r["metrics"]), r["metrics"]
        assert r["counters"]["city_frames"] == 16 and r["counters"]["probe_fetches"] == 16
        assert r["counters"]["city_graph_replays"] == 16
    else:
        assert {"frame_ms", "frame_ms_p95", "setup_s"} <= set(r["metrics"])


def test_the_city_reference_loads_nothing_of_the_port():
    mods = _modules("import benchmark.reference.city")
    assert "torch" in mods and not mods & (set(harness.FORBIDDEN) | {"w3d_torch"})


def test_the_city_system_loads_nothing_of_jax():
    mods = _modules("import benchmark.systems.tiled_city, benchmark.city_faults")
    assert "w3d_torch" in mods and not mods & set(harness.FORBIDDEN)
