"""Each cell on the card at its own size, with a short window: the
program comes out correct, and the control (the reference one precision
lower, in the program's place) reads past a limit on every seed.

    python3 -m pytest benchmark/tests -m gpu -q
"""

import pytest

from benchmark import harness

CELLS = ("spheres_10k.pile", "tiled_terrain_128.batch4096")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [71, 72, 73])
def test_program_correct_and_control_fails(card, workload, seed):
    r = harness.run_cell(workload, seed, 2.0, False, device=str(card), calibrate=True)
    assert r["correct"] and r["failed"] == 0
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    assert any(r["control"][k] > lim for k, lim in limits.items()), r["control"]
    assert r["device"]["platform"] == "gpu" and "setup_s" in r["metrics"]
