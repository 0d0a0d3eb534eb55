"""What the command loads, and how it refuses to run without a card."""

import os
import shutil
import subprocess
import sys

from benchmark import harness

ROOT = harness.ROOT

PROBE = """
import sys
import benchmark.run, benchmark.calibrate, benchmark.harness, benchmark.faults
import benchmark.systems.spheres, benchmark.systems.tiles
import benchmark.reference.spheres, benchmark.reference.terrain
from benchmark import harness
m = harness.read_json(harness.ROOT + "/BENCHMARK.json")
for x in m["end_to_end"] + m["per_layer"]:
    harness.load_file_module(harness.reader_path(harness.BENCH_DIR, x["name"]), "m_" + x["name"])
print(",".join(sorted({n.split(".")[0] for n in sys.modules})))
"""

REFERENCE_ONLY = """
import sys
import benchmark.reference.spheres, benchmark.reference.terrain
print(",".join(sorted({n.split(".")[0] for n in sys.modules})))
"""


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env.update(kw)
    return env


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.strip().splitlines()[-1].split(","))


def test_the_command_loads_nothing_of_jax_or_the_jax_package():
    mods = _top_level(PROBE)
    assert "w3d_torch" in mods and "torch" in mods
    assert not mods & set(harness.FORBIDDEN)


def test_the_references_load_nothing_of_the_port():
    mods = _top_level(REFERENCE_ONLY)
    assert not mods & (set(harness.FORBIDDEN) | {"w3d_torch"})


def _run(cwd: str):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "spheres_10k.pile", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, env=_env(CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_beside_only_its_own_files_it_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_forbidden_names_are_compared_whole():
    sys.modules["w3d_torch_probe_x"] = sys.modules[__name__]
    try:
        assert "w3d_torch_probe_x" not in harness.forbidden_modules()
    finally:
        del sys.modules["w3d_torch_probe_x"]
