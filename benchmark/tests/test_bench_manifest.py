"""BENCHMARK.json against the benchmark's contract, and the harness's
finding of cells by name."""

import json
import os
import re
import shutil

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def manifest():
    return harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(manifest["command"]) <= 32
    assert all(TEXT.match(w) and not w.startswith("/") for w in manifest["command"])
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_run_seconds_fit_a_full_check(manifest):
    """2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s of compiling a
    cell and 1,200 s spare fit into 43,200 s."""
    rs = manifest["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_texts(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in manifest["paths"]))
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(("config", c["name"]))
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] in (1, 4)
        names.append(("workload", w["name"]))
    for key in ("end_to_end", "per_layer"):
        for m in manifest[key]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
            names.append(("metric", m["name"]))
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in manifest["configs"]} == {w["config"] for w in manifest["workloads"]}


def test_end_to_end_metrics(manifest):
    e2e = manifest["end_to_end"]
    assert 1 <= len(e2e) <= 16
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in e2e)
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in manifest["workloads"]}
    for c in cells:
        got = {m["name"] for m in harness.metrics_of(manifest, c, False)}
        assert "setup_s" in got and len(got) >= 2


def test_per_layer_moves_an_end_to_end_metric_of_each_cell(manifest):
    layers = {}
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert TEXT.match(m["layer"])
        cells = m.get("workloads", [w["name"] for w in manifest["workloads"]])
        for c in cells:
            e2e = {x["name"] for x in harness.metrics_of(manifest, c, False)}
            assert m["moves"] in e2e, (m["name"], c)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for w in manifest["workloads"]:
        assert harness.metrics_of(manifest, w["name"], True)


def test_every_name_has_its_file(manifest):
    bench = os.path.join(ROOT, "benchmark")
    for c in manifest["configs"]:
        cfg = harness.read_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert os.path.isfile(os.path.join(bench, "systems", cfg["system"] + ".py"))
        assert "limits" in cfg["check"]
    for w in manifest["workloads"]:
        assert os.path.isfile(os.path.join(bench, "traffic", w["traffic"] + ".json"))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert os.path.isfile(harness.reader_path(bench, m["name"]))
        assert m["name"].endswith("_roofline") == ("roofline" in m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


DUMMY_METRIC = '''"""Frames completed in the window."""


def read(run):
    return float(len(run.steps))
'''


def test_a_cell_added_as_files_only_is_picked_up(tmp_path, manifest):
    """A later PR adds a cell by new files and entries: a configuration, a
    traffic mix and a metric, each found by its name."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = harness.read_json(os.path.join(ROOT, "benchmark/configs/spheres_10k.json"))
    cfg.update(name="spheres_tiny", num_objects=200)
    (root / "benchmark/configs/spheres_tiny.json").write_text(json.dumps(cfg))
    (root / "benchmark/traffic/drop.json").write_text(json.dumps(
        {"settle_steps": 1, "check_from": 2, "check_sample": 1,
         "trace_after": 1, "trace_steps": 1}))
    (root / "benchmark/metrics/frames_done.py").write_text(DUMMY_METRIC)
    m = json.loads(json.dumps(manifest))
    m["configs"].append({"name": "spheres_tiny", "source": "https://example.org/tiny",
                         "file": "benchmark/configs/spheres_tiny.json", "reduced": [],
                         "why": "a dummy"})
    m["workloads"].append({"name": "spheres_tiny.drop", "config": "spheres_tiny",
                           "traffic": "drop", "chips": 1, "why": "a dummy"})
    m["end_to_end"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                            "bound": 0.05, "source": "host_clock",
                            "workloads": ["spheres_tiny.drop"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    r = harness.run_cell("spheres_tiny.drop", 3, 0.2, False, device="cpu",
                         root=str(root), bench_dir=str(root / "benchmark"))
    assert r["correct"] and r["attempted"] >= 1
    assert r["metrics"]["frames_done"]["value"] == r["attempted"]
    assert set(r["metrics"]) == {"setup_s", "frames_done"}
    assert list(r)[-1] == "checks"
