"""`BENCHMARK.json` and the files it names keep to the benchmark's
contract: names, units, keys, bounds, and every file a cell needs."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= manifest["run_seconds"] <= 51
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(manifest["command"]) <= 32
    assert all(_one_line(w) for w in manifest["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(manifest):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert _one_line(entry[key]), (entry["name"], key)
    for group in ("configs", "workloads"):
        got = [n for g, n in names if g == group]
        assert len(got) == len(set(got))
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))
    for c in manifest["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(
            c["reduced"]) <= 16
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_entry_keys(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert m["better"] in ("lower", "higher")
    assert "setup_s" in [m["name"] for m in manifest["end_to_end"]]


def test_every_cell_reports_enough(manifest):
    for w in manifest["workloads"]:
        mine = [m for m in manifest["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        layer = [m for m in manifest["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert layer
        # a per-layer metric moves an end-to-end metric of each of its cells
        for m in layer:
            assert m["moves"] in [x["name"] for x in mine], (w, m["name"])


def test_files_of_every_cell_and_metric(manifest):
    bench = harness.Bench(ROOT)
    for w in manifest["workloads"]:
        bench.config(w["config"])
        bench.traffic(w["traffic"])
        assert set(bench.limits(w["name"])) >= {"pose_gap_p90_m", "pose_gap_p99_m",
                                           "yaw_gap_p95_rad"}
        assert bench.metrics(w["name"], trace=True)
    for c in manifest["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in manifest["paths"]))
    layers = {}
    for m in manifest["per_layer"]:
        cell = m.get("workloads", [manifest["workloads"][0]["name"]])[0]
        mod = [x for x in bench.metrics(cell, True) if x[0] == m["name"]]
        assert mod, m["name"]
        layers.setdefault(m["layer"], set()).add(m["name"])


def test_every_configuration_has_a_reference_that_takes_it(manifest):
    bench = harness.Bench(ROOT)
    for c in manifest["configs"]:
        cfg = bench.config(c["name"])
        bench.reference(cfg).Odometry.check(cfg["params"])


def test_program_configuration_equals_the_files(manifest):
    bench = harness.Bench(ROOT)
    for c in manifest["configs"]:
        harness.program_config(bench.config(c["name"]))


def test_a_disagreeing_file_is_refused(manifest):
    bench = harness.Bench(ROOT)
    cfg = bench.config(manifest["configs"][0]["name"])
    cfg["params"]["feature"]["max_cells"] += 1
    with pytest.raises(ValueError, match="max_cells"):
        harness.program_config(cfg)
