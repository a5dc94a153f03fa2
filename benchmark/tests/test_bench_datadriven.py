"""A configuration, a traffic mix and a per-layer metric are added as new
files and entries alone: no file of the benchmark is edited."""

from __future__ import annotations

import hashlib
import json
import os

from benchmark import harness

NEW_METRIC = '''"""Kernel launches of the whole traced window, a test metric."""

UNIT = "launches"
LAYER = "batched step and host dispatch (models/odometry.py)"
MOVES = "frames_per_s"
SOURCE = "device_trace"


def read(ctx):
    return float(ctx.steps) + 0.5
'''


def _digests(root):
    out = {}
    for base, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            p = os.path.join(base, f)
            out[p] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_new_files_make_a_new_cell_and_metric(tiny_root, tmp_path):
    import shutil
    root = str(tmp_path / "root")
    shutil.copytree(tiny_root, root)
    before = _digests(root)
    bench = os.path.join(root, "benchmark")
    # a configuration: the tiny one with another cell budget
    cfg = json.load(open(os.path.join(bench, "configs", "tiny.json")))
    cfg["name"] = "tiny-cells384"
    cfg["program"]["overrides"]["feature"]["max_cells"] = 384
    cfg["params"]["feature"]["max_cells"] = 384
    json.dump(cfg, open(os.path.join(bench, "configs",
                                     "tiny-cells384.json"), "w"))
    # a traffic mix: two lanes a traversal, a slower drive
    tr = json.load(open(os.path.join(bench, "traffic", "tiny-loop.json")))
    tr.update(name="tiny-slow", speed_m_s=4.0, lanes=4, traversals=2)
    json.dump(tr, open(os.path.join(bench, "traffic", "tiny-slow.json"), "w"))
    # a per-layer metric and the new cell's limits
    with open(os.path.join(bench, "metrics", "window_launches.py"), "w") as f:
        f.write(NEW_METRIC)
    json.dump({"pose_gap_p90_m": 0.005, "pose_gap_p99_m": 0.012,
               "yaw_gap_p95_rad": 0.0005},
              open(os.path.join(bench, "limits", "tiny-new.json"), "w"))
    # the manifest gains entries
    m = json.load(open(os.path.join(root, "BENCHMARK.json")))
    m["configs"].append({"name": "tiny-cells384", "source": "test",
                         "file": "benchmark/configs/tiny-cells384.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "tiny-new", "config": "tiny-cells384",
                           "traffic": "tiny-slow", "chips": 1, "why": "test"})
    m["per_layer"].append({"name": "window_launches", "unit": "launches",
                           "better": "lower", "source": "device_trace",
                           "layer": m["per_layer"][1]["layer"],
                           "moves": "frames_per_s",
                           "workloads": ["tiny-new"]})
    json.dump(m, open(os.path.join(root, "BENCHMARK.json"), "w"))
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())

    res = harness.run_cell("tiny-new", 17, 1.0, True, "cpu", root=root,
                           log=lambda msg: None)
    assert res["metrics"] == {"window_launches": {"value": 4.5,
                                                  "unit": "launches"}}
    assert res["correct"]
    keep = {}
    res = harness.run_cell("tiny-new", 18, 1.0, False, "cpu", root=root,
                           keep=keep, log=lambda msg: None)
    assert set(res["metrics"]) == {"frames_per_s", "setup_s",
                                   "memory_peak_gib"}
    assert keep["params"]["feature"]["max_cells"] == 384
    assert keep["traffic"]["speed_m_s"] == 4.0


def test_a_metric_file_that_disagrees_is_refused(tiny_root, tmp_path):
    import shutil
    import pytest
    root = str(tmp_path / "root")
    shutil.copytree(tiny_root, root)
    path = os.path.join(root, "benchmark", "metrics", "launches_per_step.py")
    text = open(path).read().replace('UNIT = "launches/step"',
                                     'UNIT = "launches"')
    open(path, "w").write(text)
    with pytest.raises(ValueError, match="unit"):
        harness.Bench(root).metrics("tiny4", trace=True)
