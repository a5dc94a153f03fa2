"""The point-to-line configuration through the benchmark as new files alone:
a tiny CFEAR-2 configuration (the synthetic sensor spinning
counter-clockwise, k=12, 512 cells) naming `reference_p2l.py`, and its cell,
added to a copy of the tiny root. A sound run is correct; every planted
fault of `test_bench_faults.py` and the TF32 control are not; the
point-to-line reference takes the P2L cost alone."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from benchmark import harness, reference
from test_bench_faults import (answer_altered, gate_always_fuses,
                               half_batch_mean, state_unchanged)

SEED = 2**31 + 9
CELL = "tiny-p2l4"
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def p2l_root(tiny_root, tmp_path_factory):
    from cfear_radarodometry_code_public_tpu_torch import config
    root = str(tmp_path_factory.mktemp("p2l") / "root")
    shutil.copytree(tiny_root, root)
    bench = os.path.join(root, "benchmark")
    shutil.copy(os.path.join(HERE, "reference_p2l.py"), bench)
    over = {"radar": {"ccw": True}, "filter": {"k_strongest": 12},
            "feature": {"max_cells": 512}}
    d = config.preset("CFEAR-2", dataset="synthetic").to_dict()
    for g, v in over.items():
        d[g].update(v)
    d["registration"]["max_score"] = "inf"
    doc = {"name": "tiny-p2l", "reference": "reference_p2l.py",
           "program": {"preset": "CFEAR-2", "dataset": "synthetic",
                       "overrides": over},
           "params": d}
    with open(os.path.join(bench, "configs", "tiny-p2l.json"), "w") as f:
        json.dump(doc, f)
    with open(os.path.join(bench, "limits", f"{CELL}.json"), "w") as f:
        json.dump({"pose_gap_p90_m": 0.005, "pose_gap_p99_m": 0.012,
                   "yaw_gap_p95_rad": 0.0005}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["configs"].append({"name": "tiny-p2l", "source": "test",
                         "file": "benchmark/configs/tiny-p2l.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": CELL, "config": "tiny-p2l",
                           "traffic": "tiny-loop", "chips": 1, "why": "test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    return root


@pytest.fixture(scope="module")
def sound(p2l_root):
    keep = {}
    res = harness.run_cell(CELL, SEED, 1.0, False, "cpu", root=p2l_root,
                           keep=keep, log=lambda m: None)
    return res, keep


def test_a_sound_run_is_correct(sound):
    res, keep = sound
    assert res["correct"], res["check"]
    assert keep["reference"].Odometry.PARAMS["registration.cost"][0] == \
        ("P2L",)
    assert keep["params"]["radar"]["ccw"] is True
    assert keep["params"]["registration"]["cost"] == "P2L"
    assert res["check"]["fused_differ"]["value"] == 0
    assert res["check"]["kf_slots_empty"]["value"] == 0


@pytest.mark.parametrize("fault", [state_unchanged, half_batch_mean,
                                   answer_altered, gate_always_fuses])
def test_a_broken_step_is_not_correct(p2l_root, fault):
    res = harness.run_cell(CELL, SEED, 1.0, False, "cpu", root=p2l_root,
                           fault=fault, log=lambda m: None)
    assert not res["correct"], res["check"]
    assert any(v["value"] > v["limit"] for v in res["check"].values())


def test_the_tf32_control_is_not_correct(sound):
    res, keep = sound
    steps = keep["prog"]["pose"].shape[1]
    args = (keep["reference"], keep["params"], keep["drive"], keep["lanes"],
            steps, "cpu")
    ctl = harness.run_reference(*args, precision="tf32")
    rows = list(range(len(keep["lanes"])))
    ref = harness.run_reference(*args, follow=ctl, rows=rows,
                                checked=keep["checked"])
    check = harness.compare(ref, ctl, rows, keep["checked"], keep["limits"])
    assert any(v["value"] > v["limit"] for v in check.values()), check
    for k in ("pose_gap_p90_m", "pose_gap_p99_m"):
        assert check[k]["value"] >= 3 * res["check"][k]["value"], k


def test_the_p2l_reference_takes_the_p2l_cost_alone(p2l_root):
    cfg = harness.Bench(p2l_root).config("tiny-p2l")
    mod = harness.Bench(p2l_root).reference(cfg)
    params = cfg["params"]
    mod.Odometry.check(params)
    p2p = {**params, "registration": {**params["registration"],
                                      "cost": "P2P"}}
    with pytest.raises(ValueError, match="registration.cost = 'P2P'"):
        mod.Odometry.check(p2p)
    reference.Odometry.check(p2p)
    with pytest.raises(ValueError, match="registration.cost = 'P2L'"):
        reference.Odometry.check(params)
    # every other key is `reference.py`'s
    assert {k: v for k, v in mod.PARAMS.items()
            if k != "registration.cost"} == \
        {k: v for k, v in reference.PARAMS.items() if k != "registration.cost"}
