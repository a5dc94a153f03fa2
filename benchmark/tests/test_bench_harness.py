"""The harness end to end at a tiny size on the CPU (the program's plain
twins), and its refusal to measure without a card."""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np

from benchmark import harness, traffic_gen


def test_a_sound_run_is_correct(tiny_run):
    res, keep = tiny_run
    assert res["correct"], res["check"]
    assert set(res["metrics"]) == {"frames_per_s", "setup_s",
                                   "memory_peak_gib"}
    assert res["metrics"]["frames_per_s"]["value"] > 0
    assert res["attempted"] == 4 * (keep["prog"]["pose"].shape[1]
                                    - keep["first_step"])
    assert list(res)[-1] == "check"
    for v in res["check"].values():
        assert 0 <= v["value"] <= v["limit"]
    # every lane is compared, and the keyframe gate both fuses and holds
    assert keep["lanes"] == [0, 1, 2, 3]
    fused = keep["ref"]["fused"][:, keep["checked"]]
    assert 0 < fused.mean() < 1


def test_the_reference_registers_what_the_program_does(tiny_run):
    _, keep = tiny_run
    f = keep["first_step"]
    prog, ref = keep["prog"], keep["ref"]
    rows = keep["lanes"]
    c = keep["checked"]
    window = prog["pose"].shape[1] - f
    assert len(c) == min(12, window) and c.min() >= f
    assert (prog["fused"][rows][:, c] == ref["fused"][:, c]).all()
    assert (ref["n_points"][:, c] >= ref["n_cells"][:, c]).all()
    assert (prog["n_cells"][rows][:, c] == ref["n_cells"][:, c]).mean() > 0.9
    gap_m, gap_rad = harness.gaps(ref, prog, rows, c)
    assert np.median(gap_m) < 2e-3 and np.median(gap_rad) < 1e-4


def test_a_traced_run_reads_its_metrics(tiny_root):
    res = harness.run_cell("tiny50x4", 2**31 + 3, 1.0, True, "cpu",
                           root=tiny_root, log=lambda m: None)
    assert res["correct"]
    # the CPU has no device trace: every device metric is left out, and
    # the untraced window's rate (a host-clock metric) is read
    assert set(res["metrics"]) == {"frames_per_s.host_paced"}
    assert res["metrics"]["frames_per_s.host_paced"]["value"] > 0
    assert res["trace"]["window_s"] > 0 and res["trace"]["busy_s"] == 0
    assert res["breakdown"]["device_ops"] == []


def test_a_traced_run_measures_the_window_a_reader_asks_for(tiny_root):
    keep = {}
    res = harness.run_cell("tiny4", 2**31 + 22, 1.0, True, "cpu",
                           root=tiny_root, keep=keep, log=lambda m: None)
    assert res["correct"]
    tr, w = keep["traffic"], keep["window"]
    traced = tr["trace_chunks"] * tr["chunk"]
    steps = keep["prog"]["pose"].shape[1]
    # the untraced window runs first, then the traced chunks
    assert keep["first_traced"] == steps - traced > keep["first_step"]
    assert w["frames"] == (keep["first_traced"] - keep["first_step"]) \
        * tr["lanes"] and w["seconds"] >= 1.0
    assert res["metrics"]["frames_per_s.host_paced"]["value"] \
        == w["frames"] / w["seconds"]
    assert res["attempted"] == tr["lanes"] * (steps - keep["first_step"])


def test_a_cell_reports_what_the_manifest_lists_for_it(tiny_root, tmp_path):
    root = str(tmp_path / "root")
    shutil.copytree(tiny_root, root)
    path = os.path.join(root, "BENCHMARK.json")
    m = json.load(open(path))
    for e in m["end_to_end"]:
        if e["name"] == "frames_per_s":
            e["workloads"] = ["tiny50x4"]
    for x in m["per_layer"]:
        x["workloads"] = ["tiny4" if x["moves"] != "frames_per_s"
                          else "tiny50x4"]
    json.dump(m, open(path, "w"))
    res = harness.run_cell("tiny4", 2**31 + 23, 1.0, False, "cpu",
                           root=root, log=lambda msg: None)
    assert res["correct"]
    assert set(res["metrics"]) == {"setup_s", "memory_peak_gib"}
    # no reader of this cell asks for the window: only the traced chunks run
    keep = {}
    res = harness.run_cell("tiny50x4", 2**31 + 24, 1.0, True, "cpu",
                           root=root, keep=keep, log=lambda msg: None)
    assert res["correct"] and res["metrics"] == {}
    assert keep["window"] is None
    assert keep["first_traced"] == keep["first_step"] == keep["prog"][
        "pose"].shape[1] - keep["traffic"]["trace_chunks"] \
        * keep["traffic"]["chunk"]


def test_seeds_decide_the_traffic(tiny_root):
    bench = harness.Bench(tiny_root)
    params = bench.config("tiny")["params"]
    tr = dict(bench.traffic("tiny-loop"), lap_frames=8)
    a = traffic_gen.Traffic(tr, params, 2**33 + 1)
    b = traffic_gen.Traffic(tr, params, 2**33 + 1)
    c = traffic_gen.Traffic(tr, params, 2**33 + 2)
    assert np.array_equal(a.lap_sweeps, b.lap_sweeps)
    assert a.world["seg_p0"].tolist() == c.world["seg_p0"].tolist()
    assert np.array_equal(a.ramp_sweeps, b.ramp_sweeps)
    assert not np.array_equal(a.lap_sweeps, c.lap_sweeps)
    assert traffic_gen.Traffic(tr, params, -3).lap_sweeps.shape \
        == a.lap_sweeps.shape


def test_chunks_follow_the_drives(tiny_root):
    bench = harness.Bench(tiny_root)
    tr = dict(bench.traffic("tiny-loop"), lap_frames=8)
    d = traffic_gen.Traffic(tr, bench.config("tiny")["params"], 1)
    arrays = d.chunks()
    assert len(arrays) == (d.ramp + d.lap) // d.chunk
    steps = d.ramp + 3 * d.lap
    for lane in range(len(d.lanes)):
        drive = np.concatenate([arrays[d.drive_chunk(k)][lane]
                                for k in range(steps // d.chunk)])
        want = np.stack([d.frames([lane], t)[0] for t in range(steps)])
        assert np.array_equal(drive, want)


def test_the_drive_starts_at_rest_and_joins_the_lap():
    d = object.__new__(traffic_gen.Traffic)
    d.t = {"speed_m_s": 5.0}
    d.lap, d.ramp, d.dt = 128, 16, 0.25
    d.lanes = [(0, 0), (1, 16)]
    d.radius = 128 * 5.0 * 0.25 / (2 * math.pi)
    for lane in range(2):
        p = [d.pose(lane, t) for t in range(d.ramp + 3)]
        step = [math.hypot(*(p[t + 1] - p[t])[:2]) for t in range(len(p) - 1)]
        assert step[0] < 0.05 and step[-1] > 1.24
        assert all(b >= a for a, b in zip(step, step[1:]))
        assert np.allclose(p[d.ramp], d.lap_pose(d.lanes[lane][1]))
    # the lap is periodic: a lap on from any frame is the same place
    assert np.allclose(d.lap_pose(128)[:2], d.lap_pose(0)[:2], atol=1e-9)
    assert math.isclose(math.hypot(*d.lap_motion()[:2]), 1.2495,
                        rel_tol=1e-3)


def test_without_a_card_nothing_is_measured(tmp_path):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cfear3-oxford32",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "never falls back" in out.stderr
    # a directory holding only the manifest and the benchmark's files
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "s50-oxford32",
         "--seed", "1", "--seconds", "1", "--trace", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_result_line_ends_with_the_check(capsys):
    res = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
           "device": {}, "check": {"pose_gap_p90_m": {"value": 1e-4,
                                                      "limit": 1e-3},
                                   "fused_differ": {"value": 0,
                                                    "limit": 0}}}
    harness.emit(dict(res))
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "check"
    assert err.strip().splitlines()[-1].startswith("check fused_differ")
