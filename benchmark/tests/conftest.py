"""Fixtures of the benchmark's own CPU tests: a tiny benchmark root (the
synthetic sensor, 4 lanes, a 96-frame lap: a keyframe every other frame)
beside the real one, run with the
program's plain CPU paths.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import math
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CELLS = {"tiny4": ("tiny", "CFEAR-3", {}),
              "tiny50x4": ("tiny50", "CFEAR-3-s50",
                           {"odometry": {"submap_scan_size": 8}})}


def _plain(tree):
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, float) and math.isinf(tree):
        return "inf"
    return tree


def make_root(path, extra_cells=(), reference=None):
    """A benchmark root at `path`: the real metric readers and the tiny
    configurations, traffic and limits; every tiny cell reports every
    end-to-end and every per-layer metric. With `reference` (file name, text),
    every tiny configuration names that file as its reference, and the text
    is written there (no file where the text is None)."""
    from cfear_radarodometry_code_public_tpu_torch import config
    bench = os.path.join(path, "benchmark")
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(bench, sub), exist_ok=True)
    shutil.copytree(os.path.join(ROOT, "benchmark", "metrics"),
                    os.path.join(bench, "metrics"), dirs_exist_ok=True)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["configs"], manifest["workloads"] = [], []
    cells = list(TINY_CELLS)
    for cell, (cname, preset, extra) in TINY_CELLS.items():
        over = {"feature": {"max_cells": 512}, "filter": {"k_strongest": 12},
                **extra}
        d = config.preset(preset, dataset="synthetic").to_dict()
        for g, v in over.items():
            d[g].update(v)
        doc = {"name": cname, "program": {"preset": preset,
                                          "dataset": "synthetic",
                                          "overrides": over},
               "params": _plain(d)}
        if reference is not None:
            doc["reference"] = reference[0]
        with open(os.path.join(bench, "configs", f"{cname}.json"), "w") as f:
            json.dump(doc, f)
        manifest["configs"].append({"name": cname, "source": "test",
                                    "file": f"benchmark/configs/{cname}.json",
                                    "reduced": [], "why": "test"})
        manifest["workloads"].append({"name": cell, "config": cname,
                                      "traffic": "tiny-loop", "chips": 1,
                                      "why": "test"})
        with open(os.path.join(bench, "limits", f"{cell}.json"), "w") as f:
            json.dump({"pose_gap_p90_m": 0.005, "pose_gap_p99_m": 0.012,
                       "yaw_gap_p95_rad": 0.0005}, f)
    with open(os.path.join(ROOT, "benchmark", "traffic",
                           "fleet32-loop.json")) as f:
        traffic = json.load(f)
    traffic.update(name="tiny-loop", lanes=4, traversals=2, lap_frames=96,
                   phase_step=4, chunk=4, ramp_frames=4, warmup_chunks=5,
                   trace_chunks=1, check_frames=12)
    with open(os.path.join(bench, "traffic", "tiny-loop.json"), "w") as f:
        json.dump(traffic, f)
    for m in manifest["per_layer"]:
        m["workloads"] = cells + list(extra_cells)
    for m in manifest["end_to_end"]:
        m.pop("workloads", None)
    if reference is not None and reference[1] is not None:
        with open(os.path.join(bench, reference[0]), "w") as f:
            f.write(reference[1])
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return path


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    import torch
    torch.set_num_threads(4)
    return make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture(scope="session")
def tiny_run(tiny_root):
    """One sound untraced run of `tiny4`, with its kept outputs."""
    from benchmark import harness
    keep = {}
    res = harness.run_cell("tiny4", 2**31 + 9, 2.0, False, "cpu",
                           root=tiny_root, keep=keep, log=lambda m: None)
    return res, keep


@pytest.fixture
def reference_root(tmp_path):
    """make_root(reference=(name, text)) in a fresh folder: a tiny root
    whose configurations name `name` as their reference."""
    import torch
    torch.set_num_threads(4)
    return lambda name, text: make_root(str(tmp_path / "root"),
                                        reference=(name, text))
