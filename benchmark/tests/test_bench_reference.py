"""A configuration may name its own plain reference, which then decides the
check and gives the work counts; a reference refuses, by key and before
anything is rendered, what it does not implement."""

from __future__ import annotations

import os

import numpy as np
import pytest

from benchmark import harness, reference, traffic_gen, work

SEED = 2**31 + 9
TEXT = open(reference.__file__).read()
# a reference that replaces only what differs, here a planted fault: every
# pose it registers moved by 0.5 m
MOVED = """from benchmark import reference as base
from benchmark.reference import *  # noqa: F401,F403


class Registration(base.Registration):
    def __call__(self, *args):
        pose, ok, n_assoc, iters = super().__call__(*args)
        return pose + pose.new_tensor([0.5, 0.0, 0.0]), ok, n_assoc, iters


class Odometry(base.Odometry):
    registration = Registration
"""
NO_ODOMETRY = ("from benchmark.reference import (points, compensate, cells, "
               "transform,\n    rotate, nearest)  # noqa: F401\n")
NO_CHECK = NO_ODOMETRY + """

class Odometry:
    def step(self, images, given=None, register=True):
        pass
"""
MISSING = object()
# the values that the reference does not implement, the refusals it made
# before `Odometry.check` held them all, and a key unknown or missing
REFUSED = [("filter.method", "cacfar"), ("filter.z_min_quantile", 0.98),
           ("registration.weight_opt", "Sim_N"),
           ("feature.use_raw_pointcloud", True),
           ("feature.point_budget", 8192),
           ("registration.assoc_method", "grid"),
           ("registration.cost", "P2L"), ("registration.max_score", 1.0),
           ("odometry.use_keyframe", False), ("odometry.use_guess", False),
           ("odometry.health_check_every", 8),
           ("odometry.estimate_cov_by_sampling", True),
           ("registration.time_continuous", True),
           ("registration.max_active_keyframes", 16),
           ("registration.loss", "Tukey"), ("feature.backend", "pallas"),
           ("registration.soft_constraint", True),
           ("registration.disable_registration", True),
           ("feature.new_key", 1), ("odometry.submap_scan_size", MISSING)]


def _no_render(monkeypatch):
    def render(*args, **kwargs):
        raise AssertionError("rendered before the reference was settled")
    monkeypatch.setattr(traffic_gen, "Traffic", render)


def _run(root, trace=False, keep=None):
    return harness.run_cell("tiny4", SEED, 1.0, trace, "cpu", root=root,
                            keep=keep, log=lambda m: None)


def test_without_the_key_a_run_takes_reference_py(tiny_run):
    _, keep = tiny_run
    assert keep["reference"] is reference


def test_a_named_copy_gives_the_same_check(reference_root):
    root = reference_root("reference_copy.py", TEXT)
    keep = {}
    res = _run(root, keep=keep)
    assert os.path.samefile(keep["reference"].__file__, os.path.join(
        root, "benchmark", "reference_copy.py"))
    assert res["correct"], res["check"]
    lanes, checked = keep["lanes"], keep["checked"]
    ref = harness.run_reference(
        reference, keep["params"], keep["drive"], lanes,
        keep["prog"]["pose"].shape[1], "cpu", follow=keep["prog"],
        rows=lanes, checked=checked)
    for k, v in ref.items():
        np.testing.assert_array_equal(v, keep["ref"][k], err_msg=k)
    check = harness.compare(ref, keep["prog"], lanes, checked,
                            keep["limits"])
    assert check == {k: v for k, v in res["check"].items()
                     if k != "kf_slots_empty"}


def test_the_named_reference_decides_correct(reference_root, monkeypatch):
    root = reference_root("reference_moved.py", MOVED)
    seen, counts = [], work.counts
    monkeypatch.setattr(work, "counts",
                        lambda ref, *a: seen.append(ref) or counts(ref, *a))
    res = _run(root, trace=True)
    assert not res["correct"]
    assert res["check"]["pose_gap_p90_m"]["value"] > 0.49
    assert [os.path.basename(m.__file__) for m in seen] \
        == ["reference_moved.py"]


@pytest.mark.parametrize("name, text, part", [
    ("gone.py", None, "no file"),
    ("no_odometry.py", NO_ODOMETRY, "lacks Odometry"),
    ("no_check.py", NO_CHECK, "lacks Odometry.check")],
    ids=["missing", "without_odometry", "without_check"])
def test_a_reference_that_cannot_serve_is_refused(reference_root, monkeypatch,
                                                  name, text, part):
    root = reference_root(name, text)
    _no_render(monkeypatch)
    with pytest.raises(ValueError) as err:
        _run(root)
    assert name in str(err.value) and part in str(err.value)


@pytest.mark.parametrize("key, value", REFUSED, ids=[k for k, _ in REFUSED])
def test_a_value_not_implemented_is_refused(tiny_root, monkeypatch, key,
                                            value):
    config = harness.Bench.config
    group, name = key.split(".")

    def changed(self, cname):
        cfg = config(self, cname)
        if value is MISSING:
            del cfg["params"][group][name]
        else:
            cfg["params"][group][name] = value
        return cfg

    monkeypatch.setattr(harness.Bench, "config", changed)
    _no_render(monkeypatch)
    with pytest.raises(ValueError, match="the reference refuses") as err:
        _run(tiny_root)
    assert key in str(err.value)
    params = changed(harness.Bench(tiny_root), "tiny")["params"]
    with pytest.raises(ValueError, match="the reference refuses") as err:
        reference.Odometry(params, 1, "cpu")
    assert key in str(err.value)
