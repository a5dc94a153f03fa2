"""The rooflines' work counts against a hand count, the frozen bound
arithmetic, and the reference's TF32 rounding."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import reference, roofline, work


def test_bound_arithmetic():
    b = roofline.bound(3.35e9, 0.0)
    assert math.isclose(b["bound_ms"], 1.0) and b["bound_by"] == "bytes"
    b = roofline.bound(0.0, 67e9)
    assert math.isclose(b["bound_ms"], 1.0) and b["bound_by"] == "operations"


def test_assoc_work_by_hand():
    # 3 valid source cells against 2 keyframes holding 4 and 5 valid cells
    w = roofline.assoc_work(3, 9, 2)
    assert w == {"distances": 27, "bytes": 3 * 8 + 9 * 9 + 2 * 3 * 8}
    b = roofline.assoc_bound([w, w])
    assert b["distances"] == 54
    assert math.isclose(b["bound_ms"], max(2 * w["bytes"] / 3.35e9,
                                           5 * 54 / 67e9))
    assert roofline.lm_bound(1000)["bound_ms"] == 1000 * 32 / 3.35e9


class _Line:
    """A drive of three frames on a line 2 m apart, for a hand count."""

    lanes = [(0, 0)]

    def __init__(self, frames):
        self.cells = frames

    def pose(self, lane, t):
        return np.array([2.0 * t, 0.0, 0.0])

    def key(self, lane, t):
        return ("lap", 0, t)


def test_counts_by_hand(monkeypatch):
    params = {"odometry": {"submap_scan_size": 2, "keyframe_min_dist": 1.5,
                           "keyframe_min_rot_deg": 5.0},
              "registration": {"angle_outlier_deg": 30.0,
                               "assoc_radius": 1.0}}
    up = [[0.0, 1.0]] * 4

    def cells(xy, valid):
        return {"mean": torch.tensor(xy, dtype=torch.float32),
                "normal": torch.tensor(up, dtype=torch.float32),
                "nsamples": torch.full((4,), 8.0),
                "planarity": torch.ones(4), "valid": torch.tensor(valid)}

    frames = {("lap", 0, 0): cells([[0, 5], [1, 5], [10, 5], [3, 3]],
                                   [True, True, True, False]),
              ("lap", 0, 1): cells([[-2, 5], [-1.2, 5], [8, 5], [0, 0]],
                                   [True, True, True, True]),
              ("lap", 0, 2): cells([[-4, 5.5], [-3, 5], [6, 5], [0, 9]],
                                   [True, True, True, False])}
    monkeypatch.setattr(work, "frame_cells",
                        lambda ref, drive, keys, p, dev: frames)
    got = work.counts(reference, _Line(frames), 2, 1, params, "cpu")
    # step 2 (frame 2) against the window of frames 0 and 1, each gated
    # as a keyframe (2 m apart)
    assert got["n_src"][0, 0] == 3 and got["n_kf"][0, 0] == 2
    assert got["n_tar"][0, 0] == 3 + 4
    # by hand, in the world frame: frame 2's valid cells sit at x = 0, 1,
    # 10 (y 5.5, 5, 5); frame 0's at 0, 1, 10 (y 5), frame 1's at 0, 0.8,
    # 10 (y 5) and 2 (y 0). Nearest per keyframe and source cell:
    # kf 0: 0.5, 0, 0; kf 1: 0.5, 0.2, 0 -> all six under 1 m
    assert got["assoc"][0, 0] == 6 and got["assoc_first"][0, 0] == 6
    src = np.array([[0, 5.5], [1, 5], [10, 5]])
    tar0 = np.array([[0, 5], [1, 5], [10, 5]])
    tar1 = np.array([[0, 5], [0.8, 5], [10, 5], [2, 0]])
    d0 = np.sqrt(((src[:, None] - tar0[None]) ** 2).sum(-1)).min(1)
    d1 = np.sqrt(((src[:, None] - tar1[None]) ** 2).sum(-1)).min(1)
    assert ((d0 < 1).sum() + (d1 < 1).sum()) == got["assoc"][0, 0]


class _Loop:
    """The fleet's route without its sweeps."""

    lanes = [(0, 16)]

    def __init__(self):
        from benchmark import traffic_gen
        self.d = object.__new__(traffic_gen.Traffic)
        self.d.t = {"speed_m_s": 5.0}
        self.d.lap, self.d.ramp, self.d.dt = 128, 16, 0.25
        self.d.lanes = self.lanes
        self.d.radius = 128 * 5.0 * 0.25 / (2 * math.pi)

    def pose(self, lane, t):
        return self.d.pose(lane, t)


def test_keyframe_replay_on_the_route():
    params = {"odometry": {"submap_scan_size": 4, "keyframe_min_dist": 1.5,
                           "keyframe_min_rot_deg": 5.0}}
    steps = work.keyframe_windows(_Loop(), 0, 300, params)
    assert steps[0] == [] and steps[1] == [0]
    # past the ramp, 1.25 m and 2.8 degrees a frame: a keyframe every
    # second frame
    assert list(np.diff(steps[299])) == [2, 2, 2]
    assert steps[299][-1] in (297, 298)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -22500.3, 3.0e-8], dtype=torch.float32)
    y = reference.tf32(x.clone())
    assert y[0] == 1.0 and y[1] == 1.0 + 2 ** -10
    assert y[2] == 1.0                       # a tie goes to even
    assert y[3] == 1.0 + 2 ** -9             # a tie goes to even
    assert torch.all((y - x).abs() <= x.abs() * 2 ** -11)
    assert torch.equal(reference.tf32(y.clone()), y)
