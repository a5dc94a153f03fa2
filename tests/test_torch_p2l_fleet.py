"""The port's batched point-to-line registration against the benchmark's
plain point-to-line reference (`benchmark/reference_p2l.py`), on the cells
of seeded sweeps of a counter-clockwise sensor.

Four lanes, each a window of three keyframes and a source frame rendered
along its own stretch of road (`benchmark/synthetic.py`, the synthetic
sensor spinning counter-clockwise, CFEAR-2 at k=12 and 512 cells). The cells
come from the reference's plain feature stage after its counter-clockwise
motion compensation, and both registrations are given the same cells, so
the comparison holds the association, the P2L rows, the LM and the outer
loop (`registration.register` at B=4, S=3) to the reference's.

Tolerance: position within 2e-3 m and heading within 1e-4 rad of the
reference, lane by lane. Both stop where the outer loop's relative cost
change falls under 1e-5 or the LM's under 1e-4, and the P2L cost is flat
along the walls of these cells, so two sound solves of it stop apart: the
port run in float64 on the same cells lies up to 2.5e-4 m and 1.4e-5 rad
from the reference with every association and outer iteration equal, and
the port in float32, whose dense |s|^2 + |t|^2 - 2 s.t form cannot resolve
a pair within ~5e-4 m^2 of the radius gate at 40-80 m (so a lane may keep
two pairs more), up to 9.0e-4 m and 4.4e-5 rad (12 guesses x 4 lanes).
Association counts within two of each other, success flags exact. Solving
the P2P cost on the same associations (a planted fault) moves every lane
by 1.3e-3 m or more, and the farthest lane of every guess by 1.6e-2 m and
4e-4 rad or more.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import reference, reference_p2l, synthetic
from cfear_radarodometry_code_public_tpu_torch import config
from cfear_radarodometry_code_public_tpu_torch.ops import lm
from cfear_radarodometry_code_public_tpu_torch.ops import registration as treg
from cfear_radarodometry_code_public_tpu_torch.ops.features import CellMap
from cfear_radarodometry_code_public_tpu_torch.utils import se2

LANES, WINDOW = 4, 3
POSE_TOL_M, YAW_TOL_RAD = 2e-3, 1e-4
# the frame-to-frame motion: 1.5 m and 3.4 degrees a frame
MOTION = np.array([1.5, 0.0, math.radians(3.36)])


def _cfg():
    cfg = config.preset("CFEAR-2", dataset="synthetic")
    return cfg.replace(
        radar=dataclasses.replace(cfg.radar, ccw=True),
        filter=dataclasses.replace(cfg.filter, k_strongest=12),
        feature=dataclasses.replace(cfg.feature, max_cells=512))


def _compose(a, b):
    c, s = math.cos(a[2]), math.sin(a[2])
    return np.array([a[0] + c * b[0] - s * b[1],
                     a[1] + s * b[0] + c * b[1], a[2] + b[2]])


def _relative(a, b):
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    dx, dy = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    return np.stack([c * dx + s * dy, -s * dx + c * dy, b[..., 2] - a[..., 2]],
                    -1)


@pytest.fixture(scope="module")
def problem():
    """(cfg, params, keyframe cells, keyframe poses in the anchor frame,
    source cells, true source pose in the anchor frame), every lane's
    newest keyframe its anchor."""
    torch.set_num_threads(4)
    cfg = _cfg()
    params = cfg.to_dict()
    world = synthetic.make_world(np.random.default_rng([1, 0]))
    sensor = SimpleNamespace(radar=cfg.radar)
    images, poses = [], []
    for lane in range(LANES):
        pose = np.array([10.0 * lane - 15.0, 5.0 * lane - 8.0, 0.3 * lane])
        for f in range(WINDOW + 1):
            images.append(synthetic.render_polar(
                world, pose, sensor, np.random.default_rng([7, lane, f]),
                motion=MOTION))
            poses.append(pose)
            pose = _compose(pose, MOTION)
    xy, inten, valid = reference.points(torch.as_tensor(np.stack(images)),
                                        params)
    motion = torch.as_tensor(np.tile(MOTION, (len(images), 1)),
                             dtype=torch.float32)
    xy = reference.compensate(xy, motion, True)
    cells = {k: v.reshape((LANES, WINDOW + 1) + v.shape[1:])
             for k, v in reference.cells(xy, inten, valid, params).items()}
    poses = np.stack(poses).reshape(LANES, WINDOW + 1, 3)
    anchor = poses[:, WINDOW - 1]
    kf = {k: v[:, :WINDOW] for k, v in cells.items()}
    src = {k: v[:, WINDOW] for k, v in cells.items()}
    kf_pose = _relative(anchor[:, None], poses[:, :WINDOW])
    true = _relative(anchor, poses[:, WINDOW])
    return cfg, params, kf, kf_pose, src, true


def _cellmap(d):
    return CellMap(d["mean"], d["normal"],
                   torch.zeros(d["mean"].shape + (2,)), d["nsamples"],
                   d["planarity"], d["valid"])


def _both(problem, offset):
    """The port's registration and the reference's from the true pose
    moved by `offset`: (port result, reference (pose, success, n_assoc,
    iterations))."""
    cfg, params, kf, kf_pose, src, true = problem
    guess = true + np.asarray(offset)
    kf_valid = torch.ones(LANES, WINDOW, dtype=torch.bool)
    ref = reference_p2l.Registration(params)(
        kf, torch.as_tensor(kf_pose), kf_valid, src, torch.as_tensor(guess))
    port = treg.register(_cellmap(kf),
                         torch.as_tensor(kf_pose, dtype=torch.float32),
                         kf_valid, _cellmap(src),
                         torch.as_tensor(guess, dtype=torch.float32), cfg=cfg)
    return port, ref


def _gaps(port_pose, ref_pose):
    d = port_pose.double() - ref_pose
    return torch.hypot(d[:, 0], d[:, 1]), reference.wrap(d[:, 2]).abs()


@pytest.mark.parametrize("offset", [(0.15, -0.1, 0.01), (0.3, 0.2, -0.02),
                                    (-0.2, 0.1, 0.015)])
def test_batched_p2l_register_matches_the_reference(problem, offset):
    port, (pose, success, n_assoc, _) = _both(problem, offset)
    gap_m, gap_rad = _gaps(port.pose, pose)
    assert bool((gap_m <= POSE_TOL_M).all()), gap_m
    assert bool((gap_rad <= YAW_TOL_RAD).all()), gap_rad
    assert torch.equal(port.success, success)
    assert bool(success.all())
    assert bool(((port.num_assoc.long() - n_assoc).abs() <= 2).all()), (
        port.num_assoc, n_assoc)
    # registration recovers the true pose to within the cells' own noise
    true = torch.as_tensor(problem[5])
    assert bool((_gaps(port.pose, true)[0] < 0.05).all())


def test_p2p_rows_under_the_p2l_configuration_fail(problem, monkeypatch):
    """A planted fault: the LM is handed P2P rows (identity sqrt-information
    in place of the target normal) and solves the P2P cost, while the
    configuration says P2L."""
    cfg = problem[0]
    p2p = cfg.replace(registration=dataclasses.replace(cfg.registration,
                                                       cost="P2P"))
    pack, solve = lm.pack_associations, lm.lm_solve_packed
    monkeypatch.setattr(lm, "pack_associations",
                        lambda s, t, w, c: pack(s, t, w, p2p))
    monkeypatch.setattr(lm, "lm_solve_packed",
                        lambda rows, pose, c: solve(rows, pose, p2p))
    port, (pose, *_) = _both(problem, (0.15, -0.1, 0.01))
    gap_m, gap_rad = _gaps(port.pose, pose)
    assert float(gap_m.max()) > 5 * POSE_TOL_M, gap_m
    assert float(gap_rad.max()) > 2 * YAW_TOL_RAD, gap_rad


def test_counter_clockwise_compensation_matches_the_reference(problem):
    """The port's compensation of a counter-clockwise sweep
    (`se2.compensate_points` with ccw) equals the reference's, to float32
    rounding; clockwise differs."""
    params = problem[1]
    img = torch.as_tensor(synthetic.render_polar(
        synthetic.make_world(np.random.default_rng([1, 0])),
        np.zeros(3), SimpleNamespace(radar=problem[0].radar),
        np.random.default_rng(3), motion=MOTION))[None]
    xy, _, valid = reference.points(img, params)
    tmot = torch.as_tensor(MOTION, dtype=torch.float32)[None]
    ref = reference.compensate(xy, tmot, True)[valid]
    port = se2.compensate_points(xy, tmot, True)[valid]
    torch.testing.assert_close(port, ref, atol=1e-4, rtol=1e-6)
    cw = se2.compensate_points(xy, tmot, False)[valid]
    assert float((cw - ref).abs().max()) > 0.5
