"""Inputs the main paths rarely give, the port against the reference on the
CPU: a sensor that goes blind (the collapsed reverse solve), a parked
sensor, kernel A's twin without valid targets or source cells, kernel F's
twin on problems with no weight and at zero residual, the pallas feature
backend under voxel overflow; the goldens of the smoke paths that drive
them on the card (`longrun-blind`, `stationary`, `pallas-features-overflow`,
`refine`); and the SLAM pass's loop edges on the card's own odometry
(`golden/card_h100_slam_dropout35_seed9_512.npz`, written on an H100 by
`tools/slam_verify_torch.py --save-odometry`).

Tolerances: poses as tests/test_torch_odometry.py's (2 cm, 2 mrad, 1 cm per
motion: an ulp of sin/cos moves a point across a voxel edge); flags,
counts and indices exactly; kernel F's pose within 1e-4 of the
reference's, its tolerance of the reference's own kernel-vs-XLA test
(`tests/test_registration.py:565-567`), and bit for bit where the solve
must keep its guess.
"""

import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from torch_port_helpers import both_cfgs, jax, jnp, ref, slice_cfg

from cfear_radarodometry_code_public_tpu.datasets import synthetic
from cfear_radarodometry_code_public_tpu.models import odometry as jodo
from cfear_radarodometry_code_public_tpu.ops import pallas_assoc as pa
from cfear_radarodometry_code_public_tpu.ops import pallas_lm
from cfear_radarodometry_code_public_tpu_torch.models import odometry as todo
from cfear_radarodometry_code_public_tpu_torch.ops import cuda_assoc as ca
from cfear_radarodometry_code_public_tpu_torch.ops import cuda_lm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

sys.path.remove(REPO)

POS_TOL, YAW_TOL, MOTION_TOL = 0.02, 2e-3, 0.01
LM_POSE_TOL = 1e-4
OVERFLOW_TOL = 0.062   # m, position and motion under voxel overflow
CARD_ODOMETRY = chip_smoke.CARD_SLAM_DROPOUT
_xla = jax.jit(pallas_lm.lm_solve_packed_xla, static_argnames="cfg")


def _cfg(**odometry):
    """tests/test_odometry.py's `_cfg`: the small synthetic CFEAR-3."""
    cfg = ref.preset("CFEAR-3", dataset="synthetic")
    cfg = cfg.replace(
        feature=dataclasses.replace(cfg.feature, max_cells=512),
        filter=dataclasses.replace(cfg.filter, k_strongest=12))
    if odometry:
        cfg = cfg.replace(odometry=dataclasses.replace(cfg.odometry,
                                                       **odometry))
    return both_cfgs(cfg)


def _motions(traj):
    d = traj[1:] - traj[:-1]
    c, s = np.cos(traj[:-1, 2]), np.sin(traj[:-1, 2])
    return np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]],
                    -1)


def _assert_traj_close(got, want):
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=POS_TOL)
    np.testing.assert_allclose(got[:, 2], want[:, 2], atol=YAW_TOL)
    np.testing.assert_allclose(_motions(got), _motions(want), atol=MOTION_TOL)


def _no_nan(out, traj):
    bad = [k for k, v in out._asdict().items()
           if np.issubdtype(np.asarray(v).dtype, np.floating)
           and np.isnan(v).any()]
    assert not bad and not np.isnan(traj).any(), bad


def test_collapsed_reverse_solve_is_unhealthy_matches_jax():
    """tests/test_odometry.py:253's blind sensor through both packages
    (image ingest, the health check on every frame, frames 8-15 all zero):
    keyframe, success, checked and healthy flags identical, every checked
    blind frame unhealthy on the port's side, the seeing frames' poses
    within the tolerances, no NaN in any output."""
    cfg_j, cfg_t = _cfg(health_check_every=1)
    images, _ = synthetic.make_sequence(seed=3, n_frames=16, cfg=cfg_j)
    images = np.array(images)
    images[8:] = 0
    jr = jodo.OdometryRunner(cfg_j, chunk=8)
    jr.process(images)
    tr = todo.OdometryRunner(cfg_t, chunk=8, device="cpu")
    tr.process(images)
    out, out_j = tr.frame_outputs(), jr.frame_outputs()
    for k in ("fused", "success", "health_checked", "healthy"):
        np.testing.assert_array_equal(getattr(out, k),
                                      np.asarray(getattr(out_j, k)), k)
    checked, healthy = out.health_checked, out.healthy
    assert checked[1:8].all() and healthy[1:8].all()
    assert checked[8:].any() and not healthy[8:][checked[8:]].any()
    assert not out.success[8:].any() and (out.num_cells[8:] == 0).all()
    np.testing.assert_array_equal(out.health_dist[8:], 0.0)
    traj = tr.trajectory()
    _no_nan(out, traj)
    _assert_traj_close(traj[:8], np.asarray(jr.trajectory())[:8])


def test_stationary_sensor_no_keyframes_matches_jax():
    """tests/test_odometry.py:98's parked sensor (one sweep, six times)
    through both packages: only the bootstrap keyframe, every pose within
    0.2 m of the origin, the two trajectories within the tolerances."""
    cfg_j, cfg_t = _cfg()
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    img = synthetic.render_polar(world, np.zeros(3), cfg_j, rng)
    images = np.stack([img] * 6)
    jr = jodo.OdometryRunner(cfg_j, chunk=6)
    jr.process(images)
    tr = todo.OdometryRunner(cfg_t, chunk=6, device="cpu")
    tr.process(images)
    out, traj = tr.frame_outputs(), tr.trajectory()
    np.testing.assert_array_equal(out.fused, np.asarray(jr.frame_outputs().fused))
    assert out.fused.sum() == 1 and out.fused[0] and out.success.all()
    assert np.abs(traj[:, :2]).max() < 0.2
    _no_nan(out, traj)
    _assert_traj_close(traj, np.asarray(jr.trajectory()))


def _lm_case(kind):
    """`chip_smoke.lm_problem`'s rows (B=3, N = 2 x 500, P2P/Huber) made
    degenerate: every weight zero, one non-zero row a lane, or targets
    placed where the guess puts the sources (zero residual)."""
    cfg_t, packed, pose0, _ = chip_smoke.lm_problem(
        np.random.default_rng(3), 3, 2, 500, "P2P", "Huber")
    w = packed[:, 4].copy()
    if kind in ("all weights zero", "one non-zero row"):
        packed[:, 4] = 0.0
    if kind == "one non-zero row":
        for i in range(3):
            k = int(np.flatnonzero(w[i])[i])
            packed[i, 4, k] = w[i, k]
    if kind == "zero residual":
        c, s = np.cos(pose0[:, 2:3]), np.sin(pose0[:, 2:3])
        sx, sy = packed[:, 0], packed[:, 1]
        packed[:, 2] = c * sx - s * sy + pose0[:, :1]
        packed[:, 3] = s * sx + c * sy + pose0[:, 1:2]
    return ref.CFEARConfig.from_dict(cfg_t.to_dict()), cfg_t, packed, pose0


@pytest.mark.parametrize("kind", ["all weights zero", "one non-zero row",
                                  "zero residual"])
def test_lm_twin_on_degenerate_problems_matches_xla(kind):
    """Kernel F's twin, both variants, against the reference's packed-XLA
    solve run op by op (`jax.disable_jit()`), compiled, and its fused
    kernel in interpret mode, lane by lane. No NaN in cost or relative
    decrease on any side. Op by op, the reference takes the twin's steps
    to the twin's pose: with no weight, or at zero residual, none, the
    guess kept bit for bit and cost 0; one row (two residuals for three
    unknowns) is fitted exactly by a line of poses, reached within
    LM_POSE_TOL. The compiled forms contract products into FMAs: at zero
    residual they see a cost of 2e-9-5e-9 and accept a step of 2e-8 m on
    one lane in three, and on one row they take one step more along the
    line (3e-4 m) on two lanes in three; so there they are held to at
    most one step more, a cost under 1e-8 and, with no weight, the guess
    bit for bit."""
    cfg_j, cfg_t, packed, pose0 = _lm_case(kind)
    for ee in (True, False):
        got = cuda_lm.lm_solve_fused(torch.as_tensor(packed),
                                     torch.as_tensor(pose0), cfg_t,
                                     early_exit=ee)
        pose, cost, steps, rel = (a.numpy() for a in got)
        assert not (np.isnan(cost).any() or np.isnan(rel).any()), (cost, rel)
        for i in range(3):
            rows, p0 = jnp.asarray(packed[i]), jnp.asarray(pose0[i])
            with jax.disable_jit():
                p_e, c_e, s_e, r_e = pallas_lm.lm_solve_packed_xla(
                    rows, p0, cfg=cfg_j)
            assert int(s_e) == steps[i] and float(c_e) == cost[i] == 0.0, i
            assert not np.isnan(float(r_e))
            if kind == "one non-zero row":
                np.testing.assert_allclose(pose[i], np.asarray(p_e),
                                           atol=LM_POSE_TOL)
            else:
                assert steps[i] == 0
                np.testing.assert_array_equal(pose[i], pose0[i])
                np.testing.assert_array_equal(np.asarray(p_e), pose0[i])
            for name, (p_j, c_j, s_j, r_j) in (
                    ("xla", _xla(rows, p0, cfg=cfg_j)),
                    ("kernel", pallas_lm.lm_solve_fused(
                        jnp.pad(rows, ((0, 0), (0, 24))), p0, cfg_j,
                        interpret=True, early_exit=ee))):
                assert not np.isnan(float(r_j)), (name, i)
                assert 0.0 <= float(c_j) < 1e-8, (name, i)
                assert 0 <= int(s_j) - steps[i] <= 1, (name, i)
                if kind == "all weights zero":
                    assert int(s_j) == 0 and float(c_j) == 0.0
                    np.testing.assert_array_equal(np.asarray(p_j), pose0[i])


def test_nn_min_twin_without_targets_or_sources_matches_pallas():
    """Kernel A's twin against the reference's kernel A in interpret mode:
    every target invalid (a blind frame's reverse solve: index 0 and +inf
    on every row, on both sides) and a source of no cell (a blind frame's
    forward solve: every row at the frame's origin, the cells' zero mean
    moved by the guess), with a lane axis."""
    rng = np.random.default_rng(5)
    tar = rng.normal(size=(4, 512, 2)).astype(np.float32) * 40
    src = rng.normal(size=(512, 2)).astype(np.float32) * 40
    cases = {"no valid target": (src, tar[:1], np.zeros((1, 512), bool)),
             "no source cell": (np.broadcast_to(np.float32([3.5, -1.25]),
                                                (512, 2)).copy(),
                                tar, rng.random((4, 512)) < 0.8)}
    for name, (s, t, v) in cases.items():
        nn_r, d2_r = pa.nn_min(jnp.asarray(s), jnp.asarray(t),
                               jnp.asarray(v), interpret=True, ts=256)
        nn_t, d2_t = ca.nn_min(*(torch.as_tensor(np.array(a))[None]
                                 for a in (s, t, v)))
        np.testing.assert_array_equal(nn_t[0].numpy(), np.asarray(nn_r), name)
        np.testing.assert_array_max_ulp(d2_t[0].numpy(), np.asarray(d2_r),
                                        maxulp=1)
        if name == "no valid target":
            assert (nn_t == 0).all() and torch.isinf(d2_t).all()
        else:
            assert (nn_t[0] == nn_t[0, :, :1]).all()   # one target a keyframe


def test_slice_pallas_features_under_overflow_matches_jax():
    """The slice with `feature.backend="pallas"` and pre_cells 1024, under
    the occupied voxels of every frame (1,159-1,190 here): both packages
    drop the voxels ranked beyond it, with the same keyframes, the cell
    counts within 3 and the poses within OVERFLOW_TOL. Under overflow a
    voxel that appears or goes by float32 rounding re-ranks every voxel
    after it: the reference itself, run under
    XLA_FLAGS=--xla_cpu_max_isa=AVX, keeps one cell fewer on frame 3 (the
    port's count there) and moves 2.06 cm from its default run (the port's
    distance from it); OVERFLOW_TOL is about 3x that."""
    cfg_j, _ = slice_cfg(backend="pallas", pre_cells=1024)
    cfg_t = both_cfgs(cfg_j)[1]
    images, _ = synthetic.make_sequence(seed=3, n_frames=10, cfg=cfg_j)
    occ, dropped, c_pre = chip_smoke.overflow_counts(images, cfg_t, "cpu")
    assert c_pre == 1024 and (dropped > 0).all(), occ
    jr = jodo.OdometryRunner(cfg_j, chunk=9, ingest="host")
    jr.process(images)
    tr = todo.OdometryRunner(cfg_t, ingest="host", device="cpu", chunk=8)
    tr.process(images)
    out, out_j = tr.frame_outputs(), jr.frame_outputs()
    assert out.success.all() and out_j.success.all()
    np.testing.assert_array_equal(out.fused, np.asarray(out_j.fused))
    traj, traj_j = tr.trajectory(), np.asarray(jr.trajectory())
    np.testing.assert_allclose(traj[:, :2], traj_j[:, :2], atol=OVERFLOW_TOL)
    np.testing.assert_allclose(traj[:, 2], traj_j[:, 2], atol=YAW_TOL)
    np.testing.assert_allclose(_motions(traj), _motions(traj_j),
                               atol=OVERFLOW_TOL)
    assert np.abs(out.num_cells - np.asarray(out_j.num_cells)).max() <= 3


def _golden(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_blind_golden_config_matches_chip_smoke():
    """The `longrun-blind` golden (`make_torch_port_golden.py --preset
    blind`): chip_smoke's configuration and sequence, kernel A, image
    ingest; every blind frame failed and, where checked, unhealthy."""
    g = _golden(chip_smoke.GOLDEN_BLIND)
    assert json.loads(str(g["config"])) == chip_smoke.blind_config().to_dict()
    assert json.loads(str(g["sequence"])) == chip_smoke.BLIND_SEQUENCE
    assert str(g["assoc_method"]) == "pallas" and str(g["ingest"]) == "image"
    b = int(g["blind_from"])
    assert b == chip_smoke.BLIND_FROM
    assert g["success"][:b].all() and not g["success"][b:].any()
    chk = g["health_checked"]
    assert chk[b:].all() and not g["healthy"][b:].any()
    assert np.isfinite(g["poses"]).all()


def test_stationary_golden_config_matches_chip_smoke():
    """The `stationary` golden (`--preset stationary`): chip_smoke's slice
    configuration (kernel C, host ingest), only the bootstrap keyframe,
    every pose within 0.2 m of the origin."""
    g = _golden(chip_smoke.GOLDEN_STATIONARY)
    assert json.loads(str(g["config"])) == chip_smoke.slice_config().to_dict()
    assert json.loads(str(g["sequence"])) == chip_smoke.STATIONARY
    assert str(g["assoc_method"]) == "pallas_sparse"
    assert np.flatnonzero(g["fused"]).tolist() == [0] and g["success"].all()
    assert np.abs(g["poses"][:, :2]).max() < chip_smoke.STATIONARY_MAX_XY


def test_overflow_golden_config_matches_chip_smoke():
    """The `pallas-features-overflow` golden (`--preset overflow`):
    chip_smoke's configuration, the default
    pre_cells, OVERFLOW_SEQUENCE, every frame successful."""
    g = _golden(chip_smoke.GOLDEN_OVERFLOW)
    cfg = chip_smoke.overflow_config()
    assert json.loads(str(g["config"])) == cfg.to_dict()
    assert json.loads(str(g["sequence"])) == chip_smoke.OVERFLOW_SEQUENCE
    assert cfg.feature.pre_cells == 0 and cfg.feature.backend == "pallas"
    assert cfg.feature.point_budget % 512 == 0
    assert g["poses"].shape == (chip_smoke.OVERFLOW_SEQUENCE["n_frames"], 3)
    assert g["success"].all()


def test_refine_golden_config_matches_chip_smoke():
    """The `refine` golden (`--preset refine`): the slam configuration,
    chip_smoke.REFINE's keyframes of the `slam` golden with their cells at
    max_cells, the first pose fixed, every refined pose nearer the
    odometry's than the perturbed start."""
    g = _golden(chip_smoke.GOLDEN_REFINE)
    cfg = chip_smoke.slam_config()
    assert json.loads(str(g["config"])) == cfg.to_dict()
    assert json.loads(str(g["refine"])) == chip_smoke.REFINE
    k = chip_smoke.REFINE["keyframes"]
    slam = _golden(chip_smoke.GOLDEN_SLAM)
    np.testing.assert_array_equal(
        g["frames"], np.flatnonzero(slam["fused"])[:k])
    assert g["cells_mean"].shape == (k, cfg.feature.max_cells, 2)
    assert g["valid"].all() and g["cells_valid"].sum(-1).min() > 300
    np.testing.assert_array_equal(g["refined"][0], g["poses0"][0])
    err0 = np.abs(g["poses0"][1:, :2] - g["odometry"][1:, :2]).max()
    err1 = np.abs(g["refined"][1:, :2] - g["odometry"][1:, :2]).max()
    assert err1 < 0.5 * err0, (err0, err1)


def _card_odometry():
    c = _golden(CARD_ODOMETRY)
    assert json.loads(str(c["config"])) == chip_smoke.slam_config().to_dict()
    assert json.loads(str(c["sequence"])) == chip_smoke.SLAM_DROPOUT_SEQUENCE
    return c


def test_card_odometry_file_matches_chip_smoke():
    """The card's `slam-dropout` odometry: made on an H100 (its name and
    power limit inside), 512 frames, the golden's keyframe count, flags
    equal to the golden's before the checkpoint's frame and not at it; its
    own accepted loop edges within chip_smoke's bound of the golden's; the
    checkpoint in the reference's layout, taken from a split run that
    repeated the whole one bit for bit."""
    c = _card_odometry()
    g = _golden(chip_smoke.GOLDEN_SLAM_DROPOUT)
    assert "H100" in str(c["card"]) and " W" in str(c["card"])
    assert c["poses"].shape == (512, 3) and c["success"].all()
    assert c["fused"].sum() == g["fused"].sum()
    f = int(c["first_flag_frame"])
    np.testing.assert_array_equal(c["fused"][:f], g["fused"][:f])
    assert c["fused"][f] != g["fused"][f] and bool(c["split_identical"])
    n_state = len(jax.tree.leaves(jodo.init_state(
        ref.CFEARConfig.from_dict(chip_smoke.slam_config().to_dict()))))
    assert sorted(k for k in c if k.startswith("ckpt_state_")) == sorted(
        f"ckpt_state_{i}" for i in range(n_state))
    assert c["ckpt_out_pose"].shape == (f, 3)
    share = chip_smoke.SLAM_DROPOUT_OWN_LOOP_SHARE
    assert abs(len(c["accepted"]) - len(g["accepted"])) \
        <= share * len(g["accepted"])


def _dropout_window(cfg, first, n):
    """Frames first..first+n-1 of `slam_scale.make_lap_sequence(cfg,
    **chip_smoke.SLAM_DROPOUT_SEQUENCE)`. The frames before `first` are not
    rendered: their random draws, which do not depend on the scene (the
    noise floor, then the dropout wedge's), are drawn in
    `synthetic.render_polar`'s order, so the window's sweeps are the
    sequence's (held on frames 6-7 against a whole render)."""
    from cfear_radarodometry_code_public_tpu_torch.eval import slam_scale
    seq = chip_smoke.SLAM_DROPOUT_SEQUENCE
    rng, world, lap = slam_scale._lap_world(
        cfg, seq["lap_frames"], seq["speed"], seq["extent"],
        slam_scale.WORLD_SEED)
    a, r = cfg.radar.n_azimuths, cfg.radar.n_bins
    for _ in range(first):
        rng.exponential(12.0, (a, r))
        if rng.random() < seq["dropout_prob"]:
            rng.integers(a // 16, a // 4), rng.integers(0, a)
            rng.uniform(0.0, 0.2)
    route = np.concatenate([lap] * (-(-(first + n) // len(lap))))
    return slam_scale._render_route(world, route[first:first + n], cfg, rng,
                                    seq["dropout_prob"], route[first - 1])


def test_card_state_sets_the_card_flags_in_both_packages():
    """From the card runner's checkpoint before the first keyframe flag it
    sets apart from the golden's (frame 414), the reference (kernel A in
    interpret mode) and the port on the CPU both set the card's flags over
    the next four frames: the flag follows the state it is given."""
    c = _card_odometry()
    f = int(c["first_flag_frame"])
    cfg_t = chip_smoke.slam_config()
    cfg_j = ref.CFEARConfig.from_dict(cfg_t.to_dict())
    cfg_j = cfg_j.replace(registration=dataclasses.replace(
        cfg_j.registration, assoc_method="pallas"))
    from cfear_radarodometry_code_public_tpu_torch.eval import slam_scale
    whole, _ = slam_scale.make_lap_sequence(
        cfg_t, **{**chip_smoke.SLAM_DROPOUT_SEQUENCE, "n_frames": 8})
    np.testing.assert_array_equal(_dropout_window(cfg_t, 6, 2), whole[6:])
    window = _dropout_window(cfg_t, f, 4)
    want = c["fused"][f:f + 4]
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "card.npz")
        np.savez(ck, **{k[5:]: v for k, v in c.items()
                        if k.startswith("ckpt_")})
        jr = jodo.OdometryRunner.resume(cfg_j, ck, chunk=4, ingest="host")
        jr.process(window)
        tr = todo.OdometryRunner.resume(cfg_t, ck, device="cpu", chunk=4,
                                        ingest="host")
        tr.process(window)
    np.testing.assert_array_equal(np.asarray(jr.frame_outputs().fused)[f:],
                                  want)
    np.testing.assert_array_equal(tr.frame_outputs().fused[f:], want)


@pytest.mark.slow
def test_closure_on_the_card_odometry_equals_the_reference():
    """The graph with scan payloads built from the card's odometry and
    closed in both packages on the CPU (the reference with kernel A in
    interpret mode): the same accepted pairs, and those the card's own
    pass accepted. About five minutes: two closures over 171 keyframes."""
    from cfear_radarodometry_code_public_tpu.models import (
        loopclosure as jlc, posegraph as jpg)
    from cfear_radarodometry_code_public_tpu_torch.eval import slam_scale
    from cfear_radarodometry_code_public_tpu_torch.models import (
        loopclosure as tlc, posegraph as tpg)
    c = _card_odometry()
    cfg_t = chip_smoke.slam_config()
    cfg_j = ref.CFEARConfig.from_dict(cfg_t.to_dict())
    cfg_j = cfg_j.replace(registration=dataclasses.replace(
        cfg_j.registration, assoc_method="pallas"))
    images, _ = slam_scale.make_lap_sequence(
        cfg_t, **chip_smoke.SLAM_DROPOUT_SEQUENCE)
    outputs = chip_smoke.golden_outputs(c)
    gb_j = jpg.build_graph_from_odometry(outputs, c["poses"], images=images,
                                         cfg=cfg_j)
    want = set(map(tuple, jlc.LoopCloser(cfg_j).close_from_graph(gb_j)))
    gb_t = tpg.build_graph_from_odometry(outputs, c["poses"], images=images,
                                         cfg=cfg_t, device="cpu")
    got = set(map(tuple, tlc.LoopCloser(cfg_t, device="cpu")
                  .close_from_graph(gb_t)))
    assert got == want == set(map(tuple, c["accepted"].tolist()))
