"""The port's CFEAR-3 host-ingest slice end to end against the JAX reference
on the CPU, plus the batched step, state carried across from a JAX
checkpoint, and the port running without JAX.

Tolerances: the two packages' f32 sin/cos/atan2 differ by an ulp, which
moves a few points across voxel boundaries and gates; the registration then
stops at a slightly different point inside its convergence tolerance. On the
slice below that gives per-frame pose differences of a few mm. The tests
allow 2 cm and 2 mrad on poses and 1 cm on frame-to-frame motion (both
well under the 0.1-1 m scale of a wrong association or a wrong sign), and
require identical keyframe decisions and success flags.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from torch_port_helpers import both_cfgs, jax, ref, s50_cfg, slice_cfg

from cfear_radarodometry_code_public_tpu.datasets import synthetic
from cfear_radarodometry_code_public_tpu.eval.trajectory import ate_rmse
from cfear_radarodometry_code_public_tpu.models import odometry as jodo
from cfear_radarodometry_code_public_tpu_torch.models import odometry as todo

N_FRAMES, SPLIT = 25, 13
POS_TOL, YAW_TOL, MOTION_TOL = 0.02, 2e-3, 0.01
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def seq():
    cfg_j, cfg_t = slice_cfg()
    images, gt = synthetic.make_sequence(seed=3, n_frames=N_FRAMES, cfg=cfg_j)
    return cfg_j, cfg_t, images, gt


@pytest.fixture(scope="module")
def jax_run(seq, tmp_path_factory):
    """The reference over the sequence, checkpointed after SPLIT frames."""
    cfg_j, _, images, _ = seq
    runner = jodo.OdometryRunner(cfg_j, chunk=12, ingest="host")
    runner.process(images[:SPLIT])
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "jax_state.npz")
    runner.save_checkpoint(ckpt)
    state_at_split = [np.asarray(a) for a in jax.tree.leaves(runner.state)]
    runner.process(images[SPLIT:])
    return runner.trajectory(), runner.frame_outputs(), ckpt, state_at_split


def _motions(traj):
    d = traj[1:] - traj[:-1]
    c, s = np.cos(traj[:-1, 2]), np.sin(traj[:-1, 2])
    return np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1],
                     d[:, 2]], -1)


def _assert_traj_close(got, want):
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=POS_TOL)
    np.testing.assert_allclose(got[:, 2], want[:, 2], atol=YAW_TOL)
    np.testing.assert_allclose(_motions(got)[:, :2], _motions(want)[:, :2],
                               atol=MOTION_TOL)


def test_slice_matches_jax(seq, jax_run):
    cfg_j, cfg_t, images, gt = seq
    traj_j, out_j, _, _ = jax_run
    runner = todo.OdometryRunner(cfg_t, ingest="host", device="cpu", chunk=8)
    runner.process(images)
    traj = runner.trajectory()
    out = runner.frame_outputs()
    assert traj.shape == (N_FRAMES, 3)
    assert out.success.all()
    np.testing.assert_array_equal(out.fused, out_j.fused)
    _assert_traj_close(traj, traj_j)
    assert ate_rmse(traj[:, :2], gt[:, :2]) < 0.5
    assert np.abs(out.num_cells - out_j.num_cells).max() <= 3
    for name in todo.FrameOutput._fields:
        assert getattr(out, name).dtype == getattr(out_j, name).dtype, name
        assert getattr(out, name).shape == getattr(out_j, name).shape, name


def test_slice_pallas_features_matches_jax(seq):
    """The slice with `feature.backend="pallas"`: kernel G's twin against
    the reference's moment kernel in interpret mode, end to end."""
    cfg_j, _, images, gt = seq
    cfg_j = cfg_j.replace(feature=dataclasses.replace(cfg_j.feature,
                                                      backend="pallas"))
    cfg_t = both_cfgs(cfg_j)[1]
    jr = jodo.OdometryRunner(cfg_j, chunk=12, ingest="host")
    jr.process(images)
    tr = todo.OdometryRunner(cfg_t, ingest="host", device="cpu", chunk=8)
    tr.process(images)
    out, out_j = tr.frame_outputs(), jr.frame_outputs()
    assert out.success.all() and out_j.success.all()
    np.testing.assert_array_equal(out.fused, out_j.fused)
    traj = tr.trajectory()
    _assert_traj_close(traj, jr.trajectory())
    assert ate_rmse(traj[:, :2], gt[:, :2]) < 0.5
    assert np.abs(out.num_cells - out_j.num_cells).max() <= 3


def test_candidates_ingest_p2l_matches_jax(seq):
    """The other host-ingest kind (no point budget: (A, K) candidate sets)
    with the P2L cost, over the first 10 frames."""
    cfg_j, _, images, _ = seq
    cfg_j = cfg_j.replace(
        feature=dataclasses.replace(cfg_j.feature, point_budget=0),
        registration=dataclasses.replace(cfg_j.registration, cost="P2L"))
    cfg_t = both_cfgs(cfg_j)[1]
    jr = jodo.OdometryRunner(cfg_j, chunk=9, ingest="host")
    jr.process(images[:10])
    tr = todo.OdometryRunner(cfg_t, ingest="host", device="cpu")
    assert tr.kind == "candidates"
    tr.process(images[:10])
    out, out_j = tr.frame_outputs(), jr.frame_outputs()
    assert out.success.all()
    np.testing.assert_array_equal(out.fused, out_j.fused)
    _assert_traj_close(tr.trajectory(), jr.trajectory())


def test_resume_from_jax_checkpoint(seq, jax_run):
    """JAX state saved after SPLIT frames; the port resumes it and runs the
    rest of the sequence."""
    _, cfg_t, images, _ = seq
    traj_j, out_j, ckpt, _ = jax_run
    runner = todo.OdometryRunner.resume(cfg_t, ckpt, device="cpu")
    runner.process(images[SPLIT:])
    traj = runner.trajectory()
    out = runner.frame_outputs()
    np.testing.assert_array_equal(traj[:SPLIT], traj_j[:SPLIT])
    np.testing.assert_array_equal(out.fused, out_j.fused)
    _assert_traj_close(traj, traj_j)


def test_state_from_jax_leaves_and_checkpoint_roundtrip(seq, jax_run,
                                                        tmp_path):
    _, cfg_t, images, _ = seq
    _, _, _, leaves = jax_run
    state = todo.state_from_numpy(leaves, "cpu")
    ref_state = todo.init_state(cfg_t, "cpu")
    for got, want, like in zip(todo.state_leaves(state), leaves,
                               todo.state_leaves(ref_state)):
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == like.dtype and got.shape == like.shape
    runner = todo.OdometryRunner(cfg_t, device="cpu")
    runner.process(images[:3])
    path = str(tmp_path / "port.npz")
    runner.save_checkpoint(path)
    back = todo.OdometryRunner.resume(cfg_t, path, device="cpu")
    for a, b in zip(todo.state_leaves(runner.state),
                    todo.state_leaves(back.state)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(back.trajectory(), runner.trajectory())


def test_batched_step_equals_per_lane_steps(seq):
    """make_batched_step over B=3 lanes (different frames per lane) equals
    make_step run on each lane alone."""
    _, cfg_t, images, _ = seq
    rows = todo.host_filter(images[:8], cfg_t, "compact")
    b, steps = 3, 5
    lane_rows = [todo._map(lambda a: a[i:i + steps + 1], rows)
                 for i in range(b)]
    batched = todo.filtering.CompactCandidates(
        *(np.stack(xs, 1) for xs in zip(*lane_rows)))
    boot_b = todo.make_bootstrap(cfg_t, batched=True)
    step_b = todo.make_batched_step(cfg_t)
    states = todo.init_state(cfg_t, "cpu", batch=b)
    states, _ = boot_b(states, todo.to_device(
        todo._map(lambda a: a[0], batched), "cpu"))
    outs_b = []
    for t in range(1, steps + 1):
        states, o = step_b(states, todo.to_device(
            todo._map(lambda a: a[t], batched), "cpu"))
        outs_b.append(o)
    boot, step = todo.make_bootstrap(cfg_t), todo.make_step(cfg_t)
    for i in range(b):
        st = todo.init_state(cfg_t, "cpu")
        st, _ = boot(st, todo.to_device(
            todo._map(lambda a: a[0], lane_rows[i]), "cpu"))
        for t in range(1, steps + 1):
            st, o = step(st, todo.to_device(
                todo._map(lambda a: a[t], lane_rows[i]), "cpu"))
            for f in todo.FrameOutput._fields:
                np.testing.assert_allclose(
                    getattr(outs_b[t - 1], f)[i].numpy(),
                    getattr(o, f).numpy(), rtol=1e-6, atol=1e-6, err_msg=f)
        for a, c in zip(todo.state_leaves(st), todo.state_leaves(states)):
            np.testing.assert_allclose(c[i].numpy(), a.numpy(), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("section,field,value", [
    ("filter", "method", "cacfar"),
    ("feature", "use_raw_pointcloud", True),
    ("registration", "assoc_method", "grid")])
def test_unported_options_raise(section, field, value):
    cfg_j, _ = slice_cfg()
    cfg_j = cfg_j.replace(**{section: dataclasses.replace(
        getattr(cfg_j, section), **{field: value})})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        todo.OdometryRunner(both_cfgs(cfg_j)[1], device="cpu")


def test_image_ingest_raises(seq):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        todo.OdometryRunner(seq[1], ingest="image", device="cpu")


def test_port_runs_without_jax():
    """In a process where `import jax` fails, the port runs its slice on
    the CPU and never imports the reference package."""
    script = textwrap.dedent(r"""
        import importlib.abc, sys
        class NoJax(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib"):
                    raise ImportError("jax is blocked in this test")
        sys.meta_path.insert(0, NoJax())
        import dataclasses
        import cfear_radarodometry_code_public_tpu_torch as port
        from cfear_radarodometry_code_public_tpu_torch.datasets import synthetic
        from cfear_radarodometry_code_public_tpu_torch.models import odometry
        cfg = port.preset("CFEAR-3", dataset="synthetic")
        cfg = cfg.replace(
            feature=dataclasses.replace(cfg.feature, max_cells=512,
                                        point_budget=2048),
            filter=dataclasses.replace(cfg.filter, k_strongest=12))
        images, gt = synthetic.make_sequence(seed=3, n_frames=4, cfg=cfg)
        r = odometry.OdometryRunner(cfg, ingest="host", device="cpu")
        r.process(images)
        traj = r.trajectory()
        assert traj.shape == (4, 3) and r.frame_outputs().success.all()
        assert abs(traj[-1, :2] - gt[-1, :2]).max() < 0.5, traj
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "jaxlib", "cfear_radarodometry_code_public_tpu")]
        assert not bad, bad
        for kernel_module in ("cuda_assoc", "cuda_lm", "cuda_features"):
            assert ("cfear_radarodometry_code_public_tpu_torch.ops."
                    + kernel_module) in sys.modules, kernel_module
        print("NOJAX-OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX-OK" in proc.stdout


S50_SLOTS = 12


@functools.lru_cache(maxsize=None)
def _s50_images():
    return synthetic.make_sequence(seed=3, n_frames=N_FRAMES,
                                   cfg=s50_cfg()[0])


@functools.lru_cache(maxsize=None)
def _s50_jax(k_active):
    """The reference over the s50 sequence (pallas_sparse in interpret
    mode), and its state's leaves after SPLIT frames."""
    images, _ = _s50_images()
    runner = jodo.OdometryRunner(s50_cfg(k_active)[0], chunk=12,
                                 ingest="host")
    runner.process(images[:SPLIT])
    leaves = [np.asarray(a) for a in jax.tree.leaves(runner.state)]
    runner.process(images[SPLIT:])
    return runner.trajectory(), runner.frame_outputs(), leaves


@pytest.mark.parametrize("k_active", [0, 6])
def test_s50_matches_jax(k_active):
    """CFEAR-3-s50 cut to a 12-keyframe window that fills (exact, and with
    the K=6 distance gate) against the reference, block-sparse association
    on both sides: per-frame poses within the file's tolerances, identical
    keyframe and success flags, the window full at the end."""
    images, gt = _s50_images()
    traj_j, out_j, _ = _s50_jax(k_active)
    runner = todo.OdometryRunner(s50_cfg(k_active)[1], ingest="host",
                                 device="cpu", chunk=8)
    runner.process(images)
    traj, out = runner.trajectory(), runner.frame_outputs()
    assert out.success.all() and out_j.success.all()
    np.testing.assert_array_equal(out.fused, out_j.fused)
    assert out.fused.sum() > S50_SLOTS + 2          # the window fills, then cycles
    assert int(runner.state.kf_valid.sum()) == S50_SLOTS
    _assert_traj_close(traj, traj_j)
    assert ate_rmse(traj[:, :2], gt[:, :2]) < 0.5
    assert np.abs(out.num_cells - out_j.num_cells).max() <= 3


def test_s50_state_carries_across(tmp_path):
    """A JAX state at S=12 (after SPLIT frames) carries across through
    `state_from_numpy`; the port continues the sequence from it, and its
    own checkpoint of the full window resumes to the same state."""
    images, _ = _s50_images()
    _, out_j, leaves = _s50_jax(0)
    cfg_t = s50_cfg()[1]
    state = todo.state_from_numpy(leaves, "cpu")
    like = todo.init_state(cfg_t, "cpu")
    for got, want in zip(todo.state_leaves(state), todo.state_leaves(like)):
        assert got.dtype == want.dtype and got.shape == want.shape
    assert state.kf_cells.valid.shape == (S50_SLOTS, 512)
    assert bool(state.kf_valid.all())
    runner = todo.OdometryRunner(cfg_t, ingest="host", device="cpu")
    runner.state = state
    runner.process(images[SPLIT:])
    out = runner.frame_outputs()
    np.testing.assert_array_equal(out.fused, out_j.fused[SPLIT:])
    assert out.success.all()
    np.testing.assert_allclose(out.pose[:, :2], out_j.pose[SPLIT:, :2],
                               atol=POS_TOL)
    np.testing.assert_allclose(out.pose[:, 2], out_j.pose[SPLIT:, 2],
                               atol=YAW_TOL)
    path = str(tmp_path / "s50.npz")
    runner.save_checkpoint(path)
    back = todo.OdometryRunner.resume(cfg_t, path, device="cpu")
    for a, b in zip(todo.state_leaves(runner.state),
                    todo.state_leaves(back.state)):
        assert torch.equal(a, b)


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def test_pallas_golden_config_matches_chip_smoke():
    """The second golden: chip_smoke's configuration with the pallas
    feature backend, made by `make_torch_port_golden.py --feature-backend
    pallas`."""
    import json
    chip_smoke = _chip_smoke()
    with np.load(chip_smoke.GOLDEN_PALLAS) as z:
        cfg = json.loads(str(z["config"]))
        assert json.loads(str(z["sequence"])) == chip_smoke.SEQUENCE
        assert z["poses"].shape == (chip_smoke.SEQUENCE["n_frames"], 3)
        assert z["success"].all()
    assert cfg == chip_smoke.slice_config(feature_backend="pallas").to_dict()
    assert cfg["feature"]["backend"] == "pallas"


def test_golden_config_matches_chip_smoke():
    """The committed JAX golden was made for chip_smoke.py's exact
    sequence and configuration."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    import json
    with np.load(chip_smoke.GOLDEN) as z:
        cfg = json.loads(str(z["config"]))
        seq = json.loads(str(z["sequence"]))
        assert z["poses"].shape == (chip_smoke.SEQUENCE["n_frames"], 3)
        assert z["fused"].dtype == bool and z["success"].all()
    assert cfg == chip_smoke.slice_config().to_dict()
    assert seq == chip_smoke.SEQUENCE
    assert ref.CFEARConfig.from_dict(cfg).registration.assoc_method \
        == "pallas_sparse"


def test_s50_golden_configs_match_chip_smoke():
    """The two s50 goldens were made for chip_smoke.py's s50 sequence and
    configurations (`make_torch_port_golden.py --preset CFEAR-3-s50
    [--k-active 16]`), ran the block-sparse kernel, and filled the window."""
    import json
    chip_smoke = _chip_smoke()
    for k_active, path in ((0, chip_smoke.GOLDEN_S50),
                           (16, chip_smoke.GOLDEN_S50_K16)):
        with np.load(path) as z:
            cfg = json.loads(str(z["config"]))
            assert json.loads(str(z["sequence"])) == chip_smoke.S50_SEQUENCE
            assert z["poses"].shape == (chip_smoke.S50_SEQUENCE["n_frames"], 3)
            assert z["success"].all() and z["fused"].sum() > 50
        assert cfg == chip_smoke.s50_config(k_active).to_dict()
        reg = ref.CFEARConfig.from_dict(cfg).registration
        assert reg.assoc_method == "pallas_sparse"
        assert reg.max_active_keyframes == k_active
        assert cfg["odometry"]["submap_scan_size"] == 50


HEALTH_FRAMES = 12


def _option_cfgs(**odometry):
    """`slice_cfg` with odometry / registration options, both packages."""
    reg = odometry.pop("registration", {})
    cfg_j, _ = slice_cfg()
    cfg_j = cfg_j.replace(
        odometry=dataclasses.replace(cfg_j.odometry, **odometry),
        registration=dataclasses.replace(cfg_j.registration, **reg))
    return both_cfgs(cfg_j)


@functools.lru_cache(maxsize=None)
def _health_jax():
    cfg_j, _ = _option_cfgs(health_check_every=2)
    images, _ = synthetic.make_sequence(seed=3, n_frames=HEALTH_FRAMES,
                                        cfg=cfg_j)
    runner = jodo.OdometryRunner(cfg_j, chunk=11, ingest="host")
    runner.process(images)
    return images, runner.trajectory(), runner.frame_outputs()


def _assert_health_close(out, out_j):
    np.testing.assert_array_equal(out.health_checked, out_j.health_checked)
    np.testing.assert_array_equal(out.healthy, out_j.healthy)
    np.testing.assert_allclose(out.health_dist, out_j.health_dist,
                               atol=POS_TOL)
    np.testing.assert_allclose(out.health_rot, out_j.health_rot,
                               atol=YAW_TOL)


def test_health_check_matches_jax():
    """`health_check_every=2`: the checked flags and `healthy` identical to
    the reference's, the forward/backward discrepancy within the pose
    tolerances, and the forward solve unchanged by the check."""
    images, traj_j, out_j = _health_jax()
    _, cfg_t = _option_cfgs(health_check_every=2)
    runner = todo.OdometryRunner(cfg_t, ingest="host", device="cpu")
    runner.process(images)
    out = runner.frame_outputs()
    # frame t >= 1 is checked when the frames before it, t, are a multiple
    # of 2
    even = (np.arange(HEALTH_FRAMES) % 2 == 0) & (np.arange(HEALTH_FRAMES) > 0)
    np.testing.assert_array_equal(out_j.health_checked, even)
    assert (out.health_dist[even] > 0).all()
    _assert_health_close(out, out_j)
    np.testing.assert_array_equal(out.fused, out_j.fused)
    _assert_traj_close(runner.trajectory(), traj_j)


def test_health_check_batched_lanes_equal_single_lanes():
    """Two lanes one frame apart, so that on every step one lane is checked
    and the other not: the reverse solve runs over both lanes and masks the
    unchecked one, and every lane's outputs equal its single-lane run."""
    images, _, _ = _health_jax()
    _, cfg_t = _option_cfgs(health_check_every=2)
    rows = todo.host_filter(images, cfg_t, "compact")
    frame = [todo.to_device(todo._map(lambda a: a[t], rows), "cpu")
             for t in range(HEALTH_FRAMES)]
    boot, step = todo.make_bootstrap(cfg_t), todo.make_step(cfg_t)
    lanes, singles = [], []
    for ahead in (0, 1):                # lane 1 is one frame ahead
        st, _ = boot(todo.init_state(cfg_t, "cpu"), frame[0])
        for t in range(1, 1 + ahead):
            st, _ = step(st, frame[t])
        lanes.append(st)
        outs = []
        for t in range(1 + ahead, HEALTH_FRAMES - 1 + ahead):
            st, o = step(st, frame[t])
            outs.append(o)
        singles.append(outs)
    states = todo._map2(lambda a, b: torch.stack([a, b]), *lanes)
    stepb = todo.make_batched_step(cfg_t)
    checked_mix = 0
    for i, t in enumerate(range(1, HEALTH_FRAMES - 1)):
        inp = todo._map2(lambda a, b: torch.stack([a, b]), frame[t],
                         frame[t + 1])
        states, o = stepb(states, inp)
        checked_mix += int(o.health_checked.sum()) == 1
        for lane in (0, 1):
            for f in todo.FrameOutput._fields:
                np.testing.assert_allclose(
                    getattr(o, f)[lane].numpy(),
                    getattr(singles[lane][i], f).numpy(), rtol=1e-6,
                    atol=1e-6, err_msg=f"{f} lane {lane} step {i}")
    assert checked_mix == HEALTH_FRAMES - 2


def test_split_resume_keeps_health_fields(tmp_path):
    """A run split through `save_checkpoint` / `resume` with the health
    check on: trajectory and health fields bit-identical to the unsplit
    run."""
    images, _, _ = _health_jax()
    _, cfg_t = _option_cfgs(health_check_every=2)
    whole = todo.OdometryRunner(cfg_t, ingest="host", device="cpu")
    whole.process(images)
    first = todo.OdometryRunner(cfg_t, ingest="host", device="cpu")
    first.process(images[:7])
    path = str(tmp_path / "health.npz")
    first.save_checkpoint(path)
    second = todo.OdometryRunner.resume(cfg_t, path, device="cpu")
    second.process(images[7:])
    np.testing.assert_array_equal(second.trajectory(), whole.trajectory())
    a, b = second.frame_outputs(), whole.frame_outputs()
    for f in todo.FrameOutput._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.health_checked.sum() == 5


def test_cov_sampling_matches_jax():
    """`estimate_cov_by_sampling`: poses, keyframes and success as the
    reference's, and bit for bit as the port's run without sampling (the
    covariance feeds nothing back). The sampled covariance is positive
    definite wherever it replaces the Censi one; the reference's float32
    fit is never convex at the default ranges (ROADMAP queue 3), so its
    covariances stay the Censi ones: that is pinned too."""
    images, _, _ = _health_jax()
    images = images[:8]
    cfg_j, cfg_t = _option_cfgs(estimate_cov_by_sampling=True)
    _, cfg_plain = _option_cfgs()
    jr = jodo.OdometryRunner(cfg_j, chunk=7, ingest="host")
    jr.process(images)
    jr_plain = jodo.OdometryRunner(_option_cfgs()[0], chunk=7, ingest="host")
    jr_plain.process(images)
    tr = todo.OdometryRunner(cfg_t, ingest="host", device="cpu")
    tr.process(images)
    tp = todo.OdometryRunner(cfg_plain, ingest="host", device="cpu")
    tp.process(images)
    out, out_j = tr.frame_outputs(), jr.frame_outputs()
    np.testing.assert_array_equal(out.fused, out_j.fused)
    assert out.success.all()
    _assert_traj_close(tr.trajectory(), jr.trajectory())
    np.testing.assert_array_equal(tr.trajectory(), tp.trajectory())
    np.testing.assert_array_equal(out_j.cov, jr_plain.frame_outputs().cov)
    sampled = (out.cov != tp.frame_outputs().cov).any((1, 2))
    assert sampled[1:].all() and not sampled[0]
    cov = out.cov[1:].astype(np.float64)
    assert np.isfinite(cov).all()
    assert (np.linalg.eigvalsh(0.5 * (cov + cov.transpose(0, 2, 1))) > 0).all()


def test_time_continuous_matches_jax():
    """`registration.time_continuous`: the cells warped by the previous
    motion before the solve, the cloud-level compensation skipped."""
    images, _, _ = _health_jax()
    images = images[:8]
    cfg_j, cfg_t = _option_cfgs(registration={"time_continuous": True})
    jr = jodo.OdometryRunner(cfg_j, chunk=7, ingest="host")
    jr.process(images)
    tr = todo.OdometryRunner(cfg_t, ingest="host", device="cpu")
    tr.process(images)
    out, out_j = tr.frame_outputs(), jr.frame_outputs()
    assert out.success.all()
    np.testing.assert_array_equal(out.fused, out_j.fused)
    _assert_traj_close(tr.trajectory(), jr.trajectory())
    _, cfg_plain = _option_cfgs()
    tp = todo.OdometryRunner(cfg_plain, ingest="host", device="cpu")
    tp.process(images)
    assert not np.array_equal(tr.trajectory(), tp.trajectory())


def test_runner_needs_a_card_unless_asked_for_the_cpu(seq, monkeypatch,
                                                      tmp_path):
    """`OdometryRunner()` and `resume()` run on the card by default: with
    no card they raise instead of dropping to the CPU."""
    _, cfg_t, images, _ = seq
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        todo.OdometryRunner(cfg_t)
    runner = todo.OdometryRunner(cfg_t, device="cpu")
    runner.process(images[:2])
    path = str(tmp_path / "two.npz")
    runner.save_checkpoint(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        todo.OdometryRunner.resume(cfg_t, path)
    assert todo.OdometryRunner.resume(cfg_t, path, device="cpu").state \
        .frame_nr.item() == 2


@pytest.mark.parametrize("sequence", ["LONGRUN_SEQUENCE",
                                      "LONGRUN_ADV8_SEQUENCE"])
def test_longrun_golden_configs_match_chip_smoke(sequence):
    """The two long-run goldens were made for chip_smoke.py's long-run
    configuration and worlds (`make_torch_port_golden.py --preset longrun
    [--adversarial --speed 8]`), ran kernel A, kept every frame and carry
    the health fields of 256 frames checked every 8."""
    import json
    chip_smoke = _chip_smoke()
    seq = getattr(chip_smoke, sequence)
    with np.load(chip_smoke.longrun_golden(seq)) as z:
        assert json.loads(str(z["config"])) == chip_smoke.longrun_config().to_dict()
        assert json.loads(str(z["sequence"])) == seq
        assert str(z["assoc_method"]) == "pallas"
        assert z["poses"].shape == (seq["n_frames"], 3) and z["success"].all()
        checked = z["health_checked"]
        assert checked.sum() == (seq["n_frames"] - 1) // 8
        assert (z["health_dist"][checked] > 0).all()
    cfg = chip_smoke.longrun_config()
    assert cfg.registration.assoc_method == "auto"
    assert cfg.feature.max_cells == 2048 and cfg.odometry.health_check_every == 8
