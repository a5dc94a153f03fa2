"""The port is self-contained: its copies of the reference's framework-free
modules (`config.py`, `datasets/synthetic.py`, `datasets/oxford.py`,
`utils/native_io.py` over `csrc/cfear_io.cpp`, `utils/stats.py`,
`eval/kitti.py`, `eval/trajectory.py`, the two functions of `eval/viz.py`
that its CLIs call) are held equal to the reference's, and the port, its
offline CLI, its SLAM-scale runner, the merge CLI and the parallel layer
included, runs in a process where JAX and every file of the reference
package are out of reach; `parallel/sweep.py` is the reference's file but
for the CLI it runs.

Tolerances: configs, rendered sequences, host-filter rows, loaded frames
and ground truth, timing reports, written trajectory files and figures are
compared exactly (files byte for byte); KITTI drift to 1e-12 (float64 sums
in the same order)."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from torch_port_helpers import both_cfgs, port, ref, slice_cfg

from cfear_radarodometry_code_public_tpu.datasets import oxford as jox
from cfear_radarodometry_code_public_tpu.datasets import synthetic as jsyn
from cfear_radarodometry_code_public_tpu.eval import kitti as jkitti
from cfear_radarodometry_code_public_tpu.eval import trajectory as jtraj
from cfear_radarodometry_code_public_tpu.utils import native_io as jnio
from cfear_radarodometry_code_public_tpu.utils import stats as jstats
from cfear_radarodometry_code_public_tpu_torch.datasets import oxford as tox
from cfear_radarodometry_code_public_tpu_torch.datasets import synthetic as tsyn
from cfear_radarodometry_code_public_tpu_torch.eval import kitti as tkitti
from cfear_radarodometry_code_public_tpu_torch.eval import trajectory as ttraj
from cfear_radarodometry_code_public_tpu_torch.utils import native_io as tnio
from cfear_radarodometry_code_public_tpu_torch.utils import stats as tstats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = ("CFEAR-1", "CFEAR-2", "CFEAR-3", "CFEAR-3-s50")
DATASETS = ("oxford", "mulran", "kvarntorp", "volvo", "synthetic")


@pytest.mark.parametrize("dataset", DATASETS)
def test_presets_equal_the_reference(dataset, tmp_path):
    for name in PRESETS:
        want = ref.preset(name, dataset=dataset).to_dict()
        got = port.preset(name, dataset=dataset)
        assert got.to_dict() == want, name
        assert port.CFEARConfig.from_dict(want) == got
        path = str(tmp_path / f"{name}.json")
        got.save(path)
        assert port.CFEARConfig.load(path) == got
        assert ref.CFEARConfig.load(path).to_dict() == want
    with pytest.raises(ValueError):
        port.preset("CFEAR-9", dataset=dataset)


@pytest.mark.parametrize("seed,knobs", [
    (3, {}),
    (11, {"n_dynamic": 4, "dropout_prob": 0.5, "speckle_burst_prob": 0.4,
          "speed": 8.0, "extent": 400.0})])
def test_make_sequence_equals_the_reference(seed, knobs):
    cfg_j, cfg_t = slice_cfg()
    images_j, gt_j = jsyn.make_sequence(seed=seed, n_frames=3, cfg=cfg_j,
                                        **knobs)
    images_t, gt_t = tsyn.make_sequence(seed=seed, n_frames=3, cfg=cfg_t,
                                        **knobs)
    assert images_t.dtype == images_j.dtype and images_t.any()
    np.testing.assert_array_equal(images_t, images_j)
    np.testing.assert_array_equal(gt_t, gt_j)


@pytest.mark.parametrize("z_quantile", [0.0, 0.9])
def test_host_filter_equals_the_reference(z_quantile):
    """The port's own build of the host filter gives the reference's rows
    bit for bit, from its own library file."""
    cfg_j, _ = slice_cfg()
    images, _ = jsyn.make_sequence(seed=5, n_frames=3, cfg=cfg_j)
    f = cfg_j.filter
    assert tnio.native_available()
    assert os.path.dirname(tnio._lib_path()) == tnio._BUILD_DIR
    assert "native" not in tnio._lib_path().split(os.sep)
    for fn, extra in (("filter_frames_host", ()),
                      ("filter_frames_host_compact", (2048, 57))):
        got = getattr(tnio, fn)(images, f.k_strongest, f.z_min,
                                f.nms_window, *extra, z_quantile=z_quantile)
        want = getattr(jnio, fn)(images, f.k_strongest, f.z_min,
                                 f.nms_window, *extra, z_quantile=z_quantile)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_kitti_drift_equals_the_reference():
    rng = np.random.default_rng(0)
    n = 400
    heading = np.cumsum(rng.normal(0, 0.02, n))
    step = np.stack([np.cos(heading), np.sin(heading)], -1) * 2.5
    gt = np.concatenate([np.cumsum(step, 0), heading[:, None]], -1)
    est = gt + np.cumsum(rng.normal(0, 0.01, (n, 3)), 0)
    for kw in ({}, {"step_size": 5, "lengths": (50.0, 100.0)}):
        got = tkitti.kitti_drift(est, gt, **kw)
        want = jkitti.kitti_drift(est, gt, **kw)
        assert got.keys() == want.keys()
        for k in ("t_err_percent", "r_err_deg_per_m"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12)
        assert got["n_subsequences"] == want["n_subsequences"] > 0


def test_port_runs_without_the_reference_package():
    """In a process where importing JAX or any module of the reference
    package, opening any file under its directory or under `native/`, and
    loading a library from there all fail, the port runs a short
    host-ingest sequence with the health check on; afterwards no module in
    sys.modules has a file under the reference's directory."""
    script = _GUARD + textwrap.dedent(r"""
        import dataclasses
        import cfear_radarodometry_code_public_tpu_torch as port
        from cfear_radarodometry_code_public_tpu_torch.datasets import synthetic
        from cfear_radarodometry_code_public_tpu_torch.eval import kitti
        from cfear_radarodometry_code_public_tpu_torch.models import odometry
        from cfear_radarodometry_code_public_tpu_torch.utils import native_io
        cfg = port.preset("CFEAR-3", dataset="synthetic")
        cfg = cfg.replace(
            feature=dataclasses.replace(cfg.feature, max_cells=512,
                                        point_budget=2048),
            filter=dataclasses.replace(cfg.filter, k_strongest=12),
            odometry=dataclasses.replace(cfg.odometry, health_check_every=2))
        images, gt = synthetic.make_sequence(seed=3, n_frames=5, cfg=cfg)
        r = odometry.OdometryRunner(cfg, ingest="host", device="cpu")
        r.process(images)
        traj, out = r.trajectory(), r.frame_outputs()
        assert native_io.native_available()
        assert traj.shape == (5, 3) and out.success.all()
        assert out.health_checked.sum() == 2 and out.healthy.all()
        assert abs(traj[-1, :2] - gt[-1, :2]).max() < 0.5, traj
        kitti.kitti_drift(traj, gt, step_size=1, lengths=(5.0,))
    """) + _NONE_LOADED
    _run_guarded(script)


def test_port_cli_runs_without_the_reference_package(tmp_path):
    """The port's offline CLI, as users run it (image ingest, the pose
    graph), runs to `est/result.txt` on the CPU in the guarded process."""
    script = _GUARD + textwrap.dedent(r"""
        import dataclasses, json
        import cfear_radarodometry_code_public_tpu_torch as port
        from cfear_radarodometry_code_public_tpu_torch import offline_odometry
        from cfear_radarodometry_code_public_tpu_torch.models import posegraph
        out = sys.argv[2]
        cfg = port.preset("CFEAR-3", dataset="synthetic")
        cfg = cfg.replace(
            feature=dataclasses.replace(cfg.feature, max_cells=512,
                                        point_budget=2048),
            filter=dataclasses.replace(cfg.filter, k_strongest=12))
        cfg.save(os.path.join(out, "cfg.json"))
        res = offline_odometry.main([
            "--config-file", os.path.join(out, "cfg.json"), "--dataset",
            "synthetic", "--seed", "3", "--n-frames", "5", "--cpu",
            "--output-dir", os.path.join(out, "run")])
        assert res["frames"] == 5 and res["registration_failures"] == 0
        assert res["keyframes"] >= 3 and res["ate_m"] < 0.5, res
        with open(os.path.join(out, "run", "est", "result.txt")) as f:
            assert f.read().startswith("frames: 5")
        g = posegraph.GraphBuilder.load(
            os.path.join(out, "run", "simple_graph.npz"))
        assert len(g.poses) == res["keyframes"]
    """) + _NONE_LOADED
    _run_guarded(script, str(tmp_path))


def test_lap_sequence_and_slam_metrics_equal_the_reference_tool():
    """`eval/slam_scale.py` against the lines of `tools/run_slam_scale.py`
    it stands for (:81-106 the world and render, :170-201 the loop
    residuals and the keyframe ATE), restated here with the reference's
    synthetic module and float32 `se2.relative`: images and ground truth
    exactly, metrics to 1e-12."""
    import jax.numpy as jnp

    from cfear_radarodometry_code_public_tpu.utils import se2 as jse2
    from cfear_radarodometry_code_public_tpu_torch.eval import slam_scale

    cfg_j, cfg_t = slice_cfg()
    frames, lap_frames, speed, extent, dropout = 5, 3, 2.5, 200.0, 0.3
    rng = np.random.default_rng(9)
    scale = (extent / 160.0) ** 2
    world = jsyn.make_world(rng, extent=extent,
                            n_walls=max(18, int(18 * scale)),
                            n_scatterers=max(250, int(250 * scale)))
    lap = jsyn.make_loop_trajectory(lap_frames, dt=cfg_j.radar.sensor_period,
                                    speed=speed)
    gt = np.concatenate([lap] * -(-frames // lap_frames))[:frames]
    images = np.zeros((frames, cfg_j.radar.n_azimuths, cfg_j.radar.n_bins),
                      np.uint8)
    for i in range(frames):
        motion = None
        if i > 0:
            prev, cur = gt[i - 1], gt[i]
            c, s = np.cos(prev[2]), np.sin(prev[2])
            motion = np.array([c * (cur[0] - prev[0]) + s * (cur[1] - prev[1]),
                               -s * (cur[0] - prev[0]) + c * (cur[1] - prev[1]),
                               np.angle(np.exp(1j * (cur[2] - prev[2])))])
        images[i] = jsyn.render_polar(world, gt[i], cfg_j, rng, motion=motion,
                                      t=i * cfg_j.radar.sensor_period,
                                      dropout_prob=dropout)
    got_images, got_gt = slam_scale.make_lap_sequence(
        cfg_t, frames, lap_frames, speed, extent, dropout)
    assert got_images.any()
    np.testing.assert_array_equal(got_images, images)
    np.testing.assert_array_equal(got_gt, gt)

    est = gt + np.random.default_rng(1).normal(0, 0.5, gt.shape)
    e = est[:, :2] - est[:, :2].mean(0)
    g = gt[:, :2] - gt[:, :2].mean(0)
    th = np.arctan2(np.sum(e[:, 0] * g[:, 1] - e[:, 1] * g[:, 0]),
                    np.sum(e[:, 0] * g[:, 0] + e[:, 1] * g[:, 1]))
    c, s = np.cos(th), np.sin(th)
    er = np.stack([c * e[:, 0] - s * e[:, 1], s * e[:, 0] + c * e[:, 1]], -1)
    want_ate = float(np.sqrt(np.mean(np.sum((er - g) ** 2, -1))))
    assert abs(slam_scale.keyframe_ate(est, gt) - want_ate) <= 1e-12
    edges = [(0, 3, np.array([0.1, 0.2, 0.0]), np.eye(3), 1),
             (1, 4, np.array([-0.3, 0.0, 0.1]), np.eye(3), 1),
             (2, 3, np.zeros(3), np.eye(3), 0)]
    want = [np.linalg.norm((np.asarray(jse2.relative(
        jnp.asarray(est[i], jnp.float32), jnp.asarray(est[j], jnp.float32)))
        - t)[:2]) for i, j, t, _, k in edges if k == 1]
    np.testing.assert_allclose(slam_scale.loop_residuals(edges, est, 1), want,
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(slam_scale.loop_residuals(edges, est, 2),
                                  np.zeros(1))


def test_slam_pass_runs_without_the_reference_package(tmp_path):
    """The SLAM pass as users run it, `tools/run_slam_scale_torch.py`
    (odometry, the graph with payloads, loop closure, the optimizer), runs
    on the CPU in the guarded process and writes its report; the
    loop-closure and pose-graph modules import nothing of the reference."""
    script = _GUARD + textwrap.dedent(r"""
        import importlib.util
        from cfear_radarodometry_code_public_tpu_torch.models import (
            loopclosure, posegraph)
        spec = importlib.util.spec_from_file_location(
            "run_slam_scale_torch",
            os.path.join(sys.argv[1], "tools", "run_slam_scale_torch.py"))
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        out = os.path.join(sys.argv[2], "slam.txt")
        res = tool.main(["--cpu", "--frames", "16", "--lap-frames", "16",
                         "--max-cells", "256", "--iters", "2",
                         "--cg-iters", "5", "--out", out])
        assert res["n_kf"] >= 3, res
        with open(out) as f:
            assert "keyframe ATE" in f.read()
    """) + _NONE_LOADED
    _run_guarded(script, str(tmp_path))


def test_sweep_equals_the_reference(tmp_path):
    """`parallel/sweep.py` is the reference's file but for the CLI it runs:
    the same ablation grids and grid expansion, the same job directories,
    and the same merged CSV, byte for byte."""
    from cfear_radarodometry_code_public_tpu.parallel import sweep as jsweep
    from cfear_radarodometry_code_public_tpu_torch.parallel import (
        sweep as tsweep)

    def lines(mod):
        with open(mod.__file__) as f:
            return f.read().splitlines()

    diff = [(a, b) for a, b in zip(lines(tsweep), lines(jsweep)) if a != b]
    assert len(lines(tsweep)) == len(lines(jsweep))
    assert diff == [(
        "    from cfear_radarodometry_code_public_tpu_torch import "
        "offline_odometry",
        "    from cfear_radarodometry_code_public_tpu import offline_odometry")]
    assert tsweep.ABLATIONS == jsweep.ABLATIONS
    for grid in tsweep.ABLATIONS.values():
        assert tsweep.expand_grid(grid) == jsweep.expand_grid(grid)
    grid = tsweep.ABLATIONS["filter"]
    # a worker that owns none of the 12 jobs runs none and lists them all
    assert tsweep.run_sweep(str(tmp_path), grid, [], 13, 12) == \
        jsweep.run_sweep(str(tmp_path), grid, [], 13, 12)
    for k in (0, 1, 3):
        job = tmp_path / "grid" / f"job_{k}"
        (job / "est").mkdir(parents=True)
        (job / "pars.txt").write_text(f"k_strongest, {12 + k}\nz_min, 60\n")
        if k != 1:
            (job / "est" / "result.txt").write_text(f"ate_m: 0.{k}1\n")
    paths = [str(tmp_path / f"{w}.csv") for w in ("port", "reference")]
    assert tsweep.merge(str(tmp_path), paths[0]) == \
        jsweep.merge(str(tmp_path), paths[1]) == 3
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


def test_merge_and_parallel_run_without_the_reference_package(tmp_path):
    """In the guarded process: the offline CLI writes a session graph, the
    merge CLI folds it into a copy of itself (every node matches its twin
    and its neighbours, so the alignment is near the identity), `close_and_optimize`'s edge-sharded
    solve on a mesh of one process, the segment runner, `shard_jobs` and
    the sweep's grid."""
    script = _GUARD + textwrap.dedent(r"""
        import dataclasses
        import numpy as np
        import cfear_radarodometry_code_public_tpu_torch as port
        from cfear_radarodometry_code_public_tpu_torch import (
            merge_sessions, offline_odometry)
        from cfear_radarodometry_code_public_tpu_torch.datasets import synthetic
        from cfear_radarodometry_code_public_tpu_torch.models import (
            multisession, posegraph)
        from cfear_radarodometry_code_public_tpu_torch.parallel import (
            distributed, mesh, pgo, segments, sweep)
        out = sys.argv[2]
        cfg = port.preset("CFEAR-3", dataset="synthetic")
        cfg = cfg.replace(
            feature=dataclasses.replace(cfg.feature, max_cells=512,
                                        point_budget=2048),
            filter=dataclasses.replace(cfg.filter, k_strongest=12))
        cfg.save(os.path.join(out, "cfg.json"))
        offline_odometry.main([
            "--config-file", os.path.join(out, "cfg.json"), "--dataset",
            "synthetic", "--seed", "3", "--n-frames", "6", "--cpu",
            "--output-dir", os.path.join(out, "run")])
        g = os.path.join(out, "run", "simple_graph.npz")
        k = len(posegraph.GraphBuilder.load(g).poses)
        res = merge_sessions.main([g, g, "--out", os.path.join(out, "m.npz"),
                                   "--max-cells", "512", "--cpu"])
        assert res["n_nodes"] == 2 * k and res["n_cross"] >= 2, res
        assert np.abs(res["t_ab"]).max() < 0.5, res
        m = mesh.make_mesh(device="cpu")
        graph = posegraph.GraphBuilder.load(os.path.join(out, "m.npz")
                                            ).to_arrays(device="cpu")
        got, _ = pgo.distributed_optimize(graph, m, iters=2)
        want, _ = posegraph.optimize(graph, iters=2)
        assert bool((got.poses == want.poses).all())
        images, _ = synthetic.make_sequence(seed=3, n_frames=8, cfg=cfg)
        traj = segments.run_segmented(images, cfg, 2, 2, chunk=4,
                                      device="cpu")
        assert traj.shape == (8, 3) and np.isfinite(traj).all()
        assert distributed.shard_jobs(list(range(5)), 2, 1) == [1, 3]
        assert len(sweep.expand_grid(sweep.ABLATIONS["filter"])) == 12
    """) + _NONE_LOADED
    _run_guarded(script, str(tmp_path))


# A process in which importing JAX or any module of the reference package,
# opening any file under its directory or under `native/`, and loading a
# library from there all fail (sys.argv[1] is the repository root).
_GUARD = textwrap.dedent(r"""
    import os, sys
    REF = os.path.join(sys.argv[1], "cfear_radarodometry_code_public_tpu")
    NATIVE = os.path.join(sys.argv[1], "native")
    BLOCKED = (REF + os.sep, NATIVE + os.sep)

    def guard(event, args):
        if event == "import" and args[0].split(".")[0] in (
                "jax", "jaxlib", "cfear_radarodometry_code_public_tpu"):
            raise ImportError(f"blocked in this test: {args[0]}")
        if event in ("open", "ctypes.dlopen") and args and isinstance(
                args[0], (str, bytes, os.PathLike)):
            path = os.path.abspath(os.fsdecode(args[0]))
            if path.startswith(BLOCKED):
                raise PermissionError(f"blocked in this test: {path}")

    sys.addaudithook(guard)
""")
# ...and afterwards no module in sys.modules has a file under the blocked
# directories
_NONE_LOADED = textwrap.dedent(r"""
    bad = [m for m, mod in list(sys.modules.items())
           if m.split(".")[0] in ("jax", "jaxlib",
                                  "cfear_radarodometry_code_public_tpu")
           or os.path.abspath(getattr(mod, "__file__", None) or "/"
                              ).startswith(BLOCKED)]
    assert not bad, bad
    print("SELF-CONTAINED-OK")
""")


def _run_guarded(script, *args):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script, REPO, *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SELF-CONTAINED-OK" in proc.stdout


def test_both_cfgs_go_through_the_port_config():
    """The port's config classes are its own (not the reference's), and a
    configuration crosses between the two by `to_dict` unchanged."""
    cfg_j = ref.preset("CFEAR-3-s50", dataset="oxford")
    cfg_j = cfg_j.replace(odometry=dataclasses.replace(
        cfg_j.odometry, health_check_every=8, estimate_cov_by_sampling=True))
    _, cfg_t = both_cfgs(cfg_j)
    assert type(cfg_t) is port.CFEARConfig
    assert type(cfg_t).__module__ == "cfear_radarodometry_code_public_tpu_torch.config"
    assert cfg_t.to_dict() == cfg_j.to_dict()


def test_stats_equal_the_reference():
    """`Statistics` reports (`present`, `csv`, mean, sigma, count) equal
    the reference's on the same values; the timer documents milliseconds
    under its name."""
    got, want = tstats.Statistics(), jstats.Statistics()
    rng = np.random.default_rng(1)
    for name in ("register", "Filtering", "itrs"):
        for v in rng.normal(10, 3, 7):
            got.Document(name, v)
            want.document(name, v)
    got.document("single", 2.5)
    want.document("single", 2.5)
    assert got.present() == want.present()
    assert got.csv() == want.csv()
    for name in ("register", "single", "absent"):
        np.testing.assert_array_equal(
            [got.mean(name), got.sigma(name), got.count(name)],
            [want.mean(name), want.sigma(name), want.count(name)])
    with got.timer("t"):
        pass
    assert got.count("t") == 1 and got.mean("t") >= 0.0
    got.clear()
    assert got.csv() == "" and isinstance(tstats.timing, tstats.Statistics)


def _png(path, img):
    from PIL import Image
    Image.fromarray(img).save(path)


def test_oxford_and_mulran_loaders_equal_the_reference(tmp_path):
    """On the same fixture directories: Oxford sweeps with their 11
    metadata columns, MulRan range-major sweeps, and both ground-truth CSV
    formats load to the reference's arrays and stamps."""
    rng = np.random.default_rng(2)
    ox, mu = tmp_path / "oxford", tmp_path / "mulran"
    ox.mkdir()
    mu.mkdir()
    for k in range(3):
        _png(str(ox / f"{1547120000000000 + k * 250000}.png"),
             rng.integers(0, 256, (400, 11 + 3768), dtype=np.uint8))
        _png(str(mu / f"{1566000000000000000 + k * 250000000}.png"),
             rng.integers(0, 256, (512, 400), dtype=np.uint8))
    for name in ("oxford_frames", "mulran_frames"):
        d = str(ox if name == "oxford_frames" else mu)
        got = list(getattr(tox, name)(d))
        want = list(getattr(jox, name)(d))
        assert len(got) == len(want) == 3
        for (t, a), (u, b) in zip(got, want):
            assert t == u and a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
    img = rng.integers(0, 256, (5, 7), dtype=np.uint8)
    np.testing.assert_array_equal(tox.rotate_90_ccw(img),
                                  jox.rotate_90_ccw(img))
    ro = tmp_path / "radar_odometry.csv"
    rows = rng.normal(0, 1, (6, 8))
    rows[:, 0] = 1547120000000000 + np.arange(6) * 250000
    rows[:, 1] = rows[:, 0] + 250000
    np.savetxt(ro, rows, delimiter=",", fmt="%.9f",
               header="source_radar_timestamp,destination_radar_timestamp,"
                      "x,y,z,roll,pitch,yaw", comments="")
    xy = tmp_path / "gt.csv"
    np.savetxt(xy, rng.normal(0, 5, (6, 4)), delimiter=",", fmt="%.9f",
               header="stamp,x,y,yaw", comments="")
    for path in (ro, xy):
        for a, b in zip(tox.load_gt_csv(str(path)),
                        jox.load_gt_csv(str(path))):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        next(tox.oxford_frames(str(tmp_path / "absent")))


def test_trajectory_module_equals_the_reference(tmp_path):
    """The writers give the reference's files byte for byte; the reader,
    the ground-truth interpolation, the angle difference, the Umeyama
    alignment (with and without scale), the ATE and the sequence names
    give the reference's values."""
    rng = np.random.default_rng(4)
    n = 30
    est = np.cumsum(rng.normal(0, 0.5, (n, 3)), 0)
    stamps = 1547120000.0 + np.arange(n) * 0.25 + rng.uniform(0, 0.01, n)
    covs = rng.normal(0, 1e-3, (n, 3, 3))
    gt = est + rng.normal(0, 0.05, (n, 3))
    for mod, sub in ((ttraj, "port"), (jtraj, "ref")):
        mod.save_trajectories(str(tmp_path / sub), "07", stamps, est,
                              covs=covs, gt_xyt=gt)
    for rel in ("est/07.txt", "est/07_tum.txt", "est/07_cov.txt",
                "gt/07.txt", "gt/07_tum.txt"):
        assert (tmp_path / "port" / rel).read_bytes() ==             (tmp_path / "ref" / rel).read_bytes(), rel
    path = str(tmp_path / "port" / "est" / "07.txt")
    np.testing.assert_array_equal(ttraj.read_kitti(path),
                                  jtraj.read_kitti(path))
    np.testing.assert_array_equal(ttraj.poses_to_matrices(est),
                                  jtraj.poses_to_matrices(est))
    gt_stamps = stamps[::3] + 0.05
    for a, b in zip(ttraj.interpolate_gt(stamps, gt_stamps, gt[::3]),
                    jtraj.interpolate_gt(stamps, gt_stamps, gt[::3])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ttraj.se2_angle_diff(est[:, 2], gt[:, 2]),
                                  jtraj.se2_angle_diff(est[:, 2], gt[:, 2]))
    for scale in (False, True):
        for a, b in zip(ttraj.umeyama_align(est[:, :2], gt[:, :2], scale),
                        jtraj.umeyama_align(est[:, :2], gt[:, :2], scale)):
            np.testing.assert_array_equal(a, b)
    assert ttraj.ate_rmse(est[:, :2], gt[:, :2]) == \
        jtraj.ate_rmse(est[:, :2], gt[:, :2])
    for name in ("2019-01-10-14-36-48-radar-oxford-10k-partial", "other"):
        assert ttraj.dataset_to_sequence(name) == \
            jtraj.dataset_to_sequence(name)


def test_viz_equals_the_reference(tmp_path):
    """The port's plotting functions (those its CLIs call) are the
    reference's, line for line, and write the reference's figure byte for
    byte on the same inputs."""
    import inspect

    from cfear_radarodometry_code_public_tpu.eval import viz as jviz
    from cfear_radarodometry_code_public_tpu_torch.eval import viz as tviz
    for name in ("_mpl", "plot_scan", "plot_trajectory"):
        assert inspect.getsource(getattr(tviz, name)) == \
            inspect.getsource(getattr(jviz, name)), name
    rng = np.random.default_rng(5)
    image = rng.integers(0, 255, (16, 64), dtype=np.uint8)
    xy = rng.normal(0, 10, (50, 2))
    est = np.cumsum(rng.normal(0, 0.5, (20, 3)), 0)
    fused = rng.random(20) < 0.3
    for mod, sub in ((tviz, "port"), (jviz, "ref")):
        mod.plot_scan(str(tmp_path / f"{sub}_scan.png"), image, xy,
                      max_range=30.0)
        mod.plot_trajectory(str(tmp_path / f"{sub}_traj.png"), est,
                            est + 0.1, fused)
    for fig in ("scan", "traj"):
        assert (tmp_path / f"port_{fig}.png").read_bytes() == \
            (tmp_path / f"ref_{fig}.png").read_bytes(), fig


def test_online_daemon_and_live_viz_equal_the_reference():
    """The framework-free parts of the online daemon (`PackFollower`,
    `_tum_line`, the pack constants) and the whole live viewer
    (`parse_tum_line`, `TumFollower`, `render_snapshot`, `main`) are the
    reference's, line for line; `_tum_line` and `parse_tum_line` give the
    reference's output on the same poses."""
    import inspect

    from cfear_radarodometry_code_public_tpu import online_odometry as jonl
    from cfear_radarodometry_code_public_tpu.eval import live_viz as jlv
    from cfear_radarodometry_code_public_tpu_torch import online_odometry as tonl
    from cfear_radarodometry_code_public_tpu_torch.eval import live_viz as tlv
    for name in ("PackFollower", "_tum_line"):
        assert inspect.getsource(getattr(tonl, name)) == \
            inspect.getsource(getattr(jonl, name)), name
    assert (tonl._HDR_BYTES, tonl._MAGIC) == (jonl._HDR_BYTES, jonl._MAGIC)
    for name in ("parse_tum_line", "TumFollower", "render_snapshot", "main"):
        assert inspect.getsource(getattr(tlv, name)) == \
            inspect.getsource(getattr(jlv, name)), name
    rng = np.random.default_rng(9)
    for stamp, xyt in zip(rng.uniform(0, 1e9, 20), rng.normal(0, 50, (20, 3))):
        line = tonl._tum_line(float(stamp), xyt)
        assert line == jonl._tum_line(float(stamp), xyt)
        assert tlv.parse_tum_line(line) == jlv.parse_tum_line(line)
    assert tlv.parse_tum_line("1 2 3") is None


def test_association_and_surface_plots_equal_the_reference(tmp_path):
    """`plot_associations` and `plot_cost_surface` are the reference's,
    line for line, and write its figures byte for byte."""
    import inspect

    from cfear_radarodometry_code_public_tpu.eval import viz as jviz
    from cfear_radarodometry_code_public_tpu_torch.eval import viz as tviz
    for name in ("plot_associations", "plot_cost_surface"):
        assert inspect.getsource(getattr(tviz, name)) == \
            inspect.getsource(getattr(jviz, name)), name
    rng = np.random.default_rng(6)
    src, tar = rng.normal(0, 10, (40, 2)), rng.normal(0, 10, (30, 2))
    idx, valid = rng.integers(0, 30, 40), rng.random(40) < 0.7
    surface = rng.random((21, 21))
    for mod, sub in ((tviz, "port"), (jviz, "ref")):
        mod.plot_associations(str(tmp_path / f"{sub}_assoc.png"), src, tar,
                              idx, valid)
        mod.plot_cost_surface(str(tmp_path / f"{sub}_surf.png"), surface,
                              (-5.0, 5.0, -5.0, 5.0))
    for fig in ("assoc", "surf"):
        assert (tmp_path / f"port_{fig}.png").read_bytes() == \
            (tmp_path / f"ref_{fig}.png").read_bytes(), fig


def test_online_entry_points_run_without_the_reference_package(tmp_path):
    """In the guarded process: the online daemon drains a pack written by
    the port's native writer (CPU), the live viewer renders its poses, the
    chunk runner steps the same frames, `--profile-stages` fills its
    table, and a grid registration runs."""
    script = _GUARD + textwrap.dedent(r"""
        import dataclasses
        import numpy as np
        import torch
        import cfear_radarodometry_code_public_tpu_torch as port
        from cfear_radarodometry_code_public_tpu_torch import (
            offline_odometry, online_odometry)
        from cfear_radarodometry_code_public_tpu_torch.datasets import synthetic
        from cfear_radarodometry_code_public_tpu_torch.eval import live_viz
        from cfear_radarodometry_code_public_tpu_torch.models import odometry
        from cfear_radarodometry_code_public_tpu_torch.utils import native_io, stats
        out = sys.argv[2]
        cfg = port.preset("CFEAR-3", dataset="synthetic")
        cfg = cfg.replace(
            feature=dataclasses.replace(cfg.feature, max_cells=256),
            filter=dataclasses.replace(cfg.filter, k_strongest=8))
        images, gt = synthetic.make_sequence(seed=3, n_frames=5, cfg=cfg)
        pack, tum = os.path.join(out, "p.radarpack"), os.path.join(out, "p.tum")
        native_io.pack_frames(pack, ((i * 0.25, images[i]) for i in range(5)), 5)
        daemon = online_odometry.OnlineOdometry(cfg, pack, tum, chunk=2,
                                                ingest="host", device="cpu")
        assert daemon.run(follow=False) == 5
        fol = live_viz.TumFollower(tum)
        assert fol.poll() == 5
        live_viz.render_snapshot(os.path.join(out, "live.png"), fol.poses)
        run = odometry.make_chunk_runner(cfg, "image")
        st, _ = odometry.make_bootstrap(cfg, "image")(
            odometry.init_state(cfg, "cpu"), torch.as_tensor(images[0]))
        st, outs = run(st, torch.as_tensor(images[1:]))
        assert outs.pose.shape == (4, 3) and bool(outs.success.all())
        t = stats.Statistics()
        offline_odometry._profile_stages(cfg, images, t, "cpu")
        assert t.count("register") == 4 and t.count("Surface points") == 4
        grid = cfg.replace(registration=dataclasses.replace(
            cfg.registration, assoc_method="grid"))
        r = odometry.OdometryRunner(grid, ingest="host", device="cpu")
        r.process(images)
        assert bool(r.frame_outputs().success.all())
    """) + _NONE_LOADED
    _run_guarded(script, str(tmp_path))
