"""The port is self-contained: its copies of the reference's framework-free
modules (`config.py`, `datasets/synthetic.py`, `datasets/oxford.py`,
`utils/native_io.py` over `csrc/cfear_io.cpp`, `utils/stats.py`,
`eval/kitti.py`, `eval/trajectory.py`, the two functions of `eval/viz.py`
that its CLIs call) are held equal to the reference's, and the port, its
offline CLI included, runs in a process where JAX and every file of the
reference package are out of reach.

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
