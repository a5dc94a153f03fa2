"""The port is self-contained: its copies of the reference's framework-free
modules (`config.py`, `datasets/synthetic.py`, `utils/native_io.py` over
`csrc/cfear_io.cpp`, `eval/kitti.py`) are held equal to the reference's,
and the port runs in a process where JAX and every file of the reference
package are out of reach.

Tolerances: configs, rendered sequences and host-filter rows are compared
exactly; KITTI drift to 1e-12 (float64 sums in the same order)."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from torch_port_helpers import both_cfgs, port, ref, slice_cfg

from cfear_radarodometry_code_public_tpu.datasets import synthetic as jsyn
from cfear_radarodometry_code_public_tpu.eval import kitti as jkitti
from cfear_radarodometry_code_public_tpu.utils import native_io as jnio
from cfear_radarodometry_code_public_tpu_torch.datasets import synthetic as tsyn
from cfear_radarodometry_code_public_tpu_torch.eval import kitti as tkitti
from cfear_radarodometry_code_public_tpu_torch.utils import native_io as tnio

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
    script = textwrap.dedent(r"""
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
        bad = [m for m, mod in list(sys.modules.items())
               if m.split(".")[0] in ("jax", "jaxlib",
                                      "cfear_radarodometry_code_public_tpu")
               or os.path.abspath(getattr(mod, "__file__", None) or "/"
                                  ).startswith(BLOCKED)]
        assert not bad, bad
        print("SELF-CONTAINED-OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script, REPO], cwd=REPO,
                          env=env, capture_output=True, text=True,
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
