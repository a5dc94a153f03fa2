"""The port's offline odometry CLI (`offline_odometry.py`) against the
reference's, both with `--cpu`, on the small synthetic CFEAR-3 of
`torch_port_helpers.slice_cfg` passed with `--config-file`; its flags; and
the Oxford-loader golden of `tests/test_e2e_golden.py` through the port.

Tolerances: frame, keyframe and failure counts, the graph's node and edge
counts and the `pars.txt` keys are compared exactly; `est/00.txt` poses
within the odometry tolerance of `tests/test_torch_odometry.py` (2 cm,
2 mrad); ATE within 1 cm; the port's image and host ingest within 1e-4 of
each other (`tests/test_adaptive_zmin.py:94-95`).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import slice_cfg

from cfear_radarodometry_code_public_tpu import offline_odometry as jcli
from cfear_radarodometry_code_public_tpu.models import posegraph as jpg
from cfear_radarodometry_code_public_tpu_torch import offline_odometry as tcli
from cfear_radarodometry_code_public_tpu_torch.models import posegraph as tpg

N_FRAMES = 10
POS_TOL, YAW_TOL = 0.02, 2e-3


def _args(cfg_path, out_dir, *extra, n_frames=N_FRAMES):
    return ["--config-file", cfg_path, "--dataset", "synthetic", "--seed",
            "3", "--n-frames", str(n_frames), "--chunk", "4", "--output-dir",
            out_dir, "--cpu", *extra]


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cfg") / "slice.json")
    slice_cfg()[0].save(path)
    return path


@pytest.fixture(scope="module")
def runs(cfg_path, tmp_path_factory):
    """The reference CLI and the port CLI with the same arguments."""
    root = tmp_path_factory.mktemp("runs")
    out = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        d = str(root / name)
        out[name] = (cli.main(_args(cfg_path, d)), d)
    return out


def _kitti(run_dir):
    rows = np.loadtxt(os.path.join(run_dir, "est", "00.txt")).reshape(-1, 12)
    return rows[:, [3, 7]], np.arctan2(rows[:, 4], rows[:, 0])


def _pars_keys(run_dir):
    with open(os.path.join(run_dir, "pars.txt")) as f:
        return [line.split(",")[0] for line in f if line.strip()]


def _result_txt(run_dir):
    with open(os.path.join(run_dir, "est", "result.txt")) as f:
        return dict(line.strip().split(": ") for line in f if line.strip())


def test_cli_matches_the_reference_cli(runs):
    (res, d), (res_j, d_j) = runs["port"], runs["jax"]
    assert res.keys() == res_j.keys()
    for k in ("frames", "keyframes", "registration_failures",
              "n_subsequences"):
        assert res[k] == res_j[k], k
    assert res["frames"] == N_FRAMES and res["registration_failures"] == 0
    assert abs(res["ate_m"] - res_j["ate_m"]) < 0.01
    for k in ("t_err_percent", "r_err_deg_per_m"):
        np.testing.assert_allclose(res[k], res_j[k], rtol=0.05, atol=1e-3)
    assert _result_txt(d).keys() == _result_txt(d_j).keys()
    xy, yaw = _kitti(d)
    xy_j, yaw_j = _kitti(d_j)
    assert xy.shape == (N_FRAMES, 2)
    np.testing.assert_allclose(xy, xy_j, atol=POS_TOL)
    np.testing.assert_allclose(yaw, yaw_j, atol=YAW_TOL)
    assert _pars_keys(d) == _pars_keys(d_j)
    assert sorted(os.listdir(os.path.join(d, "est"))) == \
        sorted(os.listdir(os.path.join(d_j, "est")))
    graph = os.path.join(d, "simple_graph.npz")
    g = jpg.GraphBuilder.load(graph)         # the reference reads the port's
    g_j = jpg.GraphBuilder.load(os.path.join(d_j, "simple_graph.npz"))
    assert len(g.poses) == len(g_j.poses) == res["keyframes"]
    assert len(g.edges) == len(g_j.edges) == res["keyframes"] - 1
    for s, t in zip(g.scans, g_j.scans):
        assert s.keys() == t.keys() == set(jpg.SCAN_FIELDS)
        assert len(s["cell_mean"]) == pytest.approx(len(t["cell_mean"]),
                                                    abs=3)
    assert len(tpg.GraphBuilder.load(graph).poses) == len(g.poses)


def test_cli_host_ingest_equals_image_ingest(runs, cfg_path, tmp_path):
    """`--ingest host` against the default image ingest of the same run."""
    res_img, d_img = runs["port"]
    d = str(tmp_path / "host")
    res = tcli.main(_args(cfg_path, d, "--ingest", "host"))
    assert res["keyframes"] == res_img["keyframes"]
    np.testing.assert_allclose(
        np.loadtxt(os.path.join(d, "est", "00.txt")),
        np.loadtxt(os.path.join(d_img, "est", "00.txt")), atol=1e-4)


def test_cli_no_save_graph_job_nr_and_trace(cfg_path, tmp_path):
    """`--no-save-graph` writes no graph; `--job_nr` puts the outputs under
    job_<n>; `--trace DIR` writes a torch.profiler trace there."""
    root, trace = str(tmp_path / "sweep"), str(tmp_path / "trace")
    res = tcli.main(_args(cfg_path, root, "--no-save-graph", "--job_nr", "3",
                          "--trace", trace, n_frames=4))
    job = os.path.join(root, "job_3")
    assert res["frames"] == 4
    assert os.path.exists(os.path.join(job, "est", "result.txt"))
    assert os.path.exists(os.path.join(job, "pars.txt"))
    assert not os.path.exists(os.path.join(job, "simple_graph.npz"))
    with open(os.path.join(trace, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert {"Filtering", "build_normals", "register"} <= {
        e.get("name") for e in events}


def test_cli_config_file_round_trip(cfg_path, tmp_path):
    """The configuration passed with `--config-file` is the one that runs,
    with flag overrides on top, as in the reference: every
    `section.field` line of `pars.txt` is the file's value."""
    d = str(tmp_path / "cfg")
    tcli.main(_args(cfg_path, d, "--k_strongest", "10", "--no-save-graph",
                    n_frames=3))
    cfg = slice_cfg()[1]
    cfg = cfg.replace(filter=dataclasses.replace(cfg.filter, k_strongest=10))
    with open(os.path.join(d, "pars.txt")) as f:
        pars = dict(line.rstrip("\n").split(", ", 1) for line in f
                    if ", " in line)
    n = 0
    for section in ("radar", "filter", "feature", "registration",
                    "odometry"):
        for field in dataclasses.fields(getattr(cfg, section)):
            value = getattr(getattr(cfg, section), field.name)
            assert pars[f"{section}.{field.name}"] == str(value), field.name
            n += 1
    assert n > 60 and pars["filter.k_strongest"] == "10"


STAGES = ("Filtering", "compensate", "build_normals", "register")
ROWS = ("Surface points", "itrs")


def test_cli_refuses_profile_stages_and_needs_a_card(cfg_path, tmp_path,
                                                     monkeypatch):
    """`--profile-stages` is ported: with `--cpu` it writes the stage
    timings and documented rows into `pars.txt`'s table, as the
    reference's CLI does with the same arguments (its rows compared by
    name; `test_profile_stages_matches_the_reference` holds the values).
    Without `--cpu` and without a card the CLI raises."""
    for cli, sub in ((tcli, "p"), (jcli, "pj")):
        d = str(tmp_path / sub)
        cli.main(_args(cfg_path, d, "--profile-stages", n_frames=4))
        keys = set(_pars_keys(d))
        assert set(STAGES + ROWS) <= keys, keys
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in _args(cfg_path, str(tmp_path / "c"), n_frames=2)
            if a != "--cpu"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(args)


def test_profile_stages_matches_the_reference():
    """`_profile_stages` on the first 8 frames of the CLI's sequence, on the
    CPU, against the reference's: the same stage names and documented rows
    with the same counts (7 frames after the bootstrap frame), "Surface
    points" identical frame by frame; "itrs" (outer registration
    iterations) within one of the reference's, frame by frame: the outer
    loop stops on a relative score change below `score_tolerance`, which
    f32 sum order can move by an iteration (poses within the odometry
    tolerance of `tests/test_torch_odometry.py`, as `test_image_ingest_
    matches_jax` holds them)."""
    from cfear_radarodometry_code_public_tpu.datasets import synthetic
    from cfear_radarodometry_code_public_tpu.utils import stats as jstats
    from cfear_radarodometry_code_public_tpu_torch.utils import stats as tstats
    cfg_j, cfg_t = slice_cfg()
    images, _ = synthetic.make_sequence(seed=3, n_frames=8, cfg=cfg_j)
    got, want = tstats.Statistics(), jstats.Statistics()
    tcli._profile_stages(cfg_t, images, got, "cpu")
    jcli._profile_stages(cfg_j, images, want)
    assert sorted(got._data) == sorted(want._data) == sorted(STAGES + ROWS)
    for name in STAGES:
        assert got.count(name) == want.count(name) == 7, name
        assert min(got._data[name]) > 0.0
    assert got._data["Surface points"] == want._data["Surface points"]
    itrs, itrs_j = np.array(got._data["itrs"]), np.array(want._data["itrs"])
    assert np.abs(itrs - itrs_j).max() <= 1, (itrs, itrs_j)
    assert itrs.min() >= 1
    assert min(got._data["Surface points"]) > 50


@pytest.mark.parametrize("filter_type", ["kstrong", "cacfar"])
def test_radar_filter_cli_matches_the_reference(filter_type, tmp_path):
    """The standalone filter CLI (`radar_filter.py`), both with `--cpu`:
    per frame the same point counts, intensities and peak flags, and each
    point within 1e-5 m plus 1e-6 of its range (the reference's jitted
    filter computes the azimuth angle with fused f32 arithmetic, an ulp
    from the port's; `tests/test_torch_posegraph._assert_payloads_close`);
    `--plot` writes the first frame's figure."""
    from cfear_radarodometry_code_public_tpu import radar_filter as jrf
    from cfear_radarodometry_code_public_tpu_torch import radar_filter as trf
    out = {}
    for name, cli in (("jax", jrf), ("port", trf)):
        out[name] = str(tmp_path / f"{name}.npz")
        args = ["--n-frames", "2", "--filter_type", filter_type, "--cpu",
                "--output", out[name]]
        if name == "port":
            args += ["--plot", str(tmp_path / "frame0.png")]
        cli.main(args)
    with np.load(out["port"]) as got, np.load(out["jax"]) as want:
        assert set(got.files) == set(want.files)
        np.testing.assert_array_equal(got["stamps"], want["stamps"])
        for i in range(2):
            for k in (f"intensity_{i}", f"peaks_{i}"):
                np.testing.assert_array_equal(got[k], want[k], k)
            a, b = got[f"xy_{i}"], want[f"xy_{i}"]
            assert a.shape == b.shape and len(a) > 100
            dist = np.linalg.norm(a - b, axis=-1)
            assert (dist <= 1e-5 + 1e-6 * np.linalg.norm(b, axis=-1)).all()
        assert got["peaks_0"].any() == (filter_type == "kstrong")
    assert os.path.getsize(tmp_path / "frame0.png") > 0


def test_eval_trajectories_cli_matches_the_reference(runs, tmp_path):
    """`eval_trajectories.py` on the port CLI's run directory, aligned, as
    the reference's: the same result lines, and the plot written."""
    from cfear_radarodometry_code_public_tpu import eval_trajectories as jet
    from cfear_radarodometry_code_public_tpu_torch import (
        eval_trajectories as tet)
    _, d = runs["port"]
    texts = []
    for cli, name in ((tet, "port"), (jet, "jax")):
        path = str(tmp_path / f"{name}.txt")
        args = ["--est", d, "--align", "se2", "--output", path]
        if name == "port":
            args += ["--plot", str(tmp_path / "traj.png")]
        cli.main(args)
        with open(path) as f:
            texts.append(f.read())
    assert texts[0] == texts[1] and "ate_m: " in texts[0]
    assert os.path.getsize(tmp_path / "traj.png") > 0


def test_cli_golden_matches_chip_smoke():
    """The golden of chip_smoke.py's `cli` path was made by the reference
    CLI (`make_torch_port_golden.py --preset cli`) with chip_smoke's
    arguments and configuration: every frame, no failure, a graph node per
    keyframe and an edge between consecutive ones."""
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    n = chip_smoke.CLI_SEQUENCE["n_frames"]
    with np.load(chip_smoke.GOLDEN_CLI) as z:
        assert json.loads(str(z["config"])) == chip_smoke.cli_config().to_dict()
        assert json.loads(str(z["sequence"])) == chip_smoke.CLI_SEQUENCE
        argv = json.loads(str(z["argv"]))
        assert argv == chip_smoke.cli_args(argv[1], "x")[:-2] + ["--cpu"]
        assert z["poses"].shape == (n, 3) and int(z["failures"]) == 0
        assert z["fused"][0] and int(z["fused"].sum()) == int(z["keyframes"])
        assert int(z["n_nodes"]) == int(z["keyframes"]) \
            == int(z["n_edges"]) + 1
    cfg = chip_smoke.cli_config()
    assert cfg.registration.assoc_method == "auto"
    assert not cfg.feature.spatial_sort and cfg.radar.n_bins == 3768


@pytest.mark.slow
def test_oxford_loader_to_result_txt_golden(tmp_path):
    """`tests/test_e2e_golden.py:81-114` through the port: the Oxford
    directory written from the simulator, the whole CLI on it, ATE < 0.18 m
    over 12 frames, no failures, and the three files."""
    from test_e2e_golden import N_FRAMES as OX_FRAMES, _write_oxford_fixture

    radar_dir, gt_csv, gt = _write_oxford_fixture(str(tmp_path))
    out_dir = str(tmp_path / "run")
    result = tcli.main([
        "--dataset", "oxford", "--radar-dir", radar_dir,
        "--gt-csv", gt_csv, "--output-dir", out_dir,
        "--preset", "CFEAR-3", "--chunk", "4", "--cpu"])
    assert result["frames"] == OX_FRAMES == 12
    assert result["registration_failures"] == 0
    assert result["ate_m"] < 0.18, result
    assert os.path.exists(os.path.join(out_dir, "est", "result.txt"))
    assert os.path.exists(os.path.join(out_dir, "pars.txt"))
    rows = np.loadtxt(os.path.join(out_dir, "est", "00.txt")).reshape(-1, 12)
    assert rows.shape[0] == OX_FRAMES


@pytest.mark.slow
def test_mulran_loader_to_result_txt_golden(tmp_path):
    """`tests/test_e2e_golden_mulran.py:86-122` through the port: the
    MulRan directory written from the simulator (range-major PNGs that the
    loader turns with `rotate_90_ccw`, the CCW scan-time convention, a
    generic `stamp,x,y,yaw` CSV ground truth), the whole CLI on it at
    MulRan's sensor scale: every frame, no failures, ATE < 0.21 m over 12
    frames, and the end pose within 2% of the path of the ground truth's."""
    from test_e2e_golden_mulran import (N_FRAMES as MR_FRAMES,
                                        _write_mulran_fixture)

    radar_dir, gt_csv, gt = _write_mulran_fixture(str(tmp_path))
    out_dir = str(tmp_path / "run")
    result = tcli.main([
        "--dataset", "mulran", "--radar-dir", radar_dir,
        "--gt-csv", gt_csv, "--output-dir", out_dir,
        "--preset", "CFEAR-3", "--chunk", "4", "--cpu"])
    assert result["frames"] == MR_FRAMES == 12
    assert result["registration_failures"] == 0
    assert result["ate_m"] < 0.21, result
    assert os.path.exists(os.path.join(out_dir, "est", "result.txt"))
    rows = np.loadtxt(os.path.join(out_dir, "est", "00.txt")).reshape(-1, 12)
    assert rows.shape[0] == MR_FRAMES
    path_len = np.sum(np.linalg.norm(np.diff(gt[:, :2], axis=0), axis=1))
    c, s = np.cos(gt[0, 2]), np.sin(gt[0, 2])
    d = gt[-1, :2] - gt[0, :2]
    end_rel = np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1]])
    assert np.linalg.norm(rows[-1, [3, 7]] - end_rel) < 0.02 * path_len
