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


@pytest.mark.parametrize("name", ["cli-oxford", "cli-mulran", "cli-cfear1",
                                  "cli-cfear2", "cli-cacfar", "cli-grid",
                                  "cli-raw", "cli-kvarntorp", "cli-volvo"])
def test_cli_path_golden_matches_chip_smoke(name, tmp_path, monkeypatch):
    """The golden of each `cli-*` path of chip_smoke.py was made by the
    reference CLI (`make_torch_port_golden.py --preset <path>`) with the
    path's arguments and sequence, kernel A in interpret mode (`cli-grid`:
    the reference's bucket grid): its configuration is the one the port's
    CLI builds from those arguments; every frame, no failure, a graph node
    per keyframe and an edge between consecutive ones; the sensor's
    geometry; and its bound is set."""
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)

    class Built(Exception):
        pass

    def build_config(args):
        raise Built(build(args))

    build = tcli.build_config
    monkeypatch.setattr(tcli, "build_config", build_config)
    root = str(tmp_path / "in")
    if "dataset" not in chip_smoke.CLI_PATHS[name]:
        chip_smoke.prepare_cli_path(name, root)    # the --config-file
    with pytest.raises(Built) as built:
        tcli.main(chip_smoke.cli_path_args(name, root, str(tmp_path / "run"))
                  + ["--cpu"])
    cfg = built.value.args[0]
    n = chip_smoke.cli_path_sequence(name)["n_frames"]
    with np.load(chip_smoke.cli_golden_path(name)) as z:
        assert json.loads(str(z["argv"])) == chip_smoke.cli_path_args(
            name, "<in>", "<run>")
        assert json.loads(str(z["sequence"])) == \
            chip_smoke.cli_path_sequence(name)
        assert json.loads(str(z["config"])) == cfg.to_dict()
        grid = name == "cli-grid"
        assert str(z["assoc_method"]) == ("grid" if grid else "pallas")
        assert z["poses"].shape == (n, 3) and int(z["failures"]) == 0
        assert z["success"].all() and z["fused"][0]
        assert int(z["fused"].sum()) == int(z["keyframes"]) \
            == int(z["n_nodes"]) == int(z["n_edges"]) + 1
    assert cfg.registration.assoc_method == ("grid" if grid else "auto")
    assert cfg.feature.use_raw_pointcloud == (name == "cli-raw")
    dataset = chip_smoke.CLI_PATHS[name].get("dataset", "oxford")
    assert cfg.radar.n_bins == {"mulran": 3360, "kvarntorp": 832,
                                "volvo": 832}.get(dataset, 3768)
    assert cfg.radar.ccw == (dataset != "oxford")
    assert cfg.radar.min_distance == (4.0 if dataset == "kvarntorp" else 2.5)
    assert len(chip_smoke.CLI_PATH_TOL[name]) == 3


def test_slam_dropout_golden_matches_chip_smoke():
    """The `slam-dropout` path's golden (`make_torch_port_golden.py
    --preset slam --dropout 0.35`): the `slam` configuration and
    iterations over SLAM_DROPOUT_SEQUENCE, kernel A in interpret mode, every
    frame successful, loops accepted and closure lowering the keyframe
    ATE."""
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    with np.load(chip_smoke.GOLDEN_SLAM_DROPOUT) as z:
        assert json.loads(str(z["config"])) == \
            chip_smoke.slam_config().to_dict()
        assert json.loads(str(z["sequence"])) == \
            chip_smoke.SLAM_DROPOUT_SEQUENCE
        assert json.loads(str(z["iters"])) == chip_smoke.SLAM_ITERS
        assert str(z["assoc_method"]) == "pallas"
        assert z["success"].all() and len(z["accepted"]) > 0
        assert float(z["ate_slam"]) < float(z["ate_odo"])
    assert chip_smoke.SLAM_DROPOUT_SEQUENCE["dropout_prob"] == 0.35


def test_merge3_golden_matches_chip_smoke():
    """The `merge-cli3` path's golden (`make_torch_port_golden.py --preset
    merge3`): the reference's merge CLI with the path's arguments over the
    `slam` configuration's three sessions (the closed `slam` graph,
    MERGE_SEQUENCE and MERGE3_SEQUENCE), kernel A in interpret mode: both
    merges verified with inliers, the merged graph one node a session
    node, the TUM file one line a node, and each new session's keyframe
    error under 0.2x the identity alignment's."""
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    with np.load(chip_smoke.GOLDEN_MERGE3) as z:
        assert json.loads(str(z["config"])) == \
            chip_smoke.slam_config().to_dict()
        assert json.loads(str(z["sequence"])) == chip_smoke.SLAM_SEQUENCE
        assert json.loads(str(z["merge_sequences"])) == [
            chip_smoke.MERGE_SEQUENCE, chip_smoke.MERGE3_SEQUENCE]
        assert json.loads(str(z["argv"])) == chip_smoke.merge3_args(
            ["<a>", "<b>", "<c>"], "<out>", "<tum>")
        assert str(z["assoc_method"]) == "pallas"
        nodes = z["nodes"].tolist()
        assert len(nodes) == 3 and int(z["n_nodes"]) == sum(nodes)
        assert z["offsets"].tolist() == [0, nodes[0], nodes[0] + nodes[1]]
        assert z["tum"].shape == (sum(nodes), 4)
        np.testing.assert_allclose(z["tum"][:, 1:3], z["opt_poses"][:, :2],
                                   atol=1e-6)
        for k in (1, 2):
            assert len(z[f"inliers_{k}"]) >= 3 and int(z[f"pairs_{k}"]) > 0
            assert int(z[f"fused_{k}"].sum()) == nodes[k]
            assert float(z[f"err_{k}"]) < 0.2 * float(z[f"err_identity_{k}"])
    assert len(chip_smoke.MERGE3_T_TOL) == 2


# The paper's CFEAR-1 and CFEAR-2 presets (P2L, submaps of 1 and 3),
# CFEAR-3 under CA-CFAR, with the bucket grid and with raw cells through
# both CLIs on the CPU, at `bench.py --quick`'s sensor geometry
# (`tools/tool_spread_torch.py`'s PRESETS, seed 3, 12 frames), and CFEAR-3
# at 1024 cells on 6 sweeps of a Kvarntorp and a Volvo directory (400 x
# 832). Keyframes and failed frames are compared exactly;
# poses within about 3x the reference's own spread on the same problem
# (`tools/tool_spread_torch.py --problems presets`), the largest of its
# kernel-A, AVX and op-by-op (`jax.disable_jit()`) runs' deviations from
# its dense run as this test runs it: CFEAR-1 1.05 cm, 4.87e-4 rad, 7.1 mm
# (AVX); CFEAR-2 5.37 cm, 9.09e-3 rad, 4.03 cm (op by op: the compiled
# reference fuses the image filter with the motion compensation and keeps
# one cell more in frames 2-4 and 7, which the reference run op by op and
# the port do not; the port is within 2e-6 m of the op-by-op run); CA-CFAR
# 5.31 cm, 2.27e-3 rad, 7.1 cm (AVX). The port's own deviation there:
# 0.59 mm, 5.37 cm, 4.20 cm. The bucket grid: 1.88 cm (AVX), 7.13e-4 rad,
# 1.61 cm (op by op; the port 1.45 cm, 7.13e-4, 1.60 cm). Raw cells (1024
# of them, `tool_spread_torch.PRESET_CELLS`), an ill-conditioned ablation:
# kernel A's form parts from the dense one at the points' near-ties (5
# keyframes against 4, 86 cm), so the bound is the AVX and op-by-op runs'
# spread: 0.81 mm, 8.0e-6 rad, 0.71 mm (the port 1.12 mm, 1.8e-5, 1.10 mm).
# Kvarntorp's and Volvo's 6 sweeps at 1024 cells: 9.91 mm, 1.12e-4 rad,
# 7.84 mm (kernel A; the port 9.83 mm, 1.05e-4, 7.71 mm) and 1.78 cm,
# 5.34e-4 rad, 1.55 cm (op by op; the port 1.87 cm, 6.19e-4, 1.68 cm).
PRESET_TOL = {"CFEAR-1": (0.032, 1.5e-3, 0.021),
              "CFEAR-2": (0.16, 0.027, 0.12),
              "cacfar": (0.16, 6.8e-3, 0.21),
              "grid": (0.057, 2.2e-3, 0.049),
              "raw": (0.0025, 2.4e-5, 0.0022),
              "kvarntorp": (0.030, 3.4e-4, 0.024),
              "volvo": (0.054, 1.6e-3, 0.047)}


@pytest.mark.parametrize("name", ["CFEAR-1", "CFEAR-2", "cacfar", "grid",
                                  "raw", "kvarntorp", "volvo"])
def test_preset_cli_matches_the_reference(name, tmp_path):
    """CFEAR-1, CFEAR-2, `--filter_type cacfar`, the bucket-grid
    association, `--use_raw_pointcloud` and the Kvarntorp and Volvo
    directories through the port's CLI and the reference's, both on the
    CPU (`tool_spread_torch.run_preset_cli`): every frame, identical
    keyframe and failure flags, the same configuration in both runners
    (the P2L cost and submap, the CA-CFAR filter, the grid, raw cells, the
    832-bin sensor), and poses within PRESET_TOL."""
    import importlib.util
    import sys
    from cfear_radarodometry_code_public_tpu.models.odometry import (
        OdometryRunner as JRunner)
    from cfear_radarodometry_code_public_tpu_torch.models.odometry import (
        OdometryRunner as TRunner)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "tool_spread_torch", os.path.join(repo, "tools",
                                          "tool_spread_torch.py"))
    spread = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(spread)
    import chip_smoke
    sys.path.remove(repo)
    cfg = spread.preset_cfg(name)
    want = spread.run_preset_cli(jcli, JRunner, str(tmp_path / "jax"), name,
                                 cfg)
    got = spread.run_preset_cli(tcli, TRunner, str(tmp_path / "port"), name,
                                cfg)
    n = spread.PRESET_DATASETS.get(name, spread.PRESET_FRAMES)
    assert got["poses"].shape == want["poses"].shape == (n, 3)
    assert got["result"]["frames"] == n
    np.testing.assert_array_equal(got["fused"], want["fused"])
    np.testing.assert_array_equal(got["success"], want["success"])
    assert got["result"]["keyframes"] == want["result"]["keyframes"]
    assert got["cfg"] == want["cfg"]
    c = got["cfg"]
    if name == "cacfar":
        assert c["filter"]["method"] == "cacfar"
    elif name == "grid":
        assert c["registration"]["assoc_method"] == "grid"
    elif name == "raw":
        assert c["feature"]["use_raw_pointcloud"]
    elif name in spread.PRESET_DATASETS:
        assert c["radar"]["n_bins"] == 832 and c["radar"]["ccw"]
        assert c["radar"]["min_distance"] == (4.0 if name == "kvarntorp"
                                              else 2.5)
    else:
        assert c["registration"]["cost"] == "P2L"
        assert c["odometry"]["submap_scan_size"] == (
            1 if name == "CFEAR-1" else 3)
    dpos, dyaw, dmot = chip_smoke.traj_spread(got["poses"], want["poses"])
    tol = PRESET_TOL[name]
    assert dpos <= tol[0] and dyaw <= tol[1] and dmot <= tol[2], \
        (dpos, dyaw, dmot)


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
