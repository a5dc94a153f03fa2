"""The port's multi-session merge (`models/multisession.py`,
`merge_sessions.py`) against the JAX reference on the sessions of
`tests/test_multisession.py`.

Each session's odometry and graph (scan payloads included) is made once by
the reference, saved as `simple_graph.npz` and loaded by both packages, so
the comparison isolates the merge. Tolerances:

- the verified cross-session pairs, the inlier pairs and the refusals
  (type and message) exact;
- with the association the reference runs on the CPU (the dense
  |s|^2 + |t|^2 - 2 s.t form): each match's association count exact
  where its registered `t_ij` agrees within 1e-4 (the same solve), within
  2 otherwise (`NUM_ASSOC_SLACK`); `t_ij` within 1e-2 (`TIJ_TOL`) and the
  score within 0.1 relative (`SCORE_RTOL`). A cross-session registration
  starts from a zero translation against another session's speckle; at
  40-80 m the dense form cannot resolve two targets within ~5e-4 m^2 of
  each other, and which one wins turns on an ulp of the transformed source
  (XLA contracts the reference's `se2.transform` into FMAs where the CPU
  has them; the port rounds each product). On an AVX-512 CPU the port is
  up to 4.15e-3 from the reference, 3.8e-2 relative in score, with one
  count one apart. The reference spreads as far on the same
  inputs and CPU (`tools/reference_spread_torch.py`): its kernel A against
  its dense form, `t_ij` 5.8e-3, scores 3.8e-2 relative, one count one
  apart; with XLA limited to AVX (no FMA) against its default, 3.2e-3,
  3.8e-2 and three counts up to two apart. The bounds are about 1.7x and
  2.6x that;
- with kernel A's form on both sides (`assoc_method="pallas"`), which has
  no such tie: counts exact, `t_ij` within 5e-4 (1.3e-4 seen), scores
  within 1e-4 relative (4e-6 seen), `t_ab` within 2e-5 (4.8e-6 seen);
- `t_ab`, the mean of the inlier votes, within 5e-4 (`T_TOL`): 1.6e-4 on
  the A-B pair and 1.5e-4 on the three-session merge seen, where
  the reference's dense association and kernel A are 3.1e-4 apart;
- the port's `optimize` on the reference's joint graph within 2 mm and
  1e-4 rad of the reference's merged poses (`OPT_TOL`, the bound of
  `tests/test_torch_posegraph.py` for DCS with drift scales);
- the port's whole merge within 1 cm and 2e-4 rad of the reference's
  (`MERGE_TOL`): the edges it optimizes carry the `t_ij` above. The port
  is 4.4 mm / 3.2e-5 rad from the reference on the A-B pair; the
  reference's dense association and kernel A are 7.2 mm / 1.0e-4 rad
  apart;
- the solve sharded over two gloo processes within 5 mm and 1e-4 rad of
  the unsharded one (`MESH_TOL`): each rank sums half of every edge sum,
  and near convergence the step ladder's costs differ by that rounding
  (relative 5e-6), so GN step 2 takes another rung on the merged A-B
  graph: 2.7 mm seen, final costs 16.50820 against 16.50812. The
  reference's own two-device solve happens to take the same rungs
  (2.7e-5 m from its one-device solve).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import both_cfgs, run_ranks

from cfear_radarodometry_code_public_tpu.config import preset
from cfear_radarodometry_code_public_tpu.datasets import synthetic
from cfear_radarodometry_code_public_tpu.models import multisession as jms
from cfear_radarodometry_code_public_tpu.models import odometry as jodo
from cfear_radarodometry_code_public_tpu.models import posegraph as jpg
from cfear_radarodometry_code_public_tpu_torch.models import multisession as tms
from cfear_radarodometry_code_public_tpu_torch.models import posegraph as tpg

N_A, B_LO, B_HI = 48, 16, 44
OPT_TOL = (2e-3, 1e-4)
MERGE_TOL = (1e-2, 2e-4)
T_TOL = 5e-4
TIJ_TOL = 1e-2
SCORE_RTOL = 0.1
NUM_ASSOC_SLACK = 2
SAME_SOLVE = 1e-4
MESH_TOL = (5e-3, 1e-4)


def _cfg():
    """`tests/test_multisession.py:25`."""
    cfg = preset("CFEAR-3", dataset="synthetic")
    return cfg.replace(
        feature=dataclasses.replace(cfg.feature, max_cells=256),
        filter=dataclasses.replace(cfg.filter, k_strongest=8))


CFG_J, CFG_T = both_cfgs(_cfg())


def _render_route(world, route, cfg, seed):
    """`tests/test_multisession.py:32`."""
    imgs = []
    for i in range(len(route)):
        prev = route[i - 1] if i > 0 else route[i]
        c, s = np.cos(prev[2]), np.sin(prev[2])
        dx, dy = route[i, 0] - prev[0], route[i, 1] - prev[1]
        motion = np.array([c * dx + s * dy, -s * dx + c * dy,
                           route[i, 2] - prev[2]])
        imgs.append(synthetic.render_polar(
            world, route[i], cfg, np.random.default_rng(seed + i),
            motion=motion))
    return np.stack(imgs)


def _session(images, path):
    """The reference's odometry and graph of `images`, saved to `path`.
    Returns (path, keyframe frames)."""
    runner = jodo.OdometryRunner(CFG_J, chunk=8)
    runner.process(images)
    out = runner.frame_outputs()
    gb = jpg.build_graph_from_odometry(out, np.asarray(runner.trajectory()),
                                       images=images, cfg=CFG_J)
    gb.save(path)
    return path, np.where(np.asarray(out.fused))[0]


def _both(path):
    """(reference GraphBuilder, port GraphBuilder) of one saved graph."""
    return jpg.GraphBuilder.load(path), tpg.GraphBuilder.load(path)


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """Sessions A (48 frames), B (A's frames 16-44, fresh speckle) and C
    (A's frames 8-36) over one world, and two 12-frame sessions of other
    worlds, as `tests/test_multisession.py` builds them."""
    tmp = tmp_path_factory.mktemp("ms")
    world = synthetic.make_world(np.random.default_rng(42))
    traj_a = synthetic.make_trajectory(np.random.default_rng(43), N_A,
                                       dt=CFG_J.radar.sensor_period,
                                       speed=8.0)
    routes = {"a": traj_a, "b": traj_a[B_LO:B_HI], "c": traj_a[8:36]}
    seeds = {"a": 100, "b": 900, "c": 1700}
    res = {"routes": routes}
    for k in routes:
        res[k], res["kf_" + k] = _session(
            _render_route(world, routes[k], CFG_J, seeds[k]),
            str(tmp / f"{k}.npz"))
    for seed in (3, 4, 5):
        images, _ = synthetic.make_sequence(seed=seed, n_frames=12,
                                            cfg=CFG_J, speed=8.0)
        res[f"x{seed}"], _ = _session(images, str(tmp / f"x{seed}.npz"))
    return res


def _assert_same_matches(got, want, tij_tol=TIJ_TOL, score_rtol=SCORE_RTOL,
                         slack=NUM_ASSOC_SLACK):
    """Pairs exact; counts exact where `t_ij` agrees within SAME_SOLVE, else
    within `slack`; `t_ij` and scores within their bounds."""
    assert [(m["i_a"], m["j_b"]) for m in got] == \
        [(m["i_a"], m["j_b"]) for m in want]
    for g, w in zip(got, want):
        d = np.abs(np.asarray(g["t_ij"]) - np.asarray(w["t_ij"])).max()
        assert d <= tij_tol, (g["i_a"], g["j_b"], d)
        dn = abs(g["num_assoc"] - w["num_assoc"])
        assert dn <= (0 if d <= SAME_SOLVE else slack), \
            (g["i_a"], g["j_b"], g["num_assoc"], w["num_assoc"], d)
        assert g["score"] == pytest.approx(w["score"], rel=score_rtol)
        assert g["ring_distance"] == w["ring_distance"]


def _assert_opt_close(got, want, tol=MERGE_TOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got[:, :2] - want[:, :2]).max() <= tol[0]
    assert np.abs(got[:, 2] - want[:, 2]).max() <= tol[1]


def _rmse(opt, gt):
    return float(np.sqrt(np.mean(np.sum((opt[:, :2] - gt[:, :2]) ** 2, 1))))


@pytest.fixture(scope="module")
def pair(sessions):
    """`merge_sessions(A, B)` by both packages: ((opt, joint, inliers,
    t_ab) of the reference, the same of the port)."""
    (ja, ta), (jb, tb) = _both(sessions["a"]), _both(sessions["b"])
    return (jms.merge_sessions(ja, jb, CFG_J),
            tms.merge_sessions(ta, tb, CFG_T, device="cpu"))


def test_cross_session_matching_and_alignment(sessions):
    (ja, ta), (jb, tb) = _both(sessions["a"]), _both(sessions["b"])
    want = jms.cross_session_matches(ja, jb, CFG_J)
    got = tms.cross_session_matches(ta, tb, CFG_T, device="cpu")
    assert len(got) >= 2
    _assert_same_matches(got, want)
    t_ab, inliers = tms.align_from_matches(ta, tb, got)
    t_ab_j, inliers_j = jms.align_from_matches(ja, jb, want)
    np.testing.assert_allclose(t_ab, t_ab_j, rtol=0, atol=T_TOL)
    assert [(m["i_a"], m["j_b"]) for m in inliers] == \
        [(m["i_a"], m["j_b"]) for m in inliers_j]
    t_true = sessions["routes"]["b"][0]
    assert np.linalg.norm(t_ab[:2] - t_true[:2]) < 1.0, (t_ab, t_true)
    assert abs(np.angle(np.exp(1j * (t_ab[2] - t_true[2])))) < 0.06


def test_cross_session_matches_kernel_a_equal_the_reference(sessions):
    """Matching and alignment of A-B with kernel A's form on both sides:
    pairs and association counts exact, `t_ij` within 5e-4, scores within
    1e-4 relative, `t_ab` within 2e-5 and the inliers exact."""
    cfg_j = CFG_J.replace(registration=dataclasses.replace(
        CFG_J.registration, assoc_method="pallas"))
    cfg_t = both_cfgs(cfg_j)[1]
    (ja, ta), (jb, tb) = _both(sessions["a"]), _both(sessions["b"])
    want = jms.cross_session_matches(ja, jb, cfg_j)
    got = tms.cross_session_matches(ta, tb, cfg_t, device="cpu")
    assert len(got) >= 2
    _assert_same_matches(got, want, tij_tol=5e-4, score_rtol=1e-4, slack=0)
    t_ab, inliers = tms.align_from_matches(ta, tb, got)
    t_ab_j, inliers_j = jms.align_from_matches(ja, jb, want)
    np.testing.assert_allclose(t_ab, t_ab_j, rtol=0, atol=2e-5)
    assert [(m["i_a"], m["j_b"]) for m in inliers] == \
        [(m["i_a"], m["j_b"]) for m in inliers_j]


def test_merge_sessions_joint_optimization(sessions, pair):
    (opt_j, joint_j, inl_j, t_ab_j), (opt, joint, inl, t_ab) = pair
    ka = len(tpg.GraphBuilder.load(sessions["a"]).poses)
    assert [(e[0], e[1], e[4]) for e in joint.edges] == \
        [(e[0], e[1], e[4]) for e in joint_j.edges]
    assert joint.quality.keys() == joint_j.quality.keys()
    assert [(m["i_a"], m["j_b"]) for m in inl] == \
        [(m["i_a"], m["j_b"]) for m in inl_j]
    np.testing.assert_allclose(t_ab, t_ab_j, rtol=0, atol=T_TOL)
    _assert_opt_close(opt, opt_j)
    # the optimizer alone: the port's on the reference's joint graph
    alone, _ = tpg.optimize(tpg.PoseGraph(*(
        torch.as_tensor(np.array(a)) for a in joint_j.to_arrays())),
        iters=15)
    _assert_opt_close(alone.poses.numpy(), opt_j, OPT_TOL)
    cross = [e for e in joint.edges if e[4] == tpg.LOOP_APPEARANCE
             and (e[0] < ka) != (e[1] < ka)]
    assert len(cross) == len(inl) >= 2
    gt_b = sessions["routes"]["b"][sessions["kf_b"]]
    naive = np.stack(tpg.GraphBuilder.load(sessions["b"]).poses)
    assert _rmse(opt[ka:], gt_b) < min(1.5, 0.2 * _rmse(naive, gt_b))
    gt_a = sessions["routes"]["a"][sessions["kf_a"]]
    assert _rmse(opt[:ka], gt_a) < 1.0


_MESH_RANK = r"""
import sys
import numpy as np
import cfear_radarodometry_code_public_tpu_torch as port
from cfear_radarodometry_code_public_tpu_torch.models import (multisession,
                                                              posegraph)
from cfear_radarodometry_code_public_tpu_torch.parallel import (distributed,
                                                                mesh)
rank, n, coord, cfg_path, a, b, out = sys.argv[1:8]
distributed.initialize(coord, int(n), int(rank), device="cpu")
m = mesh.make_mesh(int(n), device="cpu")
assert (m.rank, m.size) == (int(rank), int(n))
opt, joint, inliers, t_ab = multisession.merge_sessions(
    posegraph.GraphBuilder.load(a), posegraph.GraphBuilder.load(b),
    port.CFEARConfig.load(cfg_path), mesh=m, device="cpu")
np.save(f"{out}.{rank}.npy", opt)
"""


def test_merge_sessions_distributed_mesh(sessions, pair, tmp_path):
    """The joint solve edge-sharded over two gloo processes: each rank
    holds half the edges and the same optimized poses as the unsharded
    port (within MESH_TOL) and the reference (within MERGE_TOL)."""
    cfg_path = str(tmp_path / "cfg.json")
    CFG_T.save(cfg_path)
    out = str(tmp_path / "opt")
    run_ranks(_MESH_RANK, 2, cfg_path, sessions["a"], sessions["b"], out)
    (opt_j, *_), (opt, *_) = pair
    got = [np.load(f"{out}.{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(got[0], got[1])
    _assert_opt_close(got[0], opt, MESH_TOL)
    _assert_opt_close(got[0], opt_j)


def test_merge_rejects_disjoint_sessions(sessions):
    """Sessions over different worlds refuse to merge, with the
    reference's message."""
    msgs = []
    for mod, pg, cfg, kw in ((jms, jpg, CFG_J, {}),
                             (tms, tpg, CFG_T, {"device": "cpu"})):
        with pytest.raises(ValueError, match="do not overlap") as e:
            mod.merge_sessions(pg.GraphBuilder.load(sessions["x3"]),
                               pg.GraphBuilder.load(sessions["x4"]), cfg,
                               **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_merge_many_three_sessions(sessions, pair):
    graphs = [_both(sessions[k]) for k in "abc"]
    want = jms.merge_many([g[0] for g in graphs], CFG_J)
    opt, joint, merges, offsets = tms.merge_many(
        [g[1] for g in graphs], CFG_T, device="cpu")
    ka, kb, kc = (len(g[1].poses) for g in graphs)
    assert list(offsets) == list(want[3]) == [0, ka, ka + kb]
    assert [m["session"] for m in merges] == [1, 2]
    for m, w in zip(merges, want[2]):
        np.testing.assert_allclose(m["t_ab"], w["t_ab"], rtol=0, atol=T_TOL)
        assert [(x["i_a"], x["j_b"]) for x in m["inliers"]] == \
            [(x["i_a"], x["j_b"]) for x in w["inliers"]]
    assert len(merges[1]["inliers"]) >= 2
    assert [(e[0], e[1], e[4]) for e in joint.edges] == \
        [(e[0], e[1], e[4]) for e in want[1].edges]
    _assert_opt_close(opt, want[0])
    gt_b = sessions["routes"]["b"][sessions["kf_b"]]
    gt_c = sessions["routes"]["c"][sessions["kf_c"]]
    err_b = _rmse(opt[ka:ka + kb], gt_b)
    assert err_b < 1.5 and _rmse(opt[ka + kb:], gt_c) < 1.5
    err_b_pair = _rmse(pair[1][0][ka:], gt_b)
    assert err_b < max(2.0 * err_b_pair, 1.0), (err_b, err_b_pair)


def test_merge_many_refuses_disjoint_third(sessions):
    """A third session over another world refuses to merge into A+B,
    named by its index, with the reference's message."""
    msgs = []
    for mod, pg, cfg, kw in ((jms, jpg, CFG_J, {}),
                             (tms, tpg, CFG_T, {"device": "cpu"})):
        with pytest.raises(ValueError, match="session 2") as e:
            mod.merge_many([pg.GraphBuilder.load(sessions[k])
                            for k in ("a", "b", "x5")], cfg, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="at least two"):
        tms.merge_many([tpg.GraphBuilder.load(sessions["a"])], CFG_T,
                       device="cpu")


def _cli_pair(paths, tmp_path):
    """Both CLIs over the same graphs, with the cell budget the graphs were
    built at: (reference result, port result, reference merged graph, port
    merged graph, the port's TUM path)."""
    from cfear_radarodometry_code_public_tpu import merge_sessions as jcli
    from cfear_radarodometry_code_public_tpu_torch import merge_sessions as tcli
    res, graphs = [], []
    for name, cli, pg in (("j", jcli, jpg), ("t", tcli, tpg)):
        out = str(tmp_path / f"merged_{name}.npz")
        tum = str(tmp_path / f"merged_{name}.tum")
        res.append(cli.main(list(paths) + ["--out", out, "--tum", tum,
                                           "--max-cells", "256", "--cpu"]))
        graphs.append(pg.GraphBuilder.load(out))
    return res[0], res[1], graphs[0], graphs[1], tum


def _assert_cli_agree(rj, rt, gj, gt):
    assert rt.keys() == rj.keys()
    for k in ("n_nodes", "n_cross", "n_sessions", "offsets"):
        assert rt[k] == rj[k], k
    np.testing.assert_allclose(rt["t_ab"], rj["t_ab"], rtol=0, atol=T_TOL)
    assert [(e[0], e[1], e[4]) for e in gt.edges] == \
        [(e[0], e[1], e[4]) for e in gj.edges]
    _assert_opt_close(np.stack(gt.poses), np.stack(gj.poses))


def test_merge_many_cli_three_graphs(sessions, tmp_path, capsys):
    """Both CLIs over three graphs: the same printed session lines, result
    dict and merged graph (poses within MERGE_TOL)."""
    rj, rt, gj, gt, _ = _cli_pair([sessions[k] for k in "abc"], tmp_path)
    _assert_cli_agree(rj, rt, gj, gt)
    assert rt["n_sessions"] == 3 and rt["n_cross"] >= 4
    assert len(gt.poses) == rt["n_nodes"]
    lines = capsys.readouterr().out.splitlines()
    half = len(lines) // 2
    assert [ln for ln in lines[half:] if ln.startswith("session")] == \
        [ln for ln in lines[:half] if ln.startswith("session")]


def test_merge_sessions_cli(sessions, tmp_path):
    rj, rt, gj, gt, tum = _cli_pair([sessions["a"], sessions["b"]], tmp_path)
    _assert_cli_agree(rj, rt, gj, gt)
    assert rt["n_cross"] >= 2
    rows = np.loadtxt(tum)
    assert rows.shape == (rt["n_nodes"], 8)
    np.testing.assert_allclose(
        rows, np.loadtxt(str(tum).replace("_t.tum", "_j.tum")), rtol=0,
        atol=MERGE_TOL[0])


def test_merge_cli_needs_a_card_unless_given_cpu(sessions, monkeypatch):
    from cfear_radarodometry_code_public_tpu_torch import merge_sessions as tcli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main([sessions["a"], sessions["b"], "--out", os.devnull])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tms.merge_sessions(*(tpg.GraphBuilder.load(sessions[k])
                             for k in "ab"), CFG_T)


def test_cross_session_yaw_seed_convention(tmp_path):
    """`tests/test_multisession.py:260`: session B drives A's stretch with
    headings rotated 90 degrees; both packages verify the same pairs and
    align B where it is."""
    world = synthetic.make_world(np.random.default_rng(77))
    traj_a = synthetic.make_trajectory(np.random.default_rng(78), 24,
                                       dt=CFG_J.radar.sensor_period,
                                       speed=8.0)
    route_b = traj_a[20:4:-1].copy()
    route_b[:, 2] += np.pi / 2
    pa, _ = _session(_render_route(world, traj_a, CFG_J, 500),
                     str(tmp_path / "a.npz"))
    pb, _ = _session(_render_route(world, route_b, CFG_J, 700),
                     str(tmp_path / "b.npz"))
    (ja, ta), (jb, tb) = _both(pa), _both(pb)
    want = jms.cross_session_matches(ja, jb, CFG_J)
    got = tms.cross_session_matches(ta, tb, CFG_T, device="cpu")
    assert len(got) >= 2
    _assert_same_matches(got, want)
    t_ab, _ = tms.align_from_matches(ta, tb, got)
    np.testing.assert_allclose(t_ab, jms.align_from_matches(ja, jb, want)[0],
                               rtol=0, atol=T_TOL)
    assert np.linalg.norm(t_ab[:2] - route_b[0, :2]) < 1.5
    assert abs(np.angle(np.exp(1j * (t_ab[2] - route_b[0, 2])))) < 0.1
