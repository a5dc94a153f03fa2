"""The port's loop closure (`models/loopclosure.py`) against the JAX
reference on the small synthetic loop of `tests/test_loopclosure.py`.

The odometry and its graph (scan payloads included) are made once by the
reference, saved as `simple_graph.npz` and loaded by both packages, so the
comparison isolates the loop-closure pass. Tolerances:

- payload stacks exact; descriptors exact (every cell in the same ring and
  sector bin: the histograms sum integer sample counts, so any bin flip
  would show; none does);
- accepted pairs and the (i, j, type) of every constraint exact, in order;
  the association counts of LOOP_APPEARANCE edges exact and their scores
  within 1e-3 relative;
- with the association the reference runs on the CPU (the dense
  |s|^2 + |t|^2 - 2 s.t form), every edge pose within 1e-2 (`EDGE_TOL`)
  and the optimized poses of `close_and_optimize` within 0.125 m and
  3e-4 rad (`OPT_DENSE_TOL`). At 40-80 m one rounding step of that form is
  ~5e-4 m^2, so two targets nearer each other than that are a tie it
  cannot resolve, and which one wins turns on an ulp of the transformed
  source. XLA's CPU backend contracts the reference's `se2.transform` into
  FMAs where the CPU has them, the port rounds each product: on an
  AVX-512 CPU one accepted loop edge picks the other target and lands
  3.03e-3 from the reference's, and the optimized poses 4.18e-2 m /
  1.15e-4 rad. The reference itself spreads as far on the same
  inputs and CPU (`tools/reference_spread_torch.py`): its kernel A against
  its dense form, 5.7e-3 on mini-loop edges and 4.15e-2 m / 8.9e-5 rad on
  the optimized poses; with XLA limited to AVX (no FMA) against its
  default, 5.5e-4 on loop edges and 4.12e-2 m / 9.4e-5 rad. EDGE_TOL is
  under 2x the first, OPT_DENSE_TOL about 3x the largest;
- with kernel A's form (`assoc_method="pallas"`: the reference in
  interpret mode, the port's plain twin, both dx*dx + dy*dy), which has
  no such tie, the tight bounds: loop edge poses within 1e-4 (9.5e-7
  seen), the others within 1e-2 (4.6e-4 seen), the optimized poses within
  2 mm and 1e-4 rad (1.16e-3 m / 1.4e-5 rad seen).
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_helpers import both_cfgs

from cfear_radarodometry_code_public_tpu.config import preset
from cfear_radarodometry_code_public_tpu.datasets import synthetic
from cfear_radarodometry_code_public_tpu.models import loopclosure as jlc
from cfear_radarodometry_code_public_tpu.models import odometry as jodo
from cfear_radarodometry_code_public_tpu.models import posegraph as jpg
from cfear_radarodometry_code_public_tpu_torch.models import loopclosure as tlc
from cfear_radarodometry_code_public_tpu_torch.models import posegraph as tpg
from cfear_radarodometry_code_public_tpu_torch.parallel import mesh as tmesh


def _cfg():
    """`tests/test_loopclosure.py:11`."""
    cfg = preset("CFEAR-3", dataset="synthetic")
    return cfg.replace(
        feature=dataclasses.replace(cfg.feature, max_cells=256),
        filter=dataclasses.replace(cfg.filter, k_strongest=8))


def _odometry(seed, n, trajectory):
    cfg = _cfg()
    images, gt = synthetic.make_sequence(seed=seed, n_frames=n, cfg=cfg,
                                         speed=5.0, trajectory=trajectory)
    runner = jodo.OdometryRunner(cfg, chunk=8)
    runner.process(images)
    return images, gt, runner.trajectory(), runner.frame_outputs()


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """The 56-frame loop of `tests/test_loopclosure.py:18`: the reference's
    odometry and graph, saved. Returns (images, out, traj, npz path)."""
    images, _, traj, out = _odometry(51, 56, "loop")
    gb = jpg.build_graph_from_odometry(out, traj, images=images, cfg=_cfg())
    path = str(tmp_path_factory.mktemp("lc") / "simple_graph.npz")
    gb.save(path)
    return images, out, traj, path


EDGE_TOL = 1e-2
OPT_DENSE_TOL = (0.125, 3e-4)
OPT_TOL = (2e-3, 1e-4)


def _kernel_a(cfg):
    return cfg.replace(registration=dataclasses.replace(
        cfg.registration, assoc_method="pallas"))


def _closers(cfg=None):
    cfg_j, cfg_t = both_cfgs(cfg or _cfg())
    return jlc.LoopCloser(cfg_j), tlc.LoopCloser(cfg_t, device="cpu")


def _assert_same_edges(got, want, loop_atol=EDGE_TOL, other_atol=EDGE_TOL):
    assert len(got.edges) == len(want.edges)
    for e, f in zip(got.edges, want.edges):
        assert (e[0], e[1], e[4]) == (f[0], f[1], f[4])
        atol = loop_atol if e[4] == tpg.LOOP_APPEARANCE else other_atol
        np.testing.assert_allclose(np.asarray(e[2]), np.asarray(f[2]),
                                   rtol=0, atol=atol)
    assert got.quality.keys() == want.quality.keys()
    for pos, q in got.quality.items():
        assert q.keys() == want.quality[pos].keys()
        if got.edges[pos][4] == tpg.LOOP_APPEARANCE:
            assert q["num_assoc"] == want.quality[pos]["num_assoc"]
            assert q["score"] == pytest.approx(want.quality[pos]["score"],
                                               rel=1e-3)


def test_descriptors_and_bins_equal_the_reference(loop):
    """The payload stack, ring keys and sector histograms of every node,
    exactly (so no cell changes its ring or sector bin)."""
    path = loop[3]
    cj, ct = _closers()
    gj, gt = jpg.GraphBuilder.load(path), tpg.GraphBuilder.load(path)
    import jax
    import jax.numpy as jnp
    m = cj.cfg.feature.max_cells
    st_j = jax.tree.map(lambda *xs: jnp.stack(xs),
                        *[jpg.payload_to_cellmap(s, m) for s in gj.scans])
    st_t = ct.stack(gt)
    for a, b in zip(st_t, st_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rk_j, sh_j = (np.asarray(a) for a in cj._desc_fn(st_j))
    rk_t, sh_t = ct.descriptors(st_t)
    np.testing.assert_array_equal(rk_t, rk_j)
    np.testing.assert_array_equal(sh_t, sh_j)
    # one scan alone equals its row of the batch
    one = tlc._descriptors(tlc.CellMap(*(a[3] for a in st_t)), ct.cfg, ct.lc)
    np.testing.assert_array_equal(one[0].numpy(), rk_t[3])


def test_yaws_from_sectors_equal_the_reference():
    rng = np.random.default_rng(0)
    h_i, h_j = rng.random((2, 40, 60))
    h_j[:5] = np.roll(h_i[:5], 7, axis=-1)
    got = tlc._yaws_from_sectors(h_i, h_j, 60)
    np.testing.assert_array_equal(got, jlc._yaws_from_sectors(h_i, h_j, 60))
    np.testing.assert_allclose(got[:5], (60 - 7) / 60 * 2 * np.pi)
    assert [tlc._next_pow2(n) for n in (1, 8, 9, 600)] == \
        [jlc._next_pow2(n) for n in (1, 8, 9, 600)] == [8, 8, 16, 1024]


def test_close_from_graph_equals_the_reference(loop):
    """Accepted pairs and every constraint (LOOP_APPEARANCE and CANDIDATE)
    as the reference's; a precomputed stack and descriptors give the same
    pass, and stale ones raise."""
    path = loop[3]
    cj, ct = _closers()
    gj, gt = jpg.GraphBuilder.load(path), tpg.GraphBuilder.load(path)
    acc_j, acc_t = cj.close_from_graph(gj), ct.close_from_graph(gt)
    assert acc_t == acc_j and len(acc_t) >= 5
    assert gt.n_constraints(tpg.CANDIDATE) == gj.n_constraints(jpg.CANDIDATE)
    _assert_same_edges(gt, gj)

    again = tpg.GraphBuilder.load(path)
    stacked = ct.stack(again)
    rk, sh = ct.descriptors(stacked)
    assert ct.close_from_graph(again, precomputed=(stacked, rk, sh)) == acc_t
    _assert_same_edges(again, gt, loop_atol=0, other_atol=0)
    stale = tpg.GraphBuilder.load(path)
    stale.add_node(np.zeros(3))
    stale.add_scan_payload(len(stale.poses) - 1, **stale.scans[0])
    with pytest.raises(ValueError, match="stale"):
        ct.close_from_graph(stale, precomputed=(stacked, rk, sh))


def test_close_from_graph_kernel_a_equals_the_reference(loop):
    """The same pass with kernel A's form on both sides (the reference in
    interpret mode, the port's plain twin): pairs and constraints exact,
    loop edges within 1e-4, the others within 1e-2."""
    path = loop[3]
    cj, ct = _closers(_kernel_a(_cfg()))
    gj, gt = jpg.GraphBuilder.load(path), tpg.GraphBuilder.load(path)
    acc_j, acc_t = cj.close_from_graph(gj), ct.close_from_graph(gt)
    assert acc_t == acc_j and len(acc_t) >= 5
    assert gt.n_constraints(tpg.CANDIDATE) == gj.n_constraints(jpg.CANDIDATE)
    _assert_same_edges(gt, gj, loop_atol=1e-4, other_atol=1e-2)


def test_add_mini_loops_equals_the_reference(loop):
    path = loop[3]
    cj, ct = _closers()
    gj, gt = jpg.GraphBuilder.load(path), tpg.GraphBuilder.load(path)
    acc_j, acc_t = cj.add_mini_loops(gj), ct.add_mini_loops(gt)
    assert acc_t == acc_j and len(acc_t) >= 3
    assert gt.n_constraints(tpg.MINI_LOOP) == len(acc_t)
    _assert_same_edges(gt, gj)


def test_close_and_optimize_equals_the_reference(loop):
    """The whole pass from the reference's odometry outputs: payloads
    recomputed by each package, closure, optimization (15 GN iterations).
    Accepted pairs identical; optimized keyframe poses within
    OPT_DENSE_TOL (the module docstring; kernel A's form is held to 2 mm
    by `test_close_and_optimize_kernel_a_equals_the_reference`). With a
    mesh the solve runs edge-sharded."""
    images, out, traj, _ = loop
    cfg_j, cfg_t = both_cfgs(_cfg())
    opt_j, _, acc_j = jlc.close_and_optimize(images, out, traj, cfg_j,
                                             iters=15)
    opt_t, gb, acc_t = tlc.close_and_optimize(images, out, traj, cfg_t,
                                              iters=15, device="cpu")
    assert acc_t == acc_j and len(acc_t) >= 1
    _assert_opt_close(opt_t, opt_j, OPT_DENSE_TOL)
    # the solve edge-sharded over a mesh of one process: `optimize` bit for
    # bit (tests/test_torch_parallel.py holds two processes)
    opt_m, gb_m, acc_m = tlc.close_and_optimize(
        images, out, traj, cfg_t, iters=15, device="cpu",
        mesh=tmesh.make_mesh(device="cpu"))
    assert acc_m == acc_t and len(gb_m.edges) == len(gb.edges)
    np.testing.assert_array_equal(opt_m, opt_t)


def _assert_opt_close(got, want, tol):
    want = np.asarray(want)
    assert np.abs(got[:, :2] - want[:, :2]).max() <= tol[0]
    assert np.abs(got[:, 2] - want[:, 2]).max() <= tol[1]


def test_close_and_optimize_kernel_a_equals_the_reference(loop):
    """The whole pass with kernel A's form on both sides: accepted pairs
    identical, optimized keyframe poses within 2 mm and 1e-4 rad, the bound
    `test_torch_posegraph.OPT_TOL` gives DCS with drift scales."""
    images, out, traj, _ = loop
    cfg_j, cfg_t = both_cfgs(_kernel_a(_cfg()))
    opt_j, _, acc_j = jlc.close_and_optimize(images, out, traj, cfg_j,
                                             iters=15)
    opt_t, _, acc_t = tlc.close_and_optimize(images, out, traj, cfg_t,
                                             iters=15, device="cpu")
    assert acc_t == acc_j and len(acc_t) >= 1
    _assert_opt_close(opt_t, opt_j, OPT_TOL)


def test_close_computes_missing_payloads_as_the_reference(loop):
    """`LoopCloser.close` on a graph whose nodes carry no scan payloads:
    each package recomputes them from the raw sweeps, then closes; the
    accepted pairs and constraint types are the reference's."""
    images, out, _, path = loop
    kf_frames = list(np.flatnonzero(np.asarray(out.fused)))
    cj, ct = _closers()
    graphs = []
    for mod, closer in ((jpg, cj), (tpg, ct)):
        g = mod.GraphBuilder.load(path)
        g.scans = [None] * len(g.poses)
        graphs.append((g, closer.close(images, g, kf_frames)))
    (g_j, acc_j), (g_t, acc_t) = graphs
    assert acc_t == acc_j and len(acc_t) >= 5
    assert all(s is not None for s in g_t.scans)
    assert [(e[0], e[1], e[4]) for e in g_t.edges] == \
        [(e[0], e[1], e[4]) for e in g_j.edges]


def test_aliased_loop_rejected_at_defaults(tmp_path):
    """`tests/test_loopclosure.py:74` through the port: node 2's payload
    copied onto the last node of a straight run registers perfectly, and
    the odometry-consistency gate stages it as a CANDIDATE; with the gate
    off it is accepted. Both as the reference decides."""
    images, _, traj, out = _odometry(52, 40, "random")
    gb = jpg.build_graph_from_odometry(out, traj, images=images, cfg=_cfg())
    path = str(tmp_path / "simple_graph.npz")
    gb.save(path)
    cfg_j, cfg_t = both_cfgs(_cfg())
    results = []
    for lc_kw in ({}, {"max_drift_fraction": 1e9}):
        for mod, closer in ((tpg, tlc.LoopCloser(
                cfg_t, tlc.LoopCloserConfig(**lc_kw), device="cpu")),
                (jpg, jlc.LoopCloser(cfg_j, jlc.LoopCloserConfig(**lc_kw)))):
            g = mod.GraphBuilder.load(path)
            k = len(g.poses)
            g.scans[k - 1] = dict(g.scans[2])
            results.append((g, closer.close_from_graph(g)))
    (g_t, acc_t), (g_j, acc_j), (_, off_t), (_, off_j) = results
    k = len(g_t.poses)
    assert k >= 14
    assert acc_t == acc_j and off_t == off_j
    _assert_same_edges(g_t, g_j)
    assert (k - 1, 2) not in acc_t and (k - 1, 2) in off_t
    assert not g_t.constraint_exists(2, k - 1, tpg.LOOP_APPEARANCE)
    pos = g_t._index[(tpg.CANDIDATE, (2, k - 1))]
    assert g_t.quality[pos]["drift_fraction"] > 0.5


def test_loop_closer_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_t = both_cfgs(_cfg())[1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlc.LoopCloser(cfg_t)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlc.close_and_optimize(np.zeros((1, 4, 4), np.uint8), None, None,
                               cfg_t)
