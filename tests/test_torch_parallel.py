"""The port's parallel layer (`parallel/`) against the JAX reference and
against the port's own single runs, mirroring `tests/test_segments.py`,
`tests/test_sharding.py` and `tests/test_multihost.py`.

Tolerances:

- `split_indices` identical; `stitch` and `_se2_mean` on the same inputs
  within 1e-5 m / 1e-6 rad (float32 SE(2) algebra in both, an ulp of
  sin/cos apart, composed along the segments);
- a fleet lane against the port's own single-sequence run of its frames
  within 1e-4 (m, rad) with identical keyframe decisions (bit-identical
  seen): the batched step does the same arithmetic at another batch
  width. Against the reference's fleet, the reference test's own bounds
  (each lane within 1 m of its ground truth, its ATE within 0.25 m of the
  reference's) and identical keyframes. On this 128 x 256 sensor (about
  45 cells a frame) the port's odometry is up to 0.139 m / 0.014 rad from
  the reference's (lane 5: one cell fewer in frames 3 and 6), where the
  reference's own dense association and kernel A spread 0.029 m; both
  end as far from the ground truth (0.249 m);
- host ingest against image ingest within 1e-6, as the reference's test;
- `run_segmented`: the reference test's bounds (ATE within 0.3 m of the
  serial run, no seam step above 3 m) and within 3 cm / 1e-3 rad
  (`SEG_TOL`) of the reference's stitched trajectory;
- over two gloo processes: `distributed_optimize` within 3e-5 m / 3e-6 rad
  of `optimize` (each rank sums its half of the edges, so the sums differ
  from one device's by f32 rounding only: 1.14e-5 m seen, where the
  reference's own two-device solve is 1.53e-5 m / 1.37e-6 rad from its
  one-device solve) and within 1e-3 m / 1e-4 rad of
  the reference's `distributed_optimize` on two devices; the fleet and
  the segments over two ranks equal one process's within 1e-5 m / 1e-6
  rad (bit-identical seen).
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_helpers import both_cfgs, run_ranks
from test_posegraph import _noisy_ring_graph
from test_slam_robustness import _poison

import jax
from cfear_radarodometry_code_public_tpu.config import preset
from cfear_radarodometry_code_public_tpu.datasets import synthetic
from cfear_radarodometry_code_public_tpu.eval.trajectory import ate_rmse
from cfear_radarodometry_code_public_tpu.parallel import mesh as jmesh
from cfear_radarodometry_code_public_tpu.parallel import pgo as jpgo
from cfear_radarodometry_code_public_tpu.parallel import segments as jseg
from cfear_radarodometry_code_public_tpu_torch.models import odometry as todo
from cfear_radarodometry_code_public_tpu_torch.models import posegraph as tpg
from cfear_radarodometry_code_public_tpu_torch.parallel import (
    distributed as tdist)
from cfear_radarodometry_code_public_tpu_torch.parallel import mesh as tmesh
from cfear_radarodometry_code_public_tpu_torch.parallel import pgo as tpgo
from cfear_radarodometry_code_public_tpu_torch.parallel import segments as tseg

SEG_TOL = (0.03, 1e-3)
SINGLE_TOL = 1e-4
MESH_TOL = (3e-5, 3e-6)
LANE_TOL = (1e-5, 1e-6)
JAX_MESH_TOL = (1e-3, 1e-4)


def _seg_cfg():
    """`tests/test_segments.py:13`."""
    cfg = preset("CFEAR-3", dataset="synthetic")
    return both_cfgs(cfg.replace(
        feature=dataclasses.replace(cfg.feature, max_cells=256),
        filter=dataclasses.replace(cfg.filter, k_strongest=8)))


def _fleet_cfg(**odo):
    """`tests/test_sharding.py:14`: the small sensor, no point budget
    (host ingest hands over candidate sets)."""
    cfg = preset("CFEAR-3", dataset="synthetic")
    radar = dataclasses.replace(cfg.radar, n_azimuths=128, n_bins=256,
                                range_res=0.6, max_distance=100.0)
    return both_cfgs(cfg.replace(
        radar=radar, feature=dataclasses.replace(cfg.feature, max_cells=256),
        filter=dataclasses.replace(cfg.filter, k_strongest=8),
        odometry=dataclasses.replace(cfg.odometry, **odo)))


def _fleet(cfg, b, t, seed0):
    seqs = [synthetic.make_sequence(seed=seed0 + s, n_frames=t, cfg=cfg)
            for s in range(b)]
    return np.stack([s[0] for s in seqs]), np.stack([s[1] for s in seqs])


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got[..., :2] - want[..., :2]).max() <= tol[0]
    assert np.abs(got[..., 2] - want[..., 2]).max() <= tol[1]


def _single(cfg, images, ingest="image"):
    r = todo.OdometryRunner(cfg, ingest=ingest, device="cpu", chunk=4)
    r.process(images)
    return r.trajectory(), r.frame_outputs()


# -- segments -----------------------------------------------------------------

@pytest.mark.parametrize("t,n,overlap", [(100, 4, 10), (50, 1, 10),
                                         (48, 3, 8), (64, 4, 8), (32, 4, 6),
                                         (7, 5, 2), (10, 3, 9)])
def test_split_indices_equal_the_reference(t, n, overlap):
    got = tseg.split_indices(t, n, overlap)
    assert got == jseg.split_indices(t, n, overlap)
    assert got[0][0] == 0 and got[-1][1] == t


def test_stitch_equals_the_reference():
    rng = np.random.default_rng(3)
    windows = tseg.split_indices(40, 3, 6)
    trajs = []
    for s, e in windows:
        steps = rng.normal(0, 1, (e - s, 3)) * [1.5, 0.2, 0.05]
        steps[0] = 0
        trajs.append(np.cumsum(steps, 0))
    _close(tseg.stitch(trajs, windows, 6), jseg.stitch(trajs, windows, 6),
           LANE_TOL)
    poses = rng.normal(0, 1, (6, 3)) * [5, 5, 0.3]
    _close(tseg._se2_mean(poses)[None], jseg._se2_mean(poses)[None],
           LANE_TOL)


def test_segmented_matches_serial_and_the_reference():
    """`tests/test_segments.py:29` through the port: 48 frames in three
    segments with an overlap of 8."""
    cfg_j, cfg_t = _seg_cfg()
    images, gt = synthetic.make_sequence(seed=41, n_frames=48, cfg=cfg_j,
                                         speed=6.0)
    t_serial, _ = _single(cfg_t, images)
    t_seg = tseg.run_segmented(images, cfg_t, n_segments=3, overlap=8,
                               chunk=8, device="cpu")
    assert t_seg.shape == t_serial.shape and np.isfinite(t_seg).all()
    ate_serial = ate_rmse(t_serial[:, :2], gt[:, :2])
    assert ate_rmse(t_seg[:, :2], gt[:, :2]) < ate_serial + 0.3
    assert np.linalg.norm(np.diff(t_seg[:, :2], axis=0), axis=1).max() < 3.0
    _close(t_seg, jseg.run_segmented(images, cfg_j, n_segments=3, overlap=8,
                                     chunk=8), SEG_TOL)


def test_segmented_on_a_mesh():
    """`tests/test_segments.py:47`: four segments on the port's mesh (one
    process on the CPU)."""
    cfg_j, cfg_t = _seg_cfg()
    images, gt = synthetic.make_sequence(seed=43, n_frames=32, cfg=cfg_j)
    t_seg = tseg.run_segmented(images, cfg_t, n_segments=4, overlap=6,
                               chunk=8, mesh=tmesh.make_mesh(device="cpu"))
    assert np.isfinite(t_seg).all()
    assert ate_rmse(t_seg[:, :2], gt[:, :2]) < 1.0


# -- the fleet ----------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet():
    """Eight 8-frame sequences of `tests/test_sharding.py:28` through the
    port's fleet (image ingest, chunk 4) and the reference's (8 devices)."""
    cfg_j, cfg_t = _fleet_cfg()
    images, gts = _fleet(cfg_j, 8, 8, 100)
    runner = tmesh.MultiSequenceRunner(cfg_t, batch=8, chunk=4, device="cpu")
    runner.process(images)
    ref = jmesh.MultiSequenceRunner(cfg_j, batch=8, mesh=jmesh.make_mesh(8),
                                    chunk=4)
    ref.process(images)
    return dict(cfg=cfg_t, images=images, gts=gts, runner=runner,
                trajs=runner.trajectories(), ref=ref.trajectories(),
                ref_fused=np.asarray(jax.tree.map(
                    lambda *xs: np.concatenate(xs, 1),
                    *ref.outputs).fused))


def test_multi_sequence_matches_single_and_the_reference(fleet):
    trajs, out = fleet["trajs"], fleet["runner"].frame_outputs()
    assert trajs.shape == (8, 8, 3)
    for s in range(8):
        err = np.linalg.norm(trajs[s, :, :2] - fleet["gts"][s][:, :2],
                             axis=1).max()
        assert err < 1.0, (s, err)
        single, sout = _single(fleet["cfg"], fleet["images"][s])
        _close(trajs[s], single, (SINGLE_TOL, SINGLE_TOL))
        np.testing.assert_array_equal(out.fused[s], sout.fused)
        ate = ate_rmse(trajs[s][:, :2], fleet["gts"][s][:, :2])
        ate_ref = ate_rmse(fleet["ref"][s][:, :2], fleet["gts"][s][:, :2])
        assert abs(ate - ate_ref) < 0.25, (s, ate, ate_ref)
    np.testing.assert_array_equal(out.fused, fleet["ref_fused"])


def test_fleet_state_layout_and_mesh_rules(fleet):
    """`tests/test_sharding.py:57`: the states carry a leading lane axis on
    the mesh's device; a mesh larger than the process group and a batch
    that does not divide over it are refused."""
    m = tmesh.make_mesh(device="cpu")
    assert (m.rank, m.size, m.group, m.axis) == (0, 1, None, "data")
    init_fn, _, shard_batch, _ = tmesh.make_batched_runner(fleet["cfg"], m)
    states = init_fn(8)
    assert states.kf_poses.shape[0] == 8
    assert states.kf_poses.device == m.device == torch.device("cpu")
    x = shard_batch(np.arange(16.0).reshape(8, 2))
    assert torch.equal(x, torch.arange(16.0, dtype=torch.float64
                                       ).reshape(8, 2))
    with pytest.raises(ValueError, match="one device each"):
        tmesh.make_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.Mesh(torch.device("cpu"), None, "data", 1, 3).lanes(8)
    assert tmesh.Mesh(torch.device("cpu"), None, "data", 1, 2).lanes(8) == \
        slice(4, 8)


def test_multi_sequence_host_ingest_matches_image_ingest(fleet):
    """`tests/test_sharding.py:68`: host ingest (candidate sets) equals
    image ingest per lane, in chunks of 3."""
    images = fleet["images"][:4, :6]
    runs = []
    for ingest in ("image", "host"):
        r = tmesh.MultiSequenceRunner(fleet["cfg"], batch=4, chunk=3,
                                      ingest=ingest, device="cpu")
        assert r.kind == ("image" if ingest == "image" else "candidates")
        r.process(images)
        runs.append(r.trajectories())
    np.testing.assert_allclose(runs[0], runs[1], rtol=0, atol=1e-6)


def test_multi_sequence_compact_ingest_and_two_calls(fleet):
    """With a point budget, host ingest hands over compact rows; feeding
    the frames in two calls equals one call."""
    cfg_t = fleet["cfg"].replace(feature=dataclasses.replace(
        fleet["cfg"].feature, point_budget=2048))
    images = fleet["images"][:2]
    r = tmesh.MultiSequenceRunner(cfg_t, batch=2, chunk=4, ingest="host",
                                  device="cpu")
    assert r.kind == "compact"
    r.process(images[:, :3])
    r.process(images[:, 3:])
    for s in range(2):
        single, _ = _single(cfg_t, images[s], "host")
        _close(r.trajectories()[s], single, (SINGLE_TOL, SINGLE_TOL))


def test_time_continuous_fleet_follows_the_single_runs():
    """Under `registration.time_continuous` the reference's batched step
    compensates twice; the port's follows its single step, so a fleet lane
    is held to the port's own single run."""
    cfg_j, cfg_t = _fleet_cfg()
    cfg_t = cfg_t.replace(registration=dataclasses.replace(
        cfg_t.registration, time_continuous=True))
    images, _ = _fleet(cfg_j, 2, 6, 300)
    r = tmesh.MultiSequenceRunner(cfg_t, batch=2, chunk=4, device="cpu")
    r.process(images)
    for s in range(2):
        single, _ = _single(cfg_t, images[s])
        _close(r.trajectories()[s], single, (SINGLE_TOL, SINGLE_TOL))


def test_fleet_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_t = _fleet_cfg()[1]
    for call in (lambda: tmesh.MultiSequenceRunner(cfg_t, batch=2),
                 lambda: tmesh.make_mesh(),
                 lambda: tseg.run_segmented(np.zeros((4, 8, 8), np.uint8),
                                            cfg_t, 2, 1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# -- the edge-sharded optimizer and the process group --------------------------

def _graphs():
    """The reference tests' poisoned 40-node ring (41 edges, so two ranks
    pad one), as the reference's arrays and the port's tensors."""
    gb, _ = _noisy_ring_graph(np.random.default_rng(0))
    _poison(gb)
    g = gb.to_arrays()
    return g, tpg.PoseGraph(*(torch.as_tensor(np.array(a)) for a in g))


def test_distributed_optimize_on_one_process_is_optimize():
    """At world size 1 the sharded solve is `optimize` bit for bit, with
    and without drift scales, and its padding is a no-op."""
    _, g = _graphs()
    m = tmesh.make_mesh(device="cpu")
    for graph in (g, g._replace(loop_scale=None)):
        want, cost = tpg.optimize(graph, iters=6, cg_iters=30)
        got, cost_d = tpgo.distributed_optimize(graph, m, iters=6,
                                                cg_iters=30)
        assert torch.equal(got.poses, want.poses)
        assert torch.equal(cost_d, cost)
    padded = tpgo._pad_edges(g, 4)
    assert padded.edge_i.shape[0] == 44
    assert not padded.edge_valid[41:].any()
    assert (padded.loop_scale[41:] == 1).all()


def test_initialize_without_a_coordinator_does_nothing(monkeypatch):
    monkeypatch.delenv("CFEAR_COORDINATOR", raising=False)
    tdist.initialize(device="cpu")
    assert not torch.distributed.is_initialized()
    assert tdist.shard_jobs(list(range(7)), 3, 1) == [1, 4]
    assert tdist.shard_jobs(list(range(3))) == [0, 1, 2]
    with pytest.raises(ValueError, match="one axis"):
        tdist.global_mesh(("host", "data"), device="cpu")


_RANK = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
from cfear_radarodometry_code_public_tpu_torch import CFEARConfig
from cfear_radarodometry_code_public_tpu_torch.models import posegraph
from cfear_radarodometry_code_public_tpu_torch.parallel import (
    distributed, mesh, pgo, segments)
rank, n, coord, data, out = sys.argv[1:6]
rank, n = int(rank), int(n)
if rank == 0:
    distributed.initialize(coord, n, rank, device="cpu")
else:           # the environment's variables, as a launcher sets them
    os.environ.update(CFEAR_COORDINATOR=coord, CFEAR_NUM_PROCESSES=str(n),
                      CFEAR_PROCESS_ID=str(rank))
    distributed.initialize(device="cpu")
m = distributed.global_mesh(device="cpu")
res = {"rank": m.rank, "size": m.size}
x = torch.arange(4.0) + 10 * rank
m.all_reduce(x)
res["all_reduce"] = x.numpy()
res["jobs"] = np.asarray(distributed.shard_jobs(list(range(7))))
z = np.load(data)
graph = posegraph.PoseGraph(*(torch.as_tensor(z[f])
                              for f in posegraph.PoseGraph._fields))
opt, cost = pgo.distributed_optimize(graph, m, iters=6, cg_iters=30)
res["opt"], res["cost"] = opt.poses.numpy(), cost.numpy()
cfg = CFEARConfig.load(z["cfg_path"].item())
fleet = mesh.MultiSequenceRunner(cfg, batch=4, chunk=4, mesh=m)
fleet.process(z["images"])
res["fleet"] = fleet.trajectories()
res["segments"] = segments.run_segmented(z["seq"], cfg, 4, 3, chunk=4,
                                         mesh=m)
dist.destroy_process_group()
np.savez(f"{out}.{rank}.npz", **res)
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One run of `_RANK` over two gloo processes, and its inputs."""
    tmp = tmp_path_factory.mktemp("ranks")
    g_ref, g = _graphs()
    cfg_j, cfg_t = _fleet_cfg()
    cfg_path = str(tmp / "cfg.json")
    cfg_t.save(cfg_path)
    images, _ = _fleet(cfg_j, 4, 5, 500)
    seq, _ = synthetic.make_sequence(seed=44, n_frames=16, cfg=cfg_j)
    data = str(tmp / "data.npz")
    np.savez(data, **{f: np.asarray(a) for f, a in g_ref._asdict().items()},
             cfg_path=cfg_path, images=images, seq=seq)
    out = str(tmp / "out")
    run_ranks(_RANK, 2, data, out)
    ranks = [dict(np.load(f"{out}.{r}.npz")) for r in range(2)]
    return dict(ranks=ranks, g_ref=g_ref, g=g, cfg=cfg_t, images=images,
                seq=seq)


def test_two_ranks_all_reduce_and_shard_jobs(two_ranks):
    """`tests/test_multihost.py:34-44` over gloo: the group has both
    processes, an all-reduce sums across them, and jobs go out by
    i % size == rank."""
    r0, r1 = two_ranks["ranks"]
    assert (int(r0["rank"]), int(r1["rank"])) == (0, 1)
    assert int(r0["size"]) == int(r1["size"]) == 2
    for r in (r0, r1):
        np.testing.assert_array_equal(r["all_reduce"], [10, 12, 14, 16])
    assert r0["jobs"].tolist() == [0, 2, 4, 6]
    assert r1["jobs"].tolist() == [1, 3, 5]


def test_two_ranks_distributed_optimize(two_ranks):
    """Edge-sharded over two ranks: both hold the same poses, within
    MESH_TOL of the port's `optimize`, within JAX_MESH_TOL of the
    reference's `distributed_optimize` on two devices, and the cost has
    dropped below a tenth of the start's (`tests/test_multihost.py:70`)."""
    r0, r1 = two_ranks["ranks"]
    np.testing.assert_array_equal(r0["opt"], r1["opt"])
    np.testing.assert_array_equal(r0["cost"], r1["cost"])
    want, _ = tpg.optimize(two_ranks["g"], iters=6, cg_iters=30)
    _close(r0["opt"], want.poses.numpy(), MESH_TOL)
    from jax.sharding import Mesh
    ref, _ = jpgo.distributed_optimize(
        two_ranks["g_ref"], Mesh(np.array(jax.devices()[:2]), ("data",)),
        iters=6, cg_iters=30)
    _close(r0["opt"], np.asarray(ref.poses), JAX_MESH_TOL)
    g = two_ranks["g"]
    done = g._replace(poses=torch.as_tensor(r0["opt"]))
    assert float(tpg.total_cost(done)) < 0.1 * float(tpg.total_cost(g))


def test_two_ranks_fleet_and_segments(two_ranks):
    """The fleet (two lanes a rank) and the segments (two a rank) over two
    ranks: every rank gathers every lane, equal to one process's run."""
    r0, r1 = two_ranks["ranks"]
    cfg = two_ranks["cfg"]
    one = tmesh.MultiSequenceRunner(cfg, batch=4, chunk=4, device="cpu")
    one.process(two_ranks["images"])
    for key, want in (("fleet", one.trajectories()),
                      ("segments", tseg.run_segmented(
                          two_ranks["seq"], cfg, 4, 3, chunk=4,
                          device="cpu"))):
        np.testing.assert_array_equal(r0[key], r1[key])
        _close(r0[key], want, LANE_TOL)
    assert r0["fleet"].shape == (4, 5, 3)
