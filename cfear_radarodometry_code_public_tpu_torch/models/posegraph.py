"""Pose graph: construction, serialization and the robust Gauss-Newton
optimizer (port of `models/posegraph.py`).

The offline odometry run writes its keyframes as a pose graph
(`simple_graph.npz`, the reference's `.sgh`): keyframe poses, chained
odometry constraints with their information matrices and the
`ConstraintsHandler` accounting (`types.cpp:133-226`), and per keyframe
the `RadarScan` payload (`types.h:93-143`: peaks cloud, filtered cloud,
oriented-surface-point map, motion), recomputed from the raw sweeps on
the device. The npz layout is the reference's, so a graph written here
loads in the reference's `GraphBuilder.load` and the reverse.

The optimizer (`optimize`) is the reference's matrix-free Gauss-Newton
with graduated non-convexity on the loop edges' robust kernel, solved by
block-Jacobi preconditioned conjugate gradients. Where the reference forms
the Hessian-vector product from `jax.jvp`/`jax.vjp` of `edge_residuals`,
the port builds each edge's two 3x3 Jacobians of `se2.relative` once per
GN step (the IRLS weight a constant in the step, the derivative of
`normalize_angle` 1): J x is then a gather and J^T y one deterministic
`features.segment_sum`, and the same Jacobians give the preconditioner's
blocks. The loops are Python loops that only queue work: nothing in a GN
or CG iteration reads a value back to the host, and two runs on the card
are bit-identical. `gn_step` takes the all-reduce of the edge-sharded
optimizer (`parallel/pgo.py`) as a hook, the identity here.
"""

from __future__ import annotations

import dataclasses
import json
from typing import NamedTuple, Optional

import numpy as np
import torch

from cfear_radarodometry_code_public_tpu_torch.models.odometry import (
    resolve_device, upload_images)
from cfear_radarodometry_code_public_tpu_torch.ops import (features,
                                                           filtering, losses)
from cfear_radarodometry_code_public_tpu_torch.ops.features import CellMap
from cfear_radarodometry_code_public_tpu_torch.utils import se2

# constraint types (`types.h:150-190`)
ODOMETRY = 0
LOOP_APPEARANCE = 1
MINI_LOOP = 2
CANDIDATE = 3

#: robust kernel of LOOP_APPEARANCE / MINI_LOOP edges and its final limit
#: in whitened units; odometry edges stay quadratic (reference
#: `posegraph.py:36-48`, where the measurements behind them are)
DEFAULT_LOOP_LOSS = "DCS"
DEFAULT_LOOP_LOSS_LIMIT = 4.0
#: graduated non-convexity: the loop limit is annealed geometrically from
#: limit * DEFAULT_GNC_START down to the limit (reference :49-56)
DEFAULT_GNC_START = 100.0
#: per-edge robust-limit drift model of loop edges (reference :57-92): the
#: translation allowance DRIFT_FRACTION * chain distance + DRIFT_SLACK_M,
#: capped at DRIFT_ALLOW_CAP_M; the yaw allowance DRIFT_YAW_SLACK_RAD +
#: DRIFT_YAW_PER_M * chain distance, capped at 0.35 rad; the whitened
#: squared allowance capped at S_ALLOW_CAP
DRIFT_FRACTION = 0.15
DRIFT_SLACK_M = 5.0
DRIFT_ALLOW_CAP_M = 25.0
DRIFT_YAW_SLACK_RAD = 0.05
DRIFT_YAW_PER_M = 0.002
S_ALLOW_CAP = 2.0e3

#: scan payloads are recomputed in chunks of this many keyframes
PAYLOAD_CHUNK = 16


class PoseGraph(NamedTuple):
    """Fixed-shape pose graph (padded, masked) of tensors."""

    poses: torch.Tensor       # (N, 3) node poses [x, y, yaw]
    node_valid: torch.Tensor  # (N,) bool
    edge_i: torch.Tensor      # (E,) int32 id_begin
    edge_j: torch.Tensor      # (E,) int32 id_end
    t_ij: torch.Tensor        # (E, 3) measured relative pose (i -> j)
    sqrt_info: torch.Tensor   # (E, 3, 3) square-root information
    edge_type: torch.Tensor   # (E,) int32
    edge_valid: torch.Tensor  # (E,) bool
    #: (E,) f32 per-edge robust-limit multiplier (1 for odometry edges)
    loop_scale: torch.Tensor = None


def _edge_scale(graph: PoseGraph):
    # per-edge robust-limit multiplier (1.0 when the graph carries none)
    if graph.loop_scale is None:
        return 1.0
    return graph.loop_scale


def _active(graph: PoseGraph):
    return graph.edge_valid & (graph.edge_type != CANDIDATE)


def _is_loop(graph: PoseGraph):
    return ((graph.edge_type == LOOP_APPEARANCE)
            | (graph.edge_type == MINI_LOOP))


def _edge_limit(graph: PoseGraph, loop_loss_limit, like):
    """The per-edge robust limit as a tensor (so every division in the
    kernel is a tensor division, as the reference's)."""
    lim = torch.as_tensor(loop_loss_limit, dtype=like.dtype,
                          device=like.device)
    return lim * _edge_scale(graph)


def _whitened(poses, graph: PoseGraph):
    """(E, 3) sqrt_info @ [se2.relative(p_i, p_j) - t_ij, angle wrapped],
    and the relative poses."""
    pi = poses.index_select(0, graph.edge_i.long())
    pj = poses.index_select(0, graph.edge_j.long())
    rel = se2.relative(pi, pj)
    d = rel - graph.t_ij
    d = torch.cat([d[:, :2], se2.normalize_angle(d[:, 2:])], 1)
    return (graph.sqrt_info * d[:, None, :]).sum(-1), rel, pi


def _irls_weight(r, graph: PoseGraph, loop_loss, loop_loss_limit):
    """rho'(s) of loop edges (1 for the others), s = |r|^2, as a constant."""
    s = (r.detach() ** 2).sum(-1)
    _, drho = losses.rho(s, loop_loss,
                         _edge_limit(graph, loop_loss_limit, s))
    return torch.where(_is_loop(graph), torch.clamp(drho, min=0.0),
                       torch.ones_like(s))


def edge_residuals(poses, graph: PoseGraph,
                   loop_loss: str = DEFAULT_LOOP_LOSS,
                   loop_loss_limit: float = DEFAULT_LOOP_LOSS_LIMIT):
    """(E, 3) weighted residuals (zeros for invalid and CANDIDATE edges):
    loop edges scaled by the IRLS weight sqrt(rho'(|r|^2)), detached."""
    r, _, _ = _whitened(poses, graph)
    if loop_loss != "None":
        w = torch.sqrt(_irls_weight(r, graph, loop_loss, loop_loss_limit))
        r = r * w.detach()[:, None]
    return torch.where(_active(graph)[:, None], r, torch.zeros_like(r))


def robust_cost(poses, graph: PoseGraph,
                loop_loss: str = DEFAULT_LOOP_LOSS,
                loop_loss_limit: float = DEFAULT_LOOP_LOSS_LIMIT):
    """The true robust objective: 0.5 * s for odometry edges and
    0.5 * rho(s) for loop edges (s the squared whitened residual); step
    acceptance compares this, not the IRLS-weighted norm (reference
    :159-187)."""
    r, _, _ = _whitened(poses, graph)
    s = (r * r).sum(-1)
    if loop_loss != "None":
        rho, _ = losses.rho(s, loop_loss,
                            _edge_limit(graph, loop_loss_limit, s))
        s = torch.where(_is_loop(graph), rho, s)
    return 0.5 * torch.where(_active(graph), s, torch.zeros_like(s)).sum()


def _gauge_fix(x):
    return torch.cat([torch.zeros_like(x[:1]), x[1:]])


def _linearize(poses, graph: PoseGraph, loop_loss, loop_loss_limit):
    """Weighted residuals r (E, 3) and their Jacobians J (E, 3, 6) in the
    poses of (node i, node j), each scaled by the edge's IRLS weight
    sqrt(rho'(s)) and zero for inactive edges."""
    r, rel, pi = _whitened(poses, graph)
    c, s = torch.cos(pi[:, 2]), torch.sin(pi[:, 2])
    z, one = torch.zeros_like(c), torch.ones_like(c)
    # d relative / d p_i and d p_j; d wrap(t) / dt = 1
    ja = torch.stack([torch.stack([-c, -s, rel[:, 1]], -1),
                      torch.stack([s, -c, -rel[:, 0]], -1),
                      torch.stack([z, z, -one], -1)], 1)
    jb = torch.stack([torch.stack([c, s, z], -1),
                      torch.stack([-s, c, z], -1),
                      torch.stack([z, z, one], -1)], 1)
    jrel = torch.cat([ja, jb], 2)                           # (E, 3, 6)
    jac = (graph.sqrt_info[:, :, :, None] * jrel[:, None]).sum(2)
    w = (torch.sqrt(_irls_weight(r, graph, loop_loss, loop_loss_limit))
         if loop_loss != "None" else torch.ones_like(c))
    w = torch.where(_active(graph), w, torch.zeros_like(w))
    r = torch.where(_active(graph)[:, None], r * w[:, None],
                    torch.zeros_like(r))
    return r, jac * w[:, None, None]


def _node_ids(graph: PoseGraph):
    """(2E,) the node of each row of a (E, 6) -> (2E, 3) reshape."""
    return torch.stack([graph.edge_i, graph.edge_j], 1).reshape(-1).long()


def _blocks(jac, graph: PoseGraph, n: int):
    """(N, 3, 3) sum over incident edges of J_k^T J_k, two segment sums."""
    ji, jj = jac[..., :3], jac[..., 3:]
    bi = (ji[:, :, :, None] * ji[:, :, None, :]).sum(1).reshape(-1, 9)
    bj = (jj[:, :, :, None] * jj[:, :, None, :]).sum(1).reshape(-1, 9)
    return (features.segment_sum(bi, graph.edge_i.long(), n)
            + features.segment_sum(bj, graph.edge_j.long(), n)
            ).reshape(n, 3, 3)


def hessian_diag_blocks(poses, graph: PoseGraph,
                        loop_loss: str = DEFAULT_LOOP_LOSS,
                        loop_loss_limit: float = DEFAULT_LOOP_LOSS_LIMIT,
                        num_nodes: int | None = None):
    """(N, 3, 3) diagonal blocks of the GN Hessian J^T J with the IRLS
    weights of `edge_residuals`: the block-Jacobi preconditioner."""
    _, jac = _linearize(poses, graph, loop_loss, loop_loss_limit)
    return _blocks(jac, graph, num_nodes or poses.shape[0])


def _block_jacobi_apply(blocks, damping: float):
    """x -> M^{-1} x for M = blockdiag(H) + damping I, node 0 the identity
    (the gauge)."""
    eye = torch.eye(3, dtype=blocks.dtype, device=blocks.device)
    m = torch.cat([eye[None], (blocks + damping * eye)[1:]])
    minv = torch.linalg.inv_ex(m)[0]      # no error check: no host sync

    def apply(x):
        return (minv * x[:, None, :]).sum(-1)

    return apply


def _where_pos(cond, x):
    return torch.where(cond, x, torch.ones_like(x))


def _cg(matvec, b, iters: int):
    """Plain conjugate gradients (fixed iteration count)."""
    x, r, p, rs = torch.zeros_like(b), b, b, (b * b).sum()
    for _ in range(iters):
        ap = matvec(p)
        denom = (p * ap).sum()
        alpha = rs / _where_pos(denom > 0, denom)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = (r * r).sum()
        beta = rs_new / _where_pos(rs > 0, rs)
        p = r + beta * p
        rs = rs_new
    return x


def _pcg(matvec, b, precond, iters: int):
    """Preconditioned conjugate gradients (fixed iteration count)."""
    z = precond(b)
    x, r, p, rz = torch.zeros_like(b), b, z, (b * z).sum()
    for _ in range(iters):
        ap = matvec(p)
        denom = (p * ap).sum()
        alpha = rz / _where_pos(denom > 0, denom)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = (r * z).sum()
        beta = rz_new / _where_pos(rz.abs() > 0, rz)
        p = z + beta * p
        rz = rz_new
    return x


#: the damped step ladder of `gn_step` (reference :276-289), ending in 0
STEP_LADDER = (1.0, 0.5, 0.25, 0.1, 0.04, 0.01)


def _identity(t):
    return t


def gn_step(poses, graph: PoseGraph, cg_iters: int = 50, damping: float = 1e-6,
            loop_loss: str = DEFAULT_LOOP_LOSS,
            loop_loss_limit: float = DEFAULT_LOOP_LOSS_LIMIT,
            reduce=_identity):
    """One Gauss-Newton step: (J^T J + damping I) dx = -J^T r by
    block-Jacobi PCG, then the best of the step ladder on the true robust
    cost (the zero step included). Returns (poses, 0.5 |r|^2, |J^T r|).

    `reduce` sums a tensor over the shards of an edge-sharded graph (the
    all-reduce of `parallel/pgo.py`; the identity for a whole graph): it is
    applied to every edge sum, the gradient, each Hessian-vector product,
    the preconditioner's blocks, the cost and the costs of the ladder."""
    n = poses.shape[0]
    r, jac = _linearize(poses, graph, loop_loss, loop_loss_limit)
    ei, ej, ids = graph.edge_i.long(), graph.edge_j.long(), _node_ids(graph)

    def jt(y):     # (E, 3) -> (N, 3)
        rows = (jac * y[:, :, None]).sum(1).reshape(-1, 3)
        return reduce(features.segment_sum(rows, ids, n))

    def hvp(x):
        x = _gauge_fix(x)
        xe = torch.cat([x.index_select(0, ei), x.index_select(0, ej)], 1)
        return _gauge_fix(jt((jac * xe[:, None, :]).sum(-1))) + damping * x

    grad = _gauge_fix(jt(r))
    precond = _block_jacobi_apply(reduce(_blocks(jac, graph, n)), damping)
    dx = _gauge_fix(_pcg(hvp, -grad, precond, cg_iters))
    cost = 0.5 * reduce((r * r).sum())
    alphas = torch.tensor(STEP_LADDER + (0.0,), dtype=poses.dtype,
                          device=poses.device)
    costs = reduce(torch.stack(
        [robust_cost(poses + a * dx, graph, loop_loss, loop_loss_limit)
         for a in STEP_LADDER]
        + [robust_cost(poses, graph, loop_loss, loop_loss_limit)]))
    best = torch.argmin(costs).reshape(1)
    new_poses = poses + alphas.index_select(0, best) * dx
    return new_poses, cost, torch.linalg.vector_norm(grad)


def gnc_limit(k, iters: int, limit: float,
              gnc_start=DEFAULT_GNC_START, anneal_len: int = 16):
    """Annealed robust limit at GN iteration k (float32): geometric from
    limit * gnc_start (k = 0) down to limit over the first
    min(iters // 2, anneal_len) iterations, then held; fewer than 4
    iterations run every iteration at the final limit (reference
    :336-366)."""
    dev = gnc_start.device if torch.is_tensor(gnc_start) else None
    f32 = dict(dtype=torch.float32, device=dev)
    n_anneal = min(iters // 2, anneal_len)
    if n_anneal <= 1:
        return torch.tensor(limit, **f32)
    kk = torch.clamp(torch.as_tensor(k, **f32), max=float(n_anneal - 1))
    frac = 1.0 - torch.div(kk, torch.tensor(float(n_anneal - 1), **f32))
    start = torch.clamp(torch.as_tensor(gnc_start, **f32), min=1.0)
    return limit * start ** frac


def adaptive_gnc_start(poses, graph: PoseGraph, loop_loss_limit: float,
                       gnc_start: float = DEFAULT_GNC_START):
    """max(gnc_start, 2 * q90(s_loop) / limit), s_loop the initial squared
    whitened loop residuals over their drift scales, so the first iteration
    is near-quadratic for >= 90% of the loop edges (reference :369-393)."""
    r0 = edge_residuals(poses, graph, loop_loss="None")
    s0 = (r0 ** 2).sum(-1)
    if graph.loop_scale is not None:
        s0 = s0 / graph.loop_scale
    is_loop = _is_loop(graph) & graph.edge_valid
    q90 = torch.nanquantile(
        torch.where(is_loop, s0, torch.full_like(s0, float("nan"))), 0.9)
    g = torch.tensor(gnc_start, dtype=torch.float32, device=s0.device)
    lim = torch.tensor(loop_loss_limit, dtype=s0.dtype, device=s0.device)
    return torch.where(torch.isnan(q90), g,
                       torch.maximum(g, 2.0 * q90 / lim)).to(torch.float32)


def anneal_start(graph: PoseGraph, loop_loss: str, loop_loss_limit: float,
                 gnc_start: float):
    """The anneal start of `optimize` (float32): no anneal with per-edge
    drift scales (`loop_scale`), the residual-quantile start without them
    (reference :405-421)."""
    f32 = dict(dtype=torch.float32, device=graph.poses.device)
    if loop_loss == "None":
        return torch.tensor(gnc_start, **f32)
    if graph.loop_scale is not None:
        return torch.tensor(1.0, **f32)
    return adaptive_gnc_start(graph.poses, graph, loop_loss_limit, gnc_start)


def gn_iterations(graph: PoseGraph, start, iters: int, cg_iters: int,
                  damping: float, loop_loss: str, loop_loss_limit: float,
                  reduce=_identity):
    """`iters` GN steps from the graph's poses at the annealed limits.
    Returns (poses, the last step's 0.5 |r|^2)."""
    poses = graph.poses
    cost = torch.zeros((), dtype=poses.dtype, device=poses.device)
    for k in range(iters):
        poses, cost, _ = gn_step(poses, graph, cg_iters, damping, loop_loss,
                                 gnc_limit(k, iters, loop_loss_limit, start),
                                 reduce)
    return poses, cost


def optimize(graph: PoseGraph, iters: int = 10, cg_iters: int = 50,
             loop_loss: str = DEFAULT_LOOP_LOSS,
             loop_loss_limit: float = DEFAULT_LOOP_LOSS_LIMIT,
             gnc_start: float = DEFAULT_GNC_START):
    """Gauss-Newton pose-graph optimization on the graph's device with
    graduated non-convexity on the loop edges' robust kernel
    (`anneal_start`; reference :396-433). Returns (graph with optimized
    poses, the last step's 0.5 |r|^2)."""
    start = anneal_start(graph, loop_loss, loop_loss_limit, gnc_start)
    poses, cost = gn_iterations(graph, start, iters, cg_iters, 1e-6,
                                loop_loss, loop_loss_limit)
    return graph._replace(poses=poses), cost


def total_cost(graph: PoseGraph, loop_loss: str = DEFAULT_LOOP_LOSS,
               loop_loss_limit: float = DEFAULT_LOOP_LOSS_LIMIT):
    r = edge_residuals(graph.poses, graph, loop_loss, loop_loss_limit)
    return 0.5 * (r * r).sum()


#: per-node scan payload fields (the information content of the reference's
#: serialized `RadarScan`, `types.h:93-143`)
SCAN_FIELDS = ("peaks_xy", "peaks_intensity", "cloud_xy", "cloud_intensity",
               "cell_mean", "cell_normal", "cell_cov", "cell_nsamples",
               "cell_planarity", "motion")


def _relative_f32(a, b) -> np.ndarray:
    """se2.relative of two poses in float32, as the reference computes it
    (`jnp.asarray` of float64 poses is float32 there)."""
    return se2.relative(torch.as_tensor(np.asarray(a), dtype=torch.float32),
                        torch.as_tensor(np.asarray(b), dtype=torch.float32)
                        ).numpy()


@dataclasses.dataclass
class GraphBuilder:
    """Accumulates keyframe poses, constraints and scan payloads; `save` and
    `load` write and read the npz that stands for the reference's `.sgh`
    (`SaveSimpleGraph`, `types.cpp:103-130`). Constraint accounting follows
    `ConstraintsHandler` (`types.cpp:133-226`): one constraint per (type,
    unordered node pair), a later one overwriting an earlier one."""

    poses: list = dataclasses.field(default_factory=list)
    stamps: list = dataclasses.field(default_factory=list)
    gt_poses: list = dataclasses.field(default_factory=list)
    has_gt: list = dataclasses.field(default_factory=list)
    edges: list = dataclasses.field(default_factory=list)  # (i, j, tij, info, type)
    scans: list = dataclasses.field(default_factory=list)  # dict | None per node
    #: per-edge quality metrics keyed by position in `edges`
    #: (`Constraint3d::quality`, `types.h:176-190`)
    quality: dict = dataclasses.field(default_factory=dict)
    # (type, (min, max)) -> position in edges, and the accumulated odometry
    # translation (`types.cpp:158-160`)
    _index: dict = dataclasses.field(default_factory=dict)
    _dist_trav: float = 0.0

    def add_node(self, pose, stamp: float = 0.0) -> int:
        self.poses.append(np.asarray(pose, np.float64))
        self.stamps.append(float(stamp))
        self.gt_poses.append(np.zeros(3))
        self.has_gt.append(False)
        self.scans.append(None)
        return len(self.poses) - 1

    def add_scan_payload(self, node: int, **fields) -> None:
        """Attach the `RadarScan` content to a node (`types.h:118-122`)."""
        unknown = set(fields) - set(SCAN_FIELDS)
        if unknown:
            raise ValueError(f"unknown scan fields {sorted(unknown)}")
        self.scans[node] = {k: np.asarray(v) for k, v in fields.items()}

    # -- ConstraintsHandler semantics (`types.cpp:133-226`) ----------------
    def _add_constraint(self, i: int, j: int, t_ij, info, kind: int,
                        quality: dict | None = None):
        if i == j:
            raise ValueError("self-constraint not allowed (types.cpp:168)")
        key = (kind, (min(i, j), max(i, j)))
        edge = (i, j, np.asarray(t_ij, np.float64), info, kind)
        if kind == ODOMETRY:   # dist_trav accumulates per Add call
            self._dist_trav += float(np.linalg.norm(edge[2][:2]))
        pos = self._index.get(key)
        if pos is None:        # map insert-or-overwrite (`types.cpp:161`)
            pos = len(self.edges)
            self._index[key] = pos
            self.edges.append(edge)
        else:
            self.edges[pos] = edge
        if quality is not None:
            self.quality[pos] = {k: float(v) for k, v in quality.items()}

    def add_odometry_edge(self, i: int, j: int, cov3: np.ndarray):
        """Odometry constraint j -> i with information cov^-1
        (`AddToGraph`, `odometrykeyframefuser.cpp:428-445`)."""
        t_ij = _relative_f32(self.poses[i], self.poses[j])
        info = np.linalg.inv(cov3 + 1e-12 * np.eye(3))
        self._add_constraint(i, j, t_ij, info, ODOMETRY)

    def add_loop_edge(self, i: int, j: int, t_ij, cov3,
                      kind: int = LOOP_APPEARANCE,
                      quality: dict | None = None):
        info = np.linalg.inv(np.asarray(cov3) + 1e-12 * np.eye(3))
        self._add_constraint(i, j, t_ij, info, kind, quality)

    def n_constraints(self, kind: int = ODOMETRY) -> int:
        """`ConstraintsHandler::size` (`types.h:234`)."""
        return sum(1 for e in self.edges if e[4] == kind)

    def find_constraint(self, i: int, j: int, kind: int = ODOMETRY):
        """`FindConstraint` (`types.cpp:183-193`): unordered (i, j) lookup."""
        pos = self._index.get((kind, (min(i, j), max(i, j))))
        return None if pos is None else self.edges[pos]

    def constraint_exists(self, i: int, j: int, kind: int = ODOMETRY) -> bool:
        return self.find_constraint(i, j, kind) is not None

    def has_constraint_type(self, node: int, kind: int) -> bool:
        """`HasConstraintType` (`types.cpp:175-181`)."""
        return any(e[4] == kind and (e[0] == node or e[1] == node)
                   for e in self.edges)

    def relative_motion(self, i: int, j: int, kind: int = ODOMETRY):
        """`RelativeMotion` (`types.cpp:213-222`): identity if absent."""
        e = self.find_constraint(i, j, kind)
        return np.zeros(3) if e is None else np.asarray(e[2])

    def relative_distance(self, i: int, j: int) -> float:
        """`RelativeDistance` (`types.cpp:223-231`): summed odometry-chain
        translation between the two nodes."""
        lo, hi = min(i, j), max(i, j)
        return float(sum(np.linalg.norm(self.relative_motion(k, k + 1)[:2])
                         for k in range(lo, hi)))

    def chain_distances(self) -> np.ndarray:
        """Prefix sums of odometry-edge lengths: (K,) with
        `relative_distance(i, j) == |out[i] - out[j]|`, in O(K) once."""
        n = len(self.poses)
        seg = np.zeros(n)
        for k in range(n - 1):
            seg[k + 1] = np.linalg.norm(self.relative_motion(k, k + 1)[:2])
        return np.cumsum(seg)

    def distance_traveled(self) -> float:
        """`DistanceTraveled` (`types.h:236`): mean odometry-edge length."""
        return self._dist_trav / (0.1 + self.n_constraints(ODOMETRY))

    def to_string(self) -> str:
        """`ConstraintsHandler::ToString` (`types.cpp:142-144`)."""
        return (f"odom constraints: {self.n_constraints(ODOMETRY)}, "
                f"loop constraints: {self.n_constraints(LOOP_APPEARANCE)}\n")

    def attach_ground_truth(self, stamps, gt_xyt, tol: float = 1e-4):
        """Match GT poses to nodes by timestamp (`AddGroundTruth`,
        `odometrykeyframefuser.cpp:446-463`)."""
        stamps = np.asarray(stamps)
        for k, t in enumerate(self.stamps):
            d = np.abs(stamps - t)
            m = int(np.argmin(d))
            if d[m] <= tol:
                self.gt_poses[k] = np.asarray(gt_xyt[m], np.float64)
                self.has_gt[k] = True

    def to_arrays(self, max_nodes: Optional[int] = None,
                  max_edges: Optional[int] = None,
                  dtype=torch.float32, device="cuda") -> PoseGraph:
        """The graph as padded tensors on `device` (the CUDA card unless
        the caller asks for the CPU). Each information matrix is
        symmetrised, its eigenvalues clipped to a small positive floor (a
        degraded registration can hand over an indefinite one) and
        factored into its square root; each loop edge gets its robust-limit
        scale from the drift allowance between its nodes."""
        device = resolve_device(device, "GraphBuilder.to_arrays")
        n = len(self.poses)
        e = len(self.edges)
        nn = max_nodes or n
        ee = max_edges or max(e, 1)
        poses = np.zeros((nn, 3))
        poses[:n] = np.stack(self.poses) if n else 0
        ei = np.zeros(ee, np.int32)
        ej = np.zeros(ee, np.int32)
        tij = np.zeros((ee, 3))
        sinfo = np.zeros((ee, 3, 3))
        etype = np.zeros(ee, np.int32)
        lscale = np.ones(ee, np.float32)
        cum = self.chain_distances() if n else np.zeros(0)
        for k, (i, j, t, info, kind) in enumerate(self.edges[:ee]):
            ei[k], ej[k] = i, j
            tij[k] = t
            s = (np.asarray(info, np.float64)
                 + np.asarray(info, np.float64).T) / 2
            w, v = np.linalg.eigh(s)
            floor = max(1e-9, 1e-9 * float(np.max(np.abs(w), initial=0.0)))
            s = (v * np.clip(w, floor, None)) @ v.T
            sinfo[k] = np.linalg.cholesky(s).T
            etype[k] = kind
            if kind in (LOOP_APPEARANCE, MINI_LOOP):
                d_chain = abs(cum[i] - cum[j])
                allow_t = min(DRIFT_FRACTION * d_chain + DRIFT_SLACK_M,
                              DRIFT_ALLOW_CAP_M)
                allow = np.array([
                    allow_t, allow_t,
                    min(DRIFT_YAW_SLACK_RAD + DRIFT_YAW_PER_M * d_chain,
                        0.35)])
                s_allow = min(float(np.sum((sinfo[k] @ allow) ** 2)),
                              S_ALLOW_CAP)
                lscale[k] = max(1.0, s_allow / DEFAULT_LOOP_LOSS_LIMIT)

        def put(a, dt=None):
            return torch.as_tensor(a, dtype=dt).to(device)

        return PoseGraph(
            poses=put(poses, dtype), node_valid=put(np.arange(nn) < n),
            edge_i=put(ei), edge_j=put(ej), t_ij=put(tij, dtype),
            sqrt_info=put(sinfo, dtype), edge_type=put(etype),
            edge_valid=put(np.arange(ee) < e), loop_scale=put(lscale))

    def save(self, path: str) -> None:
        """Serialize poses, constraints and per-node scan payloads to one
        npz; ragged per-node arrays are stored concatenated with
        `<field>_offsets` prefix-sum indices."""
        payload = dict(
            poses=np.stack(self.poses) if self.poses else np.zeros((0, 3)),
            stamps=np.asarray(self.stamps),
            gt_poses=np.stack(self.gt_poses) if self.gt_poses
            else np.zeros((0, 3)),
            has_gt=np.asarray(self.has_gt),
            edge_i=np.asarray([e[0] for e in self.edges], np.int64),
            edge_j=np.asarray([e[1] for e in self.edges], np.int64),
            t_ij=np.stack([e[2] for e in self.edges]) if self.edges
            else np.zeros((0, 3)),
            info=np.stack([e[3] for e in self.edges]) if self.edges
            else np.zeros((0, 3, 3)),
            edge_type=np.asarray([e[4] for e in self.edges], np.int64),
            has_scan=np.asarray([s is not None for s in self.scans], bool),
        )
        if self.quality:
            payload["edge_quality_json"] = np.asarray(
                json.dumps({str(k): v for k, v in self.quality.items()}))
        if any(s is not None for s in self.scans):
            for f in SCAN_FIELDS:
                parts = [s[f] for s in self.scans
                         if s is not None and f in s]
                if not parts:
                    continue
                lens = [len(s[f]) if s is not None and f in s else 0
                        for s in self.scans]
                payload["scan_" + f] = np.concatenate(parts, axis=0)
                payload["scan_" + f + "_offsets"] = np.concatenate(
                    [[0], np.cumsum(lens)]).astype(np.int64)
        np.savez_compressed(path, **payload)

    @classmethod
    def load(cls, path: str) -> "GraphBuilder":
        gb = cls()
        with np.load(path) as z:
            gb.poses = list(z["poses"])
            gb.stamps = list(z["stamps"])
            gb.gt_poses = list(z["gt_poses"])
            gb.has_gt = list(z["has_gt"])
            gb.edges = [(int(i), int(j), t, inf, int(k))
                        for i, j, t, inf, k in zip(z["edge_i"], z["edge_j"],
                                                   z["t_ij"], z["info"],
                                                   z["edge_type"])]
            for pos, e in enumerate(gb.edges):  # rebuild the accounting
                key = (e[4], (min(e[0], e[1]), max(e[0], e[1])))
                gb._index.setdefault(key, pos)
                if e[4] == ODOMETRY:
                    gb._dist_trav += float(np.linalg.norm(e[2][:2]))
            if "edge_quality_json" in z.files:
                gb.quality = {int(k): v for k, v in
                              json.loads(str(z["edge_quality_json"])).items()}
            has_scan = z["has_scan"] if "has_scan" in z.files \
                else np.zeros(len(gb.poses), bool)
            gb.scans = [None] * len(gb.poses)
            for f in SCAN_FIELDS:
                key = "scan_" + f
                if key not in z.files:
                    continue
                flat, offs = z[key], z[key + "_offsets"]
                for n in range(len(gb.poses)):
                    if not has_scan[n]:
                        continue
                    if gb.scans[n] is None:
                        gb.scans[n] = {}
                    gb.scans[n][f] = flat[offs[n]:offs[n + 1]]
        return gb


def compute_scan_payloads(images: np.ndarray, frame_ids, cfg,
                          motions: np.ndarray | None = None,
                          device="cuda") -> list:
    """Recompute each keyframe's `RadarScan` payload (`types.h:118-122`)
    from its raw sweep: peaks cloud, filtered cloud and oriented surface
    points, in the compensated sensor frame (compensated by `motions`
    (K, 3) when `odometry.compensate` is on, as the reference does), and
    the motion itself. The sweeps go to `device` (the CUDA card unless the
    caller asks for the CPU) through `odometry.upload_images`,
    `PAYLOAD_CHUNK` keyframes at a time, filtered there by
    `filter_polar_image` and featurised by one batched
    `compute_cells_batched` per chunk."""
    device = resolve_device(device, "compute_scan_payloads")
    frame_ids = list(frame_ids)
    if motions is None:
        motions = np.zeros((len(frame_ids), 3), np.float32)
    motions = np.asarray(motions, np.float32)
    payloads = []
    for lo in range(0, len(frame_ids), PAYLOAD_CHUNK):
        ids = frame_ids[lo:lo + PAYLOAD_CHUNK]
        imgs = upload_images(np.stack([images[f] for f in ids]), device)
        pts = filtering.filter_polar_image(imgs, cfg)
        if cfg.odometry.compensate:
            tmot = torch.as_tensor(motions[lo:lo + PAYLOAD_CHUNK]).to(device)
            pts = pts._replace(xy=se2.compensate_points(pts.xy, tmot,
                                                        cfg.radar.ccw))
        cells = features.compute_cells_batched(pts, cfg)
        pts = filtering.PointCloud(*(a.cpu().numpy() for a in pts))
        cells = CellMap(*(a.cpu().numpy() for a in cells))
        for n in range(len(ids)):
            v, pk, cv = pts.valid[n], pts.peak[n], cells.valid[n]
            payloads.append(dict(
                peaks_xy=pts.xy[n][pk].astype(np.float32),
                peaks_intensity=pts.intensity[n][pk].astype(np.float32),
                cloud_xy=pts.xy[n][v].astype(np.float32),
                cloud_intensity=pts.intensity[n][v].astype(np.float32),
                cell_mean=cells.mean[n][cv].astype(np.float32),
                cell_normal=cells.normal[n][cv].astype(np.float32),
                cell_cov=cells.cov[n][cv].astype(np.float32),
                cell_nsamples=cells.nsamples[n][cv].astype(np.float32),
                cell_planarity=cells.planarity[n][cv].astype(np.float32),
                motion=motions[lo + n],
            ))
    return payloads


def payload_to_cellmap(scan: dict, max_cells: int, device="cuda") -> CellMap:
    """A fixed-size `CellMap` on `device` (the CUDA card unless the caller
    asks for the CPU) from a stored scan payload: its first `max_cells`
    cells, zero-padded."""
    device = resolve_device(device, "payload_to_cellmap")
    n = min(len(scan["cell_mean"]), max_cells)

    def pad(a, shape):
        out = np.zeros((max_cells,) + shape, np.float32)
        out[:n] = a[:n]
        return torch.as_tensor(out).to(device)

    valid = np.zeros(max_cells, bool)
    valid[:n] = True
    return CellMap(
        mean=pad(scan["cell_mean"], (2,)),
        normal=pad(scan["cell_normal"], (2,)),
        cov=pad(scan["cell_cov"], (2, 2)),
        nsamples=pad(scan["cell_nsamples"], ()),
        planarity=pad(scan["cell_planarity"], ()),
        valid=torch.as_tensor(valid).to(device),
    )


def build_graph_from_odometry(outputs, trajectory_xyt, stamps=None,
                              images=None, cfg=None,
                              device="cuda") -> GraphBuilder:
    """The odometry pose graph from the fuser's frame outputs: keyframe
    nodes and chained odometry constraints. With `images` and `cfg`, each
    node also carries its scan payload (`compute_scan_payloads` on
    `device`), with the motion into its frame as the compensation motion:
    se2.relative of the two trajectory poses in float32, as the
    reference."""
    gb = GraphBuilder()
    fused = np.asarray(outputs.fused)
    covs = np.asarray(outputs.cov, np.float64)
    prev = None
    kf_frames = list(np.where(fused)[0])
    for k in kf_frames:
        stamp = float(stamps[k]) if stamps is not None else float(k)
        idx = gb.add_node(trajectory_xyt[k], stamp)
        if prev is not None:
            gb.add_odometry_edge(idx, prev, covs[k])
        prev = idx
    if images is not None and cfg is not None:
        motions = np.zeros((len(kf_frames), 3), np.float32)
        for n, f in enumerate(kf_frames):
            if f > 0:
                motions[n] = _relative_f32(
                    np.asarray(trajectory_xyt[f - 1], np.float32),
                    np.asarray(trajectory_xyt[f], np.float32))
        payloads = compute_scan_payloads(images, kf_frames, cfg,
                                         motions=motions, device=device)
        for n, p in enumerate(payloads):
            gb.add_scan_payload(n, **p)
    return gb
