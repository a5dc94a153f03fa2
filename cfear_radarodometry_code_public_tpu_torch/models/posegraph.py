"""Pose graph: construction and serialization (port of the graph-builder
half of `models/posegraph.py`).

The offline odometry run writes its keyframes as a pose graph
(`simple_graph.npz`, the reference's `.sgh`): keyframe poses, chained
odometry constraints with their information matrices and the
`ConstraintsHandler` accounting (`types.cpp:133-226`), and per keyframe
the `RadarScan` payload (`types.h:93-143`: peaks cloud, filtered cloud,
oriented-surface-point map, motion), recomputed from the raw sweeps on
the device. The npz layout is the reference's, so a graph written here
loads in the reference's `GraphBuilder.load` and the reverse.

Not ported yet: the optimizer (`edge_residuals`, `robust_cost`,
`hessian_diag_blocks`, `gn_step` with `_pcg`, `gnc_limit`,
`adaptive_gnc_start`, `optimize`, `total_cost`; reference :113-452),
ROADMAP queue 1 item 12. `GraphBuilder.to_arrays` already sets each loop
edge's robust-limit scale for it, from the drift constants below.
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
                                                           filtering)
from cfear_radarodometry_code_public_tpu_torch.ops.features import CellMap
from cfear_radarodometry_code_public_tpu_torch.utils import se2

# constraint types (`types.h:150-190`)
ODOMETRY = 0
LOOP_APPEARANCE = 1
MINI_LOOP = 2
CANDIDATE = 3

#: the optimizer's final robust limit of loop edges, in whitened units
#: (reference `posegraph.py:34-48`, where the measurements behind it are)
DEFAULT_LOOP_LOSS_LIMIT = 4.0
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
