"""Loop-closure detection and verification for the pose-graph back-end
(port of `models/loopclosure.py`).

- **Descriptor**: a rotation-invariant ring key per keyframe (the
  nsamples-weighted histogram of cell-mean ranges) and an azimuthal sector
  histogram for the relative yaw, both one deterministic
  `features.segment_sum` over all keyframes on the device.
- **Proposal** (host numpy, as the reference): cosine distance between ring
  keys of keyframes at least `min_keyframe_separation` apart, the nearest
  `max_candidates` per keyframe, and the yaw of each pair from one FFT
  cross-correlation of sector histograms.
- **Verification**: every proposal, seeded twice (odometry translation and
  zero translation, both with the correlation yaw), is registered in chunks
  of `VERIFY_CHUNK` = 512 lanes, each chunk ONE batched `register` call with
  one keyframe (S=1) a lane: on a card kernel A (dense exact 1-NN, B=512,
  S=1) and kernel F (the fused LM solve).
- **Acceptance** (host numpy, as the reference): score, association count
  and the odometry-consistency gate; the best accepted seed becomes a
  `LOOP_APPEARANCE` constraint, else the best rejected one is stored as a
  never-optimized `CANDIDATE`.

The pass reads only the graph's stored scan payloads. The entry points run
on the CUDA card unless the caller passes `device="cpu"`.
`close_and_optimize` with a `mesh` solves edge-sharded (`parallel/pgo.py`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch

from cfear_radarodometry_code_public_tpu_torch.models import posegraph
from cfear_radarodometry_code_public_tpu_torch.models.odometry import (
    resolve_device)
from cfear_radarodometry_code_public_tpu_torch.ops import features, registration
from cfear_radarodometry_code_public_tpu_torch.ops.features import CellMap
from cfear_radarodometry_code_public_tpu_torch.parallel import pgo


@dataclasses.dataclass
class LoopCloserConfig:
    n_rings: int = 24
    n_sectors: int = 60
    max_ring_distance: float = 0.25     # cosine distance gate on ring keys
    min_keyframe_separation: int = 10
    max_candidates: int = 5             # per keyframe
    #: registration-score acceptance ceiling (reference :51-57: genuine
    #: synthetic-world loops score 0.045-0.12; aliasing is the
    #: odometry-consistency gate's job)
    verify_score_max: float = 0.1
    min_assoc: int = 50
    #: odometry-consistency gate: reject a proposal whose implied odometry
    #: correction exceeds max_drift_fraction * chain distance +
    #: drift_slack_m (reference :59-67)
    max_drift_fraction: float = 0.15
    drift_slack_m: float = 5.0


def _descriptors(cells: CellMap, cfg, lc: LoopCloserConfig):
    """(ring_key (n_rings,), sector_hist (n_sectors,)) for one scan."""
    rk, sh = _descriptors_batched(CellMap(*(a[None] for a in cells)), cfg, lc)
    return rk[0], sh[0]


def _descriptors_batched(cells: CellMap, cfg, lc: LoopCloserConfig):
    """Descriptors of a (K, M, ...) stack of keyframe cell maps: one
    lane-offset segment sum per histogram for all lanes. Divisions by a
    constant are tensor divisions (an IEEE division, as the reference's;
    CUDA turns a division by a Python number into a multiply by its
    reciprocal, which can move a cell across a bin edge)."""
    valid = cells.valid                                    # (K, M)
    k, _ = valid.shape
    mx, my = cells.mean[..., 0], cells.mean[..., 1]
    r = torch.sqrt(mx * mx + my * my)
    two_pi = 2 * math.pi
    a = torch.remainder(torch.atan2(my, mx), two_pi)
    max_r = r.new_full((), cfg.radar.max_usable_range)
    ring = torch.clamp((torch.div(r, max_r) * lc.n_rings).to(torch.int64),
                       0, lc.n_rings - 1)
    sector = torch.clamp(
        (torch.div(a, a.new_full((), two_pi)) * lc.n_sectors).to(torch.int64),
        0, lc.n_sectors - 1)
    lane = torch.arange(k, device=valid.device)[:, None]
    w = torch.where(valid, cells.nsamples, torch.zeros_like(cells.nsamples))
    ring_key = features.segment_sum(
        w.reshape(-1), (lane * lc.n_rings + ring).reshape(-1),
        k * lc.n_rings).reshape(k, lc.n_rings)
    sector_hist = features.segment_sum(
        w.reshape(-1), (lane * lc.n_sectors + sector).reshape(-1),
        k * lc.n_sectors).reshape(k, lc.n_sectors)
    return ring_key, sector_hist


def _yaws_from_sectors(h_i: np.ndarray, h_j: np.ndarray,
                       n_sectors: int) -> np.ndarray:
    """Relative yaw for each row pair by circular cross-correlation of
    sector histograms: one vectorized FFT over all pairs."""
    corr = np.fft.irfft(np.fft.rfft(h_i, axis=-1)
                        * np.conj(np.fft.rfft(h_j, axis=-1)),
                        n=n_sectors, axis=-1)
    shift = np.argmax(corr, axis=-1)
    return shift / n_sectors * 2 * np.pi


def _next_pow2(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


def stack_payloads(scans, max_cells: int, device) -> CellMap:
    """(K, max_cells, ...) CellMap on `device` of the graph's stored scan
    payloads (`posegraph.payload_to_cellmap` of each, stacked on the host
    and uploaded once)."""
    maps = [posegraph.payload_to_cellmap(s, max_cells, "cpu") for s in scans]
    return CellMap(*(torch.stack(a).to(device) for a in zip(*maps)))


class LoopCloser:
    """Offline SLAM pass over an odometry run (the TBV-SLAM role), on
    `device` (the CUDA card unless the caller asks for the CPU)."""

    #: fixed verification-batch width: pairs are verified in chunks of this
    #: many lanes so the device footprint stays bounded at Oxford scale
    VERIFY_CHUNK = 512

    def __init__(self, cfg, lc: LoopCloserConfig | None = None,
                 device="cuda"):
        self.cfg = cfg
        self.lc = lc or LoopCloserConfig()
        self.device = resolve_device(device, "LoopCloser")

    def stack(self, gb: posegraph.GraphBuilder) -> CellMap:
        """The graph's scan payloads as one (K, max_cells, ...) stack."""
        return stack_payloads(gb.scans, self.cfg.feature.max_cells,
                              self.device)

    def descriptors(self, stacked: CellMap):
        """(ring keys (K, n_rings), sector histograms (K, n_sectors)) as
        host arrays."""
        rk, sh = _descriptors_batched(stacked, self.cfg, self.lc)
        return rk.cpu().numpy(), sh.cpu().numpy()

    def _verify(self, stacked_kf: CellMap, stacked_src: CellMap, kf_idx,
                src_idx, guesses):
        """Chunked batched registration of candidate pairs: kf_idx/src_idx
        (P,) node indices into the (K, M, ...) stacks, guesses (P, 3).
        Each chunk is one `register` call of `VERIFY_CHUNK` lanes (fewer,
        a power of two, when P is smaller), the last padded with node 0
        and zero guesses. Returns a dict of numpy arrays (pose, cov, score,
        success, num_assoc) of length P."""
        p = len(kf_idx)
        c = self.VERIFY_CHUNK if p > self.VERIFY_CHUNK else _next_pow2(p)
        dev = self.device
        kf_pose = torch.zeros((c, 1, 3), dtype=torch.float32, device=dev)
        kf_valid = torch.ones((c, 1), dtype=torch.bool, device=dev)
        outs = {k: [] for k in ("pose", "cov", "score", "success",
                                "num_assoc")}
        for lo in range(0, p, c):
            hi = min(lo + c, p)
            pad = c - (hi - lo)
            ki = torch.as_tensor(np.concatenate(
                [kf_idx[lo:hi], np.zeros(pad, np.int64)])).to(dev)
            si = torch.as_tensor(np.concatenate(
                [src_idx[lo:hi], np.zeros(pad, np.int64)])).to(dev)
            g = torch.as_tensor(np.concatenate(
                [guesses[lo:hi], np.zeros((pad, 3), np.float32)])).to(dev)
            res = registration.register(
                CellMap(*(a.index_select(0, ki)[:, None] for a in stacked_kf)),
                kf_pose, kf_valid,
                CellMap(*(a.index_select(0, si) for a in stacked_src)), g,
                cfg=self.cfg)
            n = hi - lo
            for k in outs:
                outs[k].append(getattr(res, k)[:n].cpu().numpy())
        return {k: np.concatenate(v) for k, v in outs.items()}

    def close_from_graph(self, gb: posegraph.GraphBuilder,
                         precomputed=None) -> List[Tuple[int, int]]:
        """Detect and verify loops from the graph's stored scan payloads
        only; append constraints to `gb`. Returns the accepted (i, j) node
        pairs. `precomputed` optionally supplies `(stacked, rk, sh)`: the
        payload stack (`stack`) and its descriptors (`descriptors`), so a
        caller that timed those stages does not pay for them twice."""
        lc = self.lc
        n = len(gb.poses)
        if n == 0:
            return []
        if any(s is None for s in gb.scans):
            raise ValueError(
                "graph nodes lack scan payloads; build the graph with "
                "images/cfg or call add_scan_payload per node")
        if precomputed is None:
            stacked = self.stack(gb)
            rk, sh = self.descriptors(stacked)
        else:
            stacked, rk, sh = precomputed
            rk, sh = np.asarray(rk), np.asarray(sh)
            if rk.shape[0] != n or sh.shape[0] != n:
                raise ValueError(
                    f"precomputed descriptors are for {rk.shape[0]} nodes; "
                    f"the graph has {n} (stale precomputed stage?)")

        # proposal: one K x K cosine-distance matrix; a zero-norm ring key
        # has similarity 0 (distance 1) with everything
        norms = np.linalg.norm(rk, axis=-1)
        denom = np.outer(norms, norms)
        d = 1.0 - np.divide(rk @ rk.T, denom, out=np.zeros((n, n)),
                            where=denom > 0)
        pairs = []           # (i, j) with j at least min_separation older
        pair_of = []         # slices of `pairs` per query node i
        for i in range(n):
            lim = i - lc.min_keyframe_separation
            lo = len(pairs)
            if lim > 0:
                cand = np.where(d[i, :lim] < lc.max_ring_distance)[0]
                if cand.size:
                    order = np.argsort(d[i, cand])[:lc.max_candidates]
                    pairs.extend((i, int(j)) for j in cand[order])
            pair_of.append((lo, len(pairs)))
        if not pairs:
            return []

        ii = np.asarray([p[0] for p in pairs])
        jj = np.asarray([p[1] for p in pairs])
        yaw = _yaws_from_sectors(sh[ii], sh[jj], lc.n_sectors)
        poses = np.stack(gb.poses)[:, :3]
        t_odo = posegraph._relative_f32(poses[jj], poses[ii])
        # two seeds per pair: odometry translation and zero translation,
        # both with the correlation yaw
        guesses = np.concatenate([
            np.stack([t_odo[:, 0], t_odo[:, 1], -yaw], -1),
            np.stack([np.zeros_like(yaw), np.zeros_like(yaw), -yaw], -1),
        ]).astype(np.float32)                       # (2P, 3)
        kf_idx = np.concatenate([jj, jj])
        src_idx = np.concatenate([ii, ii])
        res = self._verify(stacked, stacked, kf_idx, src_idx, guesses)
        score, success = res["score"], res["success"]
        num_assoc, rpose, rcov = res["num_assoc"], res["pose"], res["cov"]

        accepted = []
        n_pairs = len(pairs)
        # odometry-consistency gate: the implied correction against the
        # odometric chain distance between the nodes
        cum = gb.chain_distances()
        dist_odo = np.asarray([abs(cum[a_] - cum[b_]) for a_, b_ in pairs])
        corr = np.linalg.norm(rpose[:, :2] - np.concatenate(
            [t_odo[:, :2], t_odo[:, :2]]), axis=1)
        drift_ok = corr <= (lc.max_drift_fraction
                            * np.concatenate([dist_odo, dist_odo])
                            + lc.drift_slack_m)
        for i in range(n):
            lo, hi = pair_of[i]
            best, best_score = None, np.inf
            cand, cand_score = None, np.inf    # best proposal that failed
            for p in range(lo, hi):
                for q in (p, p + n_pairs):     # the two seeds
                    if not success[q]:
                        continue
                    if (score[q] < lc.verify_score_max
                            and num_assoc[q] >= lc.min_assoc
                            and drift_ok[q]
                            and score[q] < best_score):
                        best, best_score = q, score[q]
                    elif score[q] < cand_score:
                        cand, cand_score = q, score[q]

            def _quality(q):
                p = q % n_pairs
                return {"score": score[q], "num_assoc": num_assoc[q],
                        "yaw_seed": -yaw[p],
                        "ring_distance": d[i, jj[p]],
                        "drift_fraction": corr[q] / max(dist_odo[p], 1e-9)}

            if best is not None:
                j = int(jj[best % n_pairs])
                gb.add_loop_edge(j, i, rpose[best], rcov[best],
                                 kind=posegraph.LOOP_APPEARANCE,
                                 quality=_quality(best))
                accepted.append((i, j))
            elif cand is not None:
                # stored with its verification quality, never optimized
                j = int(jj[cand % n_pairs])
                gb.add_loop_edge(j, i, rpose[cand], rcov[cand],
                                 kind=posegraph.CANDIDATE,
                                 quality=_quality(cand))
        return accepted

    def add_mini_loops(self, gb: posegraph.GraphBuilder,
                       max_separation: int = 3) -> List[Tuple[int, int]]:
        """MINI_LOOP constraints between keyframes 2..max_separation apart,
        seeded with the odometry relative pose, verified in the same
        chunked batches; accepted pairs get `MINI_LOOP` edges."""
        lc = self.lc
        n = len(gb.poses)
        if any(s is None for s in gb.scans):
            raise ValueError("mini loops need scan payloads on every node")
        pairs = [(i, i - sep) for sep in range(2, max_separation + 1)
                 for i in range(sep, n)]
        if not pairs:
            return []
        stacked = self.stack(gb)
        ii = np.asarray([p[0] for p in pairs])
        jj = np.asarray([p[1] for p in pairs])
        poses = np.stack(gb.poses)[:, :3]
        guesses = posegraph._relative_f32(poses[jj], poses[ii])
        res = self._verify(stacked, stacked, jj, ii,
                           guesses.astype(np.float32))
        success, num_assoc = res["success"], res["num_assoc"]
        accepted = []
        for p in range(len(pairs)):
            if success[p] and num_assoc[p] >= lc.min_assoc:
                gb.add_loop_edge(int(jj[p]), int(ii[p]), res["pose"][p],
                                 res["cov"][p], kind=posegraph.MINI_LOOP)
                accepted.append((int(ii[p]), int(jj[p])))
        return accepted

    def close(self, images: np.ndarray, gb: posegraph.GraphBuilder,
              keyframe_frames: List[int]) -> List[Tuple[int, int]]:
        """Detect and verify loops; append constraints to `gb`.
        `keyframe_frames[k]` is the frame of node k; missing scan payloads
        are computed from the raw images first."""
        if any(s is None for s in gb.scans):
            payloads = posegraph.compute_scan_payloads(
                images, keyframe_frames, self.cfg, device=self.device)
            for k, p in enumerate(payloads):
                if gb.scans[k] is None:
                    gb.add_scan_payload(k, **p)
        return self.close_from_graph(gb)


def close_and_optimize(images: np.ndarray, outputs, trajectory: np.ndarray,
                       cfg, stamps=None, lc: LoopCloserConfig | None = None,
                       iters: int = 15, mesh=None, mini_loops: bool = False,
                       device="cuda"):
    """Full SLAM pass on `device`: the graph from odometry (payloads on the
    device), loop closure, optimization; with a `mesh`
    (`parallel.mesh.Mesh`), the solve runs edge-sharded over its group on
    its device (`parallel/pgo.distributed_optimize`). Returns (optimized
    node poses (K, 3), graph builder, accepted pairs)."""
    device = resolve_device(device, "close_and_optimize")
    gb = posegraph.build_graph_from_odometry(outputs, trajectory, stamps,
                                             images=images, cfg=cfg,
                                             device=device)
    closer = LoopCloser(cfg, lc, device=device)
    accepted = closer.close_from_graph(gb)
    if mini_loops:
        closer.add_mini_loops(gb)
    return pgo.optimize_graph(gb, iters, mesh, device), gb, accepted
