"""Long-sequence segmentation: one trajectory run as a batch of segments
(port of `parallel/segments.py`).

Odometry is serial in time, so a single long sequence cannot be split
naively:

1. the sequence is cut into `n_segments` overlapping windows;
2. every segment runs independent odometry from its own bootstrap frame,
   the segments stepped in lockstep as the lanes of one batch
   (`mesh.MultiSequenceRunner`, over a process group when the mesh has
   one);
3. consecutive segments are stitched by aligning their pose estimates over
   the shared overlap frames (the SE(2) log-mean of the per-frame alignment
   transforms, in float32 as the reference computes it).

Each seam contributes one alignment estimated from `overlap` frames
instead of a continuous solve.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from cfear_radarodometry_code_public_tpu_torch.parallel.mesh import (
    MultiSequenceRunner)
from cfear_radarodometry_code_public_tpu_torch.utils import se2


def split_indices(t: int, n_segments: int, overlap: int
                  ) -> List[Tuple[int, int]]:
    """[(start, end)) windows covering [0, t) with `overlap` shared frames."""
    if n_segments <= 1:
        return [(0, t)]
    core = int(np.ceil((t + (n_segments - 1) * overlap) / n_segments))
    out = []
    s = 0
    for i in range(n_segments):
        e = min(s + core, t)
        out.append((s, e))
        if e >= t:
            break
        s = e - overlap
    return out


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _se2_mean(poses: np.ndarray) -> np.ndarray:
    """Mean of SE(2) poses through the log map around the first."""
    ref = _f32(poses[0])
    twists = [se2.log(se2.relative(ref, _f32(p))).numpy() for p in poses]
    mean_twist = np.mean(twists, axis=0)
    return se2.compose(ref, se2.exp(_f32(mean_twist))).numpy()


def stitch(segment_trajs: List[np.ndarray], windows: List[Tuple[int, int]],
           overlap: int) -> np.ndarray:
    """Compose per-segment trajectories into one global (T, 3) trajectory."""
    t = windows[-1][1]
    world = np.zeros((t, 3))
    offset = np.zeros(3)          # world pose of the current segment's origin
    prev_end = 0
    for k, ((s, e), traj) in enumerate(zip(windows, segment_trajs)):
        if k > 0:
            # the alignment: world pose of each shared frame against this
            # segment's local pose of it
            aligns = [se2.compose(_f32(world[s + j]),
                                  se2.inverse(_f32(traj[j]))).numpy()
                      for j in range(prev_end - s)]
            offset = _se2_mean(np.stack(aligns))
        glob = se2.compose(_f32(offset)[None], _f32(traj)).numpy()
        world[prev_end:e] = glob[prev_end - s:]
        prev_end = e
    return world


def run_segmented(images: np.ndarray, cfg, n_segments: int,
                  overlap: int = 8, chunk: int = 16, mesh=None,
                  device="cuda") -> np.ndarray:
    """Segment-parallel odometry over one (T, A, R) sequence of raw sweeps
    (image ingest, as the reference's) on the mesh's device, or on `device`
    (the CUDA card unless the caller asks for the CPU) without a mesh.
    Segments are zero-padded to the longest and stepped as one batch, in
    chunks of `chunk` frames; a segment's frames after its end never feed
    its kept poses. Returns the stitched global (T, 3) trajectory."""
    t = images.shape[0]
    windows = split_indices(t, n_segments, overlap)
    seg_len = max(e - s for s, e in windows)
    blocks = np.zeros((len(windows), seg_len) + images.shape[1:],
                      images.dtype)
    for i, (s, e) in enumerate(windows):
        blocks[i, :e - s] = images[s:e]
    runner = MultiSequenceRunner(cfg, batch=len(windows), mesh=mesh,
                                 chunk=chunk, ingest="image", device=device)
    runner.process(blocks)
    trajs = runner.trajectories()
    return stitch([trajs[i, :e - s] for i, (s, e) in enumerate(windows)],
                  windows, overlap)
