"""The SLAM-scale run's world and metrics (the reference's
`tools/run_slam_scale.py:81-106` and :164-201, as functions).

A multi-lap circuit: laps of one closed circular loop in one synthetic
world, so every lap after the first is loop-rich against the earlier ones;
and a second drive along a stretch of that route with its own speckle (a
session to merge into the first's map).
Metrics: keyframe ATE after a yaw-only rigid alignment of the estimate to
ground truth (map consistency, not the global gauge), and the translation
residuals of the graph's LOOP_APPEARANCE edges at given node poses.
"""

from __future__ import annotations

import numpy as np
import torch

from cfear_radarodometry_code_public_tpu_torch.datasets import synthetic
from cfear_radarodometry_code_public_tpu_torch.utils import se2

#: the world of the reference's SLAM-scale run
WORLD_SEED = 9


def _lap_world(cfg, lap_frames: int, speed: float, extent: float,
               seed: int):
    """(rng, world, lap): the world of `seed` (walls and scatterers scaled
    to `extent`), drawn first from the rng, and one lap of
    `make_loop_trajectory(lap_frames)`."""
    rng = np.random.default_rng(seed)
    scale = (extent / 160.0) ** 2
    world = synthetic.make_world(
        rng, extent=extent, n_walls=max(18, int(18 * scale)),
        n_scatterers=max(250, int(250 * scale)))
    lap = synthetic.make_loop_trajectory(lap_frames, dt=cfg.radar.sensor_period,
                                         speed=speed)
    return rng, world, lap


def _render_route(world, route, cfg, rng, dropout_prob, prev=None):
    """Render each pose of `route` (N, 3) with the motion since the pose
    before it (`prev` before the first; none when `prev` is None) and the
    frame's time i * sensor period."""
    dt = cfg.radar.sensor_period
    images = np.zeros((len(route), cfg.radar.n_azimuths, cfg.radar.n_bins),
                      np.uint8)
    for i in range(len(route)):
        before = route[i - 1] if i > 0 else prev
        motion = None
        if before is not None:
            cur = route[i]
            c, s = np.cos(before[2]), np.sin(before[2])
            motion = np.array([
                c * (cur[0] - before[0]) + s * (cur[1] - before[1]),
                -s * (cur[0] - before[0]) + c * (cur[1] - before[1]),
                np.angle(np.exp(1j * (cur[2] - before[2])))])
        images[i] = synthetic.render_polar(world, route[i], cfg, rng,
                                           motion=motion, t=i * dt,
                                           dropout_prob=dropout_prob)
    return images


def make_lap_sequence(cfg, n_frames: int, lap_frames: int,
                      speed: float = 2.5, extent: float = 300.0,
                      dropout_prob: float = 0.0, seed: int = WORLD_SEED):
    """(images (n_frames, A, R) uint8, gt (n_frames, 3)): laps of
    `make_loop_trajectory(lap_frames)` through one world of walls and
    scatterers scaled to `extent`, rendered frame by frame with the
    motion since the previous frame (its motion distortion) and
    azimuth-wedge dropout `dropout_prob`."""
    rng, world, lap = _lap_world(cfg, lap_frames, speed, extent, seed)
    laps = -(-n_frames // lap_frames)
    gt = np.concatenate([lap] * laps)[:n_frames]
    return _render_route(world, gt, cfg, rng, dropout_prob), gt


def make_route_slice(cfg, start: int, n_frames: int, lap_frames: int,
                     render_seed: int, speed: float = 2.5,
                     extent: float = 300.0, dropout_prob: float = 0.0,
                     seed: int = WORLD_SEED):
    """(images (n_frames, A, R) uint8, gt (n_frames, 3)): another drive
    through the world of `make_lap_sequence` (the same `seed`, `extent`,
    laps), along its route from frame `start` for `n_frames` frames, with
    fresh speckle from `render_seed`; its first frame carries the motion
    from the route's frame before it."""
    _, world, lap = _lap_world(cfg, lap_frames, speed, extent, seed)
    laps = -(-(start + n_frames) // lap_frames)
    route = np.concatenate([lap] * laps)
    gt = route[start:start + n_frames]
    prev = route[start - 1] if start > 0 else None
    images = _render_route(world, gt, cfg, np.random.default_rng(render_seed),
                           dropout_prob, prev)
    return images, gt


def keyframe_ate(est: np.ndarray, gt_kf: np.ndarray) -> float:
    """RMS position error of (K, >=2) keyframe poses after the yaw-only
    rigid alignment (centroids matched) of `est` to `gt_kf`."""
    e = est[:, :2] - est[:, :2].mean(0)
    g = gt_kf[:, :2] - gt_kf[:, :2].mean(0)
    num = np.sum(e[:, 0] * g[:, 1] - e[:, 1] * g[:, 0])
    den = np.sum(e[:, 0] * g[:, 0] + e[:, 1] * g[:, 1])
    th = np.arctan2(num, den)
    c, s = np.cos(th), np.sin(th)
    er = np.stack([c * e[:, 0] - s * e[:, 1], s * e[:, 0] + c * e[:, 1]], -1)
    return float(np.sqrt(np.mean(np.sum((er - g) ** 2, -1))))


def loop_residuals(edges, poses: np.ndarray, kind: int) -> np.ndarray:
    """|translation of se2.relative(p_i, p_j) - t_ij| (float32 relative, as
    the reference) of every edge of type `kind` in `edges` ((i, j, t_ij,
    info, type) tuples); [0] when there is none."""
    sel = [e for e in edges if e[4] == kind]
    if not sel:
        return np.zeros(1)
    ii = np.asarray([e[0] for e in sel])
    jj = np.asarray([e[1] for e in sel])
    rel = se2.relative(torch.as_tensor(poses[ii], dtype=torch.float32),
                       torch.as_tensor(poses[jj], dtype=torch.float32)
                       ).numpy()
    tij = np.stack([np.asarray(e[2]) for e in sel])
    return np.linalg.norm((rel - tij)[:, :2], axis=1)
