# Frozen copy of cfear_radarodometry_code_public_tpu_torch/datasets/synthetic.py
# at commit 292d3f4b1f62e4192f42d57c14b23d20a72934ff, kept here so that the
# benchmark's traffic cannot change with the program. Do not edit.
"""Synthetic spinning-FMCW radar simulator (ray-cast).

The reference is evaluated on recorded rosbags (Oxford Radar RobotCar,
MulRan); this module provides a physics-lite stand-in so every stage — and
the end-to-end drift benchmark — can run hermetically.

The world is a set of wall segments plus discrete point scatterers. Each
azimuth beam is RAY-CAST against the walls (real radar sees a continuous
return wherever the beam meets a surface, at every azimuth — this is what
anchors CFEAR's intensity-weighted cell means on real data), with a
deterministic reflectivity texture along each wall so bright scatterers stay
fixed in the world between frames. Per-azimuth sensor motion reproduces true
motion distortion with the reference's scan-time convention, and exponential
speckle noise sits below/around the detector threshold.

Conventions match the reference exactly so the same pipeline constants work:
azimuth bin b covers bearing theta = (b+1)/A * 2*pi (`radar_filters.cpp:317`),
range bin r covers distance (r+0.5) * dr (`radar_filters.cpp:324-330`),
azimuth b is measured at relative scan time d = (b+1)/A - 0.5 (`utils.h:28-32`).

The port's own copy of the reference's
`cfear_radarodometry_code_public_tpu/datasets/synthetic.py` (framework-free;
the port imports nothing of the reference package). The two are held equal
by `tests/test_torch_selfcontained.py`: `make_sequence` gives the
reference's arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def make_world(rng: np.random.Generator, n_walls: int = 18,
               n_scatterers: int = 250, extent: float = 160.0,
               texture_knots: int = 512,
               n_dynamic: int = 0,
               texture_gamma: float = 2.0) -> Dict[str, np.ndarray]:
    """Random world: wall segments with reflectivity texture + scatterers.

    `n_dynamic` adds moving point objects (cars: bright multi-scatterer
    clusters with piecewise-constant velocities) that violate the static-
    world assumption — the adversarial ingredient real radar odometry must
    be robust to. `texture_gamma` shapes the wall reflectivity contrast:
    1.0 = flat bland walls (hardest for intensity weighting), larger =
    sparser bright texture."""
    p0 = rng.uniform(-extent, extent, (n_walls, 2))
    ang = rng.uniform(0, 2 * np.pi, n_walls)
    length = rng.uniform(25.0, 100.0, n_walls)
    p1 = p0 + np.stack([np.cos(ang), np.sin(ang)], -1) * length[:, None]
    texture = rng.uniform(0.35, 1.0, (n_walls, texture_knots)) ** texture_gamma
    # sprinkle a few bright anchor scatterers into each wall's texture
    for s in range(n_walls):
        idx = rng.integers(0, texture_knots, 8)
        texture[s, idx] = rng.uniform(1.2, 1.6, 8)
    scat = np.concatenate(
        [rng.uniform(-extent, extent, (n_scatterers, 2)),
         rng.uniform(90, 230, (n_scatterers, 1))], -1)
    # dynamic objects: position, velocity (m/s), reflectivity; each renders
    # as a 3-scatterer cluster (front/center/rear) at its frame-time pose
    dyn_pos = rng.uniform(-extent, extent, (n_dynamic, 2))
    dyn_ang = rng.uniform(0, 2 * np.pi, n_dynamic)
    dyn_speed = rng.uniform(2.0, 14.0, n_dynamic)
    dyn_vel = np.stack([np.cos(dyn_ang), np.sin(dyn_ang)], -1) \
        * dyn_speed[:, None]
    dyn_refl = rng.uniform(150, 240, n_dynamic)
    return dict(seg_p0=p0, seg_p1=p1,
                seg_refl=rng.uniform(140, 230, n_walls),
                seg_texture=texture, scatterers=scat,
                dyn_pos=dyn_pos.reshape(-1, 2),
                dyn_vel=dyn_vel.reshape(-1, 2),
                dyn_refl=dyn_refl)


def make_trajectory(rng: np.random.Generator, n_frames: int,
                    dt: float = 0.25, speed: float = 5.0) -> np.ndarray:
    """Smooth forward trajectory (T, 3) [x, y, yaw]: car-like motion."""
    n_knots = max(n_frames // 40, 2)
    knots = rng.uniform(-0.25, 0.25, n_knots)
    xs = np.linspace(0, n_frames - 1, n_knots)
    yaw_rate = np.interp(np.arange(n_frames), xs, knots)
    v = speed * (1.0 + 0.2 * np.sin(np.arange(n_frames) * 0.05))
    poses = np.zeros((n_frames, 3))
    for i in range(1, n_frames):
        th = poses[i - 1, 2]
        poses[i, 0] = poses[i - 1, 0] + v[i] * dt * np.cos(th)
        poses[i, 1] = poses[i - 1, 1] + v[i] * dt * np.sin(th)
        poses[i, 2] = th + yaw_rate[i] * dt
    return poses


def _raycast(world, origins: np.ndarray, dirs: np.ndarray):
    """Vectorized ray/segment intersection.

    origins, dirs: (A, 2). Returns (range (A,), reflectivity (A,)) with
    range = inf where no wall is hit.
    """
    p0 = world["seg_p0"]                      # (S, 2)
    e = world["seg_p1"] - p0                  # (S, 2)
    S = p0.shape[0]
    o = origins[:, None, :]                   # (A, 1, 2)
    d = dirs[:, None, :]
    w = p0[None, :, :] - o                    # (A, S, 2)
    denom = d[..., 0] * e[None, :, 1] - d[..., 1] * e[None, :, 0]
    denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
    t = (w[..., 0] * e[None, :, 1] - w[..., 1] * e[None, :, 0]) / denom
    u = (w[..., 0] * d[..., 1] - w[..., 1] * d[..., 0]) / (-denom)
    hit = (t > 1.0) & (u >= 0.0) & (u <= 1.0)
    t = np.where(hit, t, np.inf)
    k = np.argmin(t, axis=1)                  # (A,) nearest wall
    rows = np.arange(t.shape[0])
    rng_out = t[rows, k]
    u_hit = np.clip(u[rows, k], 0.0, 1.0)
    # reflectivity: base * along-wall texture * incidence factor
    tex = world["seg_texture"]
    knots = tex.shape[1]
    ui = np.minimum((u_hit * (knots - 1)).astype(int), knots - 2)
    frac = u_hit * (knots - 1) - ui
    tex_v = tex[k, ui] * (1 - frac) + tex[k, ui + 1] * frac
    e_hit = e[k]
    e_norm = e_hit / np.maximum(np.linalg.norm(e_hit, axis=-1, keepdims=True),
                                1e-9)
    inc = np.abs(dirs[:, 0] * e_norm[:, 1] - dirs[:, 1] * e_norm[:, 0])
    refl = world["seg_refl"][k] * tex_v * (0.4 + 0.6 * inc)
    return rng_out, refl


def render_polar(world, pose: np.ndarray, cfg, rng: np.random.Generator,
                 motion: np.ndarray | None = None,
                 noise_scale: float = 12.0, t: float = 0.0,
                 dropout_prob: float = 0.0,
                 speckle_burst_prob: float = 0.0,
                 azimuth_jitter_rad: float = 0.0,
                 saturation_m: float = 0.0,
                 multipath_gain: float = 0.0) -> np.ndarray:
    """Render one polar sweep (A, R) uint8 at `pose`; `motion` is the
    frame-to-frame motion applied fractionally across the sweep.

    Adversarial degradations (all off by default):
    - `t`: frame time (s) — places the world's dynamic objects
    - `dropout_prob`: per-frame chance of a random azimuth wedge whose
      returns are attenuated to the noise floor (receiver blockage)
    - `speckle_burst_prob`: per-frame chance of a burst of bright
      supra-threshold speckle streaks (interference)
    - `azimuth_jitter_rad`: per-azimuth pointing noise (encoder jitter)
    - `saturation_m`: Navtech-style receiver saturation — a bright
      near-range disc of saturated bins out to this range
    - `multipath_gain`: double-bounce ghosts — every wall return is echoed
      at twice its range with this intensity fraction (classic radar
      multipath ring)"""
    radar = cfg.radar
    a_bins, r_bins = radar.n_azimuths, radar.n_bins
    dr = radar.range_res

    img = np.zeros((a_bins, r_bins), np.float32)
    if noise_scale > 0:
        img += rng.exponential(noise_scale, (a_bins, r_bins)).astype(np.float32)

    # sensor pose per azimuth (motion distortion)
    d = (np.arange(a_bins) + 1.0) / a_bins - 0.5
    if radar.ccw:
        d = -d
    if motion is None:
        motion = np.zeros(3)
    ang = pose[2] + d * motion[2]
    px = pose[0] + d * (np.cos(pose[2]) * motion[0] - np.sin(pose[2]) * motion[1])
    py = pose[1] + d * (np.sin(pose[2]) * motion[0] + np.cos(pose[2]) * motion[1])
    origins = np.stack([px, py], -1)
    bearings = (np.arange(a_bins) + 1.0) / a_bins * 2 * np.pi
    world_angles = ang + bearings
    if azimuth_jitter_rad > 0:
        world_angles = world_angles + rng.normal(
            0.0, azimuth_jitter_rad, a_bins)
    dirs = np.stack([np.cos(world_angles), np.sin(world_angles)], -1)

    # --- walls: one continuous return per azimuth beam ------------------
    rng_hit, refl = _raycast(world, origins, dirs)
    ok = np.isfinite(rng_hit) & (rng_hit / dr < r_bins - 4)
    az = np.where(ok)[0]
    rng_f = rng_hit[ok] / dr - 0.5
    refl_ok = refl[ok]
    sig_r = 1.2
    for drb in range(-3, 4):
        rb = np.clip(np.round(rng_f) + drb, 0, r_bins - 1).astype(int)
        wr = np.exp(-0.5 * ((np.round(rng_f) + drb - rng_f) / sig_r) ** 2)
        np.add.at(img, (az, rb), refl_ok * wr)
    if multipath_gain > 0:
        # double-bounce ghost: each wall return echoed at 2x its range
        ghost_f = 2.0 * rng_f + 0.5
        g_ok = ghost_f < r_bins - 4
        for drb in range(-3, 4):
            rb = np.clip(np.round(ghost_f[g_ok]) + drb, 0,
                         r_bins - 1).astype(int)
            wr = np.exp(-0.5 * ((np.round(ghost_f[g_ok]) + drb
                                 - ghost_f[g_ok]) / sig_r) ** 2)
            np.add.at(img, (az[g_ok], rb),
                      multipath_gain * refl_ok[g_ok] * wr)

    # --- discrete point scatterers (visible only if no wall in front) ---
    scat = world["scatterers"]
    if world.get("dyn_pos") is not None and len(world["dyn_pos"]):
        # dynamic objects at their frame-time position: 3-scatterer cluster
        # (rear / center / front along the velocity direction)
        dp = world["dyn_pos"] + t * world["dyn_vel"]
        speed = np.maximum(np.linalg.norm(world["dyn_vel"], axis=-1,
                                          keepdims=True), 1e-6)
        fwd = world["dyn_vel"] / speed
        cluster = np.concatenate([dp - 1.5 * fwd, dp, dp + 1.5 * fwd])
        refl3 = np.tile(world["dyn_refl"], 3)[:, None]
        scat = np.concatenate([scat,
                               np.concatenate([cluster, refl3], -1)])
    theta0 = np.mod(np.arctan2(scat[:, 1] - pose[1], scat[:, 0] - pose[0])
                    - pose[2], 2 * np.pi)
    b0 = np.clip(np.round(theta0 * a_bins / (2 * np.pi) - 1.0).astype(int),
                 0, a_bins - 1)
    rel_x = scat[:, 0] - px[b0]
    rel_y = scat[:, 1] - py[b0]
    c, s = np.cos(-ang[b0]), np.sin(-ang[b0])
    lx = c * rel_x - s * rel_y
    ly = s * rel_x + c * rel_y
    theta = np.mod(np.arctan2(ly, lx), 2 * np.pi)
    rngs = np.hypot(lx, ly)
    az_f = theta * a_bins / (2 * np.pi) - 1.0
    rng_f = rngs / dr - 0.5
    occluded = rngs > rng_hit[b0] - 0.5
    keep = (rngs > 1.0) & (rng_f < r_bins - 4) & (rng_f > 2) & ~occluded
    az_f, rng_f, refl = az_f[keep], rng_f[keep], scat[keep, 2]
    sig_a = 1.0
    for da in range(-2, 3):
        ab = np.mod(np.round(az_f) + da, a_bins).astype(int)
        wa = np.exp(-0.5 * ((np.round(az_f) + da - az_f) / sig_a) ** 2)
        for drb in range(-3, 4):
            rb = np.clip(np.round(rng_f) + drb, 0, r_bins - 1).astype(int)
            wr = np.exp(-0.5 * ((np.round(rng_f) + drb - rng_f) / sig_r) ** 2)
            np.add.at(img, (ab, rb), refl * wa * wr)

    # --- adversarial degradations -----------------------------------------
    if dropout_prob > 0 and rng.random() < dropout_prob:
        # attenuate a random azimuth wedge to the noise floor
        width = int(rng.integers(a_bins // 16, a_bins // 4))
        start = int(rng.integers(0, a_bins))
        idx = (start + np.arange(width)) % a_bins
        img[idx] *= rng.uniform(0.0, 0.2)
    if speckle_burst_prob > 0 and rng.random() < speckle_burst_prob:
        # bright interference streaks: a few azimuths with supra-threshold
        # speckle across long range spans
        for _ in range(int(rng.integers(2, 6))):
            az = int(rng.integers(0, a_bins))
            lo = int(rng.integers(0, r_bins // 2))
            hi = int(rng.integers(lo + r_bins // 8, r_bins))
            img[az, lo:hi] += rng.exponential(90.0, hi - lo)
    if saturation_m > 0:
        # receiver saturation: bright near-range disc (Navtech sweeps
        # show a saturated blob around the sensor), decaying with range —
        # injects false structure just beyond the min-distance gate
        n_sat = int(min(saturation_m / dr, r_bins))
        if n_sat > 0:
            prof = 255.0 * np.exp(-1.5 * np.arange(n_sat) / n_sat)
            img[:, :n_sat] = np.maximum(
                img[:, :n_sat],
                prof[None, :] * rng.uniform(0.85, 1.0, (a_bins, 1)))

    return np.clip(img, 0, 255).astype(np.uint8)


def make_loop_trajectory(n_frames: int, dt: float = 0.25,
                         speed: float = 5.0) -> np.ndarray:
    """Closed circular loop: ends back at the start pose (for loop-closure
    tests). (T, 3) [x, y, yaw]."""
    c = n_frames * speed * dt
    radius = c / (2 * np.pi)
    th = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    poses = np.stack([radius * np.sin(th), radius * (1 - np.cos(th)), th], -1)
    return poses


def make_sequence(seed: int, n_frames: int, cfg, speed: float = 5.0,
                  noise_scale: float = 12.0, trajectory: str = "random",
                  n_dynamic: int = 0, dropout_prob: float = 0.0,
                  speckle_burst_prob: float = 0.0, extent: float = 160.0,
                  n_walls: int | None = None, n_scatterers: int | None = None,
                  texture_gamma: float = 2.0,
                  azimuth_jitter_rad: float = 0.0,
                  saturation_m: float = 0.0,
                  multipath_gain: float = 0.0):
    """Full synthetic sequence: (images (T, A, R) uint8, gt_poses (T, 3)).

    The adversarial knobs (`n_dynamic` moving objects, azimuth-wedge
    `dropout_prob`, `speckle_burst_prob`, encoder `azimuth_jitter_rad`,
    receiver `saturation_m`, double-bounce `multipath_gain`, wall
    `texture_gamma` contrast) harden the world beyond the static,
    occlusion-light default — see `render_polar`. The sensitivity of drift
    to each knob is the committed robustness envelope
    (`eval_results/sim_sensitivity.csv`, `tools/run_sim_sensitivity.py`)."""
    rng = np.random.default_rng(seed)
    # keep world density roughly constant when the extent grows
    scale = (extent / 160.0) ** 2
    world = make_world(rng, n_dynamic=n_dynamic, extent=extent,
                       n_walls=n_walls or max(18, int(18 * scale)),
                       n_scatterers=n_scatterers or max(250, int(250 * scale)),
                       texture_gamma=texture_gamma)
    if trajectory == "loop":
        gt = make_loop_trajectory(n_frames, dt=cfg.radar.sensor_period,
                                  speed=speed)
    else:
        gt = make_trajectory(rng, n_frames, dt=cfg.radar.sensor_period,
                             speed=speed)
    images = np.zeros((n_frames, cfg.radar.n_azimuths, cfg.radar.n_bins),
                      np.uint8)
    dt = cfg.radar.sensor_period
    for i in range(n_frames):
        motion = None
        if i > 0:
            prev, cur = gt[i - 1], gt[i]
            c, s = np.cos(prev[2]), np.sin(prev[2])
            dx, dy = cur[0] - prev[0], cur[1] - prev[1]
            motion = np.array([c * dx + s * dy, -s * dx + c * dy,
                               cur[2] - prev[2]])
        images[i] = render_polar(world, gt[i], cfg, rng, motion=motion,
                                 noise_scale=noise_scale, t=i * dt,
                                 dropout_prob=dropout_prob,
                                 speckle_burst_prob=speckle_burst_prob,
                                 azimuth_jitter_rad=azimuth_jitter_rad,
                                 saturation_m=saturation_m,
                                 multipath_gain=multipath_gain)
    return images, gt
