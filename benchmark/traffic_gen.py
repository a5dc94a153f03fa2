"""The one traffic generator: a fleet of lanes driving rendered traversals
of one closed route, from a traffic file's parameters and a seed.

The route is `synthetic.make_loop_trajectory`'s circle: `lap_frames`
frames at `speed_m_s`, exactly periodic, so a lane that cycles its lap
drives on without a seam. Lane i drives traversal i mod `traversals` and
joins the lap at frame (i div `traversals`) * `phase_step`. Like a recorded
drive it starts at rest: its first `ramp_frames` frames accelerate evenly
along the route from standstill to the lap's speed, arriving at its lap
frame at full speed.

The world is the route's and the same in every run: it comes from the
file's `world_seed`. Every sweep's speckle comes from `--seed`: lap sweep
f of traversal k from (seed, 1 + k, f), ramp sweep j of lane i from (seed,
1000 + i, j), so the same seed gives the same sweeps whatever the number of
render threads, and every seed the same amount of work.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np

from benchmark import synthetic


def _seed(seed: int) -> int:
    """Any whole number -> the non-negative entropy numpy takes."""
    return int(seed) % (1 << 64)


def _relative(a, b):
    c, s = math.cos(a[2]), math.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    return np.array([c * dx + s * dy, -s * dx + c * dy, b[2] - a[2]])


class Traffic:
    """The rendered sweeps of one traffic file and seed, and each lane's
    drive over them."""

    def __init__(self, traffic, params, seed: int):
        self.t = traffic
        self.lap = traffic["lap_frames"]
        self.ramp = traffic["ramp_frames"]
        self.chunk = traffic["chunk"]
        if self.ramp % self.chunk or self.lap % self.chunk:
            raise ValueError("ramp_frames and lap_frames must be whole "
                             "chunks")
        self.dt = params["radar"]["sensor_period"]
        self.lanes = [(i % traffic["traversals"],
                       (i // traffic["traversals"]) * traffic["phase_step"]
                       % self.lap) for i in range(traffic["lanes"])]
        self.radius = self.lap * traffic["speed_m_s"] * self.dt / (2 * math.pi)
        s = _seed(seed)
        w = traffic["world"]
        self.world = synthetic.make_world(
            np.random.default_rng([_seed(w["world_seed"]), 0]),
            n_walls=w["n_walls"],
            n_scatterers=w["n_scatterers"], extent=w["extent"],
            texture_gamma=w["texture_gamma"])
        self.cfg = SimpleNamespace(radar=SimpleNamespace(**{
            k: params["radar"][k] for k in ("n_azimuths", "n_bins",
                                             "range_res", "ccw")}))
        jobs = [((s, 1 + k, f), self.lap_pose(f), self.lap_motion(), f)
                for k in range(traffic["traversals"])
                for f in range(self.lap)]
        jobs += [((s, 1000 + i, j), self.ramp_pose(i, j),
                  self.ramp_motion(i, j), j)
                 for i in range(len(self.lanes)) for j in range(self.ramp)]
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            sweeps = list(pool.map(self._render, jobs))
        n_lap = traffic["traversals"] * self.lap
        shape = sweeps[0].shape
        self.lap_sweeps = np.stack(sweeps[:n_lap]).reshape(
            (traffic["traversals"], self.lap) + shape)
        self.ramp_sweeps = np.stack(sweeps[n_lap:]).reshape(
            (len(self.lanes), self.ramp) + shape) if self.ramp else \
            np.zeros((len(self.lanes), 0) + shape, np.uint8)

    def _render(self, job):
        entropy, pose, motion, f = job
        return synthetic.render_polar(
            self.world, pose, self.cfg, np.random.default_rng(entropy),
            motion=motion, noise_scale=self.t["noise_scale"], t=f * self.dt)

    # -- the route ------------------------------------------------------
    def _on_circle(self, arc):
        """The pose at arc length `arc` along the loop (heading unwrapped),
        as `synthetic.make_loop_trajectory` places its frames."""
        th = arc / self.radius
        return np.array([self.radius * math.sin(th),
                         self.radius * (1 - math.cos(th)), th])

    def lap_pose(self, f):
        return self._on_circle(f * self.t["speed_m_s"] * self.dt)

    def lap_motion(self):
        """The frame-to-frame motion at full speed (the same every frame)."""
        return _relative(self.lap_pose(0), self.lap_pose(1))

    def _ramp_arc(self, lane, j):
        """Arc length of ramp frame j of a lane: the speed grows evenly from
        0 at frame 0 to full at frame `ramp`, the lane's lap frame."""
        v, n = self.t["speed_m_s"] * self.dt, self.ramp
        phase = self.lanes[lane][1]
        return (phase - n / 2.0) * v + v * j * j / (2.0 * n)

    def ramp_pose(self, lane, j):
        return self._on_circle(self._ramp_arc(lane, j))

    def ramp_motion(self, lane, j):
        if j == 0:
            return np.zeros(3)
        return _relative(self.ramp_pose(lane, j - 1), self.ramp_pose(lane, j))

    def pose(self, lane, t):
        """The true pose of step t of a lane's drive, heading unwrapped."""
        if t < self.ramp:
            return self.ramp_pose(lane, t)
        phase = self.lanes[lane][1]
        n = phase + t - self.ramp
        p = self.lap_pose(n % self.lap)
        p[2] += 2 * math.pi * (n // self.lap)
        return p

    # -- the sweeps -----------------------------------------------------
    def key(self, lane, t):
        """Which sweep step t of a lane reads: ('ramp', lane, j) or
        ('lap', traversal, f)."""
        if t < self.ramp:
            return ("ramp", lane, t)
        trav, phase = self.lanes[lane]
        return ("lap", trav, (phase + t - self.ramp) % self.lap)

    def sweep(self, key):
        kind, a, b = key
        return (self.ramp_sweeps if kind == "ramp" else self.lap_sweeps)[a, b]

    def frames(self, lanes, t):
        """Step t's sweeps of `lanes`: uint8 (len(lanes), A, R)."""
        return np.stack([self.sweep(self.key(j, t)) for j in lanes])

    def chunks(self):
        """The distinct lockstep chunks (lanes, chunk, A, R): the ramp's,
        then the lap's, each lane from its own lap frame; `drive_chunk`
        maps the drive's chunks onto them."""
        out = []
        for k in range((self.ramp + self.lap) // self.chunk):
            arr = np.empty((len(self.lanes), self.chunk)
                           + self.lap_sweeps.shape[2:], np.uint8)
            for t in range(self.chunk):
                arr[:, t] = self.frames(range(len(self.lanes)),
                                        k * self.chunk + t)
            out.append(arr)
        return out

    def drive_chunk(self, k: int) -> int:
        """Index into `chunks()` of the drive's chunk k."""
        n_ramp = self.ramp // self.chunk
        if k < n_ramp:
            return k
        return n_ramp + (k - n_ramp) % (self.lap // self.chunk)
