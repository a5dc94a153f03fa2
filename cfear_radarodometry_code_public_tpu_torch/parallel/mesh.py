"""The device mesh and batched multi-sequence odometry (port of
`parallel/mesh.py`).

The reference's evaluation fleet is a bash process fleet, one
`offline_odometry` process per (sequence, config) job; the reference
package steps a batch of sequences in lockstep instead, sharded over the
devices of a `data` axis. Here the batch is a leading lane axis of the
port's `make_batched_step` on one device, and a process group spreads it
over processes, one device each: a rank holds a contiguous block of B/size
lanes. Sequences never talk to each other, so a step needs no collective;
only `trajectories()` gathers the lanes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from cfear_radarodometry_code_public_tpu_torch.models import odometry
from cfear_radarodometry_code_public_tpu_torch.utils import trace


@dataclasses.dataclass
class Mesh:
    """One process's place on the mesh: its device, the process group
    (None for one process), the axis name, its rank and the group size."""

    device: torch.device
    group: Optional[object] = None
    axis: str = "data"
    rank: int = 0
    size: int = 1

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the group (in place); the identity for one
        process."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def lanes(self, batch: int) -> slice:
        """This rank's contiguous block of a batch of `batch` lanes."""
        if batch % self.size:
            raise ValueError(f"a batch of {batch} does not divide over "
                             f"{self.size} processes")
        per = batch // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def gather(self, rows: np.ndarray) -> np.ndarray:
        """Every rank's (lanes, ...) host rows, concatenated in rank
        order."""
        if self.group is None:
            return rows
        parts = [None] * self.size
        dist.all_gather_object(parts, rows, group=self.group)
        return np.concatenate(parts)


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device="cuda") -> Mesh:
    """The mesh over the default process group, if one is up, else over
    this process alone. `device` is the CUDA card unless the caller asks
    for the CPU; each process holds one device, so `n_devices` must be the
    group's size."""
    if dist.is_available() and dist.is_initialized():
        group, rank = dist.group.WORLD, dist.get_rank()
        size = dist.get_world_size()
    else:
        group, rank, size = None, 0, 1
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices needs that many "
                         f"processes, one device each; the group has {size}")
    device = odometry.resolve_device(device, "make_mesh")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(device, group, axis, rank, size)


def make_batched_runner(cfg, mesh: Mesh, ingest: str = "image"):
    """(init_fn, step_chunk, shard_batch, bootstrap_batch) for this rank's
    lanes of a batch of sequences, as the reference's (:33-89). States and
    inputs carry a leading lane axis; `step_chunk` steps every lane over a
    chunk of frames (inputs (lanes, T, ...)) with `make_batched_step`.
    `ingest` is the step's kind: "image", "compact" or "candidates"."""
    stepb = odometry.make_batched_step(cfg, ingest)
    bootstrap = odometry.make_bootstrap(cfg, ingest, batched=True)

    def shard_batch(tree):
        """This rank's lanes of (B, ...) host arrays or tensors, on the
        mesh's device."""
        def put(a):
            rows = a[mesh.lanes(a.shape[0])]
            if isinstance(rows, np.ndarray):
                return odometry.upload_images(rows, mesh.device)
            return rows.to(mesh.device)
        return odometry._map(put, tree)

    def init_fn(batch: int) -> odometry.OdometryState:
        lanes = mesh.lanes(batch)
        return odometry.init_state(cfg, mesh.device,
                                   batch=lanes.stop - lanes.start)

    def bootstrap_batch(states, first):
        """(lanes, ...) states + first frames -> initialised states."""
        return bootstrap(states, first)

    def step_chunk(states, inputs):
        """inputs (lanes, T, ...) -> (states, FrameOutput (lanes, T, ...))."""
        outs = []
        first = inputs if torch.is_tensor(inputs) else inputs[0]
        for t in range(first.shape[1]):
            states, o = stepb(states, odometry._map(
                lambda a, t=t: a[:, t].contiguous(), inputs))
            outs.append(o)
        return states, odometry.FrameOutput(
            *(torch.stack(x, 1) for x in zip(*outs)))

    return init_fn, step_chunk, shard_batch, bootstrap_batch


class MultiSequenceRunner:
    """The host loop over a batch of sequences (the "fleet") on the mesh's
    device: the CUDA card unless the caller passes `device="cpu"` (or a
    mesh on the CPU). `ingest="image"` uploads the raw sweeps, which the
    device filters; `ingest="host"` runs the native host filter (compact
    rows with a point budget, candidate sets otherwise, CA-CFAR detections
    with `filter.method="cacfar"`) and uploads its rows."""

    def __init__(self, cfg, batch: int, mesh: Optional[Mesh] = None,
                 chunk: int = 16, ingest: str = "image", device="cuda"):
        self.cfg = cfg
        self.chunk = chunk
        self.ingest = ingest
        self.mesh = mesh or make_mesh(device=device)
        self.kind = odometry._ingest_kind(cfg, ingest)
        (self.init_fn, self.step_chunk, self.shard_batch,
         self.bootstrap_batch) = make_batched_runner(cfg, self.mesh,
                                                     ingest=self.kind)
        self.batch = batch
        self.states = self.init_fn(batch)
        self.outputs: list = []   # FrameOutputs of numpy (lanes, t, ...)

    def _prepare(self, images: np.ndarray):
        """(B, T, A, R) raw frames -> per-frame host inputs (B, T, ...):
        the frames themselves, or the host filter's rows of every lane, as
        the reference's `_prepare` (`shard_batch` then takes this rank's
        lanes)."""
        if self.kind == "image":
            return images
        b, t = images.shape[:2]
        rows = odometry.host_filter(images.reshape((-1,) + images.shape[2:]),
                                    self.cfg, self.kind)
        return odometry._map(lambda a: a.reshape((b, t) + a.shape[1:]), rows)

    def process(self, images: np.ndarray) -> None:
        """images: (B, T, A, R) uint8."""
        if images.shape[0] != self.batch:
            raise ValueError(f"{images.shape[0]} sequences for a runner of "
                             f"{self.batch}")
        t = images.shape[1]
        if not t:
            return
        inp = self._prepare(images)

        def part(lo, hi):
            with trace.span("fleet.upload"):
                return self.shard_batch(odometry._map(
                    lambda x: x[:, lo:hi], inp))

        def keep(out):
            with trace.span("fleet.readback"):
                self.outputs.append(odometry.FrameOutput(
                    *(a.cpu().numpy() for a in out)))

        start = 0
        if not trace.item("sync.bootstrap", self.states.initialized.any()):
            with trace.span("fleet.upload"):
                first = self.shard_batch(odometry._map(lambda x: x[:, 0],
                                                       inp))
            self.states, out0 = self.bootstrap_batch(self.states, first)
            keep(odometry._map(lambda a: a[:, None], out0))
            start = 1
        for lo in range(start, t, self.chunk):
            self.states, out = self.step_chunk(
                self.states, part(lo, min(lo + self.chunk, t)))
            keep(out)

    def frame_outputs(self) -> odometry.FrameOutput:
        """This rank's frame outputs so far (numpy, (lanes, T, ...))."""
        return odometry.FrameOutput(
            *(np.concatenate(xs, 1) for xs in zip(*self.outputs)))

    def trajectories(self) -> np.ndarray:
        """(B, T, 3) global f64 trajectories of every lane, gathered from
        every rank."""
        out = self.frame_outputs()
        mine = np.stack([odometry.compose_trajectory(
            odometry.FrameOutput(*(a[i] for a in out)))
            for i in range(out.pose.shape[0])])
        return self.mesh.gather(mine)
