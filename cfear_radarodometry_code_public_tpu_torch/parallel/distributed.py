"""Multi-process execution over `torch.distributed` (port of
`parallel/distributed.py`).

- `initialize(...)`: brings up the default process group from arguments or
  the environment (CFEAR_COORDINATOR as host:port, CFEAR_NUM_PROCESSES,
  CFEAR_PROCESS_ID), with a `tcp://` rendezvous: NCCL when the process runs
  on a CUDA card, gloo on the CPU. No coordinator, no group.
- `global_mesh(...)`: the `Mesh` of this process over the group (one device
  a process).
- `shard_jobs(...)`: deterministic job assignment, the `job_nr % NR_WORKERS`
  rule of the reference's evaluation fleet, over rank and world size.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from cfear_radarodometry_code_public_tpu_torch.parallel.mesh import (
    Mesh, make_mesh)


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda") -> None:
    """Join the default process group (nothing without a coordinator).
    `device` picks the backend: NCCL for a CUDA card (which must be
    there; the process's card becomes the current one), gloo for the
    CPU."""
    coordinator = coordinator or os.environ.get("CFEAR_COORDINATOR")
    if coordinator is None:
        return
    num_processes = num_processes or int(
        os.environ.get("CFEAR_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("CFEAR_PROCESS_ID", "0"))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "distributed.initialize: the NCCL group needs a CUDA card "
                "and found none; pass device='cpu' for a gloo group")
        # one card a process: rank r of a host takes card r unless the
        # caller names one
        torch.cuda.set_device(device.index if device.index is not None
                              else process_id % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id)


def global_mesh(axes: Tuple[str, ...] = ("data",), device="cuda") -> Mesh:
    """This process's mesh over the default group (one axis)."""
    if len(axes) != 1:
        raise ValueError("the port's mesh has one axis (one device a "
                         "process)")
    return make_mesh(axis=axes[0], device=device)


def shard_jobs(jobs: Sequence, n_workers: Optional[int] = None,
               worker: Optional[int] = None):
    """Deterministic job assignment (reference `utils/worker` semantics)."""
    group = dist.is_available() and dist.is_initialized()
    n_workers = n_workers or (dist.get_world_size() if group else 1)
    worker = worker if worker is not None else (
        dist.get_rank() if group else 0)
    return [j for i, j in enumerate(jobs) if i % n_workers == worker]
