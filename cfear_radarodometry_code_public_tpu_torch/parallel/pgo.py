"""Edge-sharded pose-graph optimization over a process group (port of
`parallel/pgo.py`).

Constraint edges are split over the mesh's ranks and node poses are
replicated: every Gauss-Newton gradient, Hessian-vector product,
preconditioner block, cost and step-ladder cost is an edge-local sum
followed by one `torch.distributed.all_reduce` (where the reference
`psum`s, :98-144). The CG state is replicated, so every rank walks the same
solution. It is `posegraph.optimize` with the all-reduce as `gn_step`'s
reduction hook: on one process it equals `optimize` bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from cfear_radarodometry_code_public_tpu_torch.models import posegraph
from cfear_radarodometry_code_public_tpu_torch.models.posegraph import (
    DEFAULT_GNC_START, DEFAULT_LOOP_LOSS, DEFAULT_LOOP_LOSS_LIMIT, PoseGraph,
    anneal_start, gn_iterations)
from cfear_radarodometry_code_public_tpu_torch.parallel.mesh import Mesh


def _pad_edges(graph: PoseGraph, n_dev: int) -> PoseGraph:
    """Pad the edge arrays to a multiple of `n_dev` with invalid edges
    (robust-limit scale 1)."""
    pad = (-graph.edge_i.shape[0]) % n_dev
    if pad == 0:
        return graph

    def grow(a, value=0):
        return torch.cat([a, torch.full((pad,) + a.shape[1:], value,
                                        dtype=a.dtype, device=a.device)])

    return graph._replace(
        edge_i=grow(graph.edge_i), edge_j=grow(graph.edge_j),
        t_ij=grow(graph.t_ij), sqrt_info=grow(graph.sqrt_info),
        edge_type=grow(graph.edge_type), edge_valid=grow(graph.edge_valid),
        loop_scale=(None if graph.loop_scale is None
                    else grow(graph.loop_scale, 1.0)))


def _shard(graph: PoseGraph, mesh: Mesh) -> PoseGraph:
    """This rank's contiguous block of the (padded) edges."""
    lanes = mesh.lanes(graph.edge_i.shape[0])
    return graph._replace(**{
        f: getattr(graph, f)[lanes]
        for f in ("edge_i", "edge_j", "t_ij", "sqrt_info", "edge_type",
                  "edge_valid", "loop_scale")
        if getattr(graph, f) is not None})


def distributed_optimize(graph: PoseGraph, mesh: Mesh, iters: int = 10,
                         cg_iters: int = 50, damping: float = 1e-6,
                         loop_loss: str = DEFAULT_LOOP_LOSS,
                         loop_loss_limit: float = DEFAULT_LOOP_LOSS_LIMIT,
                         gnc_start: float = DEFAULT_GNC_START):
    """Edge-sharded Gauss-Newton on the mesh's device: returns (the graph
    with optimized poses, the last step's cost), on every rank. The same
    robust-loop-edge, CANDIDATE-masking and graduated-non-convexity
    semantics as `posegraph.optimize`; the anneal start is taken from the
    whole graph, before it is sharded."""
    graph = PoseGraph(*(None if a is None else a.to(mesh.device)
                        for a in graph))
    graph = _pad_edges(graph, mesh.size)
    start = anneal_start(graph, loop_loss, loop_loss_limit, gnc_start)
    poses, cost = gn_iterations(_shard(graph, mesh), start, iters, cg_iters,
                                damping, loop_loss, loop_loss_limit,
                                reduce=mesh.all_reduce)
    return graph._replace(poses=poses), cost


def optimize_graph(gb: posegraph.GraphBuilder, iters: int, mesh=None,
                   device="cuda") -> np.ndarray:
    """The builder's graph optimized (`iters` GN iterations) on `device`,
    or edge-sharded over the mesh's group on its device: (K, 3) poses."""
    if mesh is None:
        opt, _ = posegraph.optimize(gb.to_arrays(device=device), iters=iters)
    else:
        opt, _ = distributed_optimize(gb.to_arrays(device=mesh.device), mesh,
                                      iters=iters)
    return opt.poses.cpu().numpy()
