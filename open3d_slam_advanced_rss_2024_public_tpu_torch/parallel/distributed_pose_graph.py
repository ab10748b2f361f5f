"""Distributed pose-graph solve: edges sharded, normal equations psum-reduced.

Counterpart of the JAX package's ``parallel/distributed_pose_graph.py``
(reference OptimizationProblem.cpp:25-44, a single-threaded Open3D LM
solve).  The edge set, where the residual and Jacobian work is, is split
into D contiguous blocks; each rank assembles its block's share of the
dense 6N x 6N normal equations, and one packed all-reduce of H (36 N^2
floats), b (6 N) and the cost sums them.  The small dense solve and the
state update run replicated.  The LM step's second evaluation, of the
trial point, needs the cost alone, so it reduces one float.

The graph is the JAX package's: padded to ``max_nodes`` nodes and an edge
capacity divisible by D (``padded_arrays``); the padding nodes are pinned
and the padding edges masked.  Like JAX's ``lax.scan``, the solve always
runs ``max_iterations`` trips, with no look at a done flag: every rank
makes the same collectives.  The linear solve is ``torch.linalg.solve_ex``
(no ``info`` readback).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..models import pose_graph as pg
from ..models.pose_graph import PoseGraphArrays, assemble_normal_equations
from ..utils import se3
from ..utils.device import to_device
from .mesh import Mesh, psum, shard_points

Tensor = torch.Tensor


def padded_arrays(node_poses: List[np.ndarray], constraints: List[pg.Constraint],
                  max_nodes: int, max_edges: int, device="cuda") -> PoseGraphArrays:
    """The graph at its full capacity, ``max_nodes`` nodes and
    ``max_edges`` edges, as the JAX package's ``build_arrays`` lays it out
    (``pose_graph.build_arrays`` cuts it to the nodes and edges in use)."""
    buf = pg.pack_graph(node_poses, constraints, max_nodes, max_edges)
    return pg.unpack_graph(to_device(buf, device), max_nodes, max_edges, max_nodes, max_edges)


def _edge_terms(deltas, poses, e_src, e_dst, e_T, e_info, e_unc, e_mask, phi):
    """An edge block's residuals, relative poses, switch weights, chi2 and
    cost share (``models.pose_graph``'s closed forms)."""
    X = poses @ se3.se3_exp(deltas)
    rel = se3.inverse(X[e_src]) @ X[e_dst]
    r = se3.se3_log(se3.inverse(e_T) @ rel)
    chi2 = torch.einsum("ei,eij,ej->e", r, e_info, r)
    s = torch.where(e_unc, (phi / (phi + chi2)) ** 2, 1.0)
    s = torch.where(e_mask, s, 0.0)
    cost = (s * chi2).sum() + torch.where(e_unc & e_mask,
                                          phi * (1.0 - torch.sqrt(s)) ** 2, 0.0).sum()
    return r, rel, s, cost


def make_distributed_solver(mesh: Mesh, max_nodes: int, max_iterations: int = 30):
    """A distributed LM solver for graphs of ``max_nodes`` nodes whose edge
    capacity divides by the mesh size.

    solve(graph, reference_node, loop_closure_preference) -> (X f32[N,4,4],
    the cost at the start of the last trip), both replicated.
    """
    N = max_nodes

    def solve(graph: PoseGraphArrays, reference_node, loop_closure_preference):
        if graph.node_poses.shape[0] != N:
            raise ValueError(f"the graph has {graph.node_poses.shape[0]} nodes, the solver "
                             f"{N}: build it with padded_arrays")
        dev = graph.node_poses.device
        f32 = torch.float32
        eye6 = torch.eye(6, dtype=f32, device=dev)
        n_edges = torch.clamp(graph.edge_mask.sum(dtype=f32), min=1.0)
        info_scale = (torch.where(graph.edge_mask[:, None, None], graph.edge_info, 0.0)
                      * eye6).sum() / (6.0 * n_edges)
        phi = loop_closure_preference * torch.clamp(info_scale, min=1e-6)
        edges = [shard_points(mesh, t) for t in (graph.edge_src, graph.edge_dst, graph.edge_T,
                                                 graph.edge_info, graph.edge_uncertain,
                                                 graph.edge_mask)]
        e_src, e_dst, _, e_info = edges[:4]
        poses = graph.node_poses
        pin = torch.arange(N, device=dev) == torch.as_tensor(reference_node, device=dev)
        masked_out = (pin | ~graph.node_mask).repeat_interleave(6)
        blocked = masked_out[:, None] | masked_out[None, :]

        def normal_equations(deltas):
            r, rel, s, cost = _edge_terms(deltas, poses, *edges, phi)
            Jinv = se3.log_right_jacobian_inv(r)
            Ji = -(Jinv @ se3.adjoint(se3.inverse(rel)))
            Hb, b = assemble_normal_equations(r, Ji, Jinv, e_info * s[:, None, None],
                                              e_src, e_dst, N)
            packed = psum(mesh, torch.cat([Hb.permute(0, 2, 1, 3).reshape(-1),
                                           b.reshape(-1), cost[None]]))
            return (packed[:36 * N * N].reshape(6 * N, 6 * N),
                    packed[36 * N * N:-1], packed[-1])

        deltas = torch.zeros((N, 6), dtype=f32, device=dev)
        lam = torch.full((), 1e-4, dtype=f32, device=dev)
        cost = torch.full((), float("inf"), dtype=f32, device=dev)
        for _ in range(max_iterations):
            H, b, cost = normal_equations(deltas)
            H = torch.where(blocked, 0.0, H) + torch.diag(torch.where(masked_out, 1.0, lam))
            b = torch.where(masked_out, 0.0, b)
            dx = torch.linalg.solve_ex(H, b[:, None])[0][:, 0]
            new_deltas = deltas + dx.reshape(N, 6)
            new_cost = psum(mesh, _edge_terms(new_deltas, poses, *edges, phi)[3])
            improved = new_cost < cost
            deltas = torch.where(improved, new_deltas, deltas)
            lam = torch.where(improved, lam * 0.7, lam * 2.5)
        return poses @ se3.se3_exp(deltas), cost

    return solve
