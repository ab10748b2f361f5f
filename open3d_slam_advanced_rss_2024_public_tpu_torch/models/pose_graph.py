"""Sparse pose-graph optimization as a batched Levenberg-Marquardt solve.

Counterpart of the JAX package's ``models/pose_graph.py`` (reference
OptimizationProblem.cpp:25-212: certain odometry edges and uncertain
loop-closure edges, solved with edge pruning and a loop-closure preference,
returning per-submap transform increments).

The graph travels to the device as one fixed-capacity buffer and is cut
there to the nodes and edges in use (eager tensors need no fixed shape, and
the dense solve of a 7-submap graph is then 42 x 42 instead of
6 * max_nodes square); residuals and closed-form
Jacobian blocks are batched over the edges, the normal equations assemble
with accumulating ``index_put_``, and uncertain edges carry
switchable-constraint weights in closed form each iteration.

The JAX package compiles the LM iteration as a ``lax.while_loop``.  Here the
loop runs up to ``max_iterations`` trips with a device-side ``done`` flag
that freezes the carry, so the result is the while loop's.  So that a
converged solve does not pay for the remaining trips, the flag is copied to
pinned host memory every few trips without waiting, and the loop stops
dispatching once a copy that has already landed says done: the host never
waits on the device, and ``resolve_async`` is the only blocking read.  The
dense solve is ``torch.linalg.solve_ex`` (no ``info`` check on the host);
the pinned rows and columns keep the matrix regular.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.registration.icp import POLL_EVERY
from ..utils import se3
from ..utils.device import HostCopy, resolve_device, to_device

Tensor = torch.Tensor


@dataclasses.dataclass
class Constraint:
    """≙ reference Constraint (Constraint.hpp): relative transform from
    source submap frame to target submap frame."""

    source_id: int
    target_id: int
    # T maps target-frame coordinates into source-frame coordinates:
    # X_source^-1 X_target ≈ T (measured).
    T_source_target: np.ndarray
    information: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(6, dtype=np.float32))
    is_odometry: bool = True  # certain edge (not prunable)


@dataclasses.dataclass(frozen=True)
class PoseGraphArrays:
    """Device-side pose graph, N nodes and E edges (those in use, at
    least one of each: a graph with none keeps one masked-out lane)."""

    node_poses: Tensor      # f32[N,4,4] initial poses (map frame)
    node_mask: Tensor       # bool[N]
    edge_src: Tensor        # i64[E]
    edge_dst: Tensor        # i64[E]
    edge_T: Tensor          # f32[E,4,4] measured relative transforms
    edge_info: Tensor       # f32[E,6,6]
    edge_uncertain: Tensor  # bool[E] (loop closures: switchable)
    edge_mask: Tensor       # bool[E]


def build_arrays(node_poses: List[np.ndarray], constraints: List[Constraint],
                 max_nodes: int, max_edges: int, device="cuda") -> PoseGraphArrays:
    """One packed host buffer, one transfer (``pack_graph``), unpacked on
    the device."""
    buf = pack_graph(node_poses, constraints, max_nodes, max_edges)
    return unpack_graph(to_device(buf, device), max_nodes, max_edges,
                        len(node_poses), len(constraints))


def _edge_error(deltas: Tensor, graph: PoseGraphArrays):
    """rel = X_src^-1 X_dst and r = log(T_meas^-1 rel), X_k = X0_k exp(delta_k)."""
    X = graph.node_poses @ se3.se3_exp(deltas)  # [N,4,4]
    rel = se3.inverse(X[graph.edge_src]) @ X[graph.edge_dst]
    return rel, se3.se3_log(se3.inverse(graph.edge_T) @ rel)


def _edge_residuals(deltas: Tensor, graph: PoseGraphArrays) -> Tensor:
    return _edge_error(deltas, graph)[1]  # [E,6]


def edge_residuals_and_jacobians(deltas: Tensor, graph: PoseGraphArrays):
    """Residuals plus closed-form per-edge 6x6 Jacobian blocks.  With right
    perturbations X_k <- X_k exp(xi_k): J_j = Jr^{-1}(r) and
    J_i = -Jr^{-1}(r) Ad(rel^-1).  Returns (r [E,6], J_i, J_j [E,6,6])."""
    rel, r = _edge_error(deltas, graph)
    Jinv = se3.log_right_jacobian_inv(r)
    return r, -(Jinv @ se3.adjoint(se3.inverse(rel))), Jinv


def assemble_normal_equations(r: Tensor, Ji: Tensor, Jj: Tensor, W: Tensor,
                              edge_src: Tensor, edge_dst: Tensor, n_nodes: int):
    """Accumulate per-edge blocks into block-dense normal equations:
    H [N,N,6,6] and b [N,6].  Duplicate indices accumulate
    (``index_put_(accumulate=True)``), so parallel edges sum."""
    WJi = W @ Ji
    WJj = W @ Jj
    Hii = torch.einsum("eki,ekj->eij", Ji, WJi)
    Hjj = torch.einsum("eki,ekj->eij", Jj, WJj)
    Hij = torch.einsum("eki,ekj->eij", Ji, WJj)
    bi = -torch.einsum("ekn,ek->en", WJi, r)
    bj = -torch.einsum("ekn,ek->en", WJj, r)
    H = r.new_zeros((n_nodes, n_nodes, 6, 6))
    H.index_put_((edge_src, edge_src), Hii, accumulate=True)
    H.index_put_((edge_dst, edge_dst), Hjj, accumulate=True)
    H.index_put_((edge_src, edge_dst), Hij, accumulate=True)
    H.index_put_((edge_dst, edge_src), Hij.transpose(-1, -2), accumulate=True)
    b = r.new_zeros((n_nodes, 6))
    b.index_put_((edge_src,), bi, accumulate=True)
    b.index_put_((edge_dst,), bj, accumulate=True)
    return H, b


def _chi2(r: Tensor, info: Tensor) -> Tensor:
    return torch.einsum("ei,eij,ej->e", r, info, r)


def _switch_weights(graph: PoseGraphArrays, chi2: Tensor, phi: Tensor) -> Tensor:
    """s = (phi / (phi + chi2))^2 on uncertain edges, 1 on certain ones."""
    s = torch.where(graph.edge_uncertain, (phi / (phi + chi2)) ** 2, 1.0)
    return torch.where(graph.edge_mask, s, 0.0)


def _solve_impl(graph: PoseGraphArrays, reference_node: Tensor, loop_closure_preference,
                max_iterations: int):
    N = graph.node_poses.shape[0]
    dev = graph.node_poses.device
    f32 = torch.float32
    # Line-process weight scaled by the typical edge information magnitude,
    # as Open3D's GlobalOptimization does.
    eye6 = torch.eye(6, dtype=f32, device=dev)
    n_edges = torch.clamp(graph.edge_mask.sum(dtype=f32), min=1.0)
    info_scale = (torch.where(graph.edge_mask[:, None, None], graph.edge_info, 0.0)
                  * eye6).sum() / (6.0 * n_edges)
    phi = loop_closure_preference * torch.clamp(info_scale, min=1e-6)
    switchable = graph.edge_uncertain & graph.edge_mask

    def cost(d):
        c2 = _chi2(_edge_residuals(d, graph), graph.edge_info)
        ss = _switch_weights(graph, c2, phi)
        # SC adds a prior pulling s -> 1: phi * (1 - sqrt(s))^2.
        return (ss * c2).sum() + torch.where(switchable,
                                             phi * (1.0 - torch.sqrt(ss)) ** 2, 0.0).sum()

    pin6 = (torch.arange(N, device=dev) == reference_node).repeat_interleave(6)
    masked_out = pin6 | (~graph.node_mask).repeat_interleave(6)
    blocked = masked_out[:, None] | masked_out[None, :]

    def step(deltas, lam, prev_cost):
        r, Ji, Jj = edge_residuals_and_jacobians(deltas, graph)
        s = _switch_weights(graph, _chi2(r, graph.edge_info), phi)
        W = graph.edge_info * s[:, None, None]
        Hb, b = assemble_normal_equations(r, Ji, Jj, W, graph.edge_src, graph.edge_dst, N)
        H = Hb.permute(0, 2, 1, 3).reshape(N * 6, N * 6)
        # Pin the reference node and the unused nodes: zero rows and
        # columns, unit diagonal.
        H = torch.where(blocked, 0.0, H) + torch.diag(torch.where(masked_out, 1.0, lam))
        b = torch.where(masked_out, 0.0, b.reshape(N * 6))
        dx = torch.linalg.solve_ex(H, b[:, None])[0][:, 0]
        new_deltas = deltas + dx.reshape(N, 6)
        # LM accept/reject on the total weighted cost.
        new_cost = cost(new_deltas)
        improved = new_cost < prev_cost
        best_cost = torch.minimum(new_cost, prev_cost)
        converged = ((improved & (prev_cost - new_cost
                                  <= 1e-6 * torch.clamp(prev_cost, min=1e-3)))
                     | (best_cost < 1e-9) | (torch.where(improved, lam * 0.7, lam * 2.5) > 1e8))
        return (torch.where(improved, new_deltas, deltas),
                torch.where(improved, lam * 0.7, lam * 2.5), best_cost, converged)

    deltas = torch.zeros((N, 6), dtype=f32, device=dev)
    lam = torch.full((), 1e-4, dtype=f32, device=dev)
    prev_cost = cost(deltas)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    polls: List[HostCopy] = []
    for it in range(max_iterations):
        if any(p.ready() and bool(p.host[0]) for p in polls):
            break
        d_new, lam_new, cost_new, conv = step(deltas, lam, prev_cost)
        deltas = torch.where(done, deltas, d_new)
        lam = torch.where(done, lam, lam_new)
        prev_cost = torch.where(done, prev_cost, cost_new)
        done = done | conv
        if (it + 1) % POLL_EVERY == 0:
            polls.append(HostCopy([done]))
    X = graph.node_poses @ se3.se3_exp(deltas)
    chi2 = _chi2(_edge_residuals(deltas, graph), graph.edge_info)
    s = _switch_weights(graph, chi2, phi)
    return X, s, (s * chi2).sum()


def solve(graph: PoseGraphArrays, reference_node=0, loop_closure_preference: float = 2.0,
          edge_prune_threshold: float = 0.2, max_iterations: int = 30):
    """LM with switchable loop-closure weights.  Returns (optimized_poses
    f32[N,4,4], switch_weights f32[E], final_cost), all on the graph's
    device; the reference node is pinned.  ``edge_prune_threshold`` keeps
    the JAX package's signature and is not read by the solve: pruning is
    ``OptimizationProblem.pruned_loop_closures``' look at the weights."""
    return _solve_impl(graph, reference_node, loop_closure_preference, max_iterations)


# -- packed single-transfer path ---------------------------------------------
#
# The whole graph and the solve scalars travel as ONE flat f32 buffer (one
# pinned host-to-device copy) and are unpacked on the device.

_NODE_F = 16           # 4x4 pose
_EDGE_F = 55           # src, dst, uncertain, 16 T, 36 info
_HDR = 5               # n_nodes, n_edges, reference_node, preference, prune


def pack_graph(node_poses: List[np.ndarray], constraints: List[Constraint],
               max_nodes: int, max_edges: int,
               edge_block: Optional[np.ndarray] = None, reference_node: int = 0,
               loop_closure_preference: float = 2.0,
               edge_prune_threshold: float = 0.2) -> np.ndarray:
    """Flatten the graph AND the solve scalars to one f32 buffer:
    [5 header | nodes | edges].  ``edge_block``: a previously packed edge
    section (callers cache it: the constraints change less often than the
    node poses)."""
    n, e = len(node_poses), len(constraints)
    if n > max_nodes or e > max_edges:
        raise ValueError(
            f"pose graph exceeds capacity: {n}/{max_nodes} nodes, {e}/{max_edges} edges")
    buf = np.zeros(_HDR + max_nodes * _NODE_F + max_edges * _EDGE_F, np.float32)
    buf[:_HDR] = [n, e, reference_node, loop_closure_preference, edge_prune_threshold]
    nodes = buf[_HDR:_HDR + max_nodes * _NODE_F].reshape(max_nodes, 4, 4)
    nodes[:] = np.eye(4, dtype=np.float32)
    if n:
        nodes[:n] = np.stack(node_poses).astype(np.float32)
    edges = buf[_HDR + max_nodes * _NODE_F:].reshape(max_edges, _EDGE_F)
    if edge_block is not None:
        edges[:] = edge_block
    else:
        edges[:, 3:19] = np.eye(4, dtype=np.float32).ravel()
        edges[:, 19:] = np.eye(6, dtype=np.float32).ravel()
        for i, c in enumerate(constraints):
            edges[i, 0] = c.source_id
            edges[i, 1] = c.target_id
            edges[i, 2] = 0.0 if c.is_odometry else 1.0
            edges[i, 3:19] = np.asarray(c.T_source_target, np.float32).ravel()
            edges[i, 19:] = np.asarray(c.information, np.float32).ravel()
    return buf


def unpack_graph(buf: Tensor, max_nodes: int, max_edges: int, n_nodes: int,
                 n_edges: int) -> PoseGraphArrays:
    """Device-side unpack of a ``pack_graph`` buffer, cut to the
    ``n_nodes`` nodes and ``n_edges`` edges in use (the host that packed
    the buffer knows both; the masked-out rest contributes nothing)."""
    dev = buf.device
    N, E = max(n_nodes, 1), max(n_edges, 1)
    nodes = buf[_HDR:_HDR + max_nodes * _NODE_F].reshape(max_nodes, 4, 4)[:N]
    edges = buf[_HDR + max_nodes * _NODE_F:].reshape(max_edges, _EDGE_F)[:E]
    return PoseGraphArrays(
        node_poses=nodes,
        node_mask=torch.arange(N, device=dev) < buf[0],
        edge_src=edges[:, 0].to(torch.int64),
        edge_dst=edges[:, 1].to(torch.int64),
        edge_T=edges[:, 3:19].reshape(E, 4, 4),
        edge_info=edges[:, 19:].reshape(E, 6, 6),
        edge_uncertain=edges[:, 2] > 0.5,
        edge_mask=torch.arange(E, device=dev) < buf[1])


def solve_packed(buf: Tensor, max_nodes: int, max_edges: int, n_nodes: int, n_edges: int,
                 max_iterations: int = 30):
    """``solve`` over a ``pack_graph`` buffer on the device (the reference
    node and the preference ride the header).  The outputs hold
    ``n_nodes`` poses and ``n_edges`` weights."""
    graph = unpack_graph(buf, max_nodes, max_edges, n_nodes, n_edges)
    return _solve_impl(graph, buf[2].to(torch.int64), buf[3], max_iterations)


class OptimizationProblem:
    """Host-side wrapper: constraint bookkeeping + solve + increments.

    ≙ reference OptimizationProblem: odometry constraints are 'certain',
    loop closures 'uncertain'; after the solve, loop-closure edges whose
    switch weight fell below edge_prune_threshold count as pruned;
    increments are dT_i = X_opt_i · X_init_i^-1 per submap (:191-202).
    """

    def __init__(self, max_nodes: int = 128, max_edges: int = 512, device=None):
        self.device = resolve_device(device)
        self.max_nodes = max_nodes
        self.max_edges = max_edges
        self.odometry_constraints: List[Constraint] = []
        self.loop_closure_constraints: List[Constraint] = []
        self.node_poses: List[np.ndarray] = []
        self.is_ready = False
        self.last_switch_weights: Optional[np.ndarray] = None
        # Packed edge section cache: constraints change rarely relative to
        # solves; node poses repack every call (cheap numpy).
        self._edge_block: Optional[np.ndarray] = None

    def insert_odometry_constraints(self, cs: List[Constraint]) -> None:
        # Dedup by (source, target) like the reference (:177-189).
        seen = {(c.source_id, c.target_id) for c in self.odometry_constraints}
        for c in cs:
            if (c.source_id, c.target_id) not in seen:
                self.odometry_constraints.append(c)
                seen.add((c.source_id, c.target_id))
                self._edge_block = None

    def insert_loop_closure_constraints(self, cs: List[Constraint]) -> None:
        self.loop_closure_constraints.extend(cs)
        if cs:
            self._edge_block = None

    def clear_loop_closure_constraints(self) -> None:
        self.loop_closure_constraints.clear()
        self._edge_block = None

    def build(self, node_poses: List[np.ndarray]) -> PoseGraphArrays:
        """≙ buildOptimizationProblem (:50-121)."""
        self.node_poses = [np.asarray(p, np.float32) for p in node_poses]
        return build_arrays(self.node_poses,
                            self.odometry_constraints + self.loop_closure_constraints,
                            self.max_nodes, self.max_edges, device=self.device)

    def solve_async(self, node_poses: List[np.ndarray],
                    loop_closure_preference: float = 2.0,
                    edge_prune_threshold: float = 0.2, reference_node: int = 0,
                    max_iterations: int = 30):
        """Dispatch the solve and return a handle; nothing here waits for
        the device.  ``resolve_async`` blocks only on the readback whose
        copy was started here."""
        self.node_poses = [np.asarray(p, np.float32) for p in node_poses]
        cs = self.odometry_constraints + self.loop_closure_constraints
        buf = pack_graph(self.node_poses, cs, self.max_nodes, self.max_edges,
                         edge_block=self._edge_block, reference_node=reference_node,
                         loop_closure_preference=loop_closure_preference,
                         edge_prune_threshold=edge_prune_threshold)
        if self._edge_block is None:
            self._edge_block = buf[_HDR + self.max_nodes * _NODE_F:].reshape(
                self.max_edges, _EDGE_F).copy()
        X, s, _ = solve_packed(to_device(buf, self.device), self.max_nodes, self.max_edges,
                               len(self.node_poses), len(cs), max_iterations=max_iterations)
        return (HostCopy([X, s]), list(self.node_poses))

    def resolve_async(self, handle) -> Dict[int, np.ndarray]:
        """Read a ``solve_async`` handle back into per-node increments
        {node_id: dT} with dT = X_opt · X_init^-1."""
        copy, poses0 = handle
        X, s = copy.wait()
        self.last_switch_weights = np.array(s)
        increments = {}
        for i, X0 in enumerate(poses0):
            increments[i] = (X[i] @ np.linalg.inv(X0)).astype(np.float32)
        self.is_ready = True
        return increments

    def solve(self, node_poses: List[np.ndarray], loop_closure_preference: float = 2.0,
              edge_prune_threshold: float = 0.2, reference_node: int = 0,
              max_iterations: int = 30) -> Dict[int, np.ndarray]:
        """Synchronous solve: dispatch + immediate readback."""
        return self.resolve_async(self.solve_async(
            node_poses, loop_closure_preference, edge_prune_threshold,
            reference_node, max_iterations))

    def pruned_loop_closures(self, edge_prune_threshold: float = 0.2) -> List[int]:
        if self.last_switch_weights is None:
            return []
        n_odom = len(self.odometry_constraints)
        return [i for i in range(len(self.loop_closure_constraints))
                if self.last_switch_weights[n_odom + i] < edge_prune_threshold]

    # -- persistence (≙ JSON dump/load, OptimizationProblem.cpp:142-149) ----

    def to_dict(self) -> dict:
        def ser(c: Constraint) -> dict:
            return {"source": c.source_id, "target": c.target_id,
                    "T": np.asarray(c.T_source_target).tolist(),
                    "information": np.asarray(c.information).tolist(),
                    "is_odometry": c.is_odometry}
        return {"odometry_constraints": [ser(c) for c in self.odometry_constraints],
                "loop_closure_constraints": [ser(c) for c in self.loop_closure_constraints]}

    @classmethod
    def from_dict(cls, d: dict, max_nodes: int = 128, max_edges: int = 512, device=None):
        def de(cd: dict) -> Constraint:
            return Constraint(source_id=cd["source"], target_id=cd["target"],
                              T_source_target=np.asarray(cd["T"], np.float32),
                              information=np.asarray(cd["information"], np.float32),
                              is_odometry=cd["is_odometry"])
        out = cls(max_nodes, max_edges, device=device)
        out.odometry_constraints = [de(c) for c in d["odometry_constraints"]]
        out.loop_closure_constraints = [de(c) for c in d["loop_closure_constraints"]]
        return out
