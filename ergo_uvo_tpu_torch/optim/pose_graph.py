"""Pose-graph optimization and descriptor-retrieval loop closure.

Counterpart of ``ergo_uvo_tpu/optim/pose_graph.py``.  A fixed-shape graph of
T pose nodes and E edge slots with a weight each (0: slot unused); the edge
residual is r_e = log(T_meas^-1 · T_j · T_i^-1) in se(3), batched over all
edges; Gauss-Newton assembles a dense (6T x 6T) system by scatter-adds
(``index_put_`` with ``accumulate=True``: atomic adds in no fixed order on the
card, so repeated indices sum to float rounding) and solves it with
``torch.linalg.solve_ex`` without its error check.  The dense Hessian is the
JAX package's semantics, copied.

Loop candidates are the top-K far-apart pairs of a cosine-similarity matrix
of global descriptors, chosen by a stable descending sort so that ties keep
the lowest flat index first, as ``lax.top_k`` does; the caller verifies them
geometrically.

Jacobians use the right-perturbation approximation J_i ~ -Ad(T_i),
J_j ~ Ad(T_i), exact at convergence.  Nothing here reads back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ergo_uvo_tpu_torch.geometry.rotations import skew
from ergo_uvo_tpu_torch.geometry.se3 import SE3, se3_exp, se3_log


class PoseGraph(NamedTuple):
    """T pose nodes (world -> node), E relative-pose edge slots."""

    R: torch.Tensor  # (T, 3, 3)
    t: torch.Tensor  # (T, 3)
    edge_i: torch.Tensor  # (E,) int32 source node
    edge_j: torch.Tensor  # (E,) int32 target node
    edge_R: torch.Tensor  # (E, 3, 3) measured R_ij (x_j = R_ij x_i + t_ij)
    edge_t: torch.Tensor  # (E, 3)
    edge_weight: torch.Tensor  # (E,) information weight (0 = slot unused)


def _adjoint(T: SE3) -> torch.Tensor:
    """SE(3) adjoint (..., 6, 6) for the (rho, w) ordering."""
    R = T.R
    top = torch.cat([R, skew(T.t) @ R], -1)
    bot = torch.cat([torch.zeros_like(R), R], -1)
    return torch.cat([top, bot], -2)


def _node(graph: PoseGraph, idx: torch.Tensor) -> SE3:
    idx = idx.long()
    return SE3(graph.R[idx], graph.t[idx])


def pose_graph_residuals(graph: PoseGraph) -> torch.Tensor:
    """(E, 6) se(3) residuals of every edge slot (weights not applied)."""
    Ti = _node(graph, graph.edge_i)
    Tj = _node(graph, graph.edge_j)
    # Predicted relative T_ij = T_j ∘ T_i^-1 (x_j = R_j R_i^T (x_i - t_i) + t_j).
    T_err = SE3(graph.edge_R, graph.edge_t).inverse().compose(Tj.compose(Ti.inverse()))
    return se3_log(T_err)


def pose_graph_gn_step(graph: PoseGraph, num_fixed: int = 1, damping: float = 1e-6):
    """One Gauss-Newton step; returns (graph', total weighted cost)."""
    T = graph.R.shape[0]
    dev, dtype = graph.R.device, graph.R.dtype
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    r = pose_graph_residuals(graph)
    w = graph.edge_weight
    cost = (w[:, None] * r * r).sum()

    # Right-perturbation updates T <- T exp(xi): dr/dxi_j = Ad(T_i),
    # dr/dxi_i = -Ad(T_i) (small-residual approximation).
    A = _adjoint(_node(graph, graph.edge_i))
    Ji, Jj = -A, A
    wj = w[:, None, None]
    H_ii = wj * (Ji.transpose(-1, -2) @ Ji)
    H_jj = wj * (Jj.transpose(-1, -2) @ Jj)
    H_ij = wj * (Ji.transpose(-1, -2) @ Jj)
    b_i = torch.einsum("eba,eb->ea", Ji, w[:, None] * r)
    b_j = torch.einsum("eba,eb->ea", Jj, w[:, None] * r)

    # Scatter-add the edge blocks into the dense (T, T, 6, 6) Hessian.
    H = torch.zeros((T, T, 6, 6), dtype=dtype, device=dev)
    H.index_put_((ei, ei), H_ii, accumulate=True)
    H.index_put_((ej, ej), H_jj, accumulate=True)
    H.index_put_((ei, ej), H_ij, accumulate=True)
    H.index_put_((ej, ei), H_ij.transpose(-1, -2), accumulate=True)
    b = torch.zeros((T, 6), dtype=dtype, device=dev)
    b.index_put_((ei,), b_i, accumulate=True)
    b.index_put_((ej,), b_j, accumulate=True)

    # Gauge fix + damping.
    ar = torch.arange(T, device=dev)
    free = (ar >= num_fixed).to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    H = H * free[:, None, None, None] * free[None, :, None, None]
    H[ar, ar] += ((1.0 - free) + damping)[:, None, None] * eye6
    b = b * free[:, None]

    Hd = H.permute(0, 2, 1, 3).reshape(T * 6, T * 6)
    dx = -torch.linalg.solve_ex(Hd, b.reshape(T * 6), check_errors=False).result.reshape(T, 6)

    dT = se3_exp(dx)
    R_new = graph.R @ dT.R
    t_new = (graph.R @ dT.t[..., None])[..., 0] + graph.t
    return graph._replace(R=R_new, t=t_new), cost


def optimize_pose_graph(graph: PoseGraph, iters: int = 20, num_fixed: int = 1):
    """Run ``iters`` Gauss-Newton steps; returns (graph, costs (iters,))."""
    costs = []
    for _ in range(iters):
        graph, cost = pose_graph_gn_step(graph, num_fixed)
        costs.append(cost)
    return graph, torch.stack(costs)


def global_descriptor(desc: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Frame-level retrieval descriptor: the L2-normalized masked mean of the
    local descriptors (the matcher's descriptor space)."""
    m = mask[..., None].to(desc.dtype)
    s = (desc * m).sum(-2) / torch.clamp(m.sum(-2), min=1.0)
    return s / torch.clamp(torch.linalg.vector_norm(s, dim=-1, keepdim=True), min=1e-12)


def detect_loop_closures(
    global_descs: torch.Tensor,  # (T, D)
    min_gap: int = 10,
    top_k: int = 8,
    min_similarity: float = 0.85,
):
    """Top-K pairs (i, j) with j - i >= ``min_gap`` by cosine similarity.

    Returns (pairs (top_k, 2) int32, scores (top_k,), valid (top_k,)).
    """
    T = global_descs.shape[0]
    dev = global_descs.device
    sim = global_descs @ global_descs.T
    ii = torch.arange(T, device=dev)[:, None]
    jj = torch.arange(T, device=dev)[None, :]
    scores = torch.where(jj - ii >= min_gap, sim, float("-inf")).reshape(-1)
    flat_scores, flat_idx = torch.sort(scores, descending=True, stable=True)
    flat_scores, flat_idx = flat_scores[:top_k], flat_idx[:top_k].to(torch.int32)
    pairs = torch.stack([flat_idx // T, flat_idx % T], -1)
    valid = torch.isfinite(flat_scores) & (flat_scores >= min_similarity)
    return pairs, flat_scores, valid
