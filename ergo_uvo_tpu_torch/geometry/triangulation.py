"""Batched two-view triangulation and 3-D point gating.

Counterpart of ``ergo_uvo_tpu/geometry/triangulation.py``: inhomogeneous DLT
(w = 1) solved by a closed-form 3x3 adjugate per point, the reprojection and
3-sigma depth gates of ``extract_3Dpoints`` (VO_utility.cpp:188-237) as masks,
and the cheirality mask of ``convert_3Dpoints_camera`` (VO_utility.cpp:46-63).
"""

from __future__ import annotations

import torch

from ergo_uvo_tpu_torch.geometry.stats import masked_mean_and_variance


def triangulate_points(
    P1: torch.Tensor, P2: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor
) -> torch.Tensor:
    """(N, 3) points from (3, 4) projections and (N, 2) pixel coordinates."""

    def rows(P, pts):
        u = pts[..., 0:1]
        v = pts[..., 1:2]
        r0 = u * P[2][None, :] - P[0][None, :]
        r1 = v * P[2][None, :] - P[1][None, :]
        return torch.stack([r0, r1], dim=1)

    A = torch.cat([rows(P1, pts1), rows(P2, pts2)], dim=1)  # (N, 4, 4)
    M = A[..., :3]
    b = -A[..., 3]
    AtA = torch.einsum("nij,nik->njk", M, M)
    Atb = torch.einsum("nij,ni->nj", M, b)
    return _solve33(AtA, Atb)


def _solve33(A: torch.Tensor, b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Batched 3x3 linear solve via the adjugate; singular systems -> 0."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    adj = torch.stack(
        [
            torch.stack([c00, c10, c20], -1),
            torch.stack([c01, c11, c21], -1),
            torch.stack([c02, c12, c22], -1),
        ],
        -2,
    )
    sign_eps = torch.where(det < 0, -eps, eps)
    safe_det = torch.where(det.abs() < eps, sign_eps, det)
    return (adj @ b[..., None])[..., 0] / safe_det[..., None]


def reprojection_errors(
    K: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
    points3d: torch.Tensor, pts2d: torch.Tensor,
) -> torch.Tensor:
    """Per-point pixel reprojection error through K [R|t], zero distortion."""
    pc = points3d @ R.T + t[None, :]
    z = pc[..., 2]
    eps = 1e-9
    safe_z = torch.where(z.abs() < eps, torch.where(z < 0, -eps, eps), z)
    xy = pc[..., :2] / safe_z[..., None]
    uv = torch.stack(
        [xy[..., 0] * K[0, 0] + xy[..., 1] * K[0, 1] + K[0, 2],
         xy[..., 1] * K[1, 1] + K[1, 2]],
        -1,
    )
    return torch.linalg.vector_norm(uv - pts2d, dim=-1)


def filter_3d_points(
    points3d: torch.Tensor,
    mask: torch.Tensor,
    K1: torch.Tensor,
    R1: torch.Tensor,
    t1: torch.Tensor,
    K2: torch.Tensor,
    R2: torch.Tensor,
    t2: torch.Tensor,
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    reprojection_tolerance: float,
    sigma_gate: float = 3.0,
    min_points: int = 0,
):
    """Masked ``extract_3Dpoints``: returns (mask_out ⊆ mask, mean_reproj_err).

    Gate 1: mean two-view reprojection error < tolerance and view-1 Z > 0.
    Gate 2: view-1 Z within mean ± ``sigma_gate``·σ of gate 1's survivors.
    With ``min_points`` > 0 each gate needs that many candidates, or the
    output mask is empty (VO_utility.cpp:203, :222).
    """
    e1 = reprojection_errors(K1, R1, t1, points3d, pts1)
    e2 = reprojection_errors(K2, R2, t2, points3d, pts2)
    mean_err = 0.5 * (e1 + e2)
    z = (points3d @ R1.T + t1[None, :])[..., 2]
    gate1 = mask & (mean_err < reprojection_tolerance) & (z > 0)
    if min_points > 0:
        gate1 = gate1 & (mask.sum() >= min_points)
    z_mean, z_var = masked_mean_and_variance(z, gate1)
    z_std = torch.sqrt(torch.clamp(z_var, min=0.0))
    gate2 = gate1 & ((z - z_mean).abs() <= sigma_gate * z_std)
    if min_points > 0:
        gate2 = gate2 & (gate1.sum() >= min_points)
    return gate2, mean_err


def transform_points(R: torch.Tensor, t: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """x' = R x + t on (N, 3) points."""
    return points @ R.T + t[None, :]


def cheirality_mask(
    R: torch.Tensor, t: torch.Tensor, points: torch.Tensor,
    max_depth: float | None = None,
) -> torch.Tensor:
    """Points with positive depth (and below ``max_depth``) in frame (R, t)."""
    z = (points @ R.T + t[None, :])[..., 2]
    m = z > 0
    if max_depth is not None:
        m = m & (z < max_depth)
    return m
