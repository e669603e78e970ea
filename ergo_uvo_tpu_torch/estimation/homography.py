"""Homography estimation, decomposition and pose vote — counterpart of ``ergo_uvo_tpu/estimation/homography.py``.

``findHomography`` + ``decomposeHomographyMat`` + the reference's candidate
vote ``recover_pose_homography`` (VO_utility.cpp:152-154, :581-624):

* a 4-point DLT per hypothesis as a batched 8x8 solve (h33 = 1 gauge);
* forward transfer error ||p2 - H p1||^2 in pixels;
* Faugeras' SVD decomposition of K^-1 H K into four (R, t, n) candidates;
* the vote: triangulate the inliers and count 0 < Z < HOMOGRAPHY_DISTANCE;
  with no vote the previous (R, t) is kept.

A sign flip of an SVD column (``torch.linalg.svd`` against
``jnp.linalg.svd``) permutes the four candidates; on tied votes the chosen
(R, t) can then differ from the JAX package's, so the tests compare the
chosen (R, t) and the vote count, not the candidate index.
"""

from __future__ import annotations

import math

import torch

from ergo_uvo_tpu_torch.config import LMEDS
from ergo_uvo_tpu_torch.estimation.robust import inlier_mask_for_model, score_hypotheses
from ergo_uvo_tpu_torch.estimation.sampling import Sampler, draw_minimal_sets
from ergo_uvo_tpu_torch.geometry.linalg import smallest_eigvec, svd_or_nan
from ergo_uvo_tpu_torch.geometry.triangulation import triangulate_points
from ergo_uvo_tpu_torch.utils.profiling import span


def four_point_homography(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Batched exact homography from 4 correspondences (H, 4, 2) -> (H, 3, 3).

    Degenerate sets give non-finite entries, which robust scoring rejects
    (``solve_ex`` does not raise on a singular system, as ``jnp.linalg.solve``
    does not).
    """
    x, y = p1[..., 0], p1[..., 1]
    xp, yp = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    rows_x = torch.stack([x, y, o, z, z, z, -xp * x, -xp * y], -1)  # (H, 4, 8)
    rows_y = torch.stack([z, z, z, x, y, o, -yp * x, -yp * y], -1)
    A = torch.cat([rows_x, rows_y], -2)  # (H, 8, 8)
    b = torch.cat([xp, yp], -1)  # (H, 8)
    h = torch.linalg.solve_ex(A, b[..., None])[0][..., 0]
    ones = torch.ones((*h.shape[:-1], 1), dtype=h.dtype, device=h.device)
    return torch.cat([h, ones], -1).reshape(*h.shape[:-1], 3, 3)


def homography_transfer_error_sq(
    H: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor
) -> torch.Tensor:
    """Forward transfer error ||p2 - H(p1)||^2 in pixels; H (..., 3, 3) -> (..., N)."""
    P1 = torch.cat([p1, torch.ones_like(p1[..., :1])], -1)
    q = torch.einsum("...ij,nj->...ni", H, P1)
    w = q[..., 2]
    safe_w = torch.where(w.abs() < 1e-12, 1e-12, w)
    proj = q[..., :2] / safe_w[..., None]
    return ((proj - p2) ** 2).sum(-1)


def decompose_homography(H: torch.Tensor, K: torch.Tensor):
    """Calibrated homography -> 4 (R, t, n) candidates (Faugeras SVD method).

    Returns (Rs (4, 3, 3), ts (4, 3), ns (4, 3)); t is up to scale.
    """
    Hn = torch.linalg.inv(K) @ H @ K
    u, s, vt = svd_or_nan(Hn)
    l1 = s[0] / s[1]
    l3 = s[2] / s[1]
    sdet = torch.linalg.det(u) * torch.linalg.det(vt)

    denom = torch.clamp(l1 * l1 - l3 * l3, min=1e-12)
    x1 = torch.sqrt(torch.clamp((l1 * l1 - 1.0) / denom, min=0.0))
    x3 = torch.sqrt(torch.clamp((1.0 - l3 * l3) / denom, min=0.0))
    zero = torch.zeros_like(x1)
    one = torch.ones_like(x1)

    def candidate(e1, e3):
        sin_t = (l1 - l3) * x1 * x3 * e1 * e3
        cos_t = l1 * x3 * x3 + l3 * x1 * x1
        Rp = torch.stack(
            [
                torch.stack([cos_t, zero, -sin_t]),
                torch.stack([zero, one, zero]),
                torch.stack([sin_t, zero, cos_t]),
            ]
        )
        tp = (l1 - l3) * torch.stack([x1 * e1, zero, -x3 * e3])
        np_ = torch.stack([x1 * e1, zero, x3 * e3])
        return sdet * (u @ Rp @ vt), u @ tp, vt.T @ np_

    out = [candidate(e1, e3) for e1 in (1.0, -1.0) for e3 in (1.0, -1.0)]
    Rs, ts, ns = zip(*out)
    return torch.stack(Rs), torch.stack(ts), torch.stack(ns)


def recover_pose_homography(
    H: torch.Tensor,
    xy1: torch.Tensor,
    xy2: torch.Tensor,
    inlier_mask: torch.Tensor,
    K: torch.Tensor,
    homography_distance: float,
    R_prev: torch.Tensor,
    t_prev: torch.Tensor,
):
    """The reference's candidate vote: (R, t unit, num_good); with no vote at
    all, (R_prev, t_prev) pass through unchanged."""
    with span("homography.recover_pose"):
        Rs, ts, _ = decompose_homography(H, K)
        eye = torch.eye(3, dtype=H.dtype, device=H.device)
        P1 = K @ torch.cat([eye, torch.zeros(3, 1, dtype=H.dtype, device=H.device)], 1)

        def vote(R, t):
            P2 = K @ torch.cat([R, t[:, None]], 1)
            X = triangulate_points(P1, P2, xy1, xy2)
            finite = torch.isfinite(X).all(-1)
            z = X[:, 2]
            good = inlier_mask & finite & (z > 0) & (z < homography_distance)
            return good.sum()

        votes = torch.stack([vote(Rs[i], ts[i]) for i in range(4)])
        best = torch.argmax(votes)
        max_good = votes[best]
        t_best = ts[best]
        t_best = t_best / torch.clamp(torch.linalg.vector_norm(t_best), min=1e-12)
        found = max_good > 0
        R = torch.where(found, Rs[best], R_prev)
        t = torch.where(found, t_best, t_prev)
        return R, t, max_good


def _hartley_T(p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Similarity normalizing masked points to mean 0 / mean radius sqrt(2)."""
    wf = w.to(p.dtype)
    wsum = torch.clamp(wf.sum(), min=1.0)
    mean = (p * wf[:, None]).sum(0) / wsum
    d = torch.sqrt(((p - mean) ** 2).sum(-1))
    s = math.sqrt(2.0) / torch.clamp((d * wf).sum() / wsum, min=1e-6)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    one = torch.ones((), dtype=p.dtype, device=p.device)
    return torch.stack(
        [
            torch.stack([s, zero, -s * mean[0]]),
            torch.stack([zero, s, -s * mean[1]]),
            torch.stack([zero, zero, one]),
        ]
    )


def refit_homography(p1: torch.Tensor, p2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted normalized-DLT refit over an inlier set (pixel coords)."""
    T1 = _hartley_T(p1, w)
    T2 = _hartley_T(p2, w)

    def apply(T, p):
        return p * T[0, 0] + T[:2, 2]

    q1 = apply(T1, p1)
    q2 = apply(T2, p2)
    x, y = q1[:, 0], q1[:, 1]
    xp, yp = q2[:, 0], q2[:, 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    rows_x = torch.stack([x, y, o, z, z, z, -xp * x, -xp * y, -xp], -1)
    rows_y = torch.stack([z, z, z, x, y, o, -yp * x, -yp * y, -yp], -1)
    A = torch.cat([rows_x, rows_y], 0)  # (2N, 9)
    ww = torch.cat([w, w], 0).to(p1.dtype)
    AtA = torch.einsum("n,ni,nj->ij", ww, A, A)
    h = smallest_eigvec(AtA).reshape(3, 3)
    # Denormalize: H = T2^-1 Hn T1, with T2^-1 in closed form.
    s2 = T2[0, 0]
    zero = torch.zeros((), dtype=p1.dtype, device=p1.device)
    one = torch.ones((), dtype=p1.dtype, device=p1.device)
    T2_inv = torch.stack(
        [
            torch.stack([1.0 / s2, zero, -T2[0, 2] / s2]),
            torch.stack([zero, 1.0 / s2, -T2[1, 2] / s2]),
            torch.stack([zero, zero, one]),
        ]
    )
    H = T2_inv @ h @ T1
    return H / torch.where(H[2, 2].abs() < 1e-12, 1e-12, H[2, 2])


def find_homography(
    xy1: torch.Tensor,
    xy2: torch.Tensor,
    mask: torch.Tensor,
    method: int,
    threshold: float,
    num_hypotheses: int,
    generator: torch.Generator | None = None,
    sampler: Sampler | None = None,
):
    """findHomography: (H, inlier_mask); ``threshold`` in pixels."""
    with span("homography.fit"):
        idx, sets_valid = draw_minimal_sets(mask, num_hypotheses, 4, generator, sampler)
        Hs = four_point_homography(xy1[idx], xy2[idx])
        finite = torch.isfinite(Hs.reshape(Hs.shape[0], -1)).all(-1)
        r2 = homography_transfer_error_sq(Hs, xy1, xy2)
        best, inliers = score_hypotheses(
            r2, mask, sets_valid & finite, method, threshold, model_points=4
        )

        # Final polish (see essential.py for LMEDS single refit vs RANSAC iterated).
        H_out, inl_out = Hs[best], inliers
        rounds = 1 if method == LMEDS else 3
        for _ in range(rounds):
            H_refit = refit_homography(xy1, xy2, inl_out.to(xy1.dtype))
            finite = torch.isfinite(H_refit).all()
            if method == LMEDS:
                H_out = torch.where(finite, H_refit, H_out)
            else:
                r2_ref = homography_transfer_error_sq(H_refit, xy1, xy2)
                inl_ref = inlier_mask_for_model(r2_ref, mask, method, threshold, 4)
                n_ref = inl_ref.sum()
                n_old = inl_out.sum()
                ok = finite & (n_ref >= torch.clamp(n_old // 2, min=4))
                H_out = torch.where(ok, H_refit, H_out)
                inl_out = torch.where(ok, inl_ref, inl_out)
        return H_out, inl_out
