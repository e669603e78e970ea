"""Batched PnP RANSAC + Gauss-Newton refinement — counterpart of ``ergo_uvo_tpu/estimation/pnp.py``.

The stereo motion solver, in place of the reference's ``solvePnPRansac``
call (visual_odometry.h:647-648: EPnP, 1000 iters, 1.0 px reprojection, 0.99
confidence).  The minimal solver is batched P3P (estimation/p3p.py —
planar-safe, unlike projection-matrix DLT, which is kept as
:func:`_dlt_projection` for well-conditioned non-planar least-squares fits);
the winning hypothesis is polished by fixed-iteration Gauss-Newton on SE(3)
under a Cauchy loss, which plays the role of OpenCV's final iterative
refinement.

Convention: (R, t) map world (previous-left-camera) points into the current
camera: x_cam = R @ X + t — identical to OpenCV's rvec/tvec.

Nothing here reads a tensor back to the host: every choice is a
``torch.where``, and the damped 6x6 normal equations go through
``torch.linalg.solve_ex`` without its error check, so a degenerate system
gives non-finite numbers (which the masks catch) instead of raising.  The
refinement is 8 rounds of 4 eager Gauss-Newton steps, 32 small solves a
frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ergo_uvo_tpu_torch.config import RANSAC
from ergo_uvo_tpu_torch.estimation.p3p import p3p
from ergo_uvo_tpu_torch.estimation.robust import score_hypotheses
from ergo_uvo_tpu_torch.estimation.sampling import Sampler, draw_minimal_sets
from ergo_uvo_tpu_torch.geometry.linalg import cbrt, polar_so3, smallest_eigvec
from ergo_uvo_tpu_torch.geometry.rotations import skew, so3_exp
from ergo_uvo_tpu_torch.utils.profiling import span


class PnPResult(NamedTuple):
    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)
    inliers: torch.Tensor  # (N,) bool
    success: torch.Tensor  # scalar bool


def _dlt_projection(X_raw: torch.Tensor, xn: torch.Tensor):
    """Batched DLT: m world points + normalized image points -> (R, t).

    X_raw: (H, m, 3); xn: (H, m, 2) normalized coords.  Returns (H,3,3), (H,3).

    World points are Hartley-normalized per hypothesis (centroid to origin,
    RMS radius sqrt(3)) before building the 12x12 normal matrix — without
    this, f32 null-space extraction on raw coordinates loses the smallest
    eigenvector to the ~1e7 condition number.
    """
    Hh = X_raw.shape[0]
    mean = X_raw.mean(dim=-2, keepdim=True)
    Xc = X_raw - mean
    rms = torch.sqrt((Xc * Xc).sum(-1).mean(-1, keepdim=True))
    s = 3.0**0.5 / torch.clamp(rms, min=1e-9)  # (H, 1)
    X = Xc * s[..., None]
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)  # (H, m, 4)
    z = torch.zeros_like(Xh)
    u = xn[..., 0:1]
    v = xn[..., 1:2]
    rows_u = torch.cat([Xh, z, -u * Xh], -1)  # (H, m, 12)
    rows_v = torch.cat([z, Xh, -v * Xh], -1)
    A = torch.cat([rows_u, rows_v], -2)  # (H, 2m, 12)
    AtA = torch.einsum("hni,hnj->hij", A, A)
    p = smallest_eigvec(AtA).reshape(Hh, 3, 4)
    # Undo the world normalization: P [X;1] = P' [s(X-mean);1]
    #   => M = s M',  t = t' - s M' mean.
    Mp = p[..., :3]
    tp = p[..., 3]
    M = Mp * s[..., None]
    t = tp - (Mp @ (mean[..., 0, :, None] * s[..., None]))[..., 0]
    # Fix scale/sign: det(M) > 0 and unit-average row norm.
    detM = torch.linalg.det(M)
    sign = torch.where(detM < 0, -1.0, 1.0)
    safe = torch.clamp(cbrt(detM.abs()), min=1e-12)
    M = M * (sign / safe)[..., None, None]
    t = t * (sign / safe)[..., None]
    return polar_so3(M), t


def _reproj_error_sq(R, t, K, X, xy):
    """(..., N) squared pixel reprojection errors."""
    pc = torch.einsum("...ij,nj->...ni", R, X) + t[..., None, :]
    z = pc[..., 2]
    safe_z = torch.where(z.abs() < 1e-9, 1e-9, z)
    xn = pc[..., 0] / safe_z
    yn = pc[..., 1] / safe_z
    u = xn * K[0, 0] + K[0, 2]
    v = yn * K[1, 1] + K[1, 2]
    err = (u - xy[..., 0]) ** 2 + (v - xy[..., 1]) ** 2
    # Points behind the camera can never be inliers.
    return torch.where(z > 0, err, float("inf"))


def gauss_newton_pnp(
    R0: torch.Tensor,
    t0: torch.Tensor,
    K: torch.Tensor,
    X: torch.Tensor,
    xy: torch.Tensor,
    weights: torch.Tensor,
    iters: int = 10,
):
    """Fixed-iteration GN on SE(3), minimizing weighted pixel reprojection.

    Left-multiplicative update: R <- exp(w) R, t <- exp(w) t + dt.
    """
    R, t = R0, t0
    fx, fy = K[0, 0], K[1, 1]
    eye3 = torch.eye(3, dtype=R0.dtype, device=R0.device)
    damping = 1e-6 * torch.eye(6, dtype=R0.dtype, device=R0.device)
    w = weights[..., None, None]
    for _ in range(iters):
        pc = X @ R.T + t  # (N, 3)
        z = torch.clamp(pc[..., 2], min=1e-6)
        inv_z = 1.0 / z
        xn = pc[..., 0] * inv_z
        yn = pc[..., 1] * inv_z
        ru = fx * xn + K[0, 2] - xy[..., 0]
        rv = fy * yn + K[1, 2] - xy[..., 1]
        r = torch.stack([ru, rv], -1)  # (N, 2)

        # d(pixel)/d(pc): (N, 2, 3)
        zeros = torch.zeros_like(inv_z)
        J_proj = torch.stack(
            [
                torch.stack([fx * inv_z, zeros, -fx * xn * inv_z], -1),
                torch.stack([zeros, fy * inv_z, -fy * yn * inv_z], -1),
            ],
            -2,
        )
        # d(pc)/d(xi): [I | -[pc]_x] for xi = (dt, w).
        J_pc = torch.cat([eye3.expand(*pc.shape, 3), -skew(pc)], -1)  # (N, 3, 6)
        J = J_proj @ J_pc  # (N, 2, 6)

        JtJ = torch.einsum("nai,naj->ij", J * w, J)
        Jtr = torch.einsum("nai,na->i", J * w, r)
        # Levenberg damping keeps rank-deficient (few-inlier) systems sane.
        xi = -torch.linalg.solve_ex(JtJ + damping, Jtr, check_errors=False).result
        dR = so3_exp(xi[3:])
        R, t = dR @ R, (dR @ t) + xi[:3]
    return R, t


def solve_pnp_ransac(
    X: torch.Tensor,  # (N, 3) world points (prev-left camera frame)
    xy: torch.Tensor,  # (N, 2) current-frame pixels
    mask: torch.Tensor,  # (N,) validity
    K: torch.Tensor,
    reprojection_error: float = 1.0,
    num_hypotheses: int = 512,
    min_inliers: int = 5,
    refine_iters: int = 8,
    polish_rounds: int = 3,
    generator: torch.Generator | None = None,
    sampler: Sampler | None = None,
) -> PnPResult:
    """solvePnPRansac equivalent: batched P3P hypotheses, score, robust polish.

    ``reprojection_error`` is the pixel inlier gate (stereo config
    ``reprojection_error: 1.0``, stereo_VO_parameters.yaml:29).

    Minimal 3-point sets are solved exactly by P3P and every (root, plane,
    branch) candidate is scored by its count of correspondences under the
    gate (RANSAC); the winner is refined by ``2 * polish_rounds + 2`` rounds
    of Cauchy-weighted Gauss-Newton (``refine_iters // 2`` steps each) over
    all masked correspondences.  The minimal sets come from ``generator``,
    or from ``sampler(mask, num_hypotheses, 3)`` when one is given (tests
    only).  An all-false ``mask`` gives ``success`` False without raising.
    """
    with span("pnp"):
        with span("pnp.minimal"):
            xn = torch.stack(
                [(xy[..., 0] - K[0, 2]) / K[0, 0], (xy[..., 1] - K[1, 2]) / K[1, 1]], -1
            )
            idx, sets_valid = draw_minimal_sets(mask, num_hypotheses, 3, generator, sampler)
            bearings = torch.cat([xn, torch.ones_like(xn[..., :1])], -1)
            bearings = bearings / torch.linalg.vector_norm(bearings, dim=-1, keepdim=True)
            Rs, ts, cand_valid = p3p(X[idx], bearings[idx])  # (H, 12, ...)
            Rs = Rs.reshape(-1, 3, 3)
            ts = ts.reshape(-1, 3)
            cand_valid = (cand_valid & sets_valid[:, None]).reshape(-1)
        with span("pnp.score"):
            finite = torch.isfinite(Rs).flatten(1).all(-1) & torch.isfinite(ts).all(-1)
            r2 = _reproj_error_sq(Rs, ts, K, X, xy)  # (H*12, N)
            best, inliers = score_hypotheses(
                r2, mask, cand_valid & finite, RANSAC, reprojection_error, model_points=3
            )
            R_best, t_best = Rs[best], ts[best]

        with span("pnp.refine"):
            thr2 = reprojection_error * reprojection_error

            # Cauchy-IRLS refinement over ALL masked correspondences (not just
            # the hard-gated inlier set — a hard gate at ~noise level discards
            # half the good measurements and biases the fit).  Masked slots may
            # hold garbage coordinates, which would poison the normal equations
            # through 0 * inf: sanitize them first.
            X_safe = torch.where(mask[:, None], X, torch.eye(3, dtype=X.dtype, device=X.device)[2])
            xy_safe = torch.where(mask[:, None], xy, 0.0)
            delta = 0.7 * reprojection_error
            support = 20.0 * reprojection_error

            R_ref, t_ref = R_best, t_best
            for _ in range(2 * polish_rounds + 2):
                r2 = _reproj_error_sq(R_ref, t_ref, K, X_safe, xy_safe)
                r = torch.sqrt(torch.clamp(r2, min=1e-12))
                w = 1.0 / (1.0 + (r / delta) ** 2)
                w = torch.where(mask & torch.isfinite(r2) & (r < support), w, 0.0)
                R_ref, t_ref = gauss_newton_pnp(R_ref, t_ref, K, X_safe, xy_safe, w,
                                                refine_iters // 2)

            # Accept the refinement unless it diverged.  It is not required to
            # beat the RANSAC winner's count: the winner is the argmax of
            # threshold counting and overfits the gate, so the (more accurate)
            # robust-loss minimizer often counts a few fewer 1 px inliers.
            r2_ref = _reproj_error_sq(R_ref, t_ref, K, X_safe, xy_safe)
            inl_ref = mask & (r2_ref <= thr2)
            better = (
                torch.isfinite(R_ref).all() & torch.isfinite(t_ref).all()
                & (2 * inl_ref.sum() >= inliers.sum())
            )
            R_out = torch.where(better, R_ref, R_best)
            t_out = torch.where(better, t_ref, t_best)
            inl_out = torch.where(better, inl_ref, inliers)
            success = inl_out.sum() >= min_inliers
            return PnPResult(R=R_out, t=t_out, inliers=inl_out, success=success)
