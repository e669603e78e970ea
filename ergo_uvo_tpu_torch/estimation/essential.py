"""Essential-matrix estimation and pose recovery — counterpart of ``ergo_uvo_tpu/estimation/essential.py``.

``findEssentialMat`` + ``recoverPose`` (VO_utility.cpp:147-149) as the JAX
package computes them: a batched normalized 8-point solver on the Jacobi
eigensolver, Sampson scoring under LMEDS/RANSAC, an inlier refit, and a
Gauss-Newton Sampson polish on the essential manifold.  Conventions: points1
= previous frame, points2 = current frame, x_curr = R x_prev + t, and
x2^T E x1 = 0 with E = [t]_x R.

``torch.linalg.svd`` may return singular vectors with other signs than
``jnp.linalg.svd``; E after manifold projection and the chosen (R, t) do not
depend on them.  ``jax.jacfwd`` becomes ``torch.func.jacfwd`` and the
``lax.scan`` over Gauss-Newton iterations a loop.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from ergo_uvo_tpu_torch.config import LMEDS
from ergo_uvo_tpu_torch.estimation.robust import inlier_mask_for_model, score_hypotheses
from ergo_uvo_tpu_torch.estimation.sampling import Sampler, draw_minimal_sets
from ergo_uvo_tpu_torch.geometry.linalg import smallest_eigvec, svd_or_nan
from ergo_uvo_tpu_torch.geometry.rotations import skew, so3_exp
from ergo_uvo_tpu_torch.geometry.stats import masked_median
from ergo_uvo_tpu_torch.geometry.triangulation import triangulate_points
from ergo_uvo_tpu_torch.utils.profiling import span

# OpenCV recoverPose's cheirality distance gate (five-point.cpp).
_RECOVER_POSE_DISTANCE = 50.0


def _normalized(K: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Pixels -> normalized camera coords (inputs are undistorted)."""
    x = (xy[..., 0] - K[0, 2]) / K[0, 0]
    y = (xy[..., 1] - K[1, 2]) / K[1, 1]
    return torch.stack([x, y], -1)


def _homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def eight_point_essential(
    x1: torch.Tensor, x2: torch.Tensor, project: bool = False
) -> torch.Tensor:
    """Batched 8-point essential from normalized coords (H, 8, 2) -> (H, 3, 3).

    The raw linear solution is scored directly unless ``project``; only the
    winner gets projected onto the manifold.
    """
    X1 = _homogeneous(x1)
    X2 = _homogeneous(x2)
    # Constraint rows: kron(x2, x1) for x2^T E x1 = 0, E row-major.
    A = torch.einsum("hni,hnj->hnij", X2, X1).reshape(*x1.shape[:-2], 8, 9)
    AtA = torch.einsum("hni,hnj->hij", A, A)
    e = smallest_eigvec(AtA)
    E = e.reshape(*e.shape[:-1], 3, 3)
    if project:
        E = project_to_essential(E)
    return E


def project_to_essential(E: torch.Tensor) -> torch.Tensor:
    """Project onto the essential manifold: singular values -> (s, s, 0)."""
    u, s, vt = svd_or_nan(E)
    sigma = 0.5 * (s[..., 0] + s[..., 1])
    d = torch.stack([sigma, sigma, torch.zeros_like(sigma)], -1)
    return (u * d[..., None, :]) @ vt


def sampson_error_sq(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance in normalized coords; E (..., 3, 3), x (N, 2) -> (..., N)."""
    X1 = _homogeneous(x1)
    X2 = _homogeneous(x2)
    Ex1 = torch.einsum("...ij,nj->...ni", E, X1)
    Etx2 = torch.einsum("...ji,nj->...ni", E, X2)
    x2tEx1 = torch.einsum("ni,...ni->...n", X2, Ex1)
    denom = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return x2tEx1 * x2tEx1 / torch.clamp(denom, min=1e-12)


def recover_pose_from_essential(
    E: torch.Tensor, x1n: torch.Tensor, x2n: torch.Tensor, mask: torch.Tensor
):
    """cv::recoverPose: the (R, t) candidate with the most points in front.

    Returns (R, t, mask_out), mask_out = mask & the winner's cheirality and
    distance gate.  Equal votes go to the first candidate in the order
    (R1, t), (R1, -t), (R2, t), (R2, -t).
    """
    with span("essential.recover_pose"):
        u, _, vt = svd_or_nan(E)
        # Proper rotations only.
        u = u * torch.sign(torch.linalg.det(u))
        vt = vt * torch.sign(torch.linalg.det(vt))[..., None]
        W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                         dtype=E.dtype, device=E.device)
        R1 = u @ W @ vt
        R2 = u @ W.T @ vt
        t = u[..., :, 2]

        P1 = torch.cat([torch.eye(3, dtype=E.dtype, device=E.device),
                        torch.zeros(3, 1, dtype=E.dtype, device=E.device)], dim=1)

        def good_mask(R, tt):
            P2 = torch.cat([R, tt[:, None]], dim=1)
            X = triangulate_points(P1, P2, x1n, x2n)
            z1 = X[:, 2]
            z2 = (X @ R.T + tt)[:, 2]
            finite = torch.isfinite(X).all(-1)
            return (
                mask & finite
                & (z1 > 0) & (z1 < _RECOVER_POSE_DISTANCE)
                & (z2 > 0) & (z2 < _RECOVER_POSE_DISTANCE)
            )

        cands = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
        masks = torch.stack([good_mask(R, tt) for R, tt in cands])  # (4, N)
        best = torch.argmax(masks.sum(-1))
        Rs = torch.stack([c[0] for c in cands])
        ts = torch.stack([c[1] for c in cands])
        return Rs[best], ts[best], masks[best]


def refit_essential(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted 8-point refit over an inlier set, projected onto the manifold."""
    X1 = _homogeneous(x1)
    X2 = _homogeneous(x2)
    a = torch.einsum("ni,nj->nij", X2, X1).reshape(x1.shape[0], 9)
    AtA = torch.einsum("n,ni,nj->ij", w.to(x1.dtype), a, a)
    e = smallest_eigvec(AtA)
    return project_to_essential(e.reshape(3, 3))


def _params_to_E(p: torch.Tensor, R: torch.Tensor, t: torch.Tensor):
    """E, R, t after a 5-dof update: so(3) for R, a tangent step for unit t."""
    Rn = so3_exp(p[:3]) @ R
    e_z = torch.tensor([0.0, 0.0, 1.0], dtype=t.dtype, device=t.device)
    e_x = torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device)
    pole = torch.where(t[2].abs() < 0.9, e_z, e_x)
    a = torch.linalg.cross(t, pole)
    a = a / torch.clamp(torch.linalg.vector_norm(a), min=1e-12)
    b = torch.linalg.cross(t, a)
    tn = t + p[3] * a + p[4] * b
    tn = tn / torch.clamp(torch.linalg.vector_norm(tn), min=1e-12)
    return skew(tn) @ Rn, Rn, tn


def gn_refine_essential(
    E0: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor,
    iters: int = 6,
) -> torch.Tensor:
    """Gauss-Newton Sampson minimization over E = [t]_x R (5 dof), Cauchy IRLS
    on top of the inlier weights ``w``; falls back to E0 if it diverges."""
    with span("essential.refine"):
        R, t, _ = recover_pose_from_essential(E0, x1, x2, w > 0)
        X1 = _homogeneous(x1)
        X2 = _homogeneous(x2)
        eye5 = torch.eye(5, dtype=x1.dtype, device=x1.device)

        for _ in range(iters):
            def resid(p, R=R, t=t):
                E, _, _ = _params_to_E(p, R, t)
                Ex1 = X1 @ E.T
                Etx2 = X2 @ E
                num = (X2 * Ex1).sum(-1)
                den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
                return num / torch.sqrt(torch.clamp(den, min=1e-12))

            p0 = torch.zeros(5, dtype=x1.dtype, device=x1.device)
            r = resid(p0)
            delta = 1.4826 * masked_median(r.abs(), w > 0) + 1e-12
            wr = w / (1.0 + (r / delta) ** 2)
            J = jacfwd(resid)(p0)  # (N, 5)
            H = J.T @ (wr[:, None] * J) + 1e-9 * eye5
            dp = -torch.linalg.solve_ex(H, (J.T @ (wr * r))[:, None])[0][:, 0]
            _, R, t = _params_to_E(dp, R, t)

        E = skew(t) @ R
        return torch.where(torch.isfinite(E).all(), E, E0)


def find_essential(
    xy1: torch.Tensor,
    xy2: torch.Tensor,
    mask: torch.Tensor,
    K: torch.Tensor,
    method: int,
    threshold: float,
    num_hypotheses: int,
    generator: torch.Generator | None = None,
    sampler: Sampler | None = None,
):
    """findEssentialMat: (E, epipolar_inlier_mask); ``threshold`` in pixels,
    divided by the mean focal length as OpenCV does."""
    with span("essential.fit"):
        x1 = _normalized(K, xy1)
        x2 = _normalized(K, xy2)
        idx, sets_valid = draw_minimal_sets(mask, num_hypotheses, 8, generator, sampler)
        Es = eight_point_essential(x1[idx], x2[idx])  # (H, 3, 3)
        r2 = sampson_error_sq(Es, x1, x2)  # (H, N)
        thresh_norm = threshold / (0.5 * (K[0, 0] + K[1, 1]))
        best, inliers = score_hypotheses(r2, mask, sets_valid, method, thresh_norm, model_points=8)
        E_best = project_to_essential(Es[best])

        # LMEDS: exactly one refit keeping the winner's inlier mask.  RANSAC:
        # LO-style iterated refit against the fixed threshold, with a collapse guard.
        E_out, inl_out = E_best, inliers
        rounds = 1 if method == LMEDS else 3
        for _ in range(rounds):
            E_refit = refit_essential(x1, x2, inl_out.to(x1.dtype))
            finite = torch.isfinite(E_refit).all()
            if method == LMEDS:
                E_out = torch.where(finite, E_refit, E_out)
            else:
                r2_ref = sampson_error_sq(E_refit, x1, x2)
                inl_ref = inlier_mask_for_model(r2_ref, mask, method, thresh_norm, 8)
                n_ref = inl_ref.sum()
                n_old = inl_out.sum()
                ok = finite & (n_ref >= torch.clamp(n_old // 2, min=8))
                E_out = torch.where(ok, E_refit, E_out)
                inl_out = torch.where(ok, inl_ref, inl_out)
        E_out = gn_refine_essential(E_out, x1, x2, inl_out.to(x1.dtype))
        return E_out, inl_out
