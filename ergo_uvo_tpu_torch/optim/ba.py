"""Sliding-window bundle adjustment (Levenberg-Marquardt + Schur complement).

Counterpart of ``ergo_uvo_tpu/optim/ba.py``.  Fixed shapes, P poses x L
landmarks with a dense visibility mask; the Jacobians and the block Hessian
are batched einsums; the 3x3 landmark blocks are inverted in closed form; the
reduced (6P x 6P) camera system goes through ``torch.linalg.solve_ex``
without its error check, so a singular system gives non-finite numbers
instead of a host read.  The LM accept/reject and the damping update are
``torch.where`` and ``torch.clamp``: a step reads nothing back to the host.
The JAX package scans the step with ``lax.scan``; :func:`ba_solve` loops in
Python and stacks the costs on the device.

Gauge freedom is fixed by freezing the first ``num_fixed_poses`` poses.  The
Schur split (:func:`_schur_corrections`, :func:`_schur_reduce_solve`) is
kept: the distributed BA reduces the landmark-local half across shards
between the two.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ergo_uvo_tpu_torch.geometry.rotations import skew, so3_exp
from ergo_uvo_tpu_torch.geometry.triangulation import _solve33


class BAProblem(NamedTuple):
    """Fixed-shape window BA problem (P poses, L landmarks)."""

    K: torch.Tensor  # (3, 3) shared pinhole intrinsics
    obs_uv: torch.Tensor  # (P, L, 2) observed pixels
    obs_mask: torch.Tensor  # (P, L) visibility
    num_fixed_poses: int = 1  # gauge anchor


class BAState(NamedTuple):
    R: torch.Tensor  # (P, 3, 3) world -> camera
    t: torch.Tensor  # (P, 3)
    X: torch.Tensor  # (L, 3) world landmarks
    lm_lambda: torch.Tensor  # LM damping (0-d)


def reprojection_residuals(K, R, t, X, obs_uv, obs_mask):
    """(P, L, 2) masked pixel residuals, the camera-frame points and 1/z."""
    pc = torch.einsum("pij,lj->pli", R, X) + t[:, None, :]
    z = pc[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-6, 1e-6, z)
    u = K[0, 0] * pc[..., 0] * inv_z + K[0, 2]
    v = K[1, 1] * pc[..., 1] * inv_z + K[1, 2]
    r = torch.stack([u, v], -1) - obs_uv
    return torch.where(obs_mask[..., None], r, 0.0), pc, inv_z


def _jacobians(K, R, pc, inv_z, obs_mask):
    """J_pose (P, L, 2, 6) for left-multiplied (dt, w) updates; J_lm (P, L, 2, 3)."""
    fx, fy = K[0, 0], K[1, 1]
    x, y = pc[..., 0], pc[..., 1]
    zeros = torch.zeros_like(inv_z)
    J_proj = torch.stack([
        torch.stack([fx * inv_z, zeros, -fx * x * inv_z * inv_z], -1),
        torch.stack([zeros, fy * inv_z, -fy * y * inv_z * inv_z], -1),
    ], -2)  # d(pixel)/d(pc)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(*pc.shape[:-1], 3, 3)
    J_pose = J_proj @ torch.cat([eye, -skew(pc)], -1)  # d(pc)/d(dt, w) = [I | -[pc]x]
    J_lm = J_proj @ R[:, None].expand(*pc.shape[:-1], 3, 3)  # d(pc)/dX = R
    m = obs_mask[..., None, None]
    return torch.where(m, J_pose, 0.0), torch.where(m, J_lm, 0.0)


def _normal_equations(J_pose, J_lm, r):
    """The masked block Hessian pieces and gradients."""
    H_pp = torch.einsum("plci,plcj->pij", J_pose, J_pose)  # (P, 6, 6)
    H_ll = torch.einsum("plci,plcj->lij", J_lm, J_lm)  # (L, 3, 3)
    H_pl = torch.einsum("plci,plcj->plij", J_pose, J_lm)  # (P, L, 6, 3)
    b_p = torch.einsum("plci,plc->pi", J_pose, r)  # (P, 6)
    b_l = torch.einsum("plci,plc->li", J_lm, r)  # (L, 3)
    return H_pp, H_ll, H_pl, b_p, b_l


def _schur_corrections(H_ll, H_pl, b_l, lm_lambda):
    """Landmark-local half of the Schur reduction.

    Returns (Hll_inv (L,3,3), S_corr (P,P,6,6), rhs_corr (P,6)): the partial
    sums over these landmarks, which a distributed solve reduces across
    shards before :func:`_schur_reduce_solve`.
    """
    eye3 = torch.eye(3, dtype=H_ll.dtype, device=H_ll.device)
    Hll_inv = _solve33_mat(H_ll + lm_lambda * eye3)
    W = torch.einsum("plij,ljk->plik", H_pl, Hll_inv)  # (P, L, 6, 3)
    S_corr = torch.einsum("plik,qlmk->pqim", W, H_pl)  # (P, P, 6, 6)
    rhs_corr = torch.einsum("plik,lk->pi", W, b_l)  # (P, 6)
    return Hll_inv, S_corr, rhs_corr


def _schur_reduce_solve(H_pp, b_p, Hll_inv, S_corr, rhs_corr, H_pl, b_l, lm_lambda, num_fixed):
    """Reduced-system solve for (dpose (P,6), dlm (L,3)).

    ``H_pp``, ``b_p``, ``S_corr`` and ``rhs_corr`` are summed over all
    landmarks; ``H_pl``, ``b_l`` and ``Hll_inv`` may be a shard's own rows,
    since the back-substitution needs only those.
    """
    P = H_pp.shape[0]
    eye6 = torch.eye(6, dtype=H_pp.dtype, device=H_pp.device)
    ar = torch.arange(P, device=H_pp.device)
    S = -S_corr
    S[ar, ar] += H_pp + lm_lambda * eye6
    rhs = -(b_p - rhs_corr)

    # Gauge: zero the rows and columns of the first `num_fixed` poses and
    # pin their diagonal.
    pose_free = (ar >= num_fixed).to(H_pp.dtype)
    S = S * pose_free[:, None, None, None] * pose_free[None, :, None, None]
    S[ar, ar] += (1.0 - pose_free)[:, None, None] * eye6
    rhs = rhs * pose_free[:, None]

    S_full = S.permute(0, 2, 1, 3).reshape(P * 6, P * 6)
    dp = torch.linalg.solve_ex(S_full, rhs.reshape(P * 6), check_errors=False).result.reshape(P, 6)

    # Back-substitute landmarks: dl = Hll^-1 (-b_l - H_pl^T dp).
    t1 = torch.einsum("plij,pi->lj", H_pl, dp)
    dl = torch.einsum("lij,lj->li", Hll_inv, -b_l - t1)
    return dp, dl


def _schur_solve(H_pp, H_ll, H_pl, b_p, b_l, lm_lambda, num_fixed):
    """Schur-complement solve for (dpose (P,6), dlm (L,3)) on one device."""
    Hll_inv, S_corr, rhs_corr = _schur_corrections(H_ll, H_pl, b_l, lm_lambda)
    return _schur_reduce_solve(H_pp, b_p, Hll_inv, S_corr, rhs_corr, H_pl, b_l, lm_lambda,
                               num_fixed)


def _solve33_mat(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse, column by column through the adjugate."""
    cols = torch.eye(3, dtype=A.dtype, device=A.device)
    return torch.stack([_solve33(A, cols[i]) for i in range(3)], -1)


def _apply_updates(R, t, X, dp, dl):
    dR = so3_exp(dp[:, 3:])
    return dR @ R, torch.einsum("pij,pj->pi", dR, t) + dp[:, :3], X + dl


def ba_step(K, obs_uv, obs_mask, state: BAState, num_fixed: int = 1):
    """One LM step with accept/reject damping control.  Returns (state, cost)."""
    r, pc, inv_z = reprojection_residuals(K, state.R, state.t, state.X, obs_uv, obs_mask)
    cost = (r * r).sum()
    J_pose, J_lm = _jacobians(K, state.R, pc, inv_z, obs_mask)
    H_pp, H_ll, H_pl, b_p, b_l = _normal_equations(J_pose, J_lm, r)
    dp, dl = _schur_solve(H_pp, H_ll, H_pl, b_p, b_l, state.lm_lambda, num_fixed)
    R_new, t_new, X_new = _apply_updates(state.R, state.t, state.X, dp, dl)
    r_new, _, _ = reprojection_residuals(K, R_new, t_new, X_new, obs_uv, obs_mask)
    cost_new = (r_new * r_new).sum()
    improved = cost_new < cost
    next_state = BAState(
        R=torch.where(improved, R_new, state.R),
        t=torch.where(improved, t_new, state.t),
        X=torch.where(improved, X_new, state.X),
        lm_lambda=torch.where(
            improved,
            torch.clamp(state.lm_lambda * 0.3, min=1e-8),
            torch.clamp(state.lm_lambda * 4.0, max=1e6),
        ),
    )
    return next_state, torch.minimum(cost, cost_new)


def ba_solve(
    problem: BAProblem,
    R0: torch.Tensor,
    t0: torch.Tensor,
    X0: torch.Tensor,
    iters: int = 20,
    init_lambda: float = 1e-3,
):
    """Run ``iters`` LM steps where the tensors lie.  Returns (BAState, costs (iters,))."""
    # torch.full, not torch.tensor: a fill on the device, not a host copy.
    state = BAState(R=R0, t=t0, X=X0,
                    lm_lambda=torch.full((), init_lambda, dtype=R0.dtype, device=R0.device))
    costs = []
    for _ in range(iters):
        state, cost = ba_step(problem.K, problem.obs_uv, problem.obs_mask, state,
                              problem.num_fixed_poses)
        costs.append(cost)
    return state, torch.stack(costs)
