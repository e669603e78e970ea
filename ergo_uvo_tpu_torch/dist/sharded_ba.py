"""Landmark-sharded Schur-complement bundle adjustment on ``torch.distributed``.

Counterpart of ``ergo_uvo_tpu/dist/sharded_ba.py``: landmarks (and their
observations) are sharded over the mesh dimension ``axis_name``; poses are
replicated.  Every rank calls these functions (SPMD, one process a rank)
where JAX runs one ``shard_map`` program from a single controller.

Per LM iteration, communication is exactly two ``dist.all_reduce`` calls:

* one packed flat buffer of every cross-shard partial sum: the pose Hessian
  H_pp (P x 6 x 6), the gradient b_p (P x 6), the Schur correction S_corr
  (P x P x 6 x 6), its rhs (P x 6) and the pre-update cost;
* the post-update cost, for accept/reject.

Everything landmark-indexed (H_ll, H_pl, b_l, the 3x3 inverses, the landmark
updates) stays on its rank.  Accept/reject is ``torch.where``: an iteration
reads nothing back to the host.  :func:`make_sharded_ba_run` loops the step
in Python where JAX scans it inside one program.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ergo_uvo_tpu_torch.dist.mesh import (
    all_gather_rows,
    all_reduce_packed,
    local_rows,
    mesh_device,
)
from ergo_uvo_tpu_torch.optim.ba import (
    BAState,
    _apply_updates,
    _jacobians,
    _normal_equations,
    _schur_corrections,
    _schur_reduce_solve,
    reprojection_residuals,
)


def _make_local_iter(mesh: DeviceMesh, num_fixed: int, axis_name: str):
    """One LM iteration as seen by one rank (its landmark rows, all poses)."""
    group = mesh.get_group(axis_name)

    def local_iter(K, obs_uv, obs_mask, R, t, X, lam):
        r, pc, inv_z = reprojection_residuals(K, R, t, X, obs_uv, obs_mask)
        cost_local = (r * r).sum()
        J_pose, J_lm = _jacobians(K, R, pc, inv_z, obs_mask)
        H_pp, H_ll, H_pl, b_p, b_l = _normal_equations(J_pose, J_lm, r)
        # The Schur corrections depend only on landmark-local blocks, so all
        # cross-shard partial sums ride one packed collective (1 of 2).
        Hll_inv, S_corr, rhs_corr = _schur_corrections(H_ll, H_pl, b_l, lam)
        H_pp, b_p, S_corr, rhs_corr, cost = all_reduce_packed(
            [H_pp, b_p, S_corr, rhs_corr, cost_local.reshape(1)], group)
        dp, dl = _schur_reduce_solve(H_pp, b_p, Hll_inv, S_corr, rhs_corr, H_pl, b_l, lam,
                                     num_fixed)
        R2, t2, X2 = _apply_updates(R, t, X, dp, dl)
        r2, _, _ = reprojection_residuals(K, R2, t2, X2, obs_uv, obs_mask)
        # Collective 2 of 2: the post-update cost for accept/reject.
        cost2 = (r2 * r2).sum().reshape(1)
        dist.all_reduce(cost2, group=group)
        cost, cost2 = cost[0], cost2[0]
        improved = cost2 < cost
        lam_new = torch.where(improved, torch.clamp(lam * 0.3, min=1e-8),
                              torch.clamp(lam * 4.0, max=1e6))
        return (torch.where(improved, R2, R), torch.where(improved, t2, t),
                torch.where(improved, X2, X), lam_new, torch.minimum(cost, cost2))

    return local_iter


def make_sharded_ba_step(mesh: DeviceMesh, num_fixed: int = 1, axis_name: str = "data"):
    """One LM step over ``mesh``: ``step(K, obs_uv, obs_mask, R, t, X, lam)
    -> (R, t, X, lam, cost)``.

    Every rank passes its landmark rows (obs_uv (P, L_loc, 2), obs_mask
    (P, L_loc), X (L_loc, 3)) and the replicated K, R, t, lam, all on its
    mesh device; X comes back as its rows.
    """
    return _make_local_iter(mesh, num_fixed, axis_name)


def make_sharded_ba_run(mesh: DeviceMesh, iters: int, num_fixed: int = 1,
                        axis_name: str = "data"):
    """``iters`` LM steps: ``run(K, obs_uv, obs_mask, R, t, X, lam) ->
    (R, t, X, lam, costs (iters,))`` with :func:`make_sharded_ba_step`'s
    layout.  A Python loop; the costs stay on the device."""
    local_iter = _make_local_iter(mesh, num_fixed, axis_name)

    def run(K, obs_uv, obs_mask, R, t, X, lam):
        costs = []
        for _ in range(iters):
            R, t, X, lam, cost = local_iter(K, obs_uv, obs_mask, R, t, X, lam)
            costs.append(cost)
        return R, t, X, lam, torch.stack(costs)

    return run


def sharded_ba_solve(
    mesh: DeviceMesh,
    K,
    obs_uv,
    obs_mask,
    R0,
    t0,
    X0,
    iters: int = 20,
    num_fixed: int = 1,
    init_lambda: float = 1e-3,
    axis_name: str = "data",
    local: bool = False,
):
    """Solve on every rank; returns (BAState, costs (iters,)), the same on every rank.

    The arrays may be numpy or tensors anywhere; they go to the mesh's
    device.  With ``local=False`` every rank passes the global obs_uv
    (P, L, 2), obs_mask (P, L) and X0 (L, 3) and keeps its own landmark rows
    (L must divide over the mesh); with ``local=True`` it passes only its
    rows, as a process that decodes only its share does.  The state's X is
    the global (L, 3), all-gathered once after the last iteration.
    """
    dev = mesh_device(mesh)
    K, obs_uv, obs_mask, R, t, X = (torch.as_tensor(a).to(dev)
                                    for a in (K, obs_uv, obs_mask, R0, t0, X0))
    if not local:  # local_rows raises unless L divides over the mesh
        obs_uv = local_rows(obs_uv, mesh, axis_name, dim=1)
        obs_mask = local_rows(obs_mask, mesh, axis_name, dim=1)
        X = local_rows(X, mesh, axis_name)
    lam = torch.full((), init_lambda, dtype=R.dtype, device=dev)
    run = make_sharded_ba_run(mesh, iters, num_fixed, axis_name)
    R, t, X, lam, costs = run(K, obs_uv, obs_mask, R, t, X, lam)
    X = all_gather_rows(X, mesh.get_group(axis_name))
    return BAState(R=R, t=t, X=X, lm_lambda=lam), costs
