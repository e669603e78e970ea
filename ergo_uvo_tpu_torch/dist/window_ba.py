"""Window-parallel BA: keyframes and landmarks sharded on a 2-D ``('kf', 'lm')`` mesh.

Counterpart of ``ergo_uvo_tpu/dist/window_ba.py``, one process a rank:

* observations (P, L, 2) are sharded on both mesh dimensions: each rank
  holds its (P_loc, L_loc) block, its poses' R, t and its landmarks' X;
* H_ll and b_l are summed over the ``kf`` group (every keyframe shard sees
  the same landmark shard);
* the Schur cross-pose coupling S[p, q] = sum_l W[p, l] H_pl[q, l]^T needs
  every other keyframe shard's H_pl for this landmark shard: the blocks go
  round a ring in the ``kf`` group (``dist.batch_isend_irecv``), one
  (P_loc, P_loc) block row a step;
* S_rows, the Schur rhs, H_pp and b_p are summed over the ``lm`` group;
* the row blocks of the reduced (6P x 6P) system are all-gathered over
  ``kf`` and the system is solved on every rank;
* the landmark back-substitution stays on the rank.

JAX's ring sends the visiting block ``n_kf`` times and the last send only
returns it home; here it is sent ``n_kf - 1`` times, and not at all when
``n_kf == 1``.  Per iteration: one packed sum over ``kf`` (H_ll, b_l), the
ring, one packed sum over ``lm`` (with the cost), one all-gather over ``kf``,
one packed sum over ``kf`` (the back-substitution term and the cost) and the
post-update cost over the mesh: four ``all_reduce`` calls and one
``all_gather``.
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
    peer,
)
from ergo_uvo_tpu_torch.geometry.rotations import so3_exp
from ergo_uvo_tpu_torch.optim.ba import (
    _jacobians,
    _normal_equations,
    _solve33_mat,
    reprojection_residuals,
)


def make_window_sharded_ba_step(
    mesh: DeviceMesh,
    num_fixed: int = 2,
    kf_axis: str = "kf",
    lm_axis: str = "lm",
):
    """One LM step over a ``(kf_axis, lm_axis)`` mesh:
    ``step(K, obs_uv, obs_mask, R, t, X, lam) -> (R, t, X, lam, cost)``.

    Every rank passes its block: obs_uv (P_loc, L_loc, 2), obs_mask
    (P_loc, L_loc), R (P_loc, 3, 3) and t (P_loc, 3) of its keyframe shard,
    X (L_loc, 3) of its landmark shard; K and lam replicated.  P % n_kf == 0
    and L % n_lm == 0.
    """
    kf_group, lm_group = mesh.get_group(kf_axis), mesh.get_group(lm_axis)
    n_kf = dist.get_world_size(kf_group)
    my = mesh.get_local_rank(kf_axis)
    assert dist.get_rank(kf_group) == my, "kf group ranks follow the mesh coordinate"
    send_to, recv_from = peer(mesh, kf_axis, 1), peer(mesh, kf_axis, -1)

    def ring_send(visiting):
        """Pass the visiting block to the next rank on the kf ring."""
        incoming = torch.empty_like(visiting)
        for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, visiting, send_to, kf_group),
            dist.P2POp(dist.irecv, incoming, recv_from, kf_group),
        ]):
            req.wait()
        return incoming

    def local_step(K, obs_uv, obs_mask, R_loc, t_loc, X_loc, lam):
        P_loc = R_loc.shape[0]
        r, pc, inv_z = reprojection_residuals(K, R_loc, t_loc, X_loc, obs_uv, obs_mask)
        cost_loc = (r * r).sum().reshape(1)
        J_pose, J_lm = _jacobians(K, R_loc, pc, inv_z, obs_mask)
        H_pp_loc, H_ll_loc, H_pl, b_p_loc, b_l_loc = _normal_equations(J_pose, J_lm, r)
        # Landmark blocks: reduce over the keyframe shards.
        H_ll, b_l = all_reduce_packed([H_ll_loc, b_l_loc], kf_group)
        eye3 = torch.eye(3, dtype=H_ll.dtype, device=H_ll.device)
        Hll_inv = _solve33_mat(H_ll + lam * eye3)
        W = torch.einsum("plij,ljk->plik", H_pl, Hll_inv)  # (P_loc, L_loc, 6, 3)

        # The ring over the keyframe axis: at step s the visiting H_pl block
        # belongs to kf shard (my - s) mod n_kf.
        S_rows = torch.zeros((P_loc, n_kf, P_loc, 6, 6), dtype=H_pl.dtype, device=H_pl.device)
        visiting = H_pl.contiguous()
        for s in range(n_kf):
            S_rows[:, (my - s) % n_kf] = torch.einsum("plik,qlmk->pqim", W, visiting)
            if s < n_kf - 1:
                visiting = ring_send(visiting)
        rhs_corr = torch.einsum("plik,lk->pi", W, b_l)  # (P_loc, 6)
        # Reduce over the landmark shards; the cost rides along.
        S_rows, rhs_corr, H_pp, b_p, cost_kf = all_reduce_packed(
            [S_rows, rhs_corr, H_pp_loc, b_p_loc, cost_loc], lm_group)

        # Row block of S for my poses: -(Schur correction) + diagonal H_pp.
        eye6 = torch.eye(6, dtype=H_pp.dtype, device=H_pp.device)
        ar = torch.arange(P_loc, device=H_pp.device)
        S_my = -S_rows.reshape(P_loc, n_kf * P_loc, 6, 6)
        S_my[ar, my * P_loc + ar] += H_pp + lam * eye6
        rhs_my = -(b_p - rhs_corr)

        # Gather all row blocks -> the full (P, P, 6, 6) system, solved on every rank.
        Pn = n_kf * P_loc
        rows = all_gather_rows(torch.cat([S_my.reshape(-1), rhs_my.reshape(-1)])[None], kf_group)
        S_full = rows[:, :S_my.numel()].reshape(Pn, Pn, 6, 6)
        rhs_full = rows[:, S_my.numel():].reshape(Pn, 6)
        arn = torch.arange(Pn, device=H_pp.device)
        pose_free = (arn >= num_fixed).to(S_full.dtype)
        S_full = S_full * pose_free[:, None, None, None] * pose_free[None, :, None, None]
        S_full[arn, arn] += (1.0 - pose_free)[:, None, None] * eye6
        rhs_full = rhs_full * pose_free[:, None]
        dp_all = torch.linalg.solve_ex(
            S_full.permute(0, 2, 1, 3).reshape(Pn * 6, Pn * 6), rhs_full.reshape(Pn * 6),
            check_errors=False,
        ).result.reshape(Pn, 6)

        # Back-substitute landmarks (local to the lm shard); the cost's sum
        # over the kf shards rides along.
        dp_loc = dp_all[my * P_loc:(my + 1) * P_loc]
        t1, cost = all_reduce_packed(
            [torch.einsum("plij,pi->lj", H_pl, dp_loc), cost_kf], kf_group)
        dl = torch.einsum("lij,lj->li", Hll_inv, -b_l - t1)

        # Apply, then accept or reject.
        dR = so3_exp(dp_loc[:, 3:])
        R2 = dR @ R_loc
        t2 = torch.einsum("pij,pj->pi", dR, t_loc) + dp_loc[:, :3]
        X2 = X_loc + dl
        r2, _, _ = reprojection_residuals(K, R2, t2, X2, obs_uv, obs_mask)
        cost2 = (r2 * r2).sum().reshape(1)
        dist.all_reduce(cost2)  # over the whole mesh, which is the world
        cost, cost2 = cost[0], cost2[0]
        improved = cost2 < cost
        lam_new = torch.where(improved, torch.clamp(lam * 0.3, min=1e-8),
                              torch.clamp(lam * 4.0, max=1e6))
        return (torch.where(improved, R2, R_loc), torch.where(improved, t2, t_loc),
                torch.where(improved, X2, X_loc), lam_new, torch.minimum(cost, cost2))

    return local_step


def window_sharded_ba_solve(
    mesh: DeviceMesh,
    K, obs_uv, obs_mask, R0, t0, X0,
    iters: int = 15,
    num_fixed: int = 2,
    init_lambda: float = 1e-3,
    kf_axis: str = "kf",
    lm_axis: str = "lm",
):
    """Solve on every rank from the global arrays; returns ((R, t, X, lam),
    costs (iters,)), R, t and X global and the same on every rank.

    Each rank keeps its (kf, lm) block of the arrays (numpy or tensors
    anywhere, moved to the mesh's device), loops the step in Python, and
    all-gathers R and t over ``kf`` and X over ``lm`` once at the end.
    """
    dev = mesh_device(mesh)
    K, obs_uv, obs_mask, R, t, X = (torch.as_tensor(a).to(dev)
                                    for a in (K, obs_uv, obs_mask, R0, t0, X0))
    obs_uv = local_rows(local_rows(obs_uv, mesh, kf_axis), mesh, lm_axis, dim=1)
    obs_mask = local_rows(local_rows(obs_mask, mesh, kf_axis), mesh, lm_axis, dim=1)
    R, t = local_rows(R, mesh, kf_axis), local_rows(t, mesh, kf_axis)
    X = local_rows(X, mesh, lm_axis)
    lam = torch.full((), init_lambda, dtype=R.dtype, device=dev)
    step = make_window_sharded_ba_step(mesh, num_fixed, kf_axis, lm_axis)
    costs = []
    for _ in range(iters):
        R, t, X, lam, cost = step(K, obs_uv, obs_mask, R, t, X, lam)
        costs.append(cost)
    kf_group = mesh.get_group(kf_axis)
    R, t = all_gather_rows(R, kf_group), all_gather_rows(t, kf_group)
    X = all_gather_rows(X, mesh.get_group(lm_axis))
    return (R, t, X, lam), torch.stack(costs)
