"""End-to-end trajectory refinement: VO outputs -> window BA -> pose graph.

Counterpart of ``ergo_uvo_tpu/optim/trajectory.py``: the functions that connect
the frame-to-frame pipelines to the window BA and the pose graph (the
reference is frame-to-frame with no map or keyframes, visual_odometry.h
:392-395).  Host orchestration (a ring of keyframes, correction chaining,
loop bookkeeping) in numpy around tensor work on the run's device:
re-detection, window association and BA, loop verification and the pose
graph.  Every match goes through ``match_descriptors``, so on the card
through the top-2 kernel.

Where the JAX package splits a PRNG key, the port draws from one
``torch.Generator`` (seeded 0 when none is given) and takes a ``sampler``
hook: ``sampler(n, method, mask, num_hypotheses, set_size)``, ``n`` the
index of the candidate being verified (0, 1, ... in the order the JAX
package splits its key), ``method`` "essential", "homography" or "pnp".
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ergo_uvo_tpu_torch.device import resolve_device
from ergo_uvo_tpu_torch.estimation.pnp import solve_pnp_ransac
from ergo_uvo_tpu_torch.estimation.relative_pose import estimate_relative_pose
from ergo_uvo_tpu_torch.eval.ate import integrate_mono_poses
from ergo_uvo_tpu_torch.features.frontend import detect_and_describe_cfg, is_binary
from ergo_uvo_tpu_torch.features.matcher import match_descriptors
from ergo_uvo_tpu_torch.geometry.camera import projection_matrix
from ergo_uvo_tpu_torch.geometry.stats import masked_median
from ergo_uvo_tpu_torch.geometry.triangulation import (
    cheirality_mask,
    filter_3d_points,
    triangulate_points,
)
from ergo_uvo_tpu_torch.optim.keyframes import WindowedBA
from ergo_uvo_tpu_torch.optim.pose_graph import (
    PoseGraph,
    detect_loop_closures,
    global_descriptor,
    optimize_pose_graph,
)


def _rel(R_a, t_a, R_b, t_b):
    """Relative world->cam transform a -> b: x_b = R x_a + t."""
    R = R_b @ R_a.T
    return R, t_b - R @ t_a


def _compose(R_rel, t_rel, R_a, t_a):
    """World->cam pose of b from a and the a->b relative."""
    return R_rel @ R_a, R_rel @ t_a + t_rel


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _frame(imgs, f: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(imgs[f]).to(device, torch.float32)


class BATrajectoryResult(NamedTuple):
    positions: np.ndarray  # (T, 3) BA-corrected camera centers, world frame
    kf_indices: np.ndarray  # (Nk,) frame indices of keyframes
    kf_positions: np.ndarray  # (Nk, 3) refined keyframe centers
    costs: np.ndarray  # (num_solves, iters) BA cost curves
    ba_iters_per_s: float  # LM iterations/s over the solves after the first
    R_wc: np.ndarray  # (T, 3, 3) BA-corrected world->cam rotations
    t_wc: np.ndarray  # (T, 3) BA-corrected world->cam translations


def refine_mono_trajectory(
    imgs,
    timestamps,
    outs,
    K,
    cfg,
    window_size: int = 6,
    keyframe_stride: int = 3,
    ba_iters: int = 12,
    lowe_ratio: float = 0.8,
    device: torch.device | str | None = None,
) -> BATrajectoryResult:
    """Sliding-window BA over VO keyframes; returns the corrected trajectory.

    ``imgs`` (T, H, W) are the preprocessed frames VO ran on (numpy or
    tensors), ``outs`` the per-frame outputs of ``run_mono_vo`` (or of
    ``run_stereo_vo``, with the left frames and K_left: stereo publishes the
    same prev-cam displacement convention, with metric scale) as numpy
    arrays or tensors.  Keyframes are every ``keyframe_stride``-th published
    frame; each full window is refined once, and new keyframes enter composed
    onto the refined previous keyframe.  The first solve is left out of
    ``ba_iters_per_s`` (on the card it pays the first cuSOLVER call); each
    solve is timed between two ``torch.cuda.synchronize`` on the card.
    Runs on ``device`` (``None``: the card).
    """
    device = resolve_device(device)
    velocities = np.asarray(outs.velocity)
    rots = np.asarray(outs.R)
    published = np.asarray(outs.published)
    timestamps = np.asarray(timestamps)
    R_wc, t_wc, _ = integrate_mono_poses(velocities, rots, timestamps, published)

    kf_idx = np.flatnonzero(published)[::keyframe_stride]
    binary = is_binary(cfg)
    K_dev = torch.as_tensor(K, dtype=torch.float32, device=device)

    wba = WindowedBA(window_size=window_size, iters=ba_iters)
    refined: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    prev_kf = None
    costs = []
    solve_s = 0.0
    n_solves = 0
    window_members: list[int] = []

    for k in kf_idx:
        kp, dsc = detect_and_describe_cfg(_frame(imgs, k, device), cfg)
        if prev_kf is None:
            R_init, t_init = R_wc[k], t_wc[k]
        else:
            R_r, t_r = _rel(R_wc[prev_kf], t_wc[prev_kf], R_wc[k], t_wc[k])
            R_init, t_init = _compose(R_r, t_r, *refined[prev_kf])
        wba.push_keyframe(
            kp.xy, dsc, kp.mask,
            torch.as_tensor(R_init, dtype=torch.float32).to(device),
            torch.as_tensor(t_init, dtype=torch.float32).to(device),
        )
        window_members.append(int(k))
        window_members = window_members[-window_size:]
        refined[int(k)] = (np.asarray(R_init), np.asarray(t_init))
        if wba.full:
            _sync(device)
            t0 = time.perf_counter()
            state, cost_curve, _ = wba.refine(K_dev, lowe_ratio, binary=binary)
            _sync(device)
            if n_solves > 0:
                solve_s += time.perf_counter() - t0
            n_solves += 1
            costs.append(cost_curve.cpu().numpy())
            R_ref, t_ref = state.R.cpu().numpy(), state.t.cpu().numpy()
            for i, fk in enumerate(window_members):
                refined[fk] = (R_ref[i], t_ref[i])
        prev_kf = int(k)

    # Propagate the corrections to every frame: the raw VO motion from the
    # nearest earlier keyframe, composed onto its refined pose.
    n = len(timestamps)
    positions = np.zeros((n, 3))
    R_out = np.zeros((n, 3, 3))
    t_out = np.zeros((n, 3))
    kf_sorted = np.asarray(sorted(refined))
    for f in range(n):
        earlier = kf_sorted[kf_sorted <= f]
        if len(earlier) == 0:
            R_f, t_f = R_wc[f], t_wc[f]
        else:
            j = int(earlier[-1])
            R_r, t_r = _rel(R_wc[j], t_wc[j], R_wc[f], t_wc[f])
            R_f, t_f = _compose(R_r, t_r, *refined[j])
        positions[f] = -R_f.T @ t_f
        R_out[f], t_out[f] = R_f, t_f
    # A run that never published has no keyframe (the JAX package's
    # np.stack raises there).
    kf_positions = np.array([-refined[int(k)][0].T @ refined[int(k)][1] for k in kf_idx])
    kf_positions = kf_positions.reshape(len(kf_idx), 3)
    iters_per_s = (n_solves - 1) * ba_iters / solve_s if n_solves > 1 and solve_s > 0 else 0.0
    return BATrajectoryResult(
        positions=positions,
        kf_indices=np.asarray(kf_idx),
        kf_positions=kf_positions,
        costs=np.stack(costs) if costs else np.zeros((0, ba_iters)),
        ba_iters_per_s=iters_per_s,
        R_wc=R_out,
        t_wc=t_out,
    )


class LoopClosure(NamedTuple):
    i: int
    j: int
    R_rel: np.ndarray  # (3, 3) measured x_j = R x_i + t
    t_rel: np.ndarray  # (3,)
    num_inliers: int


def _bind(sampler, n: int, method: str | None = None):
    """``sampler`` bound to candidate ``n`` (and ``method``), or None."""
    if sampler is None:
        return None
    if method is None:
        return lambda m, mask, h, k: sampler(n, m, mask, h, k)
    return lambda mask, h, k: sampler(n, method, mask, h, k)


def verify_loop_candidate(
    xy_i, mask_i, desc_i,
    xy_j, mask_j, desc_j,
    K, cfg,
    range_i,
    lowe_ratio: float = 0.8,
    min_inliers: int = 20,
    binary: bool = False,
    generator: torch.Generator | None = None,
    sampler=None,
):
    """Geometric verification of a retrieval candidate pair (i, j).

    The mono estimation stack end to end: match, essential/homography
    RANSAC, triangulate, metric scale from the range measurement at i
    (``compute_scale_factor`` semantics, VO_utility.cpp:23-38).  ``binary``
    follows the detector (ORB, AKAZE: Hamming distances).  ``sampler(method,
    mask, H, m)`` replaces ``generator``'s minimal sets when given.
    Returns (ok, R_rel, t_rel_metric, n_inliers) as tensors.
    """
    m = match_descriptors(desc_i, mask_i, desc_j, mask_j, lowe_ratio, binary=binary)
    xy_i = torch.where(m.mask[:, None], xy_i, 0.0)
    xy_j = torch.where(m.mask[:, None], xy_j[m.idx.long()], 0.0)
    eye3 = torch.eye(3, dtype=K.dtype, device=K.device)
    zero3 = torch.zeros(3, dtype=K.dtype, device=K.device)
    pose = estimate_relative_pose(xy_i, xy_j, m.mask, K, cfg, eye3, zero3, generator, sampler)
    P1 = projection_matrix(K, eye3, zero3)
    P2 = projection_matrix(K, pose.R, pose.t)
    tri_mask = pose.triangulation_inliers & m.mask
    X = triangulate_points(P1, P2, xy_i, xy_j)
    good, _ = filter_3d_points(
        X, tri_mask, K, eye3, zero3, K, pose.R, pose.t, xy_i, xy_j,
        cfg.reprojection_threshold, min_points=cfg.min_num_3d_points,
    )
    che = good & cheirality_mask(pose.R, pose.t, X)
    sf = range_i / torch.clamp(masked_median(X[:, 2], che), min=1e-9)
    n_inl = pose.num_inliers
    ok = pose.success & (n_inl >= min_inliers) & (che.sum() > 0) & (sf > 0)
    return ok, pose.R, sf * pose.t, n_inl


class PoseGraphResult(NamedTuple):
    positions: np.ndarray  # (T, 3) optimized camera centers
    loops: list  # accepted LoopClosure edges
    costs: np.ndarray  # per-iteration pose-graph cost


def _retrieve(desc_all, kpts_all, min_gap, top_k, min_similarity):
    """The candidate pairs (numpy) and their validity from global descriptors."""
    gdesc = global_descriptor(torch.stack(desc_all), torch.stack([k.mask for k in kpts_all]))
    pairs, _, valid = detect_loop_closures(gdesc, min_gap=min_gap, top_k=top_k,
                                           min_similarity=min_similarity)
    return pairs.cpu().numpy(), valid.cpu().numpy()


def _verify_candidates(pairs, valid, verify) -> list:
    """Run ``verify(n, i, j)`` on each distinct valid pair in order; keep the
    accepted ones as :class:`LoopClosure` edges."""
    loops: list[LoopClosure] = []
    seen = set()
    n = 0
    for c in range(len(pairs)):
        if not valid[c]:
            continue
        i, j = int(pairs[c, 0]), int(pairs[c, 1])
        if (i, j) in seen:
            continue
        seen.add((i, j))
        ok, R_rel, t_rel, n_inl = verify(n, i, j)
        n += 1
        if bool(ok):
            loops.append(LoopClosure(i, j, R_rel.cpu().numpy(), t_rel.cpu().numpy(), int(n_inl)))
    return loops


def close_loops_and_optimize(
    imgs,
    R_wc,
    t_wc,
    ranges,
    K,
    cfg,
    generator: torch.Generator | None = None,
    min_gap: int = 10,
    top_k: int = 8,
    min_similarity: float = 0.85,
    loop_weight: float = 10.0,
    iters: int = 25,
    min_inliers: int = 20,
    sampler=None,
    device: torch.device | str | None = None,
) -> PoseGraphResult:
    """Loop closure over a trajectory of frames.

    ``imgs``: (T, H, W) preprocessed frames; ``R_wc``/``t_wc``: (T, 3, 3) /
    (T, 3) VO poses (with drift); ``ranges``: (T,) range measurements for
    metric loop edges.  Sequential odometry edges from the VO poses,
    retrieval, verification of each candidate, then the pose graph.
    ``generator`` (``None``: seeded 0) draws the minimal sets; ``sampler``
    (see the module doc) replaces it.  Runs on ``device`` (``None``: the card).
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    binary = is_binary(cfg)
    K_dev = torch.as_tensor(K, dtype=torch.float32, device=device)
    ranges = np.asarray(ranges, np.float32)
    kpts_all, desc_all = [], []
    for f in range(len(imgs)):
        kp, ds = detect_and_describe_cfg(_frame(imgs, f, device), cfg)
        kpts_all.append(kp)
        desc_all.append(ds)
    pairs, valid = _retrieve(desc_all, kpts_all, min_gap, top_k, min_similarity)

    def verify(n, i, j):
        return verify_loop_candidate(
            kpts_all[i].xy, kpts_all[i].mask, desc_all[i],
            kpts_all[j].xy, kpts_all[j].mask, desc_all[j],
            K_dev, cfg, torch.tensor(float(ranges[i]), device=device),
            min_inliers=min_inliers, binary=binary, generator=generator,
            sampler=_bind(sampler, n),
        )

    loops = _verify_candidates(pairs, valid, verify)
    return _optimize_with_loops(R_wc, t_wc, loops, loop_weight, iters, device)


def _optimize_with_loops(R_wc, t_wc, loops, loop_weight, iters, device):
    """Sequential odometry edges plus the verified loop edges into a pose
    graph, optimized: the shared tail of the mono and stereo loop closures."""
    R_wc = np.asarray(R_wc)
    t_wc = np.asarray(t_wc)
    T = len(R_wc)
    n_seq = T - 1
    E = n_seq + max(len(loops), 1)
    ei = np.zeros(E, np.int32)
    ej = np.zeros(E, np.int32)
    eR = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
    et = np.zeros((E, 3), np.float32)
    ew = np.zeros(E, np.float32)
    for k in range(n_seq):
        R_r, t_r = _rel(R_wc[k], t_wc[k], R_wc[k + 1], t_wc[k + 1])
        ei[k], ej[k] = k, k + 1
        eR[k], et[k], ew[k] = R_r, t_r, 1.0
    for li, lp in enumerate(loops):
        e = n_seq + li
        ei[e], ej[e] = lp.i, lp.j
        eR[e], et[e], ew[e] = lp.R_rel, lp.t_rel, loop_weight

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    graph = PoseGraph(R=dev(R_wc), t=dev(t_wc), edge_i=dev(ei, torch.int32),
                      edge_j=dev(ej, torch.int32), edge_R=dev(eR), edge_t=dev(et),
                      edge_weight=dev(ew))
    opt, costs = optimize_pose_graph(graph, iters=iters, num_fixed=1)
    R_o, t_o = opt.R.cpu().numpy(), opt.t.cpu().numpy()
    positions = -np.einsum("tij,ti->tj", R_o.transpose(0, 2, 1), t_o)
    return PoseGraphResult(positions=positions, loops=loops, costs=costs.cpu().numpy())


def _stereo_frame_landmarks(kpts_l, desc_l, kpts_r, desc_r, rig, cfg, binary):
    """Stereo-match one L/R pair and triangulate: (X (K, 3) in the left frame
    on the left keypoints' slots, valid mask), the landmarks the stereo loop
    verifier runs PnP against (as the stereo step's previous-pair
    triangulation)."""
    sm = match_descriptors(desc_l, kpts_l.mask, desc_r, kpts_r.mask, cfg.lowe_ratio_test,
                           binary=binary)
    xy_r = kpts_r.xy[sm.idx.long()]
    eye3 = torch.eye(3, dtype=torch.float32, device=kpts_l.xy.device)
    zero3 = torch.zeros(3, dtype=torch.float32, device=kpts_l.xy.device)
    P1 = projection_matrix(rig.K_left, eye3, zero3)
    P2 = projection_matrix(rig.K_right, rig.R_right, rig.t_right)
    X = triangulate_points(P1, P2, kpts_l.xy, xy_r)
    good, _ = filter_3d_points(
        X, sm.mask, rig.K_left, eye3, zero3, rig.K_right, rig.R_right,
        rig.t_right, kpts_l.xy, xy_r, cfg.reprojection_threshold,
        min_points=cfg.min_num_3d_points,
    )
    return X, good


def verify_loop_candidate_pnp(
    X_i, mask3d_i, desc_i,
    xy_j, mask_j, desc_j,
    K, cfg,
    lowe_ratio: float = 0.8,
    min_inliers: int = 20,
    binary: bool = False,
    generator: torch.Generator | None = None,
    sampler=None,
):
    """Stereo loop verification: PnP of keyframe i's stereo landmarks against
    keyframe j's left pixels.  Stereo landmarks carry metric scale, so the
    edge needs no range.  ``sampler(mask, H, 3)`` replaces ``generator``'s
    minimal sets when given.  Returns (ok, R_rel, t_rel, n_inliers) with
    x_j = R_rel x_i + t_rel.
    """
    m = match_descriptors(desc_i, mask3d_i, desc_j, mask_j, lowe_ratio, binary=binary)
    xy_obs = xy_j[m.idx.long()]
    pnp = solve_pnp_ransac(
        X_i, xy_obs, m.mask & mask3d_i, K, cfg.reprojection_error, cfg.num_hypotheses,
        min_inliers=min_inliers, generator=generator, sampler=sampler,
    )
    n_inl = pnp.inliers.sum(dtype=torch.int32)
    ok = pnp.success & (n_inl >= min_inliers)
    return ok, pnp.R, pnp.t, n_inl


def close_loops_and_optimize_stereo(
    imgs_l,
    imgs_r,
    R_wc,
    t_wc,
    rig,
    cfg,
    generator: torch.Generator | None = None,
    min_gap: int = 10,
    top_k: int = 8,
    min_similarity: float = 0.85,
    loop_weight: float = 10.0,
    iters: int = 25,
    min_inliers: int = 20,
    sampler=None,
    device: torch.device | str | None = None,
) -> PoseGraphResult:
    """Stereo loop closure: the mono retrieval over the left
    descriptors, candidates verified by PnP against stereo-triangulated
    landmarks (metric edges with no range sensor).  ``rig`` is a
    ``StereoRig`` on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    binary = is_binary(cfg)
    kpts_all, desc_all, X_all, m3d_all = [], [], [], []
    for f in range(len(imgs_l)):
        kl, dl = detect_and_describe_cfg(_frame(imgs_l, f, device), cfg)
        kr, dr = detect_and_describe_cfg(_frame(imgs_r, f, device), cfg)
        X, good = _stereo_frame_landmarks(kl, dl, kr, dr, rig, cfg, binary)
        kpts_all.append(kl)
        desc_all.append(dl)
        X_all.append(X)
        m3d_all.append(good)
    pairs, valid = _retrieve(desc_all, kpts_all, min_gap, top_k, min_similarity)

    def verify(n, i, j):
        return verify_loop_candidate_pnp(
            X_all[i], m3d_all[i], desc_all[i],
            kpts_all[j].xy, kpts_all[j].mask, desc_all[j],
            rig.K_left, cfg, lowe_ratio=cfg.lowe_ratio_test, min_inliers=min_inliers,
            binary=binary, generator=generator, sampler=_bind(sampler, n, "pnp"),
        )

    loops = _verify_candidates(pairs, valid, verify)
    return _optimize_with_loops(R_wc, t_wc, loops, loop_weight, iters, device)
