"""Stereo UVO step: the plain version of the port's ``pipeline/stereo.py``.

The reference's ``stereo_VO`` (visual_odometry.h:406-741) as one step over a
carried :class:`StereoVOState`: detect L/R -> stereo match -> triangular
match -> triangulate the previous pair -> 3D-point gates -> PnP RANSAC ->
velocity = t_prevCam_currCam / dt.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from uvo_bench.reference.config import StereoVOConfig
from uvo_bench.reference.estimation.pnp import solve_pnp_ransac
from uvo_bench.reference.estimation.sampling import Sampler
from uvo_bench.reference.features.frontend import detect_and_describe_cfg, is_binary
from uvo_bench.reference.features.matcher import match_descriptors
from uvo_bench.reference.geometry.camera import projection_matrix
from uvo_bench.reference.geometry.triangulation import filter_3d_points, triangulate_points


class StereoRig(NamedTuple):
    """Static rig geometry (stereo_VO_intrinsics.yaml via config.StereoIntrinsics)."""

    K_left: torch.Tensor  # (3,3) pipeline (alpha=0) left camera
    K_right: torch.Tensor  # (3,3) right camera
    R_right: torch.Tensor  # (3,3) right-from-left rotation
    t_right: torch.Tensor  # (3,) right-from-left translation (baseline)


class StereoVOState(NamedTuple):
    """Carried stereo-matched previous pair (visual_odometry.h:723-733)."""

    prev_xy_l: torch.Tensor  # (K, 2) left pixels of stereo-matched pairs
    prev_xy_r: torch.Tensor  # (K, 2) aligned right pixels
    prev_desc_l: torch.Tensor  # (K, D) left descriptors (triangular-match queries)
    prev_mask: torch.Tensor  # (K,)
    prev_time: torch.Tensor
    t_prev_curr: torch.Tensor  # (3,) last t_prevCam_currCam (constant-motion hold)
    R_curr_prev: torch.Tensor  # (3,3) last PnP rotation (diagnostic)
    initialized: torch.Tensor


class StereoFrameOutput(NamedTuple):
    velocity: torch.Tensor  # (3,) = t_prevCam_currCam / dt
    validity: torch.Tensor
    published: torch.Tensor
    R: torch.Tensor  # (3,3) R_currCam_prevCam
    t: torch.Tensor  # (3,) t_prevCam_currCam
    num_features_l: torch.Tensor
    num_features_r: torch.Tensor
    num_stereo_matches: torch.Tensor
    num_triangular_matches: torch.Tensor
    num_3d_points: torch.Tensor
    num_pnp_inliers: torch.Tensor


def stereo_vo_init(
    max_keypoints: int = 512,
    descriptor_dim: int = 64,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> StereoVOState:
    return StereoVOState(
        prev_xy_l=torch.zeros((max_keypoints, 2), dtype=dtype, device=device),
        prev_xy_r=torch.zeros((max_keypoints, 2), dtype=dtype, device=device),
        prev_desc_l=torch.zeros((max_keypoints, descriptor_dim), dtype=dtype, device=device),
        prev_mask=torch.zeros(max_keypoints, dtype=torch.bool, device=device),
        prev_time=torch.zeros((), dtype=dtype, device=device),
        t_prev_curr=torch.zeros(3, dtype=dtype, device=device),
        R_curr_prev=torch.eye(3, dtype=dtype, device=device),
        initialized=torch.zeros((), dtype=torch.bool, device=device),
    )


def stereo_vo_step(
    state: StereoVOState,
    img_l: torch.Tensor,
    img_r: torch.Tensor,
    timestamp: torch.Tensor,
    rig: StereoRig,
    cfg: StereoVOConfig,
    generator: torch.Generator | None = None,
    sampler: Sampler | None = None,
):
    """One stereo pair of (H, W) preprocessed gray frames.

    Returns (next_state, StereoFrameOutput).  ``sampler(mask, H, 3)``
    replaces the generator's minimal sets when given (tests only).
    """
    kpts_l, desc_l = detect_and_describe_cfg(img_l, cfg)
    kpts_r, desc_r = detect_and_describe_cfg(img_r, cfg)
    n_l, n_r = kpts_l.count, kpts_r.count
    detections_ok = (n_l >= cfg.min_num_features) & (n_r >= cfg.min_num_features)

    # ---- stereo match curr L (query) <-> R (train) (visual_odometry.h:558).
    binary = is_binary(cfg)
    sm = match_descriptors(desc_l, kpts_l.mask, desc_r, kpts_r.mask, cfg.lowe_ratio_test,
                           binary=binary)
    n_stereo = sm.count
    stereo_ok = detections_ok & (n_stereo > cfg.min_num_features)
    # Current stereo-matched set, aligned on left slots; emptied when the
    # gates fail (the reference's empty-compaction, :569-579).
    curr_set_mask = sm.mask & stereo_ok
    curr_xy_r = kpts_r.xy[sm.idx.long()]

    # ---- triangular matching: prev stereo-matched left -> curr FULL left
    # keypoint set (:592 matches against curr_left_descr, not the subset).
    tm = match_descriptors(
        state.prev_desc_l, state.prev_mask, desc_l, kpts_l.mask, cfg.lowe_ratio_test,
        binary=binary,
    )
    n_tri = tm.count
    tri_ok = stereo_ok & (n_tri > cfg.min_num_features)
    tri_mask = tm.mask & tri_ok

    # ---- triangulate the PREVIOUS stereo pair in the prev-left frame (:631).
    eye3 = torch.eye(3, dtype=img_l.dtype, device=img_l.device)
    zero3 = torch.zeros(3, dtype=img_l.dtype, device=img_l.device)
    P1 = projection_matrix(rig.K_left, eye3, zero3)
    P2 = projection_matrix(rig.K_right, rig.R_right, rig.t_right)
    X = triangulate_points(P1, P2, state.prev_xy_l, state.prev_xy_r)
    good_mask, _ = filter_3d_points(
        X, tri_mask,
        rig.K_left, eye3, zero3,
        rig.K_right, rig.R_right, rig.t_right,
        state.prev_xy_l, state.prev_xy_r,
        cfg.reprojection_threshold,
        min_points=cfg.min_num_3d_points,
    )
    n_3d = good_mask.sum(dtype=torch.int32)
    points_ok = tri_ok & (n_3d > cfg.min_num_3d_points)

    # ---- PnP: prev-left-frame 3D points vs current-left pixels (:647-648).
    # A frame whose gates failed still goes through, with an all-false mask.
    curr_xy_for_pnp = kpts_l.xy[tm.idx.long()]
    pnp = solve_pnp_ransac(
        X, curr_xy_for_pnp, good_mask & points_ok, rig.K_left,
        cfg.reprojection_error, cfg.num_hypotheses,
        min_inliers=cfg.min_num_inliers,
        generator=generator, sampler=sampler,
    )
    success = points_ok & pnp.success

    R_curr_prev = torch.where(success, pnp.R, state.R_curr_prev)
    t_prev_curr = torch.where(success, -(pnp.R.T @ pnp.t), state.t_prev_curr)

    # ---- output (stereo_output_computation, :148-159).
    delta_t = timestamp - state.prev_time
    safe_dt = torch.where(delta_t.abs() < 1e-6, 1.0, delta_t)
    velocity = t_prev_curr / safe_dt
    published = state.initialized

    # ---- init handshake (:474-506) + unconditional steady-state shift.
    becomes_init = (~state.initialized) & stereo_ok
    take_curr = state.initialized | becomes_init
    keep = curr_set_mask[:, None]
    next_state = StereoVOState(
        prev_xy_l=torch.where(take_curr, torch.where(keep, kpts_l.xy, 0.0), state.prev_xy_l),
        prev_xy_r=torch.where(take_curr, torch.where(keep, curr_xy_r, 0.0), state.prev_xy_r),
        prev_desc_l=torch.where(take_curr, torch.where(keep, desc_l, 0.0), state.prev_desc_l),
        prev_mask=torch.where(take_curr, curr_set_mask, state.prev_mask),
        prev_time=torch.where(take_curr, timestamp, state.prev_time),
        t_prev_curr=t_prev_curr,
        R_curr_prev=R_curr_prev,
        initialized=state.initialized | becomes_init,
    )
    out = StereoFrameOutput(
        velocity=torch.where(published, velocity, 0.0),
        validity=success & published,
        published=published,
        R=R_curr_prev,
        t=t_prev_curr,
        num_features_l=n_l,
        num_features_r=n_r,
        num_stereo_matches=n_stereo,
        num_triangular_matches=n_tri,
        num_3d_points=n_3d,
        num_pnp_inliers=pnp.inliers.sum(dtype=torch.int32),
    )
    return next_state, out
