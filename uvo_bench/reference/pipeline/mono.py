"""Mono UVO step: the plain version of the port's ``pipeline/mono.py``.

The reference's ``mono_VO`` loop (visual_odometry.h:167-398) as one step over
a carried :class:`MonoVOState`: detect + describe -> match(prev, curr) ->
method select -> essential/homography + switch-once -> triangulate + gates ->
range scale -> velocity + validity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from uvo_bench.reference.config import MonoVOConfig
from uvo_bench.reference.estimation.relative_pose import MethodSampler, estimate_relative_pose
from uvo_bench.reference.features.detector import Keypoints
from uvo_bench.reference.features.frontend import detect_and_describe_cfg, is_binary
from uvo_bench.reference.features.matcher import match_descriptors
from uvo_bench.reference.geometry.camera import projection_matrix
from uvo_bench.reference.geometry.stats import masked_median
from uvo_bench.reference.geometry.triangulation import (
    cheirality_mask,
    filter_3d_points,
    triangulate_points,
)


class MonoVOState(NamedTuple):
    """Carried frame-to-frame state (visual_odometry.h:209-215, :392-395)."""

    prev_xy: torch.Tensor  # (K, 2)
    prev_desc: torch.Tensor  # (K, D)
    prev_mask: torch.Tensor  # (K,)
    prev_time: torch.Tensor  # f32 seconds
    R: torch.Tensor  # (3, 3) last relative rotation (curr <- prev)
    t: torch.Tensor  # (3,) last unit translation
    SF: torch.Tensor  # f32 metric scale factor (init 1.0, :204)
    initialized: torch.Tensor  # bool — init handshake done (:227-245)


class MonoFrameOutput(NamedTuple):
    """Per-frame record: the ROS topics + structured diagnostics."""

    velocity: torch.Tensor  # (3,) camera-frame linear velocity
    validity: torch.Tensor  # bool — successful_estimate
    published: torch.Tensor  # bool — False for skipped/init frames
    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)
    scale_factor: torch.Tensor
    num_features: torch.Tensor
    num_matches: torch.Tensor
    num_inliers: torch.Tensor
    num_3d_points: torch.Tensor
    used_essential: torch.Tensor
    median_disparity: torch.Tensor


def mono_vo_init(
    max_keypoints: int = 512,
    descriptor_dim: int = 64,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> MonoVOState:
    return MonoVOState(
        prev_xy=torch.zeros((max_keypoints, 2), dtype=dtype, device=device),
        prev_desc=torch.zeros((max_keypoints, descriptor_dim), dtype=dtype, device=device),
        prev_mask=torch.zeros(max_keypoints, dtype=torch.bool, device=device),
        prev_time=torch.zeros((), dtype=dtype, device=device),
        R=torch.eye(3, dtype=dtype, device=device),
        t=torch.zeros(3, dtype=dtype, device=device),
        SF=torch.ones((), dtype=dtype, device=device),
        initialized=torch.zeros((), dtype=torch.bool, device=device),
    )


def mono_vo_step(
    state: MonoVOState,
    img: torch.Tensor,
    timestamp: torch.Tensor,
    range_measure: torch.Tensor,
    K: torch.Tensor,
    cfg: MonoVOConfig,
    generator: torch.Generator | None = None,
    sampler: MethodSampler | None = None,
):
    """One frame of mono VO on a (H, W) preprocessed gray frame.

    Returns (next_state, MonoFrameOutput).  ``sampler(method, mask, H, m)``
    replaces the generator's minimal sets when given (tests only).
    """
    kpts, desc = detect_and_describe_cfg(img, cfg)
    return mono_vo_step_with_features(
        state, kpts, desc, timestamp, range_measure, K, cfg, generator, sampler
    )


def mono_vo_step_with_features(
    state: MonoVOState,
    kpts: Keypoints,
    desc: torch.Tensor,
    timestamp: torch.Tensor,
    range_measure: torch.Tensor,
    K: torch.Tensor,
    cfg: MonoVOConfig,
    generator: torch.Generator | None = None,
    sampler: MethodSampler | None = None,
):
    """The mono step after detection: match -> pose -> triangulate -> scale."""
    n_features = kpts.count
    enough_features = n_features >= cfg.min_num_features

    # ---- init handshake (visual_odometry.h:227-245): before initialization
    # a frame only becomes `prev` if it has enough features.
    becomes_init = (~state.initialized) & enough_features
    run_steady = state.initialized

    # ---- matching (prev -> curr; VO_utility.cpp:551-573).
    matches = match_descriptors(
        state.prev_desc, state.prev_mask, desc, kpts.mask, cfg.lowe_ratio_test,
        binary=is_binary(cfg),
    )
    prev_xy = torch.where(matches.mask[:, None], state.prev_xy, 0.0)
    curr_xy = torch.where(matches.mask[:, None], kpts.xy[matches.idx.long()], 0.0)
    n_matches = matches.count
    enough_matches = n_matches >= cfg.min_num_features
    process = run_steady & enough_features & enough_matches

    disp = torch.linalg.vector_norm(prev_xy - curr_xy, dim=-1)
    median_disp = masked_median(disp, matches.mask)

    # ---- relative pose with method selection + switch-once.
    pose = estimate_relative_pose(
        prev_xy, curr_xy, matches.mask, K, cfg, state.R, state.t, generator, sampler
    )
    pose_success = pose.success & process

    # ---- triangulation + gating (visual_odometry.h:349-375).
    eye3 = torch.eye(3, dtype=K.dtype, device=K.device)
    zero3 = torch.zeros(3, dtype=K.dtype, device=K.device)
    P1 = projection_matrix(K, eye3, zero3)
    P2 = projection_matrix(K, pose.R, pose.t)
    tri_mask = pose.triangulation_inliers & matches.mask
    X = triangulate_points(P1, P2, prev_xy, curr_xy)
    good_mask, _ = filter_3d_points(
        X, tri_mask,
        K, eye3, zero3, K, pose.R, pose.t,
        prev_xy, curr_xy,
        cfg.reprojection_threshold,
        min_points=cfg.min_num_3d_points,
    )
    n_3d = good_mask.sum(dtype=torch.int32)
    enough_3d = n_3d >= cfg.min_num_3d_points

    # Cheirality in the current frame; Z stays in the previous frame
    # (convert_3Dpoints_camera's source-frame return, VO_utility.cpp:46-63).
    che_mask = good_mask & cheirality_mask(pose.R, pose.t, X)
    n_che = che_mask.sum()
    z_prev = X[:, 2]
    sf_new = range_measure / torch.clamp(masked_median(z_prev, che_mask), min=1e-9)

    update_sf = pose_success & enough_3d & (n_che > 0)
    validity = update_sf
    SF = torch.where(update_sf, sf_new, state.SF)

    # On a processed frame the carried (R, t) take the estimator's output,
    # even when validity drops (the reference's members hold the last attempt).
    R_out = torch.where(process, pose.R, state.R)
    t_out = torch.where(process, pose.t, state.t)

    # ---- output (mono_output_computation, visual_odometry.h:126-140).
    delta_t = timestamp - state.prev_time
    safe_dt = torch.where(delta_t.abs() < 1e-6, 1.0, delta_t)
    velocity = -SF * (R_out.T @ t_out) / safe_dt
    published = process

    # ---- state shift (prev <- curr whenever initialized or initializing).
    take_curr = run_steady | becomes_init
    next_state = MonoVOState(
        prev_xy=torch.where(take_curr, kpts.xy, state.prev_xy),
        prev_desc=torch.where(take_curr, desc, state.prev_desc),
        prev_mask=torch.where(take_curr, kpts.mask, state.prev_mask),
        prev_time=torch.where(take_curr, timestamp, state.prev_time),
        R=R_out,
        t=t_out,
        SF=SF,
        initialized=state.initialized | becomes_init,
    )
    out = MonoFrameOutput(
        velocity=torch.where(published, velocity, 0.0),
        validity=validity & published,
        published=published,
        R=R_out,
        t=t_out,
        scale_factor=SF,
        num_features=n_features,
        num_matches=n_matches,
        num_inliers=pose.num_inliers.to(torch.int32),
        num_3d_points=n_3d,
        used_essential=pose.used_essential & published,
        median_disparity=median_disp,
    )
    return next_state, out
