"""Stereo UVO pipeline — counterpart of ``ergo_uvo_tpu/pipeline/stereo.py``.

The reference's ``stereo_VO`` (visual_odometry.h:406-741) as a step over a
carried :class:`StereoVOState`:

  detect L/R -> stereo match (curr L<->R) -> "triangular matching"
  (prev stereo-matched left -> curr full left set, :592) -> triangulate the
  previous pair (prev-left frame, :631) -> 3D-point gates -> PnP RANSAC
  (:647-648) -> velocity = t_prevCam_currCam / dt (:148-159).

Failure cascade preserved exactly (every branch publishes validity 0 and
keeps the last t_prevCam_currCam — "assume constant motion", :667-711), and
the state shift prev <- curr-stereo-matched always happens, so a bad frame
empties the carried set until a good stereo pair re-seeds it (:723-733).
Gate comparisons mirror the reference's strict/non-strict choices:
detections >= MIN_NUM_FEATURES, stereo and triangular matches > MIN,
3D points > MIN_NUM_3DPOINTS, PnP inliers >= MIN_NUM_INLIERS.

Every gate is a mask, so the step has no data-dependent branch and reads
nothing back to the host.  The JAX package scans the step with ``lax.scan``;
:func:`run_stereo_vo` is a Python loop over :func:`stereo_vo_step`, and
:func:`run_stereo_vo_streaming` a loop over the chunks of a paired frame
source, which reads back once a chunk.  Both matches of a frame go through
``match_descriptors`` and so, on the card, through the top-2 kernel: two
launches a frame.

The entry points (:func:`stereo_vo_init`, :func:`stereo_vo_init_from`,
:func:`run_stereo_vo`, :func:`run_stereo_vo_streaming`) run on the card:
``device=None`` means ``"cuda"`` and raises where there is none.  The step
runs where its tensors lie.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from ergo_uvo_tpu_torch.config import StereoVOConfig
from ergo_uvo_tpu_torch.device import resolve_device, upload
from ergo_uvo_tpu_torch.estimation.pnp import solve_pnp_ransac
from ergo_uvo_tpu_torch.estimation.sampling import Sampler
from ergo_uvo_tpu_torch.features.frontend import detect_and_describe_cfg, is_binary
from ergo_uvo_tpu_torch.features.matcher import match_descriptors
from ergo_uvo_tpu_torch.geometry.camera import projection_matrix
from ergo_uvo_tpu_torch.geometry.triangulation import filter_3d_points, triangulate_points
from ergo_uvo_tpu_torch.image.preprocess import PreprocessPlan, preprocess_frame
from ergo_uvo_tpu_torch.pipeline.mono import (
    FrameSampler,
    check_plan_device,
    concat_chunks,
    read_back,
)
from ergo_uvo_tpu_torch.utils.debug import check_frame
from ergo_uvo_tpu_torch.utils.profiling import span


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
    device = resolve_device(device)
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


def stereo_vo_init_from(
    cfg: StereoVOConfig,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> StereoVOState:
    """State sized from the config (``descriptor_dim`` follows the detector)."""
    return stereo_vo_init(cfg.max_keypoints, cfg.descriptor_dim, dtype, device)


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
    with span("triangulate"):
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


def run_stereo_vo(
    imgs_l: torch.Tensor | np.ndarray,  # (T, H, W)
    imgs_r: torch.Tensor | np.ndarray,  # (T, H, W)
    timestamps: torch.Tensor | np.ndarray,  # (T,)
    rig: StereoRig,
    cfg: StereoVOConfig,
    generator: torch.Generator | None = None,
    state: StereoVOState | None = None,
    sampler: FrameSampler | None = None,
    device: torch.device | str | None = None,
):
    """Run the stereo step over (T, H, W) frame pairs; returns (state, outputs).

    ``outputs`` is a :class:`StereoFrameOutput` with every field stacked
    over the T frames.  ``generator`` drives the PnP minimal sets;
    ``sampler(frame, "pnp", mask, H, 3)`` replaces it when given, so a test
    can feed the JAX package's minimal sets.

    The frames and timestamps may be numpy arrays or tensors on any device;
    they are moved to ``device`` (``None``: the card, see
    :func:`~ergo_uvo_tpu_torch.device.resolve_device`), and the outputs lie
    there.  A ``rig``, ``state`` or ``generator`` on another device raises.
    """
    device = resolve_device(device)
    imgs_l, imgs_r, timestamps, state = _stereo_inputs(
        "run_stereo_vo", imgs_l, imgs_r, timestamps, rig, cfg, generator, state, device
    )
    return _step_pairs(state, imgs_l, imgs_r, timestamps, rig, cfg, generator, sampler)


def _stereo_inputs(name, imgs_l, imgs_r, timestamps, rig, cfg, generator, state, device):
    """Move a runner's frames to its device and check what the caller brought."""
    imgs_l, imgs_r, timestamps = (
        torch.as_tensor(x).to(device) for x in (imgs_l, imgs_r, timestamps)
    )
    if generator is not None and resolve_device(generator.device) != device:
        raise ValueError(f"generator is on {generator.device}, {name} runs on {device}")
    if state is None:
        state = stereo_vo_init_from(cfg, imgs_l.dtype, device)
    for label, tup in (("rig", rig), ("state", state)):
        for field, value in tup._asdict().items():
            if value.device != device:
                raise ValueError(f"{label}.{field} is on {value.device}, {name} runs on {device}")
    return imgs_l, imgs_r, timestamps, state


def _step_pairs(state, imgs_l, imgs_r, timestamps, rig, cfg, generator, sampler, first=0):
    """:func:`stereo_vo_step` over the pairs; ``first`` is the global index of
    the first pair, which the sampler and the nan guard see."""
    outs = []
    for i in range(imgs_l.shape[0]):
        step_sampler = None
        if sampler is not None:
            step_sampler = functools.partial(sampler, first + i, "pnp")
        with span("step", frame=first + i):
            state, out = stereo_vo_step(
                state, imgs_l[i], imgs_r[i], timestamps[i], rig, cfg, generator, step_sampler
            )
        check_frame(out, first + i)
        outs.append(out)
    return state, StereoFrameOutput(*(torch.stack(field) for field in zip(*outs)))


def run_stereo_vo_streaming(
    source,
    plan_l: PreprocessPlan,
    plan_r: PreprocessPlan,
    rig: StereoRig,
    cfg: StereoVOConfig,
    generator: torch.Generator,
    chunk_size: int = 16,
    state: StereoVOState | None = None,
    chunk_callback=None,
    timings: list | None = None,
    sampler: FrameSampler | None = None,
    device: torch.device | str | None = None,
    frames: list | None = None,
):
    """Stream synced L/R frame batches through stereo VO chunk by chunk.

    The streaming analogue of the reference's ApproximateTime-synced stereo
    loop (visual_odometry.h:766-774, :526-740): a host loop pulls fixed-size
    paired batches from a paired source
    (:class:`~ergo_uvo_tpu_torch.io.sequence.JpegPairSource`, or an
    ``ArraySource`` with ``imgs_right``), preprocesses each eye's frames in
    one call under its own plan, and runs :func:`stereo_vo_step` pair by
    pair.  The chunk reads back once, at its end: the step has no host sync
    of its own.  Returns (final_state, outputs), the outputs a
    :class:`StereoFrameOutput` of numpy arrays stacked over the streamed
    frames; with the same generator seed they equal ``preprocess_frame``
    then :func:`run_stereo_vo` bit for bit, whatever the chunk size.

    `chunk_callback(frames_done, state, chunk_out, generator_state)`,
    `timings`, `sampler` and `device` — see
    :func:`ergo_uvo_tpu_torch.pipeline.mono.run_mono_vo_streaming`;
    `frames` collects each chunk's preprocessed ``(left, right)`` frames.
    """
    device = resolve_device(device)
    check_plan_device("plan_l", plan_l, device)
    check_plan_device("plan_r", plan_r, device)
    chunks = []
    frames_done = 0
    for batch in source.batches(chunk_size):
        if batch.imgs_right is None:
            raise ValueError("stereo streaming needs a paired source "
                             "(FrameBatch.imgs_right is None)")
        t0 = time.perf_counter()
        n = len(batch.imgs)
        with span("chunk", frame=frames_done, frames=n):
            with span("upload"):
                raw_l = upload(batch.imgs, device).float()
                raw_r = upload(batch.imgs_right, device).float()
                tss = upload(batch.timestamps, device)
            imgs_l = preprocess_frame(plan_l, raw_l)
            imgs_r = preprocess_frame(plan_r, raw_r)
            if frames is not None:
                frames.append((imgs_l, imgs_r))
            imgs_l, imgs_r, tss, state = _stereo_inputs(
                "run_stereo_vo_streaming", imgs_l, imgs_r, tss, rig, cfg, generator, state,
                device,
            )
            state, outs = _step_pairs(state, imgs_l, imgs_r, tss, rig, cfg, generator, sampler,
                                      frames_done)
            chunks.append(read_back(outs, device))
            if timings is not None:
                timings.append((n, time.perf_counter() - t0))
            frames_done += n
            if chunk_callback is not None:
                with span("callback"):
                    chunk_callback(frames_done, state, chunks[-1], generator.get_state())
    return state, concat_chunks(chunks)
