"""Monocular UVO pipeline — counterpart of ``ergo_uvo_tpu/pipeline/mono.py``.

The reference's ``mono_VO`` loop (visual_odometry.h:167-398) as a step
function over a carried :class:`MonoVOState`, with every skip and fallback
expressed as masked selection:

  frame -> detect+describe -> match(prev, curr) -> method select ->
  essential/homography + switch-once -> triangulate + gates -> range scale ->
  velocity + validity, state shift prev <- curr.

The JAX package scans the step with ``lax.scan``; :func:`run_mono_vo` is a
Python loop over :func:`mono_vo_step`, and :func:`run_mono_vo_streaming` a
loop over the chunks of a frame source.  Apart from the method switch in
``estimate_relative_pose`` (two ``.item()`` per frame) the step stays on the
device.  The JAX package's ``optimization_barrier`` calls are fusion hints
with no eager meaning and are dropped.  Under
:func:`~ergo_uvo_tpu_torch.utils.debug.nan_guard` the runners check every
frame's outputs.

The entry points (:func:`mono_vo_init`, :func:`mono_vo_init_from`,
:func:`run_mono_vo`, :func:`run_mono_vo_batched_features`,
:func:`run_mono_vo_streaming`) run on the card: ``device=None`` means
``"cuda"`` and raises where there is none.  The CPU is used only when the
caller passes ``device="cpu"``.  The step functions run where their tensors
lie.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ergo_uvo_tpu_torch.config import MonoVOConfig
from ergo_uvo_tpu_torch.device import resolve_device, upload
from ergo_uvo_tpu_torch.estimation.relative_pose import MethodSampler, estimate_relative_pose
from ergo_uvo_tpu_torch.features.detector import Keypoints
from ergo_uvo_tpu_torch.features.frontend import detect_and_describe_cfg, is_binary
from ergo_uvo_tpu_torch.features.matcher import match_descriptors
from ergo_uvo_tpu_torch.geometry.camera import projection_matrix
from ergo_uvo_tpu_torch.geometry.stats import masked_median
from ergo_uvo_tpu_torch.geometry.triangulation import (
    cheirality_mask,
    filter_3d_points,
    triangulate_points,
)
from ergo_uvo_tpu_torch.image.preprocess import PreprocessPlan, preprocess_frame
from ergo_uvo_tpu_torch.utils.debug import check_frame
from ergo_uvo_tpu_torch.utils.profiling import span

# sampler(frame, method, mask, num_hypotheses, set_size) -> (idx, sets_valid)
FrameSampler = Callable[[int, str, torch.Tensor, int, int], tuple]


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
    device = resolve_device(device)
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


def mono_vo_init_from(
    cfg: MonoVOConfig,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> MonoVOState:
    """State sized from the config (``descriptor_dim`` follows the detector)."""
    return mono_vo_init(cfg.max_keypoints, cfg.descriptor_dim, dtype, device)


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
    with span("triangulate"):
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


def _run_inputs(name, imgs, timestamps, ranges, K, cfg, generator, state, device):
    """Move a runner's inputs to its device and check what the caller brought."""
    device = resolve_device(device)
    imgs, timestamps, ranges, K = (
        torch.as_tensor(x).to(device) for x in (imgs, timestamps, ranges, K)
    )
    if generator is not None and resolve_device(generator.device) != device:
        raise ValueError(f"generator is on {generator.device}, {name} runs on {device}")
    if state is None:
        state = mono_vo_init_from(cfg, imgs.dtype, device)
    else:
        for field, value in state._asdict().items():
            if value.device != device:
                raise ValueError(
                    f"state.{field} is on {value.device}, {name} runs on {device}"
                )
    return imgs, timestamps, ranges, K, state


def _bind_frame(sampler: FrameSampler | None, i: int) -> MethodSampler | None:
    return None if sampler is None else functools.partial(sampler, i)


def _step_frames(state, imgs, timestamps, ranges, K, cfg, generator, sampler, first=0):
    """:func:`mono_vo_step` over the frames; ``first`` is the global index of
    ``imgs[0]``, which the sampler and the nan guard see."""
    outs = []
    for i in range(imgs.shape[0]):
        with span("step", frame=first + i):
            state, out = mono_vo_step(
                state, imgs[i], timestamps[i], ranges[i], K, cfg, generator,
                _bind_frame(sampler, first + i),
            )
        check_frame(out, first + i)
        outs.append(out)
    return state, MonoFrameOutput(*(torch.stack(field) for field in zip(*outs)))


def run_mono_vo(
    imgs: torch.Tensor | np.ndarray,
    timestamps: torch.Tensor | np.ndarray,
    ranges: torch.Tensor | np.ndarray,
    K: torch.Tensor | np.ndarray,
    cfg: MonoVOConfig,
    generator: torch.Generator | None = None,
    state: MonoVOState | None = None,
    sampler: FrameSampler | None = None,
    device: torch.device | str | None = None,
):
    """Run the mono step over (T, H, W) frames; returns (state, outputs).

    ``outputs`` is a :class:`MonoFrameOutput` with every field stacked over
    the T frames.  ``generator`` drives the RANSAC/LMEDS minimal sets;
    ``sampler(frame, method, mask, H, m)`` replaces it when given, so a test
    can feed the JAX package's minimal sets.

    The frames, timestamps, ranges and K may be numpy arrays or tensors on
    any device; they are moved to ``device`` (``None``: the card, see
    :func:`~ergo_uvo_tpu_torch.device.resolve_device`), and the outputs lie
    there.  A ``state`` or a ``generator`` on another device raises.
    """
    imgs, timestamps, ranges, K, state = _run_inputs(
        "run_mono_vo", imgs, timestamps, ranges, K, cfg, generator, state, device
    )
    return _step_frames(state, imgs, timestamps, ranges, K, cfg, generator, sampler)


def run_mono_vo_batched_features(
    imgs: torch.Tensor | np.ndarray,
    timestamps: torch.Tensor | np.ndarray,
    ranges: torch.Tensor | np.ndarray,
    K: torch.Tensor | np.ndarray,
    cfg: MonoVOConfig,
    generator: torch.Generator | None = None,
    state: MonoVOState | None = None,
    sampler: FrameSampler | None = None,
    device: torch.device | str | None = None,
):
    """:func:`run_mono_vo` with detection taken out of the frame loop.

    Features do not depend on the state, so ``detect_and_describe`` runs
    once on all T frames (truly batched: every detector's scale space, NMS,
    stable-sort top-K, refinement and descriptor gathers carry the frame
    dimension; nothing is looped), and the loop carries only
    match -> pose -> triangulate -> scale
    (:func:`mono_vo_step_with_features`).  Every op of the batch gives a
    frame the bits it gets alone, so the outputs equal :func:`run_mono_vo`'s.
    The detector's intermediates grow with T.
    Same arguments, ``device=None`` rule and ``sampler`` hook as
    :func:`run_mono_vo`.
    """
    imgs, timestamps, ranges, K, state = _run_inputs(
        "run_mono_vo_batched_features", imgs, timestamps, ranges, K, cfg, generator, state, device
    )
    kpts, descs = detect_and_describe_cfg(imgs, cfg)
    outs = []
    for i in range(imgs.shape[0]):
        with span("step", frame=i):
            state, out = mono_vo_step_with_features(
                state, Keypoints(*(f[i] for f in kpts)), descs[i], timestamps[i], ranges[i],
                K, cfg, generator, _bind_frame(sampler, i),
            )
        check_frame(out, i)
        outs.append(out)
    stacked = MonoFrameOutput(*(torch.stack(field) for field in zip(*outs)))
    return state, stacked


def check_plan_device(name: str, plan: PreprocessPlan, device: torch.device) -> None:
    """Raise if a preprocess plan's tensors lie elsewhere than ``device``."""
    if plan.grid.device != device:
        raise ValueError(f"{name} is on {plan.grid.device}, the run is on {device}")


def read_back(outs: NamedTuple, device: torch.device) -> NamedTuple:
    """A chunk's stacked outputs as numpy: every field is copied to the host,
    then the host waits once, so the chunk's one read-back is its one sync."""
    with span("read_back"):
        if device.type == "cuda":
            host = [x.to("cpu", non_blocking=True) for x in outs]
            torch.cuda.synchronize(device)
        else:
            host = list(outs)
        return type(outs)(*(x.numpy() for x in host))


def concat_chunks(chunks: list) -> NamedTuple:
    """The chunks' outputs stacked over all streamed frames (numpy)."""
    if not chunks:
        raise ValueError("source yielded no complete chunks")
    return type(chunks[0])(*(np.concatenate(field) for field in zip(*chunks)))


def run_mono_vo_streaming(
    source,
    plan: PreprocessPlan,
    K: torch.Tensor | np.ndarray,
    cfg: MonoVOConfig,
    generator: torch.Generator,
    chunk_size: int = 16,
    state: MonoVOState | None = None,
    chunk_callback=None,
    timings: list | None = None,
    sampler: FrameSampler | None = None,
    device: torch.device | str | None = None,
    frames: list | None = None,
):
    """Stream a :class:`~ergo_uvo_tpu_torch.io.sequence.FrameSource` through mono VO.

    A host loop over ``source.batches(chunk_size)``: each chunk's frames are
    preprocessed in one :func:`preprocess_frame` call (which gives each frame
    the bits it gets alone), then :func:`mono_vo_step` runs frame by frame.
    One ``generator`` runs through the whole stream, and ``sampler`` sees the
    global frame index, so with the same generator seed the outputs equal
    ``preprocess_frame`` then :func:`run_mono_vo` bit for bit, whatever the
    chunk size.  A trailing partial chunk is not streamed.  Returns
    (final_state, outputs): the state on ``device``, the outputs a
    :class:`MonoFrameOutput` of numpy arrays stacked over the streamed frames.

    `chunk_callback(frames_done, state, chunk_out, generator_state)` fires
    after every chunk with the carried VO state, THIS chunk's outputs (numpy,
    the new frames only, so a checkpointer appends O(chunk) bytes) and
    ``generator.get_state()`` for the next chunk — what a crash-resumable
    checkpoint needs (``utils.checkpoint.save_stream_head`` /
    ``append_stream_segment``).

    `timings` (optional list) collects one `(n_frames, seconds)` entry per
    chunk, from the chunk's upload to the end of its read-back; the first
    entry also holds the CUDA context, the kernel's build or load and the
    allocator's warm-up.  A chunk reads back from the card once.

    `frames` (optional list) collects each chunk's preprocessed frames, a
    (n, H, W) tensor on ``device`` a chunk: what window BA and loop closure
    re-detect on after the stream.

    The plan's tensors, a ``state`` and the generator must lie on ``device``
    (``None``: the card).  Raises ``ValueError`` when the source yields no
    complete chunk.
    """
    device = resolve_device(device)
    check_plan_device("plan", plan, device)
    K = upload(K, device)
    chunks = []
    frames_done = 0
    for batch in source.batches(chunk_size):
        t0 = time.perf_counter()
        n = len(batch.imgs)
        with span("chunk", frame=frames_done, frames=n):
            with span("upload"):
                raw = upload(batch.imgs, device).float()
                ranges = batch.ranges if batch.ranges is not None else np.ones(n, np.float32)
                tss, rgs = upload(batch.timestamps, device), upload(ranges, device)
            imgs = preprocess_frame(plan, raw)
            if frames is not None:
                frames.append(imgs)
            imgs, tss, rgs, K, state = _run_inputs(
                "run_mono_vo_streaming", imgs, tss, rgs, K, cfg, generator, state, device,
            )
            state, outs = _step_frames(state, imgs, tss, rgs, K, cfg, generator, sampler,
                                       frames_done)
            chunks.append(read_back(outs, device))
            if timings is not None:
                timings.append((n, time.perf_counter() - t0))
            frames_done += n
            if chunk_callback is not None:
                with span("callback"):
                    chunk_callback(frames_done, state, chunks[-1], generator.get_state())
    return state, concat_chunks(chunks)
