"""Command-line runner of the port — counterpart of ``ergo_uvo_tpu/cli.py``.

The reference's L3/L4 (UVO_node + launch/config): the mono/stereo switch is a
subcommand, the rosparam YAML files load through
:mod:`ergo_uvo_tpu_torch.config`, the rosbag is a directory of JPEG frames
(decoded on the host by libjpeg through ``io/native`` or else by PIL) or a
synthetic sequence, and the output topics are a JSONL record stream, a
trajectory file and a one-line JSON summary on stdout.

Every run streams: frames go through ``run_mono_vo_streaming`` /
``run_stereo_vo_streaming`` chunk by chunk, on the card unless ``--device``
names another device.  A synthetic run streams its frames from memory under
a plan without distortion or CLAHE, which leaves them as they are, so it sees
what the JAX CLI's synthetic run sees.  Real-data runs can checkpoint and
resume (``--checkpoint``, ``--resume``).

``--ba-window K`` refines the trajectory with sliding-window BA and
``--loop-closure`` adds verified loop edges and optimizes the pose graph
(``ergo_uvo_tpu_torch.optim``), mono and stereo.  Both re-detect on the
stream's preprocessed frames, which the run then keeps on its device (the
JAX CLI bulk-decodes the sequence in this mode instead).  A resumed stream
would lack its prefix's frames, so these flags refuse ``--checkpoint`` and
``--resume``.

Usage:
  python -m ergo_uvo_tpu_torch.cli mono --params mono_VO_parameters.yaml \\
      --intrinsics mono_VO_intrinsics.yaml --camera downward_camera \\
      --frames /path/to/jpegs --ranges ranges.txt --out run.jsonl
  python -m ergo_uvo_tpu_torch.cli mono --synthetic 24 --out run.jsonl
  python -m ergo_uvo_tpu_torch.cli stereo --synthetic 24 --device cpu
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import sys

import numpy as np
import torch

from ergo_uvo_tpu_torch.device import resolve_device

SUMMARY_HELP = """\
The summary line (JSON) holds the JAX CLI's keys.  compile_s is the first
chunk's time beyond a steady chunk's: on the card, the CUDA context, the top-2
kernel's build (nvcc) or load, and the allocator's warm-up; the port compiles
nothing else.  steady_fps is the frame rate of the later chunks (pad frames
included).  device is where the run ran.  With --ba-window: ba_keyframes,
ba_solves and ba_iters_per_s (LM iterations/s over the solves after the
first); with --loop-closure: loops_accepted.
"""


def _list_frames(directory):
    paths = sorted(glob.glob(os.path.join(directory, "*.jpg"))) + sorted(
        glob.glob(os.path.join(directory, "*.jpeg"))
    )
    if not paths:
        raise SystemExit(f"no JPEG frames under {directory}")
    return paths


def _load_frames(paths, gray=True):
    """Decode a path list into (N, H, W) float32 frames (libjpeg or PIL)."""
    from ergo_uvo_tpu_torch.io.sequence import JpegDirectorySource

    return next(JpegDirectorySource(paths, gray=gray).batches(len(paths))).imgs


def _parse_size(spec):
    """'640x480' -> (640, 480)."""
    try:
        w, h = (int(v) for v in spec.lower().split("x"))
        return w, h
    except ValueError:
        raise SystemExit(f"--synthetic-size must be WxH, got {spec!r}")


def _load_timestamps(path, n_frames, what="frames"):
    """Per-frame stamps (seconds, one float per line) — the reference's
    message-header time used for deltaT (visual_odometry.h:263).  Must cover
    every frame and be non-decreasing."""
    tss = np.atleast_1d(np.loadtxt(path).astype(np.float64))
    if len(tss) < n_frames:
        raise SystemExit(
            f"--timestamps has {len(tss)} entries for {n_frames} {what}"
        )
    tss = tss[:n_frames]
    if (np.diff(tss) < 0).any():
        raise SystemExit("--timestamps must be non-decreasing")
    return tss.astype(np.float32)


def _pair_by_timestamp(tss_l, tss_r, max_skew):
    """ApproximateTime-sync analogue (message_filters sync of the stereo
    topics, visual_odometry.h:766-774): greedily pair each left stamp with
    the nearest unconsumed right stamp; drop lefts whose best skew exceeds
    `max_skew`.  Returns (left_indices, right_indices) of accepted pairs."""
    li, ri = [], []
    j = 0
    n_r = len(tss_r)
    for i, t in enumerate(tss_l):
        if j >= n_r:
            break
        while j + 1 < n_r and abs(tss_r[j + 1] - t) <= abs(tss_r[j] - t):
            j += 1
        if abs(tss_r[j] - t) <= max_skew:
            li.append(i)
            ri.append(j)
            j += 1
    return np.asarray(li, int), np.asarray(ri, int)


def _outs_example(out_type):
    """Structure template for a per-frame output tuple (leaf shapes and
    dtypes come from the checkpoint file; only the structure matters)."""
    return out_type(*([np.zeros(0)] * len(out_type._fields)))


def _seq_digest(n, *path_lists):
    """sha256 over the first `n` ordered (paired) frame basenames: the
    identity of the frames a stream checkpoint covers.

    The JAX CLI digests the whole list, so a sequence that gained frames at
    its end refuses to resume.  The port digests only the checkpointed
    prefix: appended frames resume, a changed prefix is refused.  Over a
    whole list the two digests are equal."""
    h = hashlib.sha256()
    for paths in path_lists:
        for p in paths[:n]:
            h.update(os.path.basename(str(p)).encode())
            h.update(b"\n")
        h.update(b"--\n")
    return h.hexdigest()


def _make_stream_ckpt_cb(path, every, n_real, chunk_size, start, n_segments,
                         digest_of=None):
    """Chunk callback persisting streaming-VO progress every `every` chunks.

    Segment-based (utils.checkpoint.append_stream_segment + save_stream_head):
    each checkpoint appends only the new frames and rewrites the small head —
    O(chunk) IO per checkpoint, not O(history).  Pad-duplicate rows (the tail
    padding to a chunk multiple) are trimmed before they are persisted, so
    `frames_done` and resume offsets always refer to REAL frames and a
    resumed run may use any --chunk-size.  ``digest_of(n)`` gives the digest
    of the first n real frames, written into the head.
    """
    from ergo_uvo_tpu_torch.utils.checkpoint import append_stream_segment, save_stream_head

    remaining_real = n_real - start
    pending = []
    calls = 0
    nseg = n_segments

    def cb(frames_done, state, chunk, generator_state):
        nonlocal calls, nseg
        calls += 1
        n_chunk = len(chunk[0])
        keep = min(max(remaining_real - (frames_done - n_chunk), 0), n_chunk)
        if keep:
            pending.append(
                chunk if keep == n_chunk else type(chunk)(*(v[:keep] for v in chunk))
            )
        if calls % every:
            return
        if pending:
            seg = type(pending[0])(*(np.concatenate(xs) for xs in zip(*pending)))
            append_stream_segment(path, nseg, seg)
            nseg += 1
            pending.clear()
        real_done = start + min(frames_done, remaining_real)
        save_stream_head(path, real_done, state, generator_state, nseg, n_real, chunk_size,
                         seq_digest=digest_of(real_done) if digest_of is not None else "")

    return cb


def _resume_stream(args, init_state, out_type, device):
    """Load (start_real_frame, state, outs_prefix, generator_state, meta) from
    --checkpoint if --resume was given and the file exists; else fresh-start
    values.  `start` counts real frames only (pads are never persisted)."""
    if args.resume:
        if not args.checkpoint:
            raise SystemExit("--resume requires --checkpoint PATH")
        if os.path.exists(args.checkpoint):
            from ergo_uvo_tpu_torch.utils.checkpoint import load_stream_run

            return load_stream_run(args.checkpoint, init_state, _outs_example(out_type), device)
    return 0, None, None, None, None


def _stream_perf(timings):
    """``{"compile_s", "steady_fps"}`` from per-chunk ``(n_frames, seconds)``:
    the first chunk pays the start-up (see ``SUMMARY_HELP``)."""
    perf = {}
    if len(timings) >= 2:
        steady_n = sum(n for n, _ in timings[1:])
        steady_s = sum(t for _, t in timings[1:])
        perf["steady_fps"] = round(steady_n / max(steady_s, 1e-9), 2)
        perf["compile_s"] = round(
            max(timings[0][1] - steady_s / len(timings[1:]), 0.0), 2
        )
    elif timings:
        perf["compile_s"] = round(timings[0][1], 2)
    return perf


def _run_streamed(args, n_real, tss, init_state, out_type, launch, device, digest_of=None):
    """Shared streaming scaffolding: resume accounting, tail padding to a
    chunk multiple, checkpoint wiring, and prefix stitching.

    `launch(start, pad, tss_p, state0, generator, chunk, cb, timings)` builds
    the frame source over the remaining real frames (+ `pad` repeats of the
    final frame) and runs the streaming pipeline.  The generator is seeded
    with ``--seed``, or restored from the checkpoint.  Returns
    ``(outs, perf)``: the per-frame outputs (numpy) trimmed to exactly
    `n_real` rows, and :func:`_stream_perf` of the per-chunk timings.
    """
    start, state0, outs_prev, generator_state, meta = _resume_stream(
        args, init_state, out_type, device
    )
    perf = {}
    if meta is not None:
        recorded = meta["seq_digest"]
        current = digest_of(start) if digest_of is not None else ""
        if recorded and current and recorded != current:
            msg = (
                f"--checkpoint was written for other frames: the first {start} "
                f"frames' digest is {recorded[:12]}… in the checkpoint and "
                f"{current[:12]}… now; the restored prefix would correspond to "
                "other frames"
            )
            if not args.force_resume:
                raise SystemExit(
                    f"error: {msg} — re-run with --force-resume to override"
                )
            print(f"warning: {msg} — continuing (--force-resume)",
                  file=sys.stderr)
        if meta["n_real"] != n_real:
            print(
                f"warning: --checkpoint was written for {meta['n_real']} "
                f"frames; the sequence now has {n_real} — resuming at frame "
                f"{start}",
                file=sys.stderr,
            )
    start = min(start, n_real)
    remaining = n_real - start
    if remaining == 0:
        outs = outs_prev
    else:
        chunk = max(min(args.chunk_size, remaining), 1)
        pad = (-remaining) % chunk
        tss_p = np.concatenate(
            [np.asarray(tss[start:n_real], np.float32),
             np.full(pad, tss[n_real - 1], np.float32)]
        )
        generator = torch.Generator(device=device).manual_seed(args.seed)
        if generator_state is not None:
            generator.set_state(generator_state)
        cb = (
            _make_stream_ckpt_cb(
                args.checkpoint, args.checkpoint_every, n_real, chunk, start,
                (meta or {"n_segments": 0})["n_segments"], digest_of=digest_of,
            )
            if args.checkpoint else None
        )
        timings = []
        _, outs_new = launch(start, pad, tss_p, state0, generator, chunk, cb, timings)
        perf = _stream_perf(timings)
        if outs_prev is not None:
            outs = type(outs_new)(*(np.concatenate([a, b]) for a, b in zip(outs_prev, outs_new)))
        else:
            outs = outs_new
    return type(outs)(*(np.asarray(v)[:n_real] for v in outs)), perf


def _identity_plan(K, w, h, device):
    """A plan without distortion or CLAHE at the frames' own size: it leaves
    the frames as they are and ``new_K == K`` (synthetic frames are
    preprocessed already)."""
    from ergo_uvo_tpu_torch.image import build_preprocess_plan

    return build_preprocess_plan(K, np.zeros(4), w, h, w, False, 3.0, device=device)


def _record(args, outs):
    from ergo_uvo_tpu_torch.utils import RunRecorder

    rec = RunRecorder(args.out)
    for i in range(len(outs[0])):
        rec.record_frame(i, type(outs)(*(v[i] for v in outs)))
    rec.close()


def _optimizing(args) -> bool:
    return bool(args.ba_window or args.loop_closure)


def _refine(args, summary, pos, outs, tss, imgs, K, cfg, device, close_loops):
    """``--ba-window`` then ``--loop-closure`` over the run's kept frames, as
    the JAX CLI: the pose graph starts from the BA-refined poses when both
    run.  ``close_loops(R_wc, t_wc, generator)`` is the mode's loop-closure
    function; its generator is seeded with ``--seed`` + 1.  Returns the
    positions to write, and adds the summary's keys."""
    from ergo_uvo_tpu_torch.optim import integrate_mono_poses, refine_mono_trajectory

    ba_res = None
    if args.ba_window:
        ba_res = refine_mono_trajectory(
            imgs, tss, outs, K, cfg, window_size=args.ba_window,
            keyframe_stride=args.keyframe_stride, ba_iters=args.ba_iters, device=device,
        )
        pos = ba_res.positions
        summary["ba_keyframes"] = int(len(ba_res.kf_indices))
        summary["ba_solves"] = int(ba_res.costs.shape[0])
        summary["ba_iters_per_s"] = round(ba_res.ba_iters_per_s, 2)
    if args.loop_closure:
        if ba_res is not None:
            R_wc, t_wc = ba_res.R_wc, ba_res.t_wc
        else:
            R_wc, t_wc, _ = integrate_mono_poses(outs.velocity, outs.R, tss, outs.published)
        pg = close_loops(R_wc, t_wc, torch.Generator(device=device).manual_seed(args.seed + 1))
        pos = pg.positions
        summary["loops_accepted"] = len(pg.loops)
    return pos


def _run_mono(args, device):
    from ergo_uvo_tpu_torch.config import MonoVOConfig, load_mono_intrinsics, load_vo_params
    from ergo_uvo_tpu_torch.eval import integrate_mono_trajectory
    from ergo_uvo_tpu_torch.image import build_preprocess_plan
    from ergo_uvo_tpu_torch.io import make_mono_sequence
    from ergo_uvo_tpu_torch.io.sequence import ArraySource, JpegDirectorySource
    from ergo_uvo_tpu_torch.pipeline.mono import (
        MonoFrameOutput,
        mono_vo_init_from,
        run_mono_vo_streaming,
    )

    cfg = load_vo_params(args.params) if args.params else MonoVOConfig()
    gt_positions = None
    digest_of = None
    if args.synthetic:
        w_s, h_s = _parse_size(args.synthetic_size)
        seq = make_mono_sequence(n_frames=args.synthetic, height=h_s, width=w_s)
        n_real, tss, rgs = args.synthetic, seq.timestamps, seq.ranges
        gt_positions = seq.positions
        plan = _identity_plan(seq.K, w_s, h_s, device)

        def source(start, pad, tss_p):
            idx = np.concatenate([np.arange(start, n_real), np.full(pad, n_real - 1)])
            return ArraySource(seq.imgs_left[idx], tss_p, ranges=rgs[idx])
    else:
        # Real-data path: frames decode on the host chunk by chunk while the
        # card runs VO; the sequence never bulk-materializes.
        if not (args.intrinsics and args.camera and args.ranges):
            raise SystemExit("--intrinsics, --camera and --ranges required "
                             "(or use --synthetic N)")
        intr = load_mono_intrinsics(args.intrinsics, args.camera)
        paths = _list_frames(args.frames)
        h, w = _load_frames(paths[:1]).shape[1:3]
        plan = build_preprocess_plan(
            intr.K(), intr.dist_coeffs(), w, h, cfg.preprocessing.desired_width,
            cfg.preprocessing.clahe, cfg.preprocessing.clip_limit, device=device,
        )
        rgs = np.atleast_1d(np.loadtxt(args.ranges).astype(np.float32))
        if len(rgs) < len(paths):
            raise SystemExit(
                f"--ranges has {len(rgs)} entries for {len(paths)} frames"
            )
        # Real per-frame stamps when provided (deltaT semantics,
        # visual_odometry.h:263); otherwise fabricate the nominal node rate.
        tss = (
            _load_timestamps(args.timestamps, len(paths))
            if args.timestamps
            else np.arange(len(paths), dtype=np.float32) / cfg.node_freq
        )
        n_real = len(paths)
        rgs = rgs[:n_real]

        def digest_of(n):
            return _seq_digest(n, paths)

        def source(start, pad, tss_p):
            # The path list is padded to a chunk multiple (repeating the
            # final frame): JpegDirectorySource drops a trailing partial
            # batch, and the outputs are trimmed back to the true length.
            paths_p = paths[start:n_real] + [paths[n_real - 1]] * pad
            rgs_p = np.concatenate([rgs[start:n_real], np.full(pad, rgs[n_real - 1], np.float32)])
            return JpegDirectorySource(paths_p, timestamps=tss_p, ranges=rgs_p)

    kept = [] if _optimizing(args) else None

    def launch(start, pad, tss_p, state0, generator, chunk, cb, timings):
        return run_mono_vo_streaming(
            source(start, pad, tss_p), plan, plan.new_K, cfg, generator,
            chunk_size=chunk, state=state0, chunk_callback=cb, timings=timings,
            device=device, frames=kept,
        )

    outs, perf = _run_streamed(
        args, n_real, tss, mono_vo_init_from(cfg, device="cpu"), MonoFrameOutput, launch,
        device, digest_of=digest_of,
    )
    tss = tss[:n_real]
    if args.check_nan:
        from ergo_uvo_tpu_torch.utils.debug import assert_finite

        assert_finite(outs, "mono outputs")
    _record(args, outs)

    pos, dead_reckoned = integrate_mono_trajectory(
        outs.velocity, outs.R, tss, outs.published, outs.validity
    )
    summary = {
        "frames": int(n_real),
        "dead_reckoned_frames": int(dead_reckoned.sum()),
        "published": int(outs.published.sum()),
        "valid": int(outs.validity.sum()),
        "mean_inliers": float(outs.num_inliers[outs.published].mean())
        if outs.published.any()
        else 0.0,
        **perf,
        "device": str(device),
    }
    # Budget adequacy: the batched hypothesis budget covers outlier rates
    # down to an implied minimum inlier fraction; when the data measures
    # below it the estimate quality is budget-limited.
    if outs.published.any():
        from ergo_uvo_tpu_torch.estimation.sampling import implied_inlier_rate

        pub = outs.published.astype(bool)
        frac = float(
            (outs.num_inliers[pub] / np.maximum(outs.num_matches[pub], 1)).mean()
        )
        assumed = implied_inlier_rate(
            cfg.essential.confidence, cfg.num_hypotheses, 8
        )
        summary["mean_inlier_fraction"] = round(frac, 3)
        if frac < assumed:
            summary["inlier_fraction_below_budget"] = True
            print(
                f"warning: measured inlier fraction {frac:.2f} is below the "
                f"{assumed:.2f} the {cfg.num_hypotheses}-hypothesis budget "
                "is sized for; raise tpu_params.num_hypotheses or "
                "essential_max_iters (estimation/sampling.py)",
                file=sys.stderr,
            )

    if kept is not None:
        from ergo_uvo_tpu_torch.optim import close_loops_and_optimize

        imgs = torch.cat(kept)[:n_real]

        def close_loops(R_wc, t_wc, generator):
            return close_loops_and_optimize(imgs, R_wc, t_wc, rgs[:n_real], plan.new_K, cfg,
                                            generator=generator, device=device)

        pos = _refine(args, summary, pos, outs, tss, imgs, plan.new_K, cfg, device, close_loops)
    np.savetxt(os.path.splitext(args.out)[0] + "_trajectory.txt", pos)
    if gt_positions is not None:
        from ergo_uvo_tpu_torch.eval import ate_rmse

        summary["ate_m"] = ate_rmse(pos, gt_positions - gt_positions[0])
    print(json.dumps(summary))


def _run_stereo(args, device):
    from ergo_uvo_tpu_torch.config import StereoVOConfig, load_stereo_intrinsics, load_vo_params
    from ergo_uvo_tpu_torch.convert import stereo_rig_from_numpy
    from ergo_uvo_tpu_torch.eval import integrate_mono_trajectory
    from ergo_uvo_tpu_torch.image import build_preprocess_plan
    from ergo_uvo_tpu_torch.io import make_stereo_sequence
    from ergo_uvo_tpu_torch.io.sequence import ArraySource, JpegPairSource
    from ergo_uvo_tpu_torch.pipeline.stereo import (
        StereoFrameOutput,
        run_stereo_vo_streaming,
        stereo_vo_init_from,
    )

    cfg = load_vo_params(args.params, stereo=True) if args.params else StereoVOConfig()
    gt_positions = None
    digest_of = None
    n_dropped = None
    if args.synthetic:
        w_s, h_s = _parse_size(args.synthetic_size)
        seq = make_stereo_sequence(n_frames=args.synthetic, height=h_s, width=w_s)
        n_real, tss = args.synthetic, seq.timestamps
        gt_positions = seq.positions
        K = np.asarray(seq.K, np.float32)
        rig = dict(K_left=K, K_right=K, R_right=np.eye(3, dtype=np.float32),
                   t_right=np.asarray([-0.33, 0.0, 0.0], np.float32))
        plan_l = plan_r = _identity_plan(seq.K, w_s, h_s, device)

        def source(start, pad, tss_p):
            idx = np.concatenate([np.arange(start, n_real), np.full(pad, n_real - 1)])
            return ArraySource(seq.imgs_left[idx], tss_p, imgs_right=seq.imgs_right[idx])
    else:
        # Real-data path: synced left/right JPEG directories + the reference's
        # stereo intrinsics YAML (visual_odometry.h:766-776,
        # get_stereo_camera_parameters VO_utility.cpp:408-453).
        if not (args.frames_left and args.frames_right and args.intrinsics
                and args.camera):
            raise SystemExit("--frames-left, --frames-right, --intrinsics and "
                             "--camera required (or use --synthetic N)")
        intr = load_stereo_intrinsics(args.intrinsics, args.camera)
        paths_l = _list_frames(args.frames_left)
        paths_r = _list_frames(args.frames_right)
        n_dropped = 0
        if args.timestamps_left and args.timestamps_right:
            # Stamp-based pairing (the ApproximateTime analogue,
            # visual_odometry.h:766-774): nearest-stamp matching with a
            # max-skew drop instead of index truncation.
            tss_l = _load_timestamps(args.timestamps_left, len(paths_l),
                                     "left frames")
            tss_r = _load_timestamps(args.timestamps_right, len(paths_r),
                                     "right frames")
            max_skew = (
                args.max_skew if args.max_skew is not None
                else 0.5 / cfg.node_freq
            )
            li, ri = _pair_by_timestamp(tss_l, tss_r, max_skew)
            if len(li) == 0:
                raise SystemExit("no stereo pairs within --max-skew "
                                 f"({max_skew:.4f}s)")
            n_dropped = len(paths_l) - len(li)
            if n_dropped:
                print(f"warning: dropped {n_dropped} left frames with no "
                      f"right frame within {max_skew:.4f}s", file=sys.stderr)
            paths_l = [paths_l[i] for i in li]
            paths_r = [paths_r[j] for j in ri]
            tss = tss_l[li].astype(np.float32)
        else:
            if len(paths_l) != len(paths_r):
                n = min(len(paths_l), len(paths_r))
                paths_l, paths_r = paths_l[:n], paths_r[:n]
            tss = (
                _load_timestamps(args.timestamps, len(paths_l))
                if args.timestamps
                else np.arange(len(paths_l), dtype=np.float32) / cfg.node_freq
            )
        h, w = _load_frames(paths_l[:1]).shape[1:3]
        pre = cfg.preprocessing
        plan_l = build_preprocess_plan(intr.left.K(), intr.left.dist_coeffs(), w, h,
                                       pre.desired_width, pre.clahe, pre.clip_limit,
                                       device=device)
        plan_r = build_preprocess_plan(intr.right.K(), intr.right.dist_coeffs(), w, h,
                                       pre.desired_width, pre.clahe, pre.clip_limit,
                                       device=device)
        rig = dict(K_left=plan_l.new_K.cpu().numpy(), K_right=plan_r.new_K.cpu().numpy(),
                   R_right=np.asarray(intr.R_right, np.float32),
                   t_right=np.asarray(intr.t_right, np.float32).reshape(3))
        n_real = len(paths_l)

        def digest_of(n):
            return _seq_digest(n, paths_l, paths_r)

        def source(start, pad, tss_p):
            # Pad the synced path lists to a chunk multiple, as mono does.
            paths_lp = paths_l[start:n_real] + [paths_l[n_real - 1]] * pad
            paths_rp = paths_r[start:n_real] + [paths_r[n_real - 1]] * pad
            return JpegPairSource(paths_lp, paths_rp, timestamps=tss_p)

    rig = stereo_rig_from_numpy(rig, device)
    kept = [] if _optimizing(args) else None

    def launch(start, pad, tss_p, state0, generator, chunk, cb, timings):
        return run_stereo_vo_streaming(
            source(start, pad, tss_p), plan_l, plan_r, rig, cfg, generator,
            chunk_size=chunk, state=state0, chunk_callback=cb, timings=timings,
            device=device, frames=kept,
        )

    outs, perf = _run_streamed(
        args, n_real, tss, stereo_vo_init_from(cfg, device="cpu"), StereoFrameOutput, launch,
        device, digest_of=digest_of,
    )
    tss = tss[:n_real]
    if args.check_nan:
        from ergo_uvo_tpu_torch.utils.debug import assert_finite

        assert_finite(outs, "stereo outputs")
    _record(args, outs)
    # Stereo publishes velocity = t_prevCam_currCam / dt and R_currCam_prevCam
    # — the same prev-cam-frame displacement convention as mono, so the same
    # integrator applies (stereo_output_computation, visual_odometry.h:148-159).
    pos = integrate_mono_trajectory(outs.velocity, outs.R, tss, outs.published)
    summary = {
        "frames": int(n_real),
        "published": int(outs.published.sum()),
        "valid": int(outs.validity.sum()),
        **({} if n_dropped is None else {"pairs_dropped": int(n_dropped)}),
        **perf,
        "device": str(device),
    }
    if kept is not None:
        # Stereo outputs share mono's prev-cam displacement convention with
        # metric scale, so the same window refinement runs on the left eye;
        # loop edges come from PnP against stereo landmarks.
        from ergo_uvo_tpu_torch.optim import close_loops_and_optimize_stereo

        imgs_l = torch.cat([left for left, _ in kept])[:n_real]
        imgs_r = torch.cat([right for _, right in kept])[:n_real]

        def close_loops(R_wc, t_wc, generator):
            return close_loops_and_optimize_stereo(imgs_l, imgs_r, R_wc, t_wc, rig, cfg,
                                                   generator=generator, device=device)

        pos = _refine(args, summary, pos, outs, tss, imgs_l, rig.K_left, cfg, device, close_loops)
    np.savetxt(os.path.splitext(args.out)[0] + "_trajectory.txt", pos)
    if gt_positions is not None:
        from ergo_uvo_tpu_torch.eval import ate_rmse

        summary["ate_m"] = ate_rmse(pos, gt_positions - gt_positions[0])
    print(json.dumps(summary))


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="ergo_uvo_tpu_torch",
        description="Mono and stereo underwater visual odometry on an NVIDIA GPU (PyTorch port).",
        epilog=SUMMARY_HELP, formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="mode", required=True)
    for mode in ("mono", "stereo"):
        sp = sub.add_parser(mode, epilog=SUMMARY_HELP,
                            formatter_class=argparse.RawDescriptionHelpFormatter)
        sp.add_argument("--params", help="reference-format *_VO_parameters.yaml")
        sp.add_argument("--intrinsics", help="reference-format intrinsics yaml")
        sp.add_argument("--camera", help="camera block name (e.g. downward_camera)")
        sp.add_argument("--frames", help="directory of JPEG frames (mono)")
        sp.add_argument("--frames-left", help="directory of left JPEG frames (stereo)")
        sp.add_argument("--frames-right", help="directory of right JPEG frames (stereo)")
        sp.add_argument("--ranges", help="text file of per-frame range readings")
        sp.add_argument("--timestamps",
                        help="text file of per-frame stamps in seconds "
                             "(message-header deltaT semantics, "
                             "visual_odometry.h:263); fabricated from "
                             "node_freq when absent")
        sp.add_argument("--timestamps-left",
                        help="per-frame stamps for --frames-left (stereo): "
                             "enables nearest-stamp pairing")
        sp.add_argument("--timestamps-right",
                        help="per-frame stamps for --frames-right (stereo)")
        sp.add_argument("--max-skew", type=float, default=None,
                        help="max |left-right| stamp skew in seconds for a "
                             "stereo pair (default: half the node period)")
        sp.add_argument("--synthetic", type=int, default=0,
                        help="run on an N-frame synthetic sequence instead")
        sp.add_argument("--synthetic-size", default="640x480",
                        help="synthetic frame size as WxH (default 640x480)")
        sp.add_argument("--out", default="run.jsonl")
        sp.add_argument("--seed", type=int, default=0,
                        help="seed of the torch.Generator that draws the minimal sets")
        sp.add_argument("--device", default=None,
                        help="torch device to run on (default: the card, "
                             "cuda; 'cpu' runs on the CPU)")
        sp.add_argument("--ba-window", type=int, default=0,
                        help="refine with sliding-window BA of this many "
                             "keyframes (0 = off)")
        sp.add_argument("--keyframe-stride", type=int, default=3)
        sp.add_argument("--ba-iters", type=int, default=12)
        sp.add_argument("--loop-closure", action="store_true",
                        help="run retrieval + pose-graph loop closure")
        sp.add_argument("--chunk-size", type=int, default=16,
                        help="streaming chunk length")
        sp.add_argument("--checkpoint",
                        help="stream-checkpoint file (.npz): progress is "
                             "persisted while the run streams")
        sp.add_argument("--checkpoint-every", type=int, default=4,
                        help="checkpoint every N chunks (default 4)")
        sp.add_argument("--resume", action="store_true",
                        help="resume a run from --checkpoint "
                             "(fresh start if the file does not exist yet)")
        sp.add_argument("--force-resume", action="store_true",
                        help="resume even if the checkpoint's digest of the "
                             "frames it covers does not match the current "
                             "frame list (otherwise refused)")
        sp.add_argument("--check-nan", action="store_true",
                        help="check every frame's outputs as it is computed "
                             "(reads each frame back; debug only) and assert "
                             "all outputs finite")
    args = p.parse_args(argv)
    if _optimizing(args) and (args.checkpoint or args.resume):
        raise SystemExit(
            "error: --ba-window and --loop-closure re-detect on every frame of "
            "the run, which a resumed stream no longer holds; run them without "
            "--checkpoint and --resume (a deliberate deviation from the JAX "
            "CLI, ROADMAP.md Queue 3)"
        )
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise RuntimeError(f"{e} (on the command line: --device cpu)") from None
    run = _run_mono if args.mode == "mono" else _run_stereo
    if args.check_nan:
        from ergo_uvo_tpu_torch.utils.debug import nan_guard

        with nan_guard():
            run(args, device)
    else:
        run(args, device)


if __name__ == "__main__":
    main()
