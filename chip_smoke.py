#!/usr/bin/env python3
"""Drive every path of the PyTorch / CUDA port (UVO, detectors, BA, dist/) once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX or of
``ergo_uvo_tpu``; every check that fails raises, so any failure exits
non-zero.  It writes only under ``build/chip_smoke/`` in the checkout.
Thirty phases, one JSON line each (two detector phases and the
preprocessed slice print side lines):

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build: nvcc builds ``ergo_uvo_tpu_torch/csrc/top2_distances.cu`` and
   ``ergo_uvo_tpu_torch/csrc/jacobi_eigh.cu`` from the checkout's sources
   into ``build/``, one nvcc a source, both started together (seconds,
   ptxas register and spill report of each, and each kernel's SASS
   instruction count where the toolkit has ``cuobjdump``);
3. kernel: the top-2 kernel against its plain PyTorch version on the card at
   the main path's shape, the contract shapes and the edge cases (empty and
   masked slices, duplicates across cluster ranks, a depth that is no
   multiple of 4), the detectors' shapes (512x512x128 floats; {0,1} bit
   rows at 512x512x256 and 512x512x512, random, with duplicate rows and with
   rows equal across cluster ranks, where the kernel must give the plain
   version's bits exactly), each also under every cluster size; then
   at 512x512x64, 2048x2048x64, 4096x4096x128 and 512x512x{128,256,512},
   every train row valid, the
   time of the kernel, of the plain version and of the nearest library route (``torch.cdist`` then
   ``torch.topk``), per call between CUDA events (median of 100 calls after
   10 warm-ups) and as device time of the call's kernels under
   torch.profiler (mean of 20 calls), beside the card's bound for the shape;
4. jacobi: the Jacobi kernel against its plain PyTorch version on the card,
   bit for bit (0 ulps, NaN where NaN), at (1, 9, 9), (512, 9, 9), P3P's
   (512, 3, 3, 3), (512, 12, 12), a batch of 0, the edge cases (random SPD, a
   diagonal matrix, signed zeros, a repeated eigenvalue, zero matrices, a
   rank-deficient 12x12, NaN and inf in 9x9 and in P3P's pencils) and batches
   that cut the kernel's lane groups, warps and blocks (1, 2, 31, 33, 257,
   513 at n = 9, 1537 at n = 3, 511 at n = 12), at 7 sweeps, and the four
   main shapes again at 0 and 1 sweeps, one launch a call, the input left as
   it was; CUDA inputs it cannot take raise; then at the four shapes the time
   of the kernel, of the plain version and of ``torch.linalg.eigh``, per call
   between CUDA events and as device time under torch.profiler, beside the
   card's bound, and the kernel's cycles a rotation at the SM clock that
   ``nvidia-smi`` reads, polled from a thread, while the kernel keeps the card
   busy (the 512x12x12 batch 64 times over);
5. slice: ``run_mono_vo`` on 24 synthetic 640x480 frames under the main
   path's config (SURF, 512 keypoints, 512 hypotheses, LMEDS), counting both
   kernels' launches (the Jacobi kernel at least once a frame and twice an
   essential frame), checking the outputs against ground truth, and timing
   frames 2..23;
6. mono_stages: frames 12 and 13 of the slice's run taken apart (one
   prefers the homography, one the essential matrix; detect + describe,
   match, the relative pose, ``find_essential``, ``find_homography``, the
   Sampson Gauss-Newton, each Jacobi solve of the relative pose through the
   kernel and the plain version, triangulate + gates), then both under
   torch.profiler (device time, launches, idle share);
7. preprocess: ``preprocess_frame`` (undistort under distortion
   [-0.05, 0.01, 0, 0], CLAHE 3.0) on the same 24 frames on the card: range,
   agreement with the same call on the CPU, ms per frame between CUDA events;
8. slice_preprocessed: ``preprocess_frame`` then ``run_mono_vo`` with the
   plan's camera, on frames seen through a lens with that distortion, with
   the slice's checks and timing (and two 12-frame side runs: undistorted
   only, and the pinhole frames under the plan, reported unchecked);
9. slice_batched: ``run_mono_vo_batched_features`` on the first 12 gray
   frames with the slice's generator seed; its outputs must equal the slice's;
10. slice_stereo: ``run_stereo_vo`` on 24 synthetic 640x480 pairs (SURF, 512
   keypoints, 512 minimal sets, P3P + PnP RANSAC): two kernel launches a
   frame and one Jacobi launch (P3P), the outputs against ground truth,
   frames 2..23 timed, then the stages of one frame timed apart and two
   frames under torch.profiler;
11. parity_mono and 12. parity_stereo: the main paths held to the JAX
   package's own outputs (``tests/fixtures/torch_parity_main.npz``, written
   on the CPU by ``tests/test_torch_parity_main.py --write``): 12 frames
   (pairs) of 640x480 regenerated and checked against the fixture's SHA-256,
   ``run_mono_vo`` / ``run_stereo_vo`` with no device argument and JAX's
   minimal sets from the fixture, each match mask the card presents equal to
   the stored one, and every frame under the repo's contract against JAX's
   eager run (published, validity, the method and the feature counts exact,
   the match, inlier and point counts within 2, velocity to 5e-3 m/s, the
   scale factor to 1e-2 relative, stereo t to 2e-3 and R to 1e-3); the line
   holds both sides' discrete fields, each float field's max |difference|,
   the frames whose counts are all exact, the frames where JAX's jitted and
   eager runs differ, and the launches (the top-2 kernel once a mono frame
   and twice a stereo frame, the Jacobi kernel at least once an estimator
   run);
13. stream_mono: ``run_mono_vo_streaming`` over the 24 frames of
   ``slice_undistorted`` (seen through the lens, its plan) from an
   ``ArraySource`` in chunks of 8: one kernel launch a frame, the outputs
   and final state equal ``preprocess_frame`` then ``run_mono_vo`` with the
   same generator seed bit for bit; then a run in chunks of 7 that
   checkpoints every chunk and dies after chunk 2 (14 frames), resumed from
   the checkpoint in chunks of 5 (10 frames): outputs and final state equal
   the uninterrupted run's bit for bit; frames/s, ms per frame (stream and
   bulk, same frames), the time of a checkpoint write;
14. stream_stereo: the same for the 24 pairs of ``slice_stereo`` under two
   plans without distortion or CLAHE: two launches a frame;
15. cli_mono and 16. cli_stereo: ``ergo_uvo_tpu_torch.cli.main`` on 24
   synthetic 640x480 frames (pairs), the main paths' configs through
   ``--params``, chunks of 8, no ``--device``: valid == published on frames
   1..23, a finite ATE, every chunk's outputs on the card when read back,
   the launches a frame, and the CLI's summary;
17. plain_jacobi: the first 12 frames of ``slice`` and of ``slice_stereo``
   through the kernel, then with ``jacobi_eigh_reference`` patched in from
   here (``linalg.jacobi_eigh``, ``p3p.jacobi_eigh``): no Jacobi launch in
   the patched runs, every output field equal bit for bit, ms per frame of
   both;
18.-20. slice_sift, slice_orb, slice_akaze: ``bench.py``'s detector configs
   (512 keypoints, 512 hypotheses) on the slice's 24 frames, ORB through
   ``run_mono_vo_batched_features``: 24 launches (D = 128, 256, 512), the
   outputs against ground truth and against the JAX package's CPU run of
   the same frames (medians over generator seeds 0-4), and one frame's
   frontend timed, profiled and run under
   ``torch.cuda.set_sync_debug_mode("error")``;
21. accuracy_sift and 22. accuracy_stereo_sift: ``bench.py::section_parity``'s
   SIFT configs and sequences (mono: 3 seeds of 24 frames of 320x240;
   stereo: 2 seeds of 16 pairs), mean velocity RMSE and ATE held to bounds
   set from the port's own CPU run, beside the JAX package's figures;
23. cli_mono_sift: the CLI as in 15 with ``feature_detector: SIFT``;
24. ba: ``bench.py::section_ba``'s window BA problem (8 poses, 512
   landmarks, 2 fixed poses) through ``ba_solve``: 30 LM iterations under
   ``torch.cuda.set_sync_debug_mode("error")``, the final cost against the
   starting one, the fixed poses, the card's result against the port's CPU
   run of the same arrays; LM iterations/s by the iteration-count slope
   (30 and 330), launches an iteration and the device-idle share under
   torch.profiler;
25. trajectory_ba: ``tests/test_trajectory.py``'s fixture (36 frames of
   320x240, the starved VO config) through ``run_mono_vo`` then
   ``refine_mono_trajectory`` (window 6, stride 2, 12 iterations): its
   gates (ATE below 0.7x the raw one, non-increasing cost curves), the
   kernel's launches (one a window member but the anchor) and
   ``ba_iters_per_s``;
26. loop_closure: ``close_loops_and_optimize`` on ``make_loop_sequence(20,
   240, 320, seed=2)`` with the test's drift: a loop with j - i >= 12
   accepted, the endpoint error shrunk 5x, the candidates verified; the
   pose graph of its loops run twice on the card and once on the CPU,
   within 1e-3 m (its scatter-adds are atomic on the card);
27. cli_mono_opt and 28. cli_stereo_opt: the CLI as in 15 and 16 with
   ``--ba-window 6 --keyframe-stride 3 --ba-iters 12 --loop-closure``: the
   summary's ``ba_keyframes``, ``ba_solves``, ``ba_iters_per_s`` and
   ``loops_accepted``, and the launches beyond the VO's;
29. dist_ba: a world of 1 on NCCL (one card; the cross-rank arithmetic is
   held by the CPU tests on gloo worlds of 2 and 4):
   ``tools/bench_scaling_2proc.py``'s problem (8 poses, 16,384 landmarks, 2
   fixed poses, 30 LM iterations) through ``sharded_ba_solve`` on a 1-D mesh
   and ``window_sharded_ba_solve`` on a (1, 1) mesh, each against
   ``ba_solve`` on the same card arrays (costs to 1e-4 relative an
   iteration, state to 2e-3) under ``torch.cuda.set_sync_debug_mode("error")``,
   two ``dist.all_reduce`` calls an iteration counted; LM iterations/s by the
   iteration-count slope (30 and 330), launches an iteration and the
   device-idle share of each solver, and the time of one NCCL
   ``all_reduce`` of the packed buffer; the group is destroyed at the end;
30. dist_vo: a world of 1 on NCCL: ``run_mono_vo_batch`` under the main
   path's config on 4 streams of 12 frames of 640x480
   (``make_mono_sequence`` seeds 1-4) fed by ``shard_frame_batches``: 48
   kernel launches, each stream equal to ``run_mono_vo`` with generator seed
   ``seed + b`` bit for bit, each stream's validity and the velocity RMSE
   over all streams held to the slice's bounds (each stream's RMSE
   reported), frames/s.

Then the card's ``nvidia-smi`` line again, the kernel summary line (both
kernels' launches on every path) and, last, ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK_DIR = ROOT / "build" / "chip_smoke"  # checkpoints and CLI outputs (git-ignored)
KERNEL_SOURCE = "ergo_uvo_tpu_torch/csrc/top2_distances.cu"
KERNEL_REPLACES = "ergo_uvo_tpu/features/pallas_matcher.py:83"
N_FRAMES = 24
N_BATCHED = 12  # frames of the batched-features phase and of the side runs
LENS_DISTORTION = [-0.05, 0.01, 0.0, 0.0]  # (k1, k2, p1, p2) of the main path's plan


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


# Each path's launches of the Jacobi kernel, by the path's phase name; the
# top-2 kernel's come back from the phases themselves.
JACOBI_BY_PATH: dict[str, int] = {}


def _zero_counts() -> None:
    """Set every kernel's launch count to 0, just before a path is driven."""
    from ergo_uvo_tpu_torch.utils.profiling import COUNTERS

    COUNTERS["top2_distances.launches"] = 0
    COUNTERS["jacobi_eigh.launches"] = 0


def _read_counts(path: str) -> int:
    """Read every count just after the path ran: the Jacobi kernel's goes to
    ``JACOBI_BY_PATH[path]``, the top-2 kernel's is returned."""
    from ergo_uvo_tpu_torch.utils.profiling import COUNTERS

    JACOBI_BY_PATH[path] = COUNTERS["jacobi_eigh.launches"]
    return COUNTERS["top2_distances.launches"]


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return smi


def phase_build():
    """Build every kernel from the checkout's sources, one nvcc a source, all
    started together."""
    from concurrent.futures import ThreadPoolExecutor

    from ergo_uvo_tpu_torch.cuda_build import BUILD_INFO, load_library

    stems = ("top2_distances", "jacobi_eigh")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(stems)) as pool:
        list(pool.map(load_library, stems))
    seconds = time.perf_counter() - t0
    kernels = {}
    for stem in stems:
        nvcc_seconds, log = BUILD_INFO[stem]
        kernels[stem] = {"nvcc_seconds": nvcc_seconds, "ptxas": [
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line],
            "sass_instructions": _sass_counts(load_library(stem)._name)}
    emit({"phase": "build", "seconds": seconds, "kernels": kernels})


def _sass_counts(library):
    """{kernel: SASS instructions} in a built library, from ``cuobjdump
    -sass``; None where the toolkit has no cuobjdump."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        return None
    sass = subprocess.run([tool, "-sass", library], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if m := re.match(r"\s*Function : (\S+)", line):
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[name] += 1
    return counts


def _unit(torch, n, d, seed, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(n, d, generator=g)
    return (x / x.norm(dim=-1, keepdim=True)).to(dev)


def _bits(torch, n, d, seed, dev):
    """{0,1} float rows, as ORB (256) and AKAZE (512) descriptors are."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(0, 2, (n, d), generator=g).to(torch.float32).to(dev)


def _event_ms(torch, fn):
    """(ms between two CUDA events around ``fn()``, its result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _time_ms(torch, fn, warmup=10, runs=100):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return statistics.median(_event_ms(torch, fn)[0] for _ in range(runs))


def _device_ms(torch, fn, runs=20):
    """Device time per call: the kernels' device time under torch.profiler.

    At these sizes a call's event-timed span is set by the host's launch
    path (checks, allocation, enqueue); this is the time the card itself
    spent in the call's kernels.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back with no device event at all
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        # Each kernel's mean time, times its launches per call: a trace that
        # lost some of a kernel's events still gives that kernel's share.
        us = sum(e.self_device_time_total / e.count * max(1, round(e.count / runs))
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation and e.count > 0)
        if us > 0:
            return us / 1e3
    check(False, "torch.profiler recorded no device time in three traces")


# An H100 SXM's published peaks: fp32 FMA outside the tensor cores, device memory.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TIMED_SHAPES = [(512, 512, 64), (2048, 2048, 64), (4096, 4096, 128)]
# The alternate detectors' shapes: SIFT floats, ORB and AKAZE bits.
DETECTOR_SHAPES = [(512, 512, 128), (512, 512, 256), (512, 512, 512)]
BINARY_DEPTHS = (256, 512)
MAIN_SHAPE = "512x512x64"


def _bound(q, t, d, valid):
    """The least time the card could take for these inputs: 2 Q V D fp32
    operations over the V valid train rows (a masked row is skipped, not
    scored), and every needed input byte read once (the queries, the valid
    train rows, the mask) and every output byte written once."""
    ops_ms = 1e3 * 2.0 * q * valid * d / PEAK_FP32_FLOPS
    bytes_ms = 1e3 * (4.0 * (q + valid) * d + t + 12.0 * q) / PEAK_BYTES_PER_S
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_operations_ms": ops_ms, "bound_bytes_ms": bytes_ms}


def _compare(torch, name, got, ref):
    """The kernel's (min1, idx1, min2) against the plain version's: the +inf
    pattern equal, idx exact except where the best and second-best tie
    within 1e-5 (fp32 sums in another order), distances within 1e-3 (squared
    distances of unit vectors lie in [0, 4])."""
    (k1, ki, k2), (r1, ri, r2) = got, ref
    tie = (r2 - r1).abs() <= 1e-5 * torch.clamp(r1.abs(), min=1.0)
    check(bool(((ki == ri) | tie).all()), f"{name}: idx1 differs from the plain version off ties")
    err = 0.0
    for k, r in ((k1, r1), (k2, r2)):
        check(torch.equal(torch.isinf(k), torch.isinf(r)), f"{name}: +inf pattern differs")
        fin = torch.isfinite(r)
        if bool(fin.any()):
            err = max(err, float((k[fin] - r[fin]).abs().max()))
    check(err <= 1e-3, f"{name}: distance error {err} > 1e-3")
    return err


def phase_kernel(torch):
    from ergo_uvo_tpu_torch.features import top2_matcher

    dev = torch.device("cuda")
    cases = []
    shapes = TIMED_SHAPES + [(37, 91, 64), (384, 200, 64), (8, 3, 128), (256, 512, 48),
                             (33, 130, 50), (5, 7, 64), (1, 512, 64),
                             # too deep for a resident query tile: it rides the ring
                             (40, 70, 576), (9, 20, 515)]
    for q, t, d in shapes + DETECTOR_SHAPES[:1]:
        mt = torch.ones(t, dtype=torch.bool, device=dev)
        mt[::5] = False  # every 5th column masked
        cases.append((f"{q}x{t}x{d}", _unit(torch, q, d, q, dev), _unit(torch, t, d, t + 1, dev), mt))
    # Bit rows (ORB, AKAZE): Hamming distances are integers that fp32 holds
    # exactly, with ties everywhere, so the kernel must give the plain
    # version's bits.  Random rows with every 5th column masked; duplicate
    # rows; and one query row equal to train rows in two cluster ranks' slices.
    exact = set()
    for d in BINARY_DEPTHS:
        bq, bt = _bits(torch, 512, d, d, dev), _bits(torch, 512, d, d + 1, dev)
        mt = torch.ones(512, dtype=torch.bool, device=dev)
        mt[::5] = False
        across = bt.clone()
        across[70] = bq[5]
        across[400] = bq[5]
        ones = torch.ones(512, dtype=torch.bool, device=dev)
        for name, q, t, m in ((f"bits_512x512x{d}", bq, bt, mt),
                              (f"bits_512x512x{d}_duplicate_rows", bq, torch.cat([bq[:256], bq[:256]]), ones),
                              (f"bits_512x512x{d}_equal_across_ranks", bq, across, ones)):
            cases.append((name, q, t, m))
            exact.add(name)
    # The timed shapes once more with every train row valid: these are the
    # inputs that are timed, so that the kernel's work is the bound's work.
    timed = []
    for q, t, d in TIMED_SHAPES + DETECTOR_SHAPES:
        make = _bits if d in BINARY_DEPTHS else _unit
        timed.append((f"{q}x{t}x{d}", make(torch, q, d, q, dev), make(torch, t, d, t + 1, dev),
                      torch.ones(t, dtype=torch.bool, device=dev)))
    cases += [(name + "_all_valid", q, t, m) for name, q, t, m in timed]
    exact |= {f"512x512x{d}_all_valid" for d in BINARY_DEPTHS}
    dq = _unit(torch, 512, 64, 7, dev)
    dt = _unit(torch, 512, 64, 8, dev)
    ones = torch.ones(512, dtype=torch.bool, device=dev)
    cases.append(("all_masked", dq, dt, torch.zeros(512, dtype=torch.bool, device=dev)))
    cases.append(("T=0", dq, dt[:0].contiguous(), ones[:0].contiguous()))
    cases.append(("T=1", dq, dt[:1].contiguous(), ones[:1].contiguous()))
    cases.append(("duplicate_rows", dq, torch.cat([dq[:256], dq[:256]]), ones))
    # At 512 columns the train set is cut into 8 slices of 64, one per
    # cluster rank.  The only valid column in the last rank's slice:
    last_only = torch.zeros(512, dtype=torch.bool, device=dev)
    last_only[500] = True
    cases.append(("only_last_rank_valid", dq, dt, last_only))
    # One train row, equal to query row 5, in rank 1's slice and in rank 6's.
    dup = dt.clone()
    dup[70] = dq[5]
    dup[400] = dq[5]
    cases.append(("duplicate_across_ranks", dq, dup, ones))

    max_err = 0.0
    results = []
    cluster_sizes = (1, 2, 4, 8)
    for name, q, t, m in cases:
        got = top2_matcher.top2_distances(q, t, m)
        ref = top2_matcher.top2_distances_reference(q, t, m)
        torch.cuda.synchronize()
        if name in exact:
            check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                  f"{name}: the kernel's outputs on bit rows are not the plain version's bit for bit")
        err = _compare(torch, name, got, ref)
        # Every cluster size gives the same bits, those of the size the shape picks.
        for splits in cluster_sizes:
            out = top2_matcher.launch_forced(q, t, m, splits)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(out, got)),
                  f"{name}: result changes with cluster size {splits}")
        if name == "only_last_rank_valid":
            check(bool((got[1] == 500).all()) and bool(torch.isinf(got[2]).all()),
                  f"{name}: expected idx1 500 and min2 +inf on every row")
        if name == "duplicate_rows":
            check(torch.equal(got[1][:256].cpu(), torch.arange(256, dtype=torch.int32))
                  and torch.equal(got[0][:256], got[2][:256]),
                  f"{name}: the lower of two equal rows must win with min2 == min1")
        if name.startswith("bits_") and name.endswith("_duplicate_rows"):
            check(torch.equal(got[1][:256].cpu(), torch.arange(256, dtype=torch.int32))
                  and torch.equal(got[0][:256], got[2][:256]) and bool((got[0][:256] == 0).all()),
                  f"{name}: the lower of two equal rows must win at distance 0 with min2 == min1")
        if name.startswith("bits_") and name.endswith("_equal_across_ranks"):
            check(int(got[1][5]) == 70 and float(got[0][5]) == 0.0 == float(got[2][5]),
                  f"{name}: row 5 gave idx1 {int(got[1][5])}, expected 70 at distance 0 twice")
        if name == "duplicate_across_ranks":
            check(int(got[1][5]) == 70 and float(got[0][5]) == float(got[2][5]),
                  f"{name}: row 5 gave idx1 {int(got[1][5])}, min1 {float(got[0][5])}, "
                  f"min2 {float(got[2][5])}; expected 70 and min2 == min1")
        max_err = max(max_err, err)
        results.append({"case": name, "max_abs_err": err})

    def library(q, t):
        # The nearest library route (two calls, the mask left out); the port never calls it.
        return torch.topk(torch.cdist(q, t), k=2, dim=1, largest=False)

    timings = {}
    for (name, q, t, m), (nq, nt, nd) in zip(timed, TIMED_SHAPES + DETECTOR_SHAPES):
        kernel = lambda: top2_matcher.top2_distances(q, t, m)  # noqa: E731
        plain = lambda: top2_matcher.top2_distances_reference(q, t, m)  # noqa: E731
        lib = lambda: library(q, t)  # noqa: E731
        plan = top2_matcher.launch_plan(nq, nt, nd)
        row = {"shape": name, "valid_train_rows": int(m.sum()), "cluster": plan["cluster"],
               "blocks": plan["blocks"], "smem_bytes": plan["smem_bytes"],
               "ms": _time_ms(torch, kernel), "device_ms": _device_ms(torch, kernel),
               "plain_ms": _time_ms(torch, plain), "plain_device_ms": _device_ms(torch, plain),
               "library": "cdist+topk",
               "library_ms": _time_ms(torch, lib), "library_device_ms": _device_ms(torch, lib)}
        row.update(_bound(nq, nt, nd, int(m.sum())))
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        # Device time under every cluster size at the three contract shapes.
        if (nq, nt, nd) in TIMED_SHAPES:
            row["cluster_device_ms"] = {
                str(s): _device_ms(torch, lambda s=s: top2_matcher.launch_forced(q, t, m, s), runs=10)
                for s in cluster_sizes}
        timings[name] = row
    main = timings[MAIN_SHAPE]
    check(main["device_ms"] < main["plain_device_ms"],
          f"kernel device time {main['device_ms']} ms is not below the plain version's "
          f"{main['plain_device_ms']} ms at {MAIN_SHAPE}")
    emit({"phase": "kernel", "cases": results, "max_abs_err": max_err,
          "bit_exact_cases": sorted(exact), "timings": list(timings.values())})
    return max_err, timings


JACOBI_SOURCE = "ergo_uvo_tpu_torch/csrc/jacobi_eigh.cu"
JACOBI_REPLACES = "ergo_uvo_tpu/geometry/linalg.py:21"
JACOBI_SWEEPS = 7
# (name, n) of the timed inputs: a refit, the 8-point solve of 512
# hypotheses, P3P's (512, 3, 3, 3) pencils, 512 DLT normal matrices.
JACOBI_TIMED = [("1x9x9", 9), ("512x9x9", 9), ("1536x3x3", 3), ("512x12x12", 12)]
JACOBI_MAIN = "512x9x9"
JACOBI_EDGE_BATCHES = {9: (1, 2, 31, 33, 257, 513), 3: (1537,), 12: (511,)}
JACOBI_FEW_SWEEPS = (0, 1)  # the timed shapes again, where order errors cannot hide in convergence
JACOBI_LOAD = 64  # the clock's load: the 512x12x12 DLT batch 64 times over, ~1 ms a call


def _sm_clock_under_load(torch, load):
    """(SM clock MHz, utilization %): the medians of what ``nvidia-smi``
    reads, polled from a thread, for 2 s of ``load()``'s calls, 20 of them
    queued between syncs so that the card stays busy."""
    import threading

    readings, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,utilization.gpu", "--format=csv,noheader,nounits"],
                capture_output=True, text=True, check=True, timeout=60).stdout
            if not stop.is_set():
                readings.append([float(x) for x in out.splitlines()[0].split(",")])

    load()
    torch.cuda.synchronize()
    poller = threading.Thread(target=poll)
    t0 = time.perf_counter()
    poller.start()
    while time.perf_counter() - t0 < 2.0 or (len(readings) < 3 and poller.is_alive()):
        for _ in range(20):
            load()
        torch.cuda.synchronize()
    stop.set()
    poller.join()
    check(len(readings) >= 3, f"jacobi: nvidia-smi gave {len(readings)} clock readings under load")
    return (statistics.median(r[0] for r in readings), statistics.median(r[1] for r in readings))


def _jacobi_bound(batch, n, sweeps=JACOBI_SWEEPS):
    """The least time the card could take: per rotation 18 n + 15 fp32
    operations (the rows, the columns and V: 6 n each; the rotation's
    scalars: 15), n (n - 1) / 2 rotations a sweep; each matrix read once,
    n eigenvalues and n^2 eigenvector entries written once."""
    ops = batch * sweeps * n * (n - 1) // 2 * (18 * n + 15)
    ops_ms = 1e3 * ops / PEAK_FP32_FLOPS
    bytes_ms = 1e3 * 4.0 * batch * (2 * n * n + n) / PEAK_BYTES_PER_S
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_operations_ms": ops_ms, "bound_bytes_ms": bytes_ms, "operations": ops}


def _jacobi_inputs(torch, dev):
    """name -> float32 (..., n, n) on the card: the timed inputs (the paths'
    kinds of matrix), then the edge cases."""
    g = torch.Generator(device="cpu").manual_seed(11)

    def normal(*shape):
        return torch.randn(*shape, generator=g)

    def gram(b, rows, n):  # B^T B of `rows` constraint rows: rank min(rows, n)
        B = normal(b, rows, n)
        return B.transpose(-1, -2) @ B

    def pencil(*lead):  # symmetric indefinite, as D1 + root * D2
        M = normal(*lead, 3, 3)
        return M + M.transpose(-1, -2)

    def spectrum(w):  # Q diag(w) Q^T
        Q, _ = torch.linalg.qr(normal(len(w), len(w)).double())
        return ((Q * torch.tensor(w, dtype=torch.float64)) @ Q.T)[None].float()

    cases = {"1x9x9": gram(1, 200, 9), "512x9x9": gram(512, 8, 9), "1536x3x3": pencil(512, 3),
             "512x12x12": gram(512, 12, 12)}
    cases["0x9x9"] = torch.zeros(0, 9, 9)
    cases["spd_9"] = (lambda M: M @ M.transpose(-1, -2) + torch.eye(9))(normal(16, 9, 9))
    cases["diagonal_9"] = torch.diag(torch.tensor([3.0, -1.0, 7.0, 0.5, 2.0, -4.0, 1.5, 9.0, 0.25]))[None]
    cases["signed_zeros_9"] = torch.diag(torch.tensor([2.0, -0.0, 0.0, -1.0, -0.0, 3.0, 0.0, 1.0, -2.0]))[None]
    cases["repeated_9"] = spectrum([1.0, 1.0, 1.0, 2.0, 3.0, 3.0, 5.0, 8.0, 13.0])
    cases["zero_3"] = torch.zeros(2, 3, 3)
    cases["rank_deficient_12"] = gram(8, 11, 12)
    nan9 = gram(4, 20, 9)
    nan9[1, 2, 5] = nan9[1, 5, 2] = float("nan")
    nan9[2, 4, 4] = float("nan")
    nan9[3, 0, 0] = float("inf")
    cases["nan_inf_9"] = nan9
    p3p = pencil(6, 3)
    p3p[1, 2] = float("nan")  # a NaN root: its whole pencil is NaN
    p3p[3, 0, 1, 2] = p3p[3, 0, 2, 1] = float("inf")
    p3p[4, 1, 1, 1] = -float("inf")
    cases["nan_inf_6x3x3x3"] = p3p
    # Batches that cut a group of lanes, a warp and a block of the kernel.
    for batch in JACOBI_EDGE_BATCHES[9]:
        cases[f"batch_{batch}x9x9"] = gram(batch, 8, 9)
    for n in (3, 12):
        for batch in JACOBI_EDGE_BATCHES[n]:
            cases[f"batch_{batch}x{n}x{n}"] = pencil(batch) if n == 3 else gram(batch, n, n)
    return {k: v.contiguous().to(dev) for k, v in cases.items()}


def _ordered(torch, x):
    """float32 bits as integers in the order of the values (-0 just below +0)."""
    i = x.contiguous().view(torch.int32).long()
    return torch.where(i < 0, -(i & 0x7FFFFFFF) - 1, i)


def _bit_compare(torch, got, ref):
    """(bit equal with NaN where NaN, largest difference in ulps and in value
    over the entries finite in both)."""
    nan_same = torch.equal(torch.isnan(got), torch.isnan(ref))
    fin = torch.isfinite(got) & torch.isfinite(ref)
    ulps = int((_ordered(torch, got) - _ordered(torch, ref))[fin].abs().max()) if bool(fin.any()) else 0
    err = float((got - ref)[fin].abs().max()) if bool(fin.any()) else 0.0
    other = ~torch.isnan(got)
    bits = nan_same and torch.equal(got.view(torch.int32)[other], ref.view(torch.int32)[other])
    return bits, ulps, err


def phase_jacobi(torch):
    """The Jacobi kernel against its plain version on the card, then timed."""
    from ergo_uvo_tpu_torch.geometry import linalg
    from ergo_uvo_tpu_torch.utils.profiling import COUNTERS

    dev = torch.device("cuda")
    cases = _jacobi_inputs(torch, dev)
    runs = [(name, A, JACOBI_SWEEPS) for name, A in cases.items()]
    runs += [(name, cases[name], sweeps) for sweeps in JACOBI_FEW_SWEEPS for name, _ in JACOBI_TIMED]
    results, max_err, max_ulps = [], 0.0, 0
    for name, A, sweeps in runs:
        keep = A.clone()
        before = COUNTERS["jacobi_eigh.launches"]
        w, v = linalg.jacobi_eigh(A, sweeps)
        launched = COUNTERS["jacobi_eigh.launches"] - before
        rw, rv = linalg.jacobi_eigh_reference(A, sweeps)
        torch.cuda.synchronize()
        (wb, wu, we), (vb, vu, ve) = _bit_compare(torch, w, rw), _bit_compare(torch, v, rv)
        max_err, max_ulps = max(max_err, we, ve), max(max_ulps, wu, vu)
        results.append({"case": name, "sweeps": sweeps, "shape": list(A.shape), "launches": launched,
                        "bit_equal": wb and vb, "max_ulps": max(wu, vu), "max_abs_err": max(we, ve),
                        "input_kept": _bit_compare(torch, A, keep)[0]})
    line = {"phase": "jacobi", "sweeps": JACOBI_SWEEPS, "cases": results,
            "max_abs_err": max_err, "max_ulps": max_ulps}
    for r in results:
        check(r["bit_equal"] and r["max_ulps"] == 0,
              f"jacobi: {r['case']} at {r['sweeps']} sweeps: the kernel differs from the plain "
              f"version by {r['max_ulps']} ulps ({r['max_abs_err']})")
        check(r["input_kept"], f"jacobi: {r['case']}: the input was written")
        check(r["launches"] == (0 if r["shape"][0] == 0 else 1),
              f"jacobi: {r['case']}: {r['launches']} launches")
    for bad in (torch.zeros(2, 4, 4, device=dev), torch.zeros(2, 9, 9, device=dev, dtype=torch.float64)):
        try:
            linalg.jacobi_eigh(bad)
        except (TypeError, ValueError):
            continue
        check(False, f"jacobi: a CUDA input of shape {tuple(bad.shape)}, {bad.dtype} did not raise")

    load = cases["512x12x12"].repeat(JACOBI_LOAD, 1, 1)
    mhz, util = _sm_clock_under_load(torch, lambda: linalg.jacobi_eigh(load))
    line.update(sm_mhz_under_load=mhz, utilization_under_load=util, load_shape=list(load.shape))
    timings = {}
    for name, n in JACOBI_TIMED:
        A = cases[name]
        kernel = lambda: linalg.jacobi_eigh(A)  # noqa: E731
        plain = lambda: linalg.jacobi_eigh_reference(A)  # noqa: E731
        lib = lambda: torch.linalg.eigh(A)  # noqa: E731
        batch = A.numel() // (n * n)
        row = {"shape": name, "batch": batch, "n": n,
               "ms": _time_ms(torch, kernel), "device_ms": _device_ms(torch, kernel),
               # ~50 launches a rotation: a few calls suffice
               "plain_ms": _time_ms(torch, plain, warmup=1, runs=3),
               "plain_device_ms": _device_ms(torch, plain, runs=1),
               "library": "torch.linalg.eigh",
               "library_ms": _time_ms(torch, lib), "library_device_ms": _device_ms(torch, lib)}
        row.update(_jacobi_bound(batch, n))
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        row["cycles_per_rotation"] = row["device_ms"] * 1e3 * mhz / (JACOBI_SWEEPS * n * (n - 1) // 2)
        timings[name] = row
    line["timings"] = list(timings.values())
    emit(line)
    main = timings[JACOBI_MAIN]
    check(main["device_ms"] < main["plain_device_ms"],
          f"jacobi: kernel device time {main['device_ms']} ms is not below the plain version's "
          f"{main['plain_device_ms']} ms at {JACOBI_MAIN}")
    return max_err, timings


def _main_path_config():
    from ergo_uvo_tpu_torch.config import MonoVOConfig, SurfConfig

    return MonoVOConfig(surf=SurfConfig(min_hessian=60.0), max_keypoints=512, num_hypotheses=512)


def _mono_sequence():
    from ergo_uvo_tpu_torch.io import make_mono_sequence

    return make_mono_sequence(n_frames=N_FRAMES, height=480, width=640, dt=0.05, seed=1)


def _velocity_check(np, outs, gt, bound=0.35):
    """Velocity RMSE over the valid frames against ``bound`` x the mean
    ground-truth speed (0.35: tests/test_pipeline.py:115); ``bound=None``
    reports without checking."""
    val = outs["validity"]
    err = outs["velocity"][val].astype(np.float64) - gt[val]
    rmse = float(np.sqrt((err**2).sum(-1).mean()))
    speed = float(np.linalg.norm(gt[1:], axis=-1).mean())
    if bound is not None:
        check(rmse < bound * speed, f"velocity RMSE {rmse} >= {bound} * mean speed {speed}")
    return rmse, speed


def _mono_phase(torch, phase, runner, imgs, K, seq, n_frames, extra=None, rmse_bound=0.35,
                cfg=None, valid_min=0.7):
    """Drive a mono runner over ``n_frames`` frames, check its outputs against
    ground truth and emit the phase's line; returns (launches, outputs).

    ``cfg`` defaults to the main path's; the checks are validity on at least
    ``valid_min`` of frames 1.. and velocity RMSE under ``rmse_bound`` x the
    mean speed.

    Frames 0-1 (initialization and the first steady frame) untimed, then
    frames 2..n-1 timed; the state and the generator carry over.  The head
    call names no device: the entry point runs on the card by default.  The
    timed call's inputs lie on the card before the clock starts, so the span
    holds no copy from the host.
    """
    import numpy as np

    dev = torch.device("cuda")
    cfg = cfg or _main_path_config()
    ts, rg = seq.timestamps, seq.ranges
    gen = torch.Generator(device=dev).manual_seed(0)

    _zero_counts()
    state, head = runner(imgs[:2], ts[:2], rg[:2], K, cfg, gen)
    rest = [torch.as_tensor(x[2:n_frames]).to(dev) for x in (imgs, ts, rg)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, tail = runner(*rest, K, cfg, gen, state=state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read_counts(phase)

    outs = {f: np.concatenate([getattr(head, f).cpu().numpy(), getattr(tail, f).cpu().numpy()])
            for f in head._fields}
    check(launches >= n_frames - 1, f"kernel launched {launches} times in {n_frames} frames")
    # A frame solves once a branch it runs: the essential branch twice (the
    # 8-point solve, its refit), the homography branch once.
    jacobi = JACOBI_BY_PATH[phase]
    n_essential = int(outs["used_essential"].sum())
    check(jacobi >= n_frames - 1 + n_essential,
          f"{phase}: the Jacobi kernel launched {jacobi} times in {n_frames} frames, "
          f"{n_essential} of them essential")
    check(all(x.is_cuda for x in tail), f"{phase}: the runner's outputs are not on the card")
    for f in ("velocity", "R", "t", "scale_factor", "median_disparity"):
        check(bool(np.isfinite(outs[f]).all()), f"{f} has non-finite values")
    check(outs["velocity"].shape == (n_frames, 3), f"velocity shape {outs['velocity'].shape}")
    pub, val = outs["published"], outs["validity"]
    check(not pub[0] and bool(pub[1:].all()), f"published {pub.tolist()}")
    valid_share = float(val[1:].mean())
    rmse, speed = _velocity_check(np, outs, seq.velocities_prevcam[:n_frames], None)
    timed = n_frames - 2
    emit({"phase": phase, "frames": n_frames, "height": 480, "width": 640,
          "max_keypoints": 512, "num_hypotheses": cfg.num_hypotheses, "kernel_launches": launches,
          "jacobi_launches": jacobi,
          "rmse_bound_x_speed": rmse_bound, "valid_min": valid_min,
          "launches_per_frame": launches / n_frames,
          "frames_per_second": timed / seconds, "ms_per_frame": 1e3 * seconds / timed,
          "velocity_rmse": rmse, "mean_gt_speed": speed, "valid_share": valid_share,
          "published": pub.astype(int).tolist(), "validity": val.astype(int).tolist(),
          "used_essential": outs["used_essential"].astype(int).tolist(),
          "num_features": outs["num_features"].tolist(),
          "num_matches": outs["num_matches"].tolist(),
          "num_inliers": outs["num_inliers"].tolist(),
          "num_3d_points": outs["num_3d_points"].tolist(), **(extra or {})})
    # Accuracy checked after the line is out, so that a miss shows its numbers.
    check(valid_share >= valid_min, f"{phase}: validity on {valid_share:.2f} of frames < {valid_min}")
    _velocity_check(np, outs, seq.velocities_prevcam[:n_frames], rmse_bound)
    return launches, outs


def phase_slice(torch, seq):
    from ergo_uvo_tpu_torch.pipeline import run_mono_vo

    return _mono_phase(torch, "slice", run_mono_vo, seq.imgs_left, seq.K, seq, N_FRAMES)


def phase_preprocess(torch, seq):
    """The main path's plan (the JAX package's benchmark: distortion
    [-0.05, 0.01, 0, 0], the config's width 640, CLAHE on, clip 3.0) on the
    24 frames, frame by frame on the card; returns (plan, frames)."""
    import numpy as np

    from ergo_uvo_tpu_torch.image import build_preprocess_plan, preprocess_frame, remap_bilinear
    from ergo_uvo_tpu_torch.image.clahe import clahe

    dev = torch.device("cuda")
    pre = _main_path_config().preprocessing
    dist = np.array(LENS_DISTORTION)
    plan = build_preprocess_plan(seq.K.astype(np.float64), dist, 640, 480, pre.desired_width,
                                 clahe_enabled=pre.clahe, clip_limit=pre.clip_limit)
    check(plan.grid.is_cuda and plan.new_K.is_cuda, "the plan's tensors are not on the card")
    check((plan.new_h, plan.new_w) == (480, 640), f"plan size {(plan.new_h, plan.new_w)}")
    raw = torch.as_tensor(seq.imgs_left).to(dev)
    # All frames in one call (the second call is timed: the first one's
    # buffers are new to the allocator), then frame by frame with the
    # results dropped, as a frame loop drops them.
    frames = preprocess_frame(plan, raw)
    batch_ms, again = _event_ms(torch, lambda: preprocess_frame(plan, raw))
    check(torch.equal(again, frames), "preprocess_frame is not deterministic on the card")
    del again
    for i in range(5):  # warm-up
        check(torch.equal(preprocess_frame(plan, raw[i]), frames[i]),
              "a batch of frames differs from its frames one by one")
    torch.cuda.synchronize()

    def median_ms(fn):
        return statistics.median(_event_ms(torch, lambda i=i: fn(i))[0] for i in range(N_FRAMES))

    frame_ms = median_ms(lambda i: preprocess_frame(plan, raw[i]))
    remap_ms = median_ms(lambda i: remap_bilinear(raw[i], plan.grid, plan.disp))
    clahe_ms = median_ms(lambda i: clahe(frames[i], clip_limit=plan.clip_limit))

    check(frames.shape == (N_FRAMES, 480, 640) and frames.dtype == torch.float32,
          f"preprocessed frames {tuple(frames.shape)} {frames.dtype}")
    check(bool(torch.isfinite(frames).all()), "preprocessed frames are not finite")
    lo, hi = float(frames.min()), float(frames.max())
    check(lo >= 0.0 and hi <= 255.0, f"preprocessed range [{lo}, {hi}]")
    cpu_plan = build_preprocess_plan(seq.K.astype(np.float64), dist, 640, 480, pre.desired_width,
                                     clahe_enabled=pre.clahe, clip_limit=pre.clip_limit,
                                     device="cpu")
    on_cpu = preprocess_frame(cpu_plan, torch.as_tensor(seq.imgs_left[5]))
    cpu_err = float((frames[5].cpu() - on_cpu).abs().max())
    check(cpu_err <= 1e-3, f"frame 5 on the card differs from the CPU by {cpu_err} gray levels")
    emit({"phase": "preprocess", "frames": N_FRAMES, "height": 480, "width": 640,
          "max_shift": plan.max_shift, "clahe": plan.clahe_enabled, "clip_limit": plan.clip_limit,
          "ms_per_frame": frame_ms, "remap_ms": remap_ms, "clahe_ms": clahe_ms,
          "batch_of_24_ms": batch_ms,
          "min": lo, "max": hi, "mean": float(frames.mean()), "std": float(frames.std()),
          "raw_std": float(raw.std()), "max_abs_err_vs_cpu": cpu_err})
    return plan, frames


def _through_the_lens(torch, dist):
    """The mono sequence as a camera with lens distortion ``dist`` sees it.

    The renderer is a pinhole.  Its frames, rendered 16 px wider on every
    side, are resampled at the pinhole position of every pixel of a 640x480
    distorted image (the inverse of the distortion by fixed-point iteration,
    as ``cv::undistortPoints``), so that undistorting them is geometrically
    true and the sequence's ground truth holds for the result.  Returns
    (sequence, (T, 480, 640) frames on the card, the distorted camera's K).
    """
    import numpy as np

    from ergo_uvo_tpu_torch.image import remap_bilinear
    from ergo_uvo_tpu_torch.image.undistort import _undistort_points_np
    from ergo_uvo_tpu_torch.io import make_mono_sequence

    dev = torch.device("cuda")
    m = 16
    seq = make_mono_sequence(n_frames=N_FRAMES, height=480 + 2 * m, width=640 + 2 * m,
                             dt=0.05, seed=1)
    K_pinhole = seq.K.astype(np.float64)
    K_lens = K_pinhole.copy()
    K_lens[:2, 2] -= m
    ys, xs = np.mgrid[0:480, 0:640].astype(np.float64)
    xn = _undistort_points_np(np.stack([xs.ravel(), ys.ravel()], -1), K_lens, dist)
    grid = np.stack([xn[:, 0] * K_pinhole[0, 0] + K_pinhole[0, 2],
                     xn[:, 1] * K_pinhole[1, 1] + K_pinhole[1, 2]], -1).reshape(480, 640, 2)
    check(grid.min() >= 0 and grid[..., 0].max() <= 640 + 2 * m - 1
          and grid[..., 1].max() <= 480 + 2 * m - 1, "the lens sees beyond the rendered frame")
    frames = remap_bilinear(torch.as_tensor(seq.imgs_left).to(dev),
                            torch.as_tensor(grid.astype(np.float32)).to(dev))
    return seq, frames, K_lens


def phase_slice_preprocessed(torch, seq, plan, frames):
    """The mono path as the JAX package's benchmark runs it: ``preprocess_frame``
    then ``run_mono_vo`` with the plan's camera.

    The benchmark undistorts the renderer's pinhole frames under a distortion
    they do not have, which bends them by up to 4 px, as much as the parallax
    between two frames: that run is reported (12 frames) and its accuracy is
    not checked.  The checked runs take the frames through that lens first
    (:func:`_through_the_lens`): undistorted only (12 frames), held to the
    slice's 0.35 x mean speed, and the whole path with CLAHE at clip 3.0 (24
    frames, the timed one), held to 0.5 x mean speed: on the synthetic
    texture CLAHE fills all 512 keypoint slots with weaker features and
    roughly doubles the error of the gray path.
    """
    import numpy as np

    from ergo_uvo_tpu_torch.image import build_preprocess_plan, preprocess_frame
    from ergo_uvo_tpu_torch.pipeline import run_mono_vo

    _mono_phase(torch, "slice_preprocessed_pinhole_frames", run_mono_vo, frames, plan.new_K, seq,
                N_BATCHED, {"K": "plan.new_K"}, rmse_bound=None)
    dist = np.array(LENS_DISTORTION)
    lens = _through_the_lens(torch, dist)
    lens_seq, lens_frames, K_lens = lens
    for clahe_on, phase, n, bound in ((False, "slice_undistorted", N_BATCHED, 0.35),
                                      (True, "slice_preprocessed", N_FRAMES, 0.5)):
        lens_plan = build_preprocess_plan(K_lens, dist, 640, 480, plan.new_w,
                                          clahe_enabled=clahe_on, clip_limit=plan.clip_limit)
        pre = preprocess_frame(lens_plan, lens_frames)
        launches, _ = _mono_phase(torch, phase, run_mono_vo, pre, lens_plan.new_K, lens_seq, n,
                                  {"K": "plan.new_K", "clahe": clahe_on,
                                   "frames_seen_through_lens": LENS_DISTORTION,
                                   "max_shift": lens_plan.max_shift}, rmse_bound=bound)
    return launches, lens


def phase_slice_batched(torch, seq, slice_outs):
    """The batched-features runner on the first 12 gray frames, same generator
    seed as the slice: equal discrete outputs, floats to the repo's contract."""
    import numpy as np

    from ergo_uvo_tpu_torch.pipeline import run_mono_vo_batched_features

    n = N_BATCHED
    launches, outs = _mono_phase(torch, "slice_batched", run_mono_vo_batched_features,
                                 seq.imgs_left, seq.K, seq, n)
    for f in ("published", "validity", "used_essential", "num_features"):
        check(np.array_equal(outs[f], slice_outs[f][:n]), f"slice_batched: {f} differs from slice")
    for f in ("num_matches", "num_inliers", "num_3d_points"):
        diff = int(np.abs(outs[f].astype(int) - slice_outs[f][:n].astype(int)).max())
        check(diff <= 2, f"slice_batched: {f} differs from slice by {diff}")
    dv = float(np.abs(outs["velocity"] - slice_outs["velocity"][:n]).max())
    check(dv <= 5e-3, f"slice_batched: velocity differs from slice by {dv}")
    check(bool(np.allclose(outs["scale_factor"], slice_outs["scale_factor"][:n], rtol=1e-2)),
          "slice_batched: scale factor differs from slice")
    emit({"phase": "slice_batched_vs_slice", "max_abs_velocity_diff": dv,
          "all_fields_bit_equal": bool(all(np.array_equal(outs[f], slice_outs[f][:n])
                                           for f in outs))})
    return launches


def _sync_ms(torch, fn, runs=5):
    """Median wall time of ``fn`` with the card drained before and after."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times), out


def _stereo_stages(torch, state, img_l, img_r, rig, cfg):
    """The stages of one steady stereo frame, each timed apart (wall time,
    the card drained around it, median of 5)."""
    from ergo_uvo_tpu_torch.estimation.p3p import p3p
    from ergo_uvo_tpu_torch.estimation.pnp import gauss_newton_pnp, solve_pnp_ransac
    from ergo_uvo_tpu_torch.estimation.sampling import sample_minimal_sets
    from ergo_uvo_tpu_torch.features.frontend import detect_and_describe
    from ergo_uvo_tpu_torch.features.matcher import match_descriptors
    from ergo_uvo_tpu_torch.geometry.camera import projection_matrix
    from ergo_uvo_tpu_torch.geometry.triangulation import filter_3d_points, triangulate_points

    dev = img_l.device
    gen = torch.Generator(device=dev).manual_seed(1)
    detect = lambda im: detect_and_describe(im, cfg.surf, cfg.max_keypoints)  # noqa: E731
    detect_ms, (kl, dl) = _sync_ms(torch, lambda: detect(img_l))
    pair_ms, _ = _sync_ms(torch, lambda: detect(torch.stack([img_l, img_r])))
    kr, dr = detect(img_r)
    match_ms, _ = _sync_ms(torch, lambda: match_descriptors(dl, kl.mask, dr, kr.mask,
                                                            cfg.lowe_ratio_test))
    tm = match_descriptors(state.prev_desc_l, state.prev_mask, dl, kl.mask, cfg.lowe_ratio_test)
    eye3, zero3 = torch.eye(3, device=dev), torch.zeros(3, device=dev)

    def triangulate():
        P1 = projection_matrix(rig.K_left, eye3, zero3)
        P2 = projection_matrix(rig.K_right, rig.R_right, rig.t_right)
        X = triangulate_points(P1, P2, state.prev_xy_l, state.prev_xy_r)
        good, _ = filter_3d_points(X, tm.mask, rig.K_left, eye3, zero3, rig.K_right, rig.R_right,
                                   rig.t_right, state.prev_xy_l, state.prev_xy_r,
                                   cfg.reprojection_threshold, min_points=cfg.min_num_3d_points)
        return X, good

    tri_ms, (X, good) = _sync_ms(torch, triangulate)
    xy = kl.xy[tm.idx.long()]
    pnp_ms, pnp = _sync_ms(torch, lambda: solve_pnp_ransac(
        X, xy, good, rig.K_left, cfg.reprojection_error, cfg.num_hypotheses,
        min_inliers=cfg.min_num_inliers, generator=gen))
    idx, _ = sample_minimal_sets(good, cfg.num_hypotheses, 3, gen)
    K = rig.K_left
    xn = torch.stack([(xy[:, 0] - K[0, 2]) / K[0, 0], (xy[:, 1] - K[1, 2]) / K[1, 1],
                      torch.ones_like(xy[:, 0])], -1)
    bearings = xn / torch.linalg.vector_norm(xn, dim=-1, keepdim=True)
    p3p_ms, _ = _sync_ms(torch, lambda: p3p(X[idx], bearings[idx]))
    w = good.to(X.dtype)
    X_safe = torch.where(good[:, None], X, eye3[2])
    xy_safe = torch.where(good[:, None], xy, 0.0)
    gn_ms, _ = _sync_ms(torch, lambda: gauss_newton_pnp(pnp.R, pnp.t, K, X_safe, xy_safe, w, 4))
    return {"detect_one_image_ms": detect_ms, "detect_pair_as_one_batch_ms": pair_ms,
            "match_ms": match_ms, "triangulate_and_gates_ms": tri_ms, "pnp_ms": pnp_ms,
            "p3p_512_sets_ms": p3p_ms, "gauss_newton_4_steps_ms": gn_ms,
            "pnp_inliers": int(pnp.inliers.sum()), "points": int(good.sum())}


def phase_slice_stereo(torch):
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ergo_uvo_tpu_torch.io import make_stereo_sequence
    from ergo_uvo_tpu_torch.pipeline import run_stereo_vo

    dev = torch.device("cuda")
    cfg = _stereo_config()
    seq = make_stereo_sequence(n_frames=N_FRAMES, height=480, width=640, seed=2)
    rig = _bench_rig(torch, seq)
    il, ir, ts = seq.imgs_left, seq.imgs_right, seq.timestamps
    gen = torch.Generator(device=dev).manual_seed(0)

    _zero_counts()
    # Frames 0-1 untimed through numpy inputs and no device (the card by
    # default), frames 2..23 timed with inputs already on the card.
    state, head = run_stereo_vo(il[:2], ir[:2], ts[:2], rig, cfg, gen)
    rest = [torch.as_tensor(x[2:]).to(dev) for x in (il, ir, ts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, tail = run_stereo_vo(*rest, rig, cfg, gen, state=state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read_counts("slice_stereo")

    outs = {f: np.concatenate([getattr(head, f).cpu().numpy(), getattr(tail, f).cpu().numpy()])
            for f in head._fields}
    check(launches == 2 * N_FRAMES,
          f"kernel launched {launches} times in {N_FRAMES} stereo frames, expected 2 a frame")
    check(JACOBI_BY_PATH["slice_stereo"] == N_FRAMES,
          f"the Jacobi kernel launched {JACOBI_BY_PATH['slice_stereo']} times in {N_FRAMES} "
          "stereo frames, expected 1 a frame (P3P)")
    check(all(x.is_cuda for x in tail) and all(x.is_cuda for x in state),
          "run_stereo_vo's outputs are not on the card")
    for f in ("velocity", "R", "t"):
        check(bool(np.isfinite(outs[f]).all()), f"stereo {f} has non-finite values")
    check(outs["velocity"].shape == (N_FRAMES, 3), f"velocity shape {outs['velocity'].shape}")
    pub, val = outs["published"], outs["validity"]
    check(not pub[0] and bool(pub[1:].all()), f"published {pub.tolist()}")
    valid_share = float(val[1:].mean())
    check(valid_share > 0.6, f"stereo validity on {valid_share:.2f} of frames <= 0.6")
    rmse, speed = _velocity_check(np, outs, seq.velocities_prevcam)

    # One steady frame's stages apart, then two frames under the profiler.
    mid = N_FRAMES // 2
    mid_state, _ = run_stereo_vo(il[:mid], ir[:mid], ts[:mid], rig, cfg,
                                 torch.Generator(device=dev).manual_seed(0))
    stages = _stereo_stages(torch, mid_state, rest[0][mid - 2], rest[1][mid - 2], rig, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_stereo_vo(rest[0][mid - 2:mid], rest[1][mid - 2:mid], rest[2][mid - 2:mid], rig, cfg,
                      gen, state=mid_state)
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    n_launch = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    check(device_us > 0, "torch.profiler recorded no device time on the stereo path")
    timed = N_FRAMES - 2
    emit({"phase": "slice_stereo", "frames": N_FRAMES, "height": 480, "width": 640,
          "max_keypoints": 512, "num_hypotheses": 512, "kernel_launches": launches,
          "jacobi_launches": JACOBI_BY_PATH["slice_stereo"],
          "launches_per_frame": launches / N_FRAMES,
          "frames_per_second": timed / seconds, "ms_per_frame": 1e3 * seconds / timed,
          "velocity_rmse": rmse, "mean_gt_speed": speed, "valid_share": valid_share,
          "published": pub.astype(int).tolist(), "validity": val.astype(int).tolist(),
          **{f: outs[f].tolist() for f in (
              "num_features_l", "num_features_r", "num_stereo_matches",
              "num_triangular_matches", "num_3d_points", "num_pnp_inliers")},
          "stages": stages,
          "profiled": {"frames": 2, "wall_ms_per_frame": 1e3 * profiled_s / 2,
                       "device_ms_per_frame": device_us / 2e3,
                       "cuda_launch_calls_per_frame": n_launch / 2}})
    return launches


def _mono_stages(torch, state, img, K, cfg):
    """The stages of one steady mono frame, each timed apart (wall time, the
    card drained around it, median of 5), and each Jacobi solve of its
    relative pose timed apart on the input the frame gave it, through the
    kernel and through the plain version."""
    from ergo_uvo_tpu_torch.estimation.essential import _normalized, find_essential, gn_refine_essential
    from ergo_uvo_tpu_torch.estimation.homography import find_homography
    from ergo_uvo_tpu_torch.estimation.relative_pose import (
        estimate_relative_pose,
        select_estimation_method,
    )
    from ergo_uvo_tpu_torch.features.frontend import detect_and_describe_cfg
    from ergo_uvo_tpu_torch.features.matcher import match_descriptors
    from ergo_uvo_tpu_torch.geometry import linalg
    from ergo_uvo_tpu_torch.geometry.camera import projection_matrix
    from ergo_uvo_tpu_torch.geometry.triangulation import filter_3d_points, triangulate_points

    dev = img.device
    detect_ms, (kp, desc) = _sync_ms(torch, lambda: detect_and_describe_cfg(img, cfg))
    match_ms, m = _sync_ms(torch, lambda: match_descriptors(state.prev_desc, state.prev_mask, desc,
                                                            kp.mask, cfg.lowe_ratio_test))
    xy1 = torch.where(m.mask[:, None], state.prev_xy, 0.0)
    xy2 = torch.where(m.mask[:, None], kp.xy[m.idx.long()], 0.0)
    gen = lambda: torch.Generator(device=dev).manual_seed(1)  # noqa: E731

    def pose():
        return estimate_relative_pose(xy1, xy2, m.mask, K, cfg, state.R, state.t, gen())

    solves, real = [], linalg.jacobi_eigh

    def recording(A, sweeps=7):
        solves.append(A.clone())
        return real(A, sweeps)

    linalg.jacobi_eigh = recording
    try:
        pose()
    finally:
        linalg.jacobi_eigh = real
    pose_ms, res = _sync_ms(torch, pose)
    ess = cfg.essential
    essential_ms, (E, inl) = _sync_ms(torch, lambda: find_essential(
        xy1, xy2, m.mask, K, ess.outlier_method, ess.threshold, cfg.num_hypotheses, gen()))
    hom = cfg.homography
    homography_ms, _ = _sync_ms(torch, lambda: find_homography(
        xy1, xy2, m.mask, hom.outlier_method, hom.threshold, cfg.num_hypotheses, gen()))
    x1, x2 = _normalized(K, xy1), _normalized(K, xy2)
    gn_ms, _ = _sync_ms(torch, lambda: gn_refine_essential(E, x1, x2, inl.to(x1.dtype)))
    solve_rows = [{"shape": list(A.shape),
                   "kernel_ms": _sync_ms(torch, lambda A=A: linalg.jacobi_eigh(A))[0],
                   "plain_ms": _sync_ms(torch, lambda A=A: linalg.jacobi_eigh_reference(A), runs=3)[0]}
                  for A in solves]
    eye3, zero3 = torch.eye(3, device=dev), torch.zeros(3, device=dev)

    def triangulate():
        P1 = projection_matrix(K, eye3, zero3)
        P2 = projection_matrix(K, res.R, res.t)
        X = triangulate_points(P1, P2, xy1, xy2)
        return filter_3d_points(X, res.triangulation_inliers & m.mask, K, eye3, zero3, K, res.R,
                                res.t, xy1, xy2, cfg.reprojection_threshold,
                                min_points=cfg.min_num_3d_points)

    tri_ms, _ = _sync_ms(torch, triangulate)
    return {"detect_ms": detect_ms, "match_ms": match_ms, "relative_pose_ms": pose_ms,
            "find_essential_ms": essential_ms, "find_homography_ms": homography_ms,
            "sampson_gauss_newton_6_steps_ms": gn_ms, "jacobi_solves": solve_rows,
            "triangulate_and_gates_ms": tri_ms,
            "prefer_essential": bool(select_estimation_method(xy1, xy2, m.mask, cfg.distance)),
            "used_essential": bool(res.used_essential),
            "num_matches": int(m.count), "num_inliers": int(res.num_inliers)}


def phase_mono_stages(torch, seq):
    """Frames 12 and 13 of the slice taken apart, each after the frames
    before it with the slice's generator seed, then both under
    torch.profiler: device time, launches and the device's idle share.  On
    the slice's planar scene the frames take turns: one prefers the
    homography (one Jacobi solve), the next the essential matrix, whose gate
    fails on the plane, and then the homography too (three solves)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ergo_uvo_tpu_torch.pipeline import run_mono_vo
    from ergo_uvo_tpu_torch.utils.profiling import COUNTERS

    dev = torch.device("cuda")
    cfg = _main_path_config()
    mid = N_FRAMES // 2
    imgs, ts, rg, K = (torch.as_tensor(x).to(dev) for x in (seq.imgs_left, seq.timestamps,
                                                            seq.ranges, seq.K))
    stages = []
    for f in (mid + 1, mid):  # frame `mid`'s state and generator are kept for the profile
        gen = torch.Generator(device=dev).manual_seed(0)
        state, _ = run_mono_vo(imgs[:f], ts[:f], rg[:f], K, cfg, gen)
        stages.insert(0, {"frame": f, **_mono_stages(torch, state, imgs[f], K, cfg)})
    torch.cuda.synchronize()
    before = COUNTERS["jacobi_eigh.launches"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_mono_vo(imgs[mid:mid + 2], ts[mid:mid + 2], rg[mid:mid + 2], K, cfg, gen, state=state)
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    solves = COUNTERS["jacobi_eigh.launches"] - before
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    jacobi_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA and "jacobi_eigh" in e.key)
    n_launch = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    check(device_us > 0, "torch.profiler recorded no device time on the mono path")
    wall_ms = 1e3 * profiled_s / 2
    emit({"phase": "mono_stages", "height": 480, "width": 640, "stages": stages,
          "profiled": {"frames": 2, "wall_ms_per_frame": wall_ms,
                       "device_ms_per_frame": device_us / 2e3,
                       "jacobi_device_ms_per_frame": jacobi_us / 2e3,
                       "jacobi_launches_per_frame": solves / 2,
                       "device_idle_share": 1.0 - device_us / 2e3 / wall_ms,
                       "cuda_launch_calls_per_frame": n_launch / 2}})
    for st in stages:
        solves = len(st["jacobi_solves"])
        check(solves >= (3 if st["prefer_essential"] and not st["used_essential"] else 1),
              f"mono_stages: frame {st['frame']}: {solves} Jacobi solves in the relative pose")


def phase_plain_jacobi(torch, seq):
    """The first 12 frames of ``slice`` and of ``slice_stereo`` twice in turn:
    through the kernel, then with ``jacobi_eigh_reference`` patched in where
    the estimators look ``jacobi_eigh`` up (``linalg`` for ``smallest_eigvec``,
    ``p3p``), so that no kernel solves.  Every output field of the two runs
    must be equal bit for bit; ms per frame of each, same call."""
    import importlib

    import numpy as np

    from ergo_uvo_tpu_torch.geometry import linalg
    from ergo_uvo_tpu_torch.io import make_stereo_sequence
    from ergo_uvo_tpu_torch.pipeline import run_mono_vo, run_stereo_vo
    from ergo_uvo_tpu_torch.utils.profiling import COUNTERS

    # The module: the package's name p3p is the function.
    p3p = importlib.import_module("ergo_uvo_tpu_torch.estimation.p3p")

    dev = torch.device("cuda")
    n = N_BATCHED
    sseq = make_stereo_sequence(n_frames=N_FRAMES, height=480, width=640, seed=2)
    rig = _bench_rig(torch, sseq)
    runs = {
        "slice": lambda gen: run_mono_vo(seq.imgs_left[:n], seq.timestamps[:n], seq.ranges[:n],
                                         seq.K, _main_path_config(), gen),
        "slice_stereo": lambda gen: run_stereo_vo(sseq.imgs_left[:n], sseq.imgs_right[:n],
                                                  sseq.timestamps[:n], rig, _stereo_config(), gen),
    }
    line = {"phase": "plain_jacobi", "frames": n}
    for path, run in runs.items():
        got = {}
        for route in ("kernel", "plain"):
            real = linalg.jacobi_eigh, p3p.jacobi_eigh
            if route == "plain":
                linalg.jacobi_eigh = p3p.jacobi_eigh = linalg.jacobi_eigh_reference
            try:
                before = COUNTERS["jacobi_eigh.launches"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, outs = run(torch.Generator(device=dev).manual_seed(0))
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launched = COUNTERS["jacobi_eigh.launches"] - before
            finally:
                linalg.jacobi_eigh, p3p.jacobi_eigh = real
            got[route] = ({f: getattr(outs, f).cpu().numpy() for f in outs._fields}, launched,
                          1e3 * seconds / n)
        (k, k_launches, k_ms), (p, p_launches, p_ms) = got["kernel"], got["plain"]
        line[path] = {"kernel_jacobi_launches": k_launches, "plain_jacobi_launches": p_launches,
                      "kernel_ms_per_frame": k_ms, "plain_ms_per_frame": p_ms,
                      "bit_equal": {f: k[f].tobytes() == p[f].tobytes() for f in k},
                      "max_abs_velocity_diff": float(np.abs(k["velocity"] - p["velocity"]).max())}
    emit(line)
    for path in runs:
        r = line[path]
        check(r["kernel_jacobi_launches"] > 0 and r["plain_jacobi_launches"] == 0,
              f"plain_jacobi: {path}: {r['kernel_jacobi_launches']} kernel launches through the "
              f"kernel, {r['plain_jacobi_launches']} with the plain version patched in")
        check(all(r["bit_equal"].values()),
              f"plain_jacobi: {path}: outputs differ with the plain Jacobi: {r['bit_equal']}")


def _stereo_config():
    from ergo_uvo_tpu_torch.config import StereoVOConfig, SurfConfig

    return StereoVOConfig(surf=SurfConfig(min_hessian=60.0), max_keypoints=512, num_hypotheses=512)


def _bench_rig(torch, seq):
    import numpy as np

    from ergo_uvo_tpu_torch.convert import stereo_rig_from_numpy

    K32 = seq.K.astype(np.float32)
    return stereo_rig_from_numpy(
        dict(K_left=K32, K_right=K32, R_right=np.eye(3, dtype=np.float32),
             t_right=np.asarray([-0.33, 0.0, 0.0], np.float32)), torch.device("cuda"))


PARITY_FIXTURE = "tests/fixtures/torch_parity_main.npz"
PARITY_FRAMES = 12  # frames (pairs) of each parity phase, as the fixture holds them


def phase_parity(torch, kind):
    """The port's ``kind`` runner on the card, given JAX's minimal sets,
    held frame by frame to the JAX package's eager outputs in the parity
    fixture; returns the top-2 kernel's launches."""
    import numpy as np

    import ergo_uvo_tpu_torch.config as tconfig
    from ergo_uvo_tpu_torch.eval import parity
    from ergo_uvo_tpu_torch.pipeline import run_mono_vo, run_stereo_vo

    phase = f"parity_{kind}"
    start = time.perf_counter()
    fixture = parity.load_fixture(ROOT / PARITY_FIXTURE)
    seq = parity.fixture_sequence(fixture, kind)  # raises unless the frames hash as stored
    cfg = parity.fixture_config(fixture, kind, tconfig)
    check(cfg == (_main_path_config() if kind == "mono" else _stereo_config()),
          f"{phase}: the fixture's config is not the main path's")
    sampler = parity.FixtureSampler(fixture, kind)
    n = len(seq.timestamps)
    check(n == PARITY_FRAMES, f"{phase}: the fixture holds {n} frames, not {PARITY_FRAMES}")

    _zero_counts()
    t0 = time.perf_counter()
    if kind == "mono":
        _, outs = run_mono_vo(seq.imgs_left, seq.timestamps, seq.ranges, seq.K, cfg,
                              sampler=sampler)
    else:
        _, outs = run_stereo_vo(seq.imgs_left, seq.imgs_right, seq.timestamps,
                                _bench_rig(torch, seq), cfg, sampler=sampler)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read_counts(phase)
    jacobi = JACOBI_BY_PATH[phase]

    port = {k: v.cpu().numpy() for k, v in outs._asdict().items()}
    contract = parity.CONTRACTS[kind]
    eager = parity.reference_outputs(fixture, kind)
    report = parity.contract_report(port, eager, contract)
    jit_vs_eager = parity.contract_report(parity.reference_outputs(fixture, kind, "jit"), eager,
                                          contract)
    discrete = contract.exact + contract.counts
    per_frame = 1 if kind == "mono" else 2
    emit({"phase": phase, "frames": n, "height": seq.imgs_left.shape[1],
          "width": seq.imgs_left.shape[2], "max_keypoints": cfg.max_keypoints,
          "num_hypotheses": cfg.num_hypotheses, "fixture": PARITY_FIXTURE,
          "kernel_launches": launches, "jacobi_launches": jacobi,
          "estimator_runs": len(sampler.asked), "seconds": seconds,
          "frames_per_second": n / seconds,
          "phase_seconds": time.perf_counter() - start,  # the frames' regeneration and hash too
          "mask_failures": sampler.failures, "contract_failures": report["failures"],
          "max_abs_diff": report["max_abs"],
          "frames_counts_exact": report["frames_counts_exact"],
          "frames_differing": report["frames_differing"],
          "jax_jit_vs_eager_frames": jit_vs_eager["frames_differing"],
          "jax_jit_vs_eager_max_abs_diff": jit_vs_eager["max_abs"],
          "card": {f: port[f].astype(int).tolist() for f in discrete},
          "jax_eager": {f: eager[f].astype(int).tolist() for f in discrete}})
    # Checked after the line is out, so that a miss shows its numbers.
    check(all(x.is_cuda for x in outs), f"{phase}: the runner's outputs are not on the card")
    check(not sampler.failures, f"{phase}: the card's masks are not JAX's: {sampler.failures}")
    check(sorted(sampler.asked) == parity.set_entries(fixture, kind),
          f"{phase}: the card ran the estimators {sorted(sampler.asked)}, JAX "
          f"{parity.set_entries(fixture, kind)}")
    check(not report["failures"], f"{phase}: the contract fails: {report['failures']}")
    for f in contract.atol:
        check(bool(np.isfinite(port[f]).all()), f"{phase}: {f} has non-finite values")
    check(launches == per_frame * n,
          f"{phase}: the top-2 kernel launched {launches} times in {n} frames, "
          f"expected {per_frame} a frame")
    check(jacobi >= len(sampler.asked),
          f"{phase}: the Jacobi kernel launched {jacobi} times for {len(sampler.asked)} "
          "estimator runs")
    return launches


class _Stop(Exception):
    """Raised by a chunk callback to end a streamed run, as a crash would."""


def _host(tup):
    return type(tup)(*(x.cpu().numpy() for x in tup))


def _bit_equal(a, b):
    import numpy as np

    return all(np.array_equal(x, y) and x.dtype == y.dtype for x, y in zip(a, b))


def _stream_phase(torch, phase, stream, bulk, state_example, out_type, per_frame, gt, valid_min):
    """The checks and timings of a streaming phase.

    ``stream(chunk, start=0, **kw)`` streams frames ``start..23`` in chunks of
    ``chunk`` through the runner (``device=None``: the card); ``bulk(gen)``
    is ``preprocess_frame`` then the bulk runner on all 24 frames.
    """
    import numpy as np

    from ergo_uvo_tpu_torch.cli import _make_stream_ckpt_cb
    from ergo_uvo_tpu_torch.utils.checkpoint import load_stream_run

    dev = torch.device("cuda")
    gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bulk_state, bulk_outs = bulk(gen())
    torch.cuda.synchronize()
    bulk_s = time.perf_counter() - t0

    timings = []
    _zero_counts()
    t0 = time.perf_counter()
    state, outs = stream(8, generator=gen(), timings=timings)
    stream_s = time.perf_counter() - t0
    launches = _read_counts(phase)
    check(launches == per_frame * N_FRAMES,
          f"{phase}: kernel launched {launches} times in {N_FRAMES} frames, "
          f"expected {per_frame} a frame")
    check(all(isinstance(x, np.ndarray) for x in outs) and all(x.is_cuda for x in state),
          f"{phase}: outputs are not numpy or the state is not on the card")
    check(_bit_equal(outs, _host(bulk_outs)) and _bit_equal(_host(state), _host(bulk_state)),
          f"{phase}: the streamed run differs from preprocess_frame then the bulk runner")

    WORK_DIR.mkdir(parents=True, exist_ok=True)
    ckpt = str(WORK_DIR / f"{phase}.npz")
    save = _make_stream_ckpt_cb(ckpt, every=1, n_real=N_FRAMES, chunk_size=7, start=0,
                                n_segments=0)
    write_ms = []

    def crash_after_chunk_2(frames_done, *rest):
        t = time.perf_counter()
        save(frames_done, *rest)
        write_ms.append(1e3 * (time.perf_counter() - t))
        if frames_done == 14:
            raise _Stop

    try:
        stream(7, generator=gen(), chunk_callback=crash_after_chunk_2)
        check(False, f"{phase}: the checkpointed run did not stop after chunk 2")
    except _Stop:
        pass
    done, ck_state, prefix, generator_state, meta = load_stream_run(
        ckpt, state_example, out_type(*([np.zeros(0)] * len(out_type._fields))))
    check(done == 14 and meta["n_segments"] == 2 and all(x.is_cuda for x in ck_state),
          f"{phase}: checkpoint holds {done} frames, {meta}")
    generator = torch.Generator(device=dev)
    generator.set_state(generator_state)
    resumed_state, tail = stream(5, start=done, generator=generator, state=ck_state)
    resumed = out_type(*(np.concatenate([a, b]) for a, b in zip(prefix, tail)))
    check(_bit_equal(resumed, outs) and _bit_equal(_host(resumed_state), _host(state)),
          f"{phase}: the resumed run differs from the uninterrupted one")

    for f in ("velocity", "R", "t"):
        check(bool(np.isfinite(getattr(outs, f)).all()), f"{phase}: {f} has non-finite values")
    pub, val = outs.published, outs.validity
    check(not pub[0] and bool(pub[1:].all()), f"{phase}: published {pub.tolist()}")
    valid_share = float(val[1:].mean())
    check(valid_share >= valid_min, f"{phase}: validity on {valid_share:.2f} of frames")
    rmse, speed = _velocity_check(np, outs._asdict(), gt)
    steady_n = sum(n for n, _ in timings[1:])
    steady_s = sum(t for _, t in timings[1:])
    emit({"phase": phase, "frames": N_FRAMES, "height": 480, "width": 640,
          "max_keypoints": 512, "num_hypotheses": 512, "chunk": 8,
          "kernel_launches": launches, "launches_per_frame": launches / N_FRAMES,
          "frames_per_second": steady_n / steady_s, "ms_per_frame": 1e3 * steady_s / steady_n,
          "first_chunk_s": timings[0][1], "chunk_s": [t for _, t in timings],
          "all_frames_per_second": N_FRAMES / stream_s,
          "bulk_frames_per_second": N_FRAMES / bulk_s, "bulk_ms_per_frame": 1e3 * bulk_s / N_FRAMES,
          "equal_to_bulk": True, "resumed_equal": True,
          "checkpoint_write_ms": statistics.mean(write_ms), "checkpoint_writes_ms": write_ms,
          "velocity_rmse": rmse, "mean_gt_speed": speed, "valid_share": valid_share,
          "validity": val.astype(int).tolist()})
    return launches


def phase_stream_mono(torch, lens):
    """The mono streaming runner on the frames of ``slice_undistorted``."""
    import numpy as np

    from ergo_uvo_tpu_torch.image import build_preprocess_plan, preprocess_frame
    from ergo_uvo_tpu_torch.io import ArraySource
    from ergo_uvo_tpu_torch.pipeline import (
        MonoFrameOutput,
        mono_vo_init_from,
        run_mono_vo,
        run_mono_vo_streaming,
    )

    lens_seq, lens_frames, K_lens = lens
    cfg = _main_path_config()
    plan = build_preprocess_plan(K_lens, np.array(LENS_DISTORTION), 640, 480, 640,
                                 clahe_enabled=False, clip_limit=cfg.preprocessing.clip_limit)
    frames = lens_frames.cpu().numpy()
    ts, rg = lens_seq.timestamps, lens_seq.ranges

    def stream(chunk, start=0, **kw):
        source = ArraySource(frames[start:], ts[start:], ranges=rg[start:])
        return run_mono_vo_streaming(source, plan, plan.new_K, cfg, chunk_size=chunk, **kw)

    def bulk(gen):
        return run_mono_vo(preprocess_frame(plan, lens_frames), ts, rg, plan.new_K, cfg, gen)

    return _stream_phase(torch, "stream_mono", stream, bulk,
                         mono_vo_init_from(cfg, device="cpu"), MonoFrameOutput, 1,
                         lens_seq.velocities_prevcam, 0.7)


def phase_stream_stereo(torch):
    """The stereo streaming runner on the pairs of ``slice_stereo``."""
    import numpy as np

    from ergo_uvo_tpu_torch.image import build_preprocess_plan, preprocess_frame
    from ergo_uvo_tpu_torch.io import ArraySource, make_stereo_sequence
    from ergo_uvo_tpu_torch.pipeline import (
        StereoFrameOutput,
        run_stereo_vo,
        run_stereo_vo_streaming,
        stereo_vo_init_from,
    )

    dev = torch.device("cuda")
    cfg = _stereo_config()
    seq = make_stereo_sequence(n_frames=N_FRAMES, height=480, width=640, seed=2)
    rig = _bench_rig(torch, seq)
    plan_l, plan_r = (build_preprocess_plan(seq.K, np.zeros(4), 640, 480, 640, False,
                                            cfg.preprocessing.clip_limit) for _ in range(2))

    def stream(chunk, start=0, **kw):
        source = ArraySource(seq.imgs_left[start:], seq.timestamps[start:],
                             imgs_right=seq.imgs_right[start:])
        return run_stereo_vo_streaming(source, plan_l, plan_r, rig, cfg, chunk_size=chunk, **kw)

    def bulk(gen):
        il = preprocess_frame(plan_l, torch.as_tensor(seq.imgs_left).to(dev))
        ir = preprocess_frame(plan_r, torch.as_tensor(seq.imgs_right).to(dev))
        return run_stereo_vo(il, ir, seq.timestamps, rig, cfg, gen)

    return _stream_phase(torch, "stream_stereo", stream, bulk,
                         stereo_vo_init_from(cfg, device="cpu"), StereoFrameOutput, 2,
                         seq.velocities_prevcam, 0.6)


# The JAX package on the CPU on the frames of the slice_* detector phases
# (the same 24 frames and config; ORB through the batched runner): the
# medians over PRNG keys 0..keys-1 of `tools/jax_detector_reference.py
# --keys N`.  The port draws other minimal sets (a torch.Generator), so its
# medians over seeds are held to validity >= JAX's - 0.1 and velocity RMSE
# <= 1.5 x JAX's.
DETECTOR_REFERENCE = {
    "SIFT": {"keys": 5, "median_valid_share": 1.0, "median_velocity_rmse": 0.10134529791857437},
    "ORB": {"keys": 5, "median_valid_share": 0.5652173913043478,
            "median_velocity_rmse": 5.76800016761254},
    "AKAZE": {"keys": 10, "median_valid_share": 1.0, "median_velocity_rmse": 0.5981855150869289},
}
DETECTOR_SEEDS = (0, 1, 2, 3, 4)  # the port's generator seeds of each detector slice


def _detector_config(det, num_hypotheses=512, stereo=False):
    from ergo_uvo_tpu_torch.config import MonoVOConfig, StereoVOConfig

    config = StereoVOConfig if stereo else MonoVOConfig
    return config(feature_detector=det, max_keypoints=512, num_hypotheses=num_hypotheses)


def _frontend_profile(torch, cfg, img):
    """One frame's detect + describe: wall ms with the card drained around
    it (median of 5), then one call under torch.profiler (device ms, kernel
    launches) and one under ``torch.cuda.set_sync_debug_mode("error")``,
    which raises at any host sync."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ergo_uvo_tpu_torch.features.frontend import detect_and_describe_cfg

    wall_ms, (kpts, desc) = _sync_ms(torch, lambda: detect_and_describe_cfg(img, cfg))
    check(desc.shape == (cfg.max_keypoints, cfg.descriptor_dim) and bool(torch.isfinite(desc).all()),
          f"{cfg.feature_detector}: descriptors {tuple(desc.shape)}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        detect_and_describe_cfg(img, cfg)
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    n_launch = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    check(device_us > 0, f"{cfg.feature_detector}: torch.profiler recorded no device time")
    torch.cuda.set_sync_debug_mode("error")
    try:
        detect_and_describe_cfg(img, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return {"detect_describe_ms": wall_ms, "keypoints": int(kpts.count),
            "profiled_wall_ms": profiled_ms, "device_ms": device_us / 1e3,
            "device_idle_share": 1.0 - device_us / 1e3 / profiled_ms,
            "cuda_launch_calls": n_launch, "no_host_sync": True}


def phase_slice_detector(torch, seq, det):
    """``bench.py::_section_detector``'s config for ``det`` (512 keypoints,
    512 hypotheses) on the slice's 24 frames of 640x480, ORB through
    ``run_mono_vo_batched_features`` as ``bench.py`` runs it: one launch a
    frame at D = 128 (SIFT), 256 (ORB bits) or 512 (AKAZE bits), the
    frontend of one frame apart, and the outputs against the JAX package's
    CPU runs: the medians over generator seeds 0-4 (seed 0 the timed run)
    of validity share and velocity RMSE against the medians of JAX's over
    its PRNG keys (``DETECTOR_REFERENCE``).  A single draw would not do:
    JAX's own ORB RMSE spans 2.38-5.97 m/s over keys 0-4, AKAZE's
    0.53-0.97 m/s over keys 0-9."""
    import numpy as np

    from ergo_uvo_tpu_torch.pipeline import run_mono_vo, run_mono_vo_batched_features

    cfg = _detector_config(det)
    ref = DETECTOR_REFERENCE[det]
    runner = run_mono_vo_batched_features if det == "ORB" else run_mono_vo
    frontend = _frontend_profile(torch, cfg, torch.as_tensor(seq.imgs_left[5]).cuda())
    phase = f"slice_{det.lower()}"
    launches, outs = _mono_phase(
        torch, phase, runner, seq.imgs_left, seq.K, seq, N_FRAMES,
        {"detector": det, "descriptor_dim": cfg.descriptor_dim, "runner": runner.__name__,
         "frontend": frontend}, rmse_bound=None, cfg=cfg, valid_min=0.0)
    check(launches == N_FRAMES, f"{phase}: {launches} launches in {N_FRAMES} frames")
    draws = [outs]
    for seed in DETECTOR_SEEDS[1:]:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        _, o = runner(seq.imgs_left, seq.timestamps, seq.ranges, seq.K, cfg, gen)
        draws.append({f: getattr(o, f).cpu().numpy() for f in o._fields})
    gt = seq.velocities_prevcam
    valid = [float(o["validity"][1:].mean()) for o in draws]
    rmse = [_velocity_check(np, o, gt, None)[0] for o in draws]
    out = {"phase": f"{phase}_seeds", "seeds": list(DETECTOR_SEEDS), "valid_share": valid, "velocity_rmse": rmse,
           "median_valid_share": float(np.median(valid)), "median_velocity_rmse": float(np.median(rmse)),
           "jax_cpu": ref, "valid_min": ref["median_valid_share"] - 0.1,
           "rmse_max": 1.5 * ref["median_velocity_rmse"]}
    emit(out)
    check(out["median_valid_share"] >= out["valid_min"],
          f"{phase}: median validity {out['median_valid_share']} < {out['valid_min']}")
    check(out["median_velocity_rmse"] <= out["rmse_max"],
          f"{phase}: median velocity RMSE {out['median_velocity_rmse']} > {out['rmse_max']}")
    return launches


# bench.py::section_parity's SIFT figures for the JAX package (BENCH_r05.json,
# CPU) and the bounds the port is held to on the card: twice the means of the
# port's own CPU run of the same phases (tools/port_accuracy_cpu.py: mono RMSE
# 0.028078289618529356 m/s, ATE 0.00884696660526642 m; stereo ATE
# 0.00862466728139838 m), capped at twice the JAX figures.
JAX_ACCURACY = {"mono_velocity_rmse": 0.02617, "mono_ate_m": 0.0717, "stereo_ate_m": 0.00863}
ACCURACY_BOUND = {"mono_velocity_rmse": 0.05234, "mono_ate_m": 0.0177, "stereo_ate_m": 0.01725}


def accuracy_runs(torch, device, stereo):
    """``bench.py::section_parity`` through the port on ``device``: mono,
    ``MonoVOConfig(SIFT, 512 keypoints, 256 hypotheses)`` on seeds 0, 1, 2 of
    24 frames of 320x240 at dt 0.25; stereo, the same on seeds 0 and 1 of 16
    pairs, rig R = I, t = [-0.33, 0, 0].  The generator is seeded with the
    sequence's seed.  Returns one row a seed: velocity RMSE, ATE (trajectories
    integrated and aligned by ``eval/ate.py``), validity share."""
    import numpy as np

    from ergo_uvo_tpu_torch.convert import stereo_rig_from_numpy
    from ergo_uvo_tpu_torch.eval.ate import ate_rmse, integrate_mono_trajectory, velocity_rmse
    from ergo_uvo_tpu_torch.io import make_mono_sequence, make_stereo_sequence
    from ergo_uvo_tpu_torch.pipeline import run_mono_vo, run_stereo_vo

    cfg = _detector_config("SIFT", num_hypotheses=256, stereo=stereo)
    rows = []
    for seed in ((0, 1) if stereo else (0, 1, 2)):
        gen = torch.Generator(device=device).manual_seed(seed)
        if stereo:
            seq = make_stereo_sequence(n_frames=16, height=240, width=320, dt=0.25, seed=seed)
            K32 = seq.K.astype(np.float32)
            rig = stereo_rig_from_numpy(dict(K_left=K32, K_right=K32, R_right=np.eye(3, dtype=np.float32),
                                             t_right=np.asarray([-0.33, 0.0, 0.0], np.float32)), device)
            _, outs = run_stereo_vo(seq.imgs_left, seq.imgs_right, seq.timestamps, rig, cfg, gen,
                                    device=device)
        else:
            seq = make_mono_sequence(n_frames=24, height=240, width=320, dt=0.25, seed=seed)
            _, outs = run_mono_vo(seq.imgs_left, seq.timestamps, seq.ranges, seq.K, cfg, gen,
                                  device=device)
        o = {f: getattr(outs, f).cpu().numpy() for f in outs._fields}
        pos, _ = integrate_mono_trajectory(o["velocity"], o["R"], seq.timestamps, o["published"],
                                           o["validity"])
        rows.append({"seed": seed, "frames": len(o["validity"]),
                     "velocity_rmse": velocity_rmse(o["velocity"], seq.velocities_prevcam, o["validity"]),
                     "ate_m": ate_rmse(pos, seq.positions - seq.positions[0]),
                     "valid_share": float(o["validity"][1:].mean()),
                     "published": o["published"].astype(int).tolist()})
    return rows


def phase_accuracy(torch, stereo):
    """The accuracy phases (``accuracy_sift``, ``accuracy_stereo_sift``) on the
    card, held to the bounds above; one launch a mono frame, two a pair."""
    import numpy as np

    phase = "accuracy_stereo_sift" if stereo else "accuracy_sift"
    _zero_counts()
    t0 = time.perf_counter()
    rows = accuracy_runs(torch, torch.device("cuda"), stereo)
    seconds = time.perf_counter() - t0
    launches = _read_counts(phase)
    frames = sum(r["frames"] for r in rows)
    check(launches == (2 if stereo else 1) * frames,
          f"{phase}: {launches} kernel launches in {frames} frames")
    out = {"phase": phase, "seeds": [r["seed"] for r in rows], "rows": rows,
           "kernel_launches": launches, "launches_per_frame": launches / frames, "seconds": seconds}
    keys = ("stereo_ate_m",) if stereo else ("mono_velocity_rmse", "mono_ate_m")
    for key in keys:
        mean = float(np.mean([r["velocity_rmse" if key.endswith("rmse") else "ate_m"] for r in rows]))
        out.update({key: mean, f"{key}_bound": ACCURACY_BOUND[key], f"{key}_jax_cpu": JAX_ACCURACY[key]})
    emit(out)
    for key in keys:
        check(out[key] <= ACCURACY_BOUND[key], f"{phase}: mean {key} {out[key]} > {ACCURACY_BOUND[key]}")
    return launches, frames


# The main paths' configs as the CLI reads them (--params); the stereo
# clip limit is its config's default, which a synthetic run does not use.
CLI_PARAMS = {
    "mono": "surf_params:\n  min_hessian: 60.0\n"
            "tpu_params:\n  max_keypoints: 512\n  num_hypotheses: 512\n",
    "stereo": "preprocessing:\n  clip_limit: 8.0\n"
              "surf_params:\n  min_hessian: 60.0\n"
              "tpu_params:\n  max_keypoints: 512\n  num_hypotheses: 512\n",
    "mono_sift": "vo_params:\n  feature_detector: SIFT\n"
                 "tpu_params:\n  max_keypoints: 512\n  num_hypotheses: 512\n",
}


OPT_FLAGS = ["--ba-window", "6", "--keyframe-stride", "3", "--ba-iters", "12", "--loop-closure"]


def phase_cli(torch, run, opt=False):
    """``python -m ergo_uvo_tpu_torch.cli {mode} --synthetic 24`` in process,
    with no ``--device``: the card; ``run`` is ``mono``, ``stereo`` or
    ``mono_sift`` (mono with ``feature_detector: SIFT`` in ``--params``);
    ``opt`` adds ``OPT_FLAGS`` (window BA and loop closure after the
    stream)."""
    import math

    import numpy as np

    from ergo_uvo_tpu_torch import cli
    from ergo_uvo_tpu_torch.config import load_vo_params
    from ergo_uvo_tpu_torch.pipeline import mono as mono_mod
    from ergo_uvo_tpu_torch.pipeline import stereo as stereo_mod

    mode = run.split("_")[0]
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    params = WORK_DIR / f"{run}_params.yaml"
    params.write_text(CLI_PARAMS[run])
    cfg = load_vo_params(str(params), stereo=mode == "stereo")
    want = {"mono": _main_path_config(), "stereo": _stereo_config(),
            "mono_sift": _detector_config("SIFT")}[run]
    check(cfg == want, f"cli_{run}: --params does not give the phase's config")
    phase = f"cli_{run}_opt" if opt else f"cli_{run}"
    out = WORK_DIR / f"{phase}.jsonl"
    out.unlink(missing_ok=True)
    argv = [mode, "--synthetic", str(N_FRAMES), "--synthetic-size", "640x480",
            "--params", str(params), "--chunk-size", "8", "--out", str(out),
            *(OPT_FLAGS if opt else [])]

    # Watch each chunk's outputs where the runner reads them back.
    read_back_devices = []
    module = mono_mod if mode == "mono" else stereo_mod
    real_read_back = module.read_back

    def watched_read_back(outs, device):
        read_back_devices.append(sorted({str(x.device) for x in outs}))
        return real_read_back(outs, device)

    module.read_back = watched_read_back
    stdout = io.StringIO()
    _zero_counts()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            cli.main(argv)
        seconds = time.perf_counter() - t0
    finally:
        module.read_back = real_read_back
    launches = _read_counts(phase)
    summary = json.loads(stdout.getvalue().strip().splitlines()[-1])
    with open(out) as f:
        records = [json.loads(line) for line in f]
    per_frame = 1 if mode == "mono" else 2
    pub = np.array([r["published"] for r in records])
    val = np.array([r["validity"] for r in records])
    check(len(records) == N_FRAMES and summary["frames"] == N_FRAMES,
          f"{phase}: {len(records)} records, summary {summary}")
    # The SURF runs are valid on every published frame; SIFT is held to the
    # mono floor of 0.7 (its accuracy is accuracy_sift's to check).
    valid_min = 0.7 if run == "mono_sift" else 1.0
    check(bool(pub[1:].all()) and float(val[1:].mean()) >= valid_min,
          f"{phase}: published {pub.astype(int).tolist()}, valid {val.astype(int).tolist()}")
    check(math.isfinite(summary["ate_m"]), f"{phase}: ate_m {summary['ate_m']}")
    check(summary["device"].startswith("cuda") and read_back_devices
          and all(d == [summary["device"]] for d in read_back_devices),
          f"{phase}: ran on {summary['device']}, chunks read back from {read_back_devices}")
    vo_launches = per_frame * N_FRAMES
    if opt:
        # The VO's launches, then one a window member but the anchor a BA
        # solve and those of retrieval and verification.
        check({"ba_keyframes", "ba_solves", "ba_iters_per_s", "loops_accepted"} <= set(summary)
              and summary["ba_solves"] >= 1 and summary["ba_iters_per_s"] > 0,
              f"{phase}: summary {summary}")
        check(launches >= vo_launches + 5 * summary["ba_solves"],
              f"{phase}: kernel launched {launches} times, the VO alone {vo_launches}")
    else:
        check(launches == vo_launches,
              f"{phase}: kernel launched {launches} times in {N_FRAMES} frames")
    emit({"phase": phase, "argv": argv, "summary": summary, "kernel_launches": launches,
          "launches_beyond_vo": launches - vo_launches,
          "launches_per_frame": launches / N_FRAMES, "seconds": seconds,
          "chunks_read_back_from": read_back_devices})
    return launches


# bench.py::section_ba's problem; the tolerances of the card against the
# CPU are tests/test_torch_optim.py::BA_TOL's for two fixed poses.
BA_POSES, BA_LANDMARKS, BA_ITERS, BA_ITERS_HI = 8, 512, 30, 330
BA_TOL = {"costs_rtol": 1e-4, "final_cost_rtol": 2e-2, "state_atol": 2e-3}


def _ba_scene(np, P=BA_POSES, L=BA_LANDMARKS):
    """``bench.py::section_ba``'s scene, ``tools/bench_scaling.py::make_problem``
    at other sizes: (K, obs (P, L, 2), R0, t0, X0, X)."""
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L), rng.uniform(5, 9, L)],
                 -1).astype(np.float32)
    K = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)
    obs = np.zeros((P, L, 2), np.float32)
    ts = np.zeros((P, 3), np.float32)
    Rs = np.tile(np.eye(3, dtype=np.float32), (P, 1, 1))
    for p in range(P):
        ts[p] = [0.25 * p, 0.0, 0.0]
        pc = X + ts[p]
        obs[p] = pc[:, :2] / pc[:, 2:3] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    obs += 0.1 * rng.standard_normal(obs.shape).astype(np.float32)
    X0 = X + 0.2 * rng.standard_normal(X.shape).astype(np.float32)
    return K, obs, Rs, ts, X0, X


def _profile_launches(torch, fn):
    """(wall ms, device ms, kernel launches, host-sync calls) of one ``fn()``
    under torch.profiler, the card drained before and after; launches through
    cudaLaunchKernel and cuLaunchKernel (cuSOLVER's) both count, and so does every
    synchronizing call the trace shows (a library's own, which
    ``set_sync_debug_mode`` does not see, included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    device_ms = 1e-3 * sum(e.self_device_time_total for e in events
                           if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    launches = sum(e.count for e in events if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"))
    # Host calls that may wait (the harness's own synchronize is one), and
    # the copies the device ran, by direction.
    syncs = {e.key: e.count for e in events
             if e.key.startswith(("cudaMemcpy", "cudaStreamSynchronize", "cudaDeviceSynchronize",
                                  "cudaEventSynchronize", "cuMemcpy", "cuStreamSynchronize",
                                  "Memcpy"))}
    check(device_ms > 0, "torch.profiler recorded no device time")
    return wall_ms, device_ms, launches, syncs


def phase_ba(torch):
    """Window BA on the card: ``ba_solve`` on ``bench.py::section_ba``'s
    problem, then the same scene as a keyframe window through
    ``WindowedBA.refine`` (association by the top-2 kernel, then the solve)."""
    import numpy as np

    from ergo_uvo_tpu_torch.optim.ba import BAProblem, ba_solve, reprojection_residuals
    from ergo_uvo_tpu_torch.optim.keyframes import WindowedBA

    K, obs, Rs, ts, X0, X = _ba_scene(np)

    def arrays(dev):
        prob = BAProblem(torch.as_tensor(K).to(dev), torch.as_tensor(obs).to(dev),
                         torch.ones((BA_POSES, BA_LANDMARKS), dtype=torch.bool, device=dev), 2)
        return prob, *(torch.as_tensor(a).to(dev) for a in (Rs, ts, X0))

    prob, R0, t0, Xd = arrays(torch.device("cuda"))
    ba_solve(prob, R0, t0, Xd, iters=2)  # the first cuSOLVER call, outside every timing
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, costs = ba_solve(prob, R0, t0, Xd, iters=BA_ITERS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    def seconds(n):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        ba_solve(prob, R0, t0, Xd, iters=n)
        torch.cuda.synchronize()
        return time.perf_counter() - t_start

    t_lo = min(seconds(BA_ITERS) for _ in range(2))
    t_hi = min(seconds(BA_ITERS_HI) for _ in range(2))
    iters_per_s = (BA_ITERS_HI - BA_ITERS) / (t_hi - t_lo)
    wall_ms, device_ms, launches, syncs = _profile_launches(
        torch, lambda: ba_solve(prob, R0, t0, Xd, iters=BA_ITERS))

    r, _, _ = reprojection_residuals(prob.K, R0, t0, Xd, prob.obs_uv, prob.obs_mask)
    start_cost = float((r * r).sum())
    costs = costs.cpu().numpy()
    cpu_state, cpu_costs = ba_solve(*arrays(torch.device("cpu")), iters=BA_ITERS)
    cpu_costs = cpu_costs.numpy()
    state_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(state[:3], cpu_state[:3]))
    first_rel = float((np.abs(costs[:4] - cpu_costs[:4]) / cpu_costs[:4]).max())
    final_rel = float(abs(costs[-1] - cpu_costs[-1]) / cpu_costs[-1])

    # The scene as a keyframe window: one random 64-d unit descriptor a
    # landmark, seen by every keyframe with 1% noise; the VO poses are the
    # true ones and the anchor pair fixes the gauge.
    rng = np.random.default_rng(1)
    desc = rng.standard_normal((BA_LANDMARKS, 64)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    wba = WindowedBA(window_size=BA_POSES, iters=12)
    for p in range(BA_POSES):
        d = desc + 0.01 * rng.standard_normal(desc.shape).astype(np.float32)
        wba.push_keyframe(*(torch.as_tensor(a).cuda() for a in (
            obs[p], d, np.ones(BA_LANDMARKS, bool), Rs[p], ts[p])))
    _zero_counts()
    w_state, w_costs, lm_mask = wba.refine(torch.as_tensor(K).cuda())
    torch.cuda.synchronize()
    window_launches = _read_counts("ba")
    w_costs = w_costs.cpu().numpy()
    n_landmarks = int(lm_mask.sum())

    emit({"phase": "ba", "poses": BA_POSES, "landmarks": BA_LANDMARKS, "num_fixed_poses": 2,
          "iters": BA_ITERS, "start_cost": start_cost, "costs": costs.tolist(),
          "final_over_start": float(costs[-1] / start_cost), "no_host_sync": True,
          "lm_iters_per_s": iters_per_s, "slope_iters": [BA_ITERS, BA_ITERS_HI],
          "seconds_lo_hi": [t_lo, t_hi],
          "profiled_wall_ms": wall_ms, "device_ms": device_ms,
          "device_idle_share": 1.0 - device_ms / wall_ms,
          "launches_per_iter": launches / BA_ITERS, "sync_calls_in_profile": syncs,
          "cpu_first_costs_max_rel_diff": first_rel, "cpu_final_cost_rel_diff": final_rel,
          "cpu_state_max_abs_diff": state_err, "tolerances": BA_TOL,
          "window": {"kernel_launches": window_launches, "landmarks_kept": n_landmarks,
                     "costs_first_last": [float(w_costs[0]), float(w_costs[-1])]}})
    check(costs[-1] <= 0.02 * start_cost, f"ba: final cost {costs[-1]} > 2% of {start_cost}")
    check(torch.equal(state.R[:2], R0[:2]) and torch.equal(state.t[:2], t0[:2]),
          "ba: a fixed pose moved")
    check(first_rel <= BA_TOL["costs_rtol"] and final_rel <= BA_TOL["final_cost_rtol"]
          and state_err <= BA_TOL["state_atol"],
          f"ba: the card differs from the CPU: costs {first_rel} / {final_rel}, state {state_err}")
    check(window_launches == BA_POSES - 1, f"ba: {window_launches} launches for a window of {BA_POSES}")
    noise_floor = BA_POSES * BA_LANDMARKS * 2 * 0.1**2  # chi^2 of the 0.1 px pixel noise
    check(n_landmarks >= 0.9 * BA_LANDMARKS and w_costs[-1] <= 2.0 * noise_floor,
          f"ba: the window kept {n_landmarks} landmarks, costs {w_costs[0]} -> {w_costs[-1]}")
    return window_launches


def phase_trajectory_ba(torch):
    """``tests/test_trajectory.py``'s BA gate on the card: the starved VO run,
    then ``refine_mono_trajectory`` with its BA config."""
    import numpy as np

    from ergo_uvo_tpu_torch.config import MonoVOConfig, SurfConfig
    from ergo_uvo_tpu_torch.eval import ate_rmse
    from ergo_uvo_tpu_torch.io import make_mono_sequence
    from ergo_uvo_tpu_torch.optim import integrate_mono_poses, refine_mono_trajectory
    from ergo_uvo_tpu_torch.pipeline import run_mono_vo

    cfg_vo = MonoVOConfig(surf=SurfConfig(min_hessian=150.0), max_keypoints=96, num_hypotheses=16)
    cfg_ba = MonoVOConfig(surf=SurfConfig(min_hessian=60.0), max_keypoints=256, num_hypotheses=16)
    seq = make_mono_sequence(n_frames=36, height=240, width=320, dt=0.25, seed=5, speed=0.5)
    gen = torch.Generator(device="cuda").manual_seed(0)
    _zero_counts()
    _, outs = run_mono_vo(seq.imgs_left, seq.timestamps, seq.ranges, seq.K, cfg_vo, gen)
    vo_launches = _read_counts("trajectory_ba_vo")
    outs = type(outs)(*(x.cpu().numpy() for x in outs))
    _, _, raw = integrate_mono_poses(outs.velocity, outs.R, seq.timestamps, outs.published)
    gt = seq.positions - seq.positions[0]

    _zero_counts()
    t0 = time.perf_counter()
    res = refine_mono_trajectory(seq.imgs_left, seq.timestamps, outs, seq.K, cfg_ba,
                                 window_size=6, keyframe_stride=2, ba_iters=12)
    seconds = time.perf_counter() - t0
    launches = _read_counts("trajectory_ba")
    ate_raw, ate_ba = ate_rmse(raw, gt), ate_rmse(res.positions, gt)
    diffs = np.diff(res.costs, axis=1)
    monotone = bool((diffs <= 1e-3 * np.abs(res.costs[:, :-1]) + 1e-5).all())
    emit({"phase": "trajectory_ba", "frames": 36, "height": 240, "width": 320,
          "window": 6, "keyframe_stride": 2, "ba_iters": 12,
          "vo_valid_share": float(outs.validity[1:].mean()), "vo_kernel_launches": vo_launches,
          "ate_raw_m": ate_raw, "ate_ba_m": ate_ba, "ate_ratio": ate_ba / ate_raw,
          "keyframes": int(len(res.kf_indices)), "solves": int(res.costs.shape[0]),
          "ba_iters_per_s": res.ba_iters_per_s, "seconds": seconds,
          "costs_first_last": [[float(c[0]), float(c[-1])] for c in res.costs],
          "kernel_launches": launches, "costs_non_increasing": monotone})
    check(ate_ba < 0.7 * ate_raw, f"trajectory_ba: ATE {ate_ba} not below 0.7 x {ate_raw}")
    check(monotone, "trajectory_ba: a cost curve increases")
    check(launches == 5 * res.costs.shape[0],
          f"trajectory_ba: {launches} launches for {res.costs.shape[0]} windows of 6")
    return launches


def phase_loop_closure(torch):
    """``tests/test_trajectory.py``'s loop gate on the card:
    ``close_loops_and_optimize`` on the loop fixture with injected drift."""
    import numpy as np

    from ergo_uvo_tpu_torch.config import MonoVOConfig, SurfConfig
    from ergo_uvo_tpu_torch.io import make_loop_sequence
    from ergo_uvo_tpu_torch.optim import trajectory

    cfg = MonoVOConfig(surf=SurfConfig(min_hessian=60.0), max_keypoints=256, num_hypotheses=256)
    seq = make_loop_sequence(n_frames=20, height=240, width=320, seed=2)
    T = len(seq.imgs_left)
    rng = np.random.default_rng(0)
    step = np.linalg.norm(np.diff(seq.positions, axis=0), axis=-1).mean()
    d = rng.standard_normal(3)
    d /= np.linalg.norm(d)
    pos_drift = seq.positions + np.outer(np.arange(T), d) * (0.06 * step)
    t_drift = -np.einsum("tij,tj->ti", seq.rotations, pos_drift)
    before = float(np.linalg.norm(pos_drift[-1] - seq.positions[-1]))

    verified = []
    real_verify = trajectory.verify_loop_candidate

    def watched_verify(*args, **kwargs):
        verified.append(1)
        return real_verify(*args, **kwargs)

    trajectory.verify_loop_candidate = watched_verify
    _zero_counts()
    try:
        t0 = time.perf_counter()
        res = trajectory.close_loops_and_optimize(
            seq.imgs_left, seq.rotations, t_drift, seq.ranges, seq.K, cfg,
            min_gap=12, top_k=6, min_similarity=0.8, iters=25)
        seconds = time.perf_counter() - t0
    finally:
        trajectory.verify_loop_candidate = real_verify
    launches = _read_counts("loop_closure")
    after = float(np.linalg.norm((res.positions[-1] - res.positions[0])
                                 - (seq.positions[-1] - seq.positions[0])))
    # The pose graph's scatter-adds are atomic adds in no fixed order on the
    # card: two runs of the same graph, and the CPU's, agree to the tests'
    # 1e-3 (tests/test_torch_trajectory.py::test_optimize_with_loops_matches_jax).
    graph_runs = [trajectory._optimize_with_loops(seq.rotations, t_drift, res.loops, 10.0, 25, dev)
                  for dev in (torch.device("cuda"), torch.device("cuda"), torch.device("cpu"))]
    rerun_diff = float(np.abs(graph_runs[0].positions - graph_runs[1].positions).max())
    cpu_diff = float(np.abs(graph_runs[0].positions - graph_runs[2].positions).max())
    emit({"phase": "loop_closure", "frames": T, "height": 240, "width": 320,
          "candidates_verified": len(verified),
          "loops": [[lp.i, lp.j, lp.num_inliers] for lp in res.loops],
          "endpoint_error_before_m": before, "endpoint_error_after_m": after,
          "pose_graph_costs_first_last": [float(res.costs[0]), float(res.costs[-1])],
          "pose_graph_rerun_max_abs_diff_m": rerun_diff, "pose_graph_cpu_max_abs_diff_m": cpu_diff,
          "seconds": seconds, "kernel_launches": launches})
    check(any(lp.j - lp.i >= 12 for lp in res.loops), f"loop_closure: loops {res.loops}")
    check(rerun_diff <= 1e-3 and cpu_diff <= 1e-3,
          f"loop_closure: pose graph reruns differ by {rerun_diff} m, from the CPU by {cpu_diff} m")
    check(after < before / 5.0, f"loop_closure: endpoint error {before} -> {after}")
    check(launches == len(verified) > 0,
          f"loop_closure: {launches} launches for {len(verified)} candidates")
    return launches


# The distributed layer on the card: a world of 1 on NCCL (one card).
DIST_BA_POSES, DIST_BA_LANDMARKS = 8, 16384  # tools/bench_scaling_2proc.py's make_problem(8, 16384)
DIST_BA_TOL = {"costs_rtol": 1e-4, "state_atol": 2e-3}
DIST_VO_STREAMS, DIST_VO_FRAMES, DIST_VO_SEED = 4, 12, 0


def _nccl_world_of_one(torch):
    """Start a world of 1 on NCCL over ``tcp://localhost:<a free port>``; the card's device."""
    import socket
    from datetime import timedelta

    from ergo_uvo_tpu_torch.dist import init_world

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    return init_world(0, 1, init_method=f"tcp://localhost:{port}", timeout=timedelta(seconds=120))


def phase_dist_ba(torch):
    """Landmark-sharded BA on a 1-D mesh and window BA on a (1, 1) mesh, on
    NCCL, each against ``ba_solve`` on the same card arrays."""
    import numpy as np
    import torch.distributed as dist

    from ergo_uvo_tpu_torch.dist import (
        make_mesh,
        make_mesh_2d,
        sharded_ba_solve,
        window_sharded_ba_solve,
    )
    from ergo_uvo_tpu_torch.optim.ba import BAProblem, ba_solve, reprojection_residuals

    dev = _nccl_world_of_one(torch)
    P, L = DIST_BA_POSES, DIST_BA_LANDMARKS
    K, obs, Rs, ts, X0, _ = _ba_scene(np, P, L)
    Kd, obs_d, R0, t0, Xd = (torch.as_tensor(a).to(dev) for a in (K, obs, Rs, ts, X0))
    mask = torch.ones((P, L), dtype=torch.bool, device=dev)
    mesh, mesh2 = make_mesh(), make_mesh_2d(1, 1)  # device=None: the card
    check(dist.get_backend() == "nccl" and mesh.device_type == "cuda", "dist_ba: not an NCCL mesh")
    solvers = {
        "sharded": lambda n: sharded_ba_solve(mesh, Kd, obs_d, mask, R0, t0, Xd, iters=n,
                                              num_fixed=2),
        "window": lambda n: window_sharded_ba_solve(mesh2, Kd, obs_d, mask, R0, t0, Xd, iters=n,
                                                    num_fixed=2),
        "ba_solve": lambda n: ba_solve(BAProblem(Kd, obs_d, mask, 2), R0, t0, Xd, iters=n),
    }
    for solve in solvers.values():  # the communicator, cuSOLVER: outside every check and timing
        solve(2)
    torch.cuda.synchronize()

    reduces = []
    real_all_reduce = dist.all_reduce

    def counted_all_reduce(*args, **kwargs):
        reduces.append(1)
        return real_all_reduce(*args, **kwargs)

    _zero_counts()
    dist.all_reduce = counted_all_reduce
    torch.cuda.set_sync_debug_mode("error")
    try:
        results = {}
        for name, solve in solvers.items():
            del reduces[:]
            results[name] = (solve(BA_ITERS), len(reduces))
    finally:
        torch.cuda.set_sync_debug_mode(0)
        dist.all_reduce = real_all_reduce
    torch.cuda.synchronize()
    launches = _read_counts("dist_ba")

    r, _, _ = reprojection_residuals(Kd, R0, t0, Xd, obs_d, mask)
    start_cost = float((r * r).sum())
    (ref_state, ref_costs), _ = results["ba_solve"]
    ref = [x.cpu() for x in ref_state[:3]]
    ref_costs = ref_costs.cpu()
    line = {"phase": "dist_ba", "world_size": dist.get_world_size(), "backend": dist.get_backend(),
            "poses": P, "landmarks": L, "num_fixed_poses": 2, "iters": BA_ITERS,
            "start_cost": start_cost, "no_host_sync": True, "kernel_launches": launches,
            "tolerances": DIST_BA_TOL, "slope_iters": [BA_ITERS, BA_ITERS_HI]}
    for name, solve in solvers.items():
        (state, costs), n_reduce = results[name]
        state, costs = [x.cpu() for x in state[:3]], costs.cpu()

        def seconds(n):
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            solve(n)
            torch.cuda.synchronize()
            return time.perf_counter() - t_start

        t_lo = min(seconds(BA_ITERS) for _ in range(2))
        t_hi = min(seconds(BA_ITERS_HI) for _ in range(2))
        wall_ms, device_ms, n_launch, syncs = _profile_launches(torch, lambda: solve(BA_ITERS))
        line[name] = {
            "costs_first_last": [float(costs[0]), float(costs[-1])],
            "costs_max_rel_diff": float(((costs - ref_costs).abs() / ref_costs).max()),
            "state_max_abs_diff": max(float((a - b).abs().max()) for a, b in zip(state, ref)),
            "all_reduces_per_iter": n_reduce / BA_ITERS,
            "lm_iters_per_s": (BA_ITERS_HI - BA_ITERS) / (t_hi - t_lo),
            "seconds_lo_hi": [t_lo, t_hi], "profiled_wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": 1.0 - device_ms / wall_ms,
            "launches_per_iter": n_launch / BA_ITERS, "sync_calls_in_profile": syncs}
    # One NCCL all_reduce of the sharded step's packed buffer: H_pp, b_p,
    # S_corr, rhs_corr and the cost.
    packed = torch.zeros(P * 36 + P * 6 + P * P * 36 + P * 6 + 1, device=dev)
    line["packed_all_reduce"] = {"floats": packed.numel(),
                                 "ms": _time_ms(torch, lambda: dist.all_reduce(packed))}
    dist.destroy_process_group()
    emit(line)
    for name in ("sharded", "window"):
        got = line[name]
        check(got["costs_max_rel_diff"] <= DIST_BA_TOL["costs_rtol"]
              and got["state_max_abs_diff"] <= DIST_BA_TOL["state_atol"],
              f"dist_ba: {name} differs from ba_solve: costs {got['costs_max_rel_diff']}, "
              f"state {got['state_max_abs_diff']}")
        check(got["costs_first_last"][1] < 0.02 * start_cost,
              f"dist_ba: {name} final cost {got['costs_first_last'][1]} >= 2% of {start_cost}")
    check(line["sharded"]["all_reduces_per_iter"] == 2,
          f"dist_ba: {line['sharded']['all_reduces_per_iter']} all_reduce calls an iteration")
    check(launches == 0, f"dist_ba: the top-2 kernel launched {launches} times")
    return launches


def phase_dist_vo(torch):
    """``run_mono_vo_batch`` on 4 streams of 12 frames of 640x480 (the main
    path's config) over a 1-D NCCL mesh, fed by ``shard_frame_batches``; each
    stream against ``run_mono_vo`` with generator seed ``seed + b``."""
    import numpy as np
    import torch.distributed as dist

    from ergo_uvo_tpu_torch.dist import make_mesh, run_mono_vo_batch, shard_frame_batches
    from ergo_uvo_tpu_torch.io import make_mono_sequence
    from ergo_uvo_tpu_torch.io.sequence import ArraySource
    from ergo_uvo_tpu_torch.pipeline.mono import run_mono_vo

    dev = _nccl_world_of_one(torch)
    B, T = DIST_VO_STREAMS, DIST_VO_FRAMES
    seqs = [make_mono_sequence(n_frames=T, height=480, width=640, dt=0.05, seed=s)
            for s in range(1, B + 1)]
    cfg = _main_path_config()
    # Global batch t holds frame t of every stream.
    flat = [np.stack([getattr(q, f) for q in seqs], 1).reshape(B * T, *getattr(seqs[0], f).shape[1:])
            for f in ("imgs_left", "timestamps", "ranges")]
    mesh = make_mesh()
    batches = list(shard_frame_batches(ArraySource(flat[0], flat[1], ranges=flat[2]), mesh, B))
    imgs, tss, rgs = (torch.stack([b[i] for b in batches], 1) for i in range(3))
    check(imgs.is_cuda and imgs.shape == (B, T, 480, 640), f"dist_vo: ingested {tuple(imgs.shape)}")

    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    state, outs = run_mono_vo_batch(mesh, imgs, tss, rgs, seqs[0].K, cfg, seed=DIST_VO_SEED,
                                    local=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read_counts("dist_vo")

    equal, streams, sq_errs = [], [], []
    for b, seq in enumerate(seqs):
        gen = torch.Generator(dev).manual_seed(DIST_VO_SEED + b)
        ref_state, ref_outs = run_mono_vo(seq.imgs_left, seq.timestamps, seq.ranges, seq.K, cfg, gen)
        equal.append(all(torch.equal(getattr(outs, f)[b], getattr(ref_outs, f)) for f in outs._fields)
                     and all(torch.equal(getattr(state, f)[b], getattr(ref_state, f))
                             for f in state._fields))
        host = {f: getattr(outs, f)[b].cpu().numpy() for f in ("velocity", "validity", "published")}
        rmse, speed = _velocity_check(np, host, seq.velocities_prevcam, None)
        val = host["validity"]
        sq_errs.append(((host["velocity"][val].astype(np.float64) - seq.velocities_prevcam[val])**2)
                       .sum(-1))
        streams.append({"seed": b + 1, "valid_share": float(host["validity"][1:].mean()),
                        "velocity_rmse": rmse, "mean_gt_speed": speed,
                        "published": host["published"].astype(int).tolist(),
                        "finite": bool(np.isfinite(host["velocity"]).all())})
    # The batch's velocity RMSE over every stream's valid frames: one stream
    # of 12 frames misses the slice's bound on its own (seed 2; PERF.md,
    # section 6), as run_mono_vo does on it bit for bit.
    pooled = float(np.sqrt(np.concatenate(sq_errs).mean()))
    dist.destroy_process_group()
    emit({"phase": "dist_vo", "world_size": 1, "backend": "nccl", "streams": B, "frames": T,
          "height": 480, "width": 640, "max_keypoints": 512, "num_hypotheses": cfg.num_hypotheses,
          "seed": DIST_VO_SEED, "kernel_launches": launches,
          "frames_per_second": B * T / seconds, "ms_per_frame": 1e3 * seconds / (B * T),
          "seconds": seconds, "streams_equal_run_mono_vo": equal, "per_stream": streams,
          "velocity_rmse_all_streams": pooled, "valid_min": 0.7, "rmse_bound_x_speed": 0.35})
    check(all(equal), f"dist_vo: streams equal to run_mono_vo: {equal}")
    check(launches == B * T, f"dist_vo: {launches} kernel launches for {B * T} frames")
    for st in streams:
        check(st["finite"] and not st["published"][0] and all(st["published"][1:]),
              f"dist_vo: stream {st['seed']} published {st['published']}")
        check(st["valid_share"] >= 0.7, f"dist_vo: stream {st['seed']} valid on {st['valid_share']}")
    speed = float(np.mean([st["mean_gt_speed"] for st in streams]))
    check(pooled < 0.35 * speed, f"dist_vo: velocity RMSE {pooled} over the streams >= 0.35 x {speed}")
    return launches


def main() -> int:
    if not (ROOT / "ergo_uvo_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: ergo_uvo_tpu_torch/ not found beside this script; "
              "run it from the root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    smi = phase_device(torch)
    import ergo_uvo_tpu_torch  # noqa: F401  (pins TF32 off before any kernel)

    phase_build()
    max_err, timings = phase_kernel(torch)
    main_shape = timings[MAIN_SHAPE]
    jacobi_err, jacobi_timings = phase_jacobi(torch)
    seq = _mono_sequence()
    launches, slice_outs = phase_slice(torch, seq)
    phase_mono_stages(torch, seq)
    plan, frames = phase_preprocess(torch, seq)
    preprocessed_launches, lens = phase_slice_preprocessed(torch, seq, plan, frames)
    paths = {"slice": launches,
             "slice_preprocessed": preprocessed_launches,
             "slice_batched": phase_slice_batched(torch, seq, slice_outs),
             "slice_stereo": phase_slice_stereo(torch),
             "parity_mono": phase_parity(torch, "mono"),
             "parity_stereo": phase_parity(torch, "stereo"),
             "stream_mono": phase_stream_mono(torch, lens),
             "stream_stereo": phase_stream_stereo(torch),
             "cli_mono": phase_cli(torch, "mono"),
             "cli_stereo": phase_cli(torch, "stereo")}
    phase_plain_jacobi(torch, seq)
    frames_by_path = {"slice": N_FRAMES, "slice_preprocessed": N_FRAMES, "slice_batched": N_BATCHED,
                      "slice_stereo": N_FRAMES, "parity_mono": PARITY_FRAMES,
                      "parity_stereo": PARITY_FRAMES, "stream_mono": N_FRAMES,
                      "stream_stereo": N_FRAMES, "cli_mono": N_FRAMES, "cli_stereo": N_FRAMES}
    for det in ("SIFT", "ORB", "AKAZE"):
        paths[f"slice_{det.lower()}"] = phase_slice_detector(torch, seq, det)
        frames_by_path[f"slice_{det.lower()}"] = N_FRAMES
    for stereo, name in ((False, "accuracy_sift"), (True, "accuracy_stereo_sift")):
        paths[name], frames_by_path[name] = phase_accuracy(torch, stereo)
    paths["cli_mono_sift"] = phase_cli(torch, "mono_sift")
    frames_by_path["cli_mono_sift"] = N_FRAMES
    # The optimization layers: launches per frame there are per window
    # member (ba, trajectory_ba), per candidate (loop_closure) or per frame
    # of the whole CLI run (VO, BA and loop closure).
    paths["ba"], frames_by_path["ba"] = phase_ba(torch), BA_POSES
    paths["trajectory_ba"], frames_by_path["trajectory_ba"] = phase_trajectory_ba(torch), 36
    paths["loop_closure"], frames_by_path["loop_closure"] = phase_loop_closure(torch), 20
    for mode in ("mono", "stereo"):
        paths[f"cli_{mode}_opt"] = phase_cli(torch, mode, opt=True)
        frames_by_path[f"cli_{mode}_opt"] = N_FRAMES
    # The distributed layer: BA launches no kernel (counted, 0); the batch
    # runner once a frame of every stream.
    paths["dist_ba"], frames_by_path["dist_ba"] = phase_dist_ba(torch), DIST_BA_POSES
    paths["dist_vo"] = phase_dist_vo(torch)
    frames_by_path["dist_vo"] = DIST_VO_STREAMS * DIST_VO_FRAMES
    check(all(n > 0 for k, n in paths.items() if k != "dist_ba"),
          f"a path launched the kernel no time: {paths}")
    # Window BA and the BA of the trajectory run no pose solver.
    jacobi_paths = {k: JACOBI_BY_PATH[k] for k in paths}
    check(all(n > 0 for k, n in jacobi_paths.items() if k not in ("ba", "trajectory_ba", "dist_ba")),
          f"a path launched the Jacobi kernel no time: {jacobi_paths}")
    jacobi_main = jacobi_timings[JACOBI_MAIN]
    print(smi, flush=True)  # the card again, beside the summary at the end of the output
    emit({"kernels": [{"name": "top2_distances", "route": "cuda", "source": KERNEL_SOURCE,
                       "replaces": KERNEL_REPLACES, "launches": launches,
                       "launches_per_frame": launches / N_FRAMES,
                       "launches_by_path": paths,
                       "launches_per_frame_by_path": {k: n / frames_by_path[k]
                                                      for k, n in paths.items()},
                       "max_abs_err": max_err,
                       **{k: main_shape[k] for k in (
                           "shape", "ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms",
                           "bound_by", "library", "library_ms", "library_device_ms")},
                       "by_shape": {name: {k: row[k] for k in (
                           "ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
                           "library_device_ms", "bound_ms", "bound_by")}
                           for name, row in timings.items()}},
                      {"name": "jacobi_eigh", "route": "cuda", "source": JACOBI_SOURCE,
                       "replaces": JACOBI_REPLACES, "launches": JACOBI_BY_PATH["slice"],
                       "launches_per_frame": JACOBI_BY_PATH["slice"] / N_FRAMES,
                       "launches_by_path": jacobi_paths,
                       "launches_per_frame_by_path": {k: n / frames_by_path[k]
                                                      for k, n in jacobi_paths.items()},
                       "max_abs_err": jacobi_err,
                       **{k: jacobi_main[k] for k in (
                           "shape", "ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms",
                           "bound_by", "library", "library_ms", "library_device_ms",
                           "cycles_per_rotation")},
                       "by_shape": {name: {k: row[k] for k in (
                           "ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
                           "library_device_ms", "bound_ms", "bound_by", "cycles_per_rotation")}
                           for name, row in jacobi_timings.items()}}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
