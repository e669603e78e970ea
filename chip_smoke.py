#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port of the mono UVO main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX or of
``ergo_uvo_tpu``; every check that fails raises, so any failure exits
non-zero.  Four phases, one JSON line each:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build: nvcc builds ``ergo_uvo_tpu_torch/csrc/top2_distances.cu`` from the
   checkout's sources into ``build/`` (seconds, ptxas register report);
3. kernel: the top-2 kernel against its plain PyTorch version on the card at
   the main path's shape, the contract shapes and the edge cases (empty and
   masked slices, duplicates across cluster ranks, a depth that is no
   multiple of 4), each also under every cluster size; then
   at 512x512x64, 2048x2048x64 and 4096x4096x128, every train row valid, the
   time of the kernel, of the plain version and of the nearest library route (``torch.cdist`` then
   ``torch.topk``), per call between CUDA events (median of 100 calls after
   10 warm-ups) and as device time of the call's kernels under
   torch.profiler (mean of 20 calls), beside the card's bound for the shape;
4. slice: ``run_mono_vo`` on 24 synthetic 640x480 frames under the main
   path's config (SURF, 512 keypoints, 512 hypotheses, LMEDS), counting the
   kernel's launches, checking the outputs against ground truth, and timing
   frames 2..23.

Then the kernel summary line and, last, ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "ergo_uvo_tpu_torch/csrc/top2_distances.cu"
KERNEL_REPLACES = "ergo_uvo_tpu/features/pallas_matcher.py:83"
N_FRAMES = 24


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


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
    from ergo_uvo_tpu_torch.cuda_build import BUILD_INFO, load_library

    t0 = time.perf_counter()
    load_library("top2_distances")
    seconds = time.perf_counter() - t0
    nvcc_seconds, log = BUILD_INFO["top2_distances"]
    ptxas = [line.strip() for line in log.splitlines()
             if "registers" in line or "spill" in line or "Compiling entry" in line]
    emit({"phase": "build", "kernel": "top2_distances", "seconds": seconds,
          "nvcc_seconds": nvcc_seconds, "ptxas": ptxas})


def _unit(torch, n, d, seed, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(n, d, generator=g)
    return (x / x.norm(dim=-1, keepdim=True)).to(dev)


def _time_ms(torch, fn, warmup=10, runs=100):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    # Each kernel's mean time, times its launches per call: a trace that
    # lost some of a kernel's events still gives that kernel's share.
    us = sum(e.self_device_time_total / e.count * max(1, round(e.count / runs))
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation and e.count > 0)
    check(us > 0, "torch.profiler recorded no device time")
    return us / 1e3


# An H100 SXM's published peaks: fp32 FMA outside the tensor cores, device memory.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TIMED_SHAPES = [(512, 512, 64), (2048, 2048, 64), (4096, 4096, 128)]
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
    for q, t, d in shapes:
        mt = torch.ones(t, dtype=torch.bool, device=dev)
        mt[::5] = False  # every 5th column masked
        cases.append((f"{q}x{t}x{d}", _unit(torch, q, d, q, dev), _unit(torch, t, d, t + 1, dev), mt))
    # The three timed shapes once more with every train row valid: these are
    # the inputs that are timed, so that the kernel's work is the bound's work.
    timed = []
    for q, t, d in TIMED_SHAPES:
        timed.append((f"{q}x{t}x{d}", _unit(torch, q, d, q, dev), _unit(torch, t, d, t + 1, dev),
                      torch.ones(t, dtype=torch.bool, device=dev)))
    cases += [(name + "_all_valid", q, t, m) for name, q, t, m in timed]
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
    for (name, q, t, m), (nq, nt, nd) in zip(timed, TIMED_SHAPES):
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
        # Device time under every cluster size at this shape.
        row["cluster_device_ms"] = {
            str(s): _device_ms(torch, lambda s=s: top2_matcher.launch_forced(q, t, m, s), runs=10)
            for s in cluster_sizes}
        timings[name] = row
    main = timings[MAIN_SHAPE]
    check(main["device_ms"] < main["plain_device_ms"],
          f"kernel device time {main['device_ms']} ms is not below the plain version's "
          f"{main['plain_device_ms']} ms at {MAIN_SHAPE}")
    emit({"phase": "kernel", "cases": results, "max_abs_err": max_err,
          "timings": list(timings.values())})
    return max_err, main


def phase_slice(torch):
    import numpy as np

    from ergo_uvo_tpu_torch.config import MonoVOConfig, SurfConfig
    from ergo_uvo_tpu_torch.features import top2_matcher
    from ergo_uvo_tpu_torch.io import make_mono_sequence
    from ergo_uvo_tpu_torch.pipeline import run_mono_vo

    dev = torch.device("cuda")
    cfg = MonoVOConfig(surf=SurfConfig(min_hessian=60.0), max_keypoints=512, num_hypotheses=512)
    seq = make_mono_sequence(n_frames=N_FRAMES, height=480, width=640, dt=0.05, seed=1)
    imgs, ts, rg, K = seq.imgs_left, seq.timestamps, seq.ranges, seq.K
    gen = torch.Generator(device=dev).manual_seed(0)

    top2_matcher.LAUNCHES = 0
    # Frames 0-1 (initialization and the first steady frame) untimed, then
    # frames 2..N-1 timed; the state and the generator carry over.
    # The head call takes numpy arrays and names no device: the entry point
    # runs on the card by default.  The timed call's inputs lie on the card
    # before the clock starts, so the span holds no copy from the host.
    state, head = run_mono_vo(imgs[:2], ts[:2], rg[:2], K, cfg, gen)
    rest = [torch.as_tensor(x[2:]).to(dev) for x in (imgs, ts, rg)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, tail = run_mono_vo(*rest, K, cfg, gen, state=state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = top2_matcher.LAUNCHES

    outs = {f: np.concatenate([getattr(head, f).cpu().numpy(), getattr(tail, f).cpu().numpy()])
            for f in head._fields}
    check(launches >= N_FRAMES - 1, f"kernel launched {launches} times in {N_FRAMES} frames")
    check(all(x.is_cuda for x in tail), "run_mono_vo's outputs are not on the card")
    for f in ("velocity", "R", "t", "scale_factor", "median_disparity"):
        check(bool(np.isfinite(outs[f]).all()), f"{f} has non-finite values")
    check(outs["velocity"].shape == (N_FRAMES, 3), f"velocity shape {outs['velocity'].shape}")
    pub, val = outs["published"], outs["validity"]
    check(not pub[0] and bool(pub[1:].all()), f"published {pub.tolist()}")
    valid_share = float(val[1:].mean())
    check(valid_share >= 0.7, f"validity on {valid_share:.2f} of frames < 0.7")
    gt = seq.velocities_prevcam
    err = outs["velocity"][val].astype(np.float64) - gt[val]
    rmse = float(np.sqrt((err**2).sum(-1).mean()))
    speed = float(np.linalg.norm(gt[1:], axis=-1).mean())
    check(rmse < 0.35 * speed, f"velocity RMSE {rmse} >= 0.35 * mean speed {speed}")
    timed = N_FRAMES - 2
    emit({"phase": "slice", "frames": N_FRAMES, "height": 480, "width": 640,
          "max_keypoints": 512, "num_hypotheses": 512, "kernel_launches": launches,
          "launches_per_frame": launches / N_FRAMES,
          "frames_per_second": timed / seconds, "ms_per_frame": 1e3 * seconds / timed,
          "velocity_rmse": rmse, "mean_gt_speed": speed, "valid_share": valid_share,
          "published": pub.astype(int).tolist(), "validity": val.astype(int).tolist(),
          "used_essential": outs["used_essential"].astype(int).tolist(),
          "num_features": outs["num_features"].tolist(),
          "num_matches": outs["num_matches"].tolist(),
          "num_inliers": outs["num_inliers"].tolist(),
          "num_3d_points": outs["num_3d_points"].tolist()})
    return launches


def main() -> int:
    if not (ROOT / "ergo_uvo_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: ergo_uvo_tpu_torch/ not found beside this script; "
              "run it from the root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    phase_device(torch)
    import ergo_uvo_tpu_torch  # noqa: F401  (pins TF32 off before any kernel)

    phase_build()
    max_err, main_shape = phase_kernel(torch)
    launches = phase_slice(torch)
    emit({"kernels": [{"name": "top2_distances", "route": "cuda", "source": KERNEL_SOURCE,
                       "replaces": KERNEL_REPLACES, "launches": launches,
                       "launches_per_frame": launches / N_FRAMES, "max_abs_err": max_err,
                       **{k: main_shape[k] for k in (
                           "shape", "ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms",
                           "bound_by", "library", "library_ms", "library_device_ms")}}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
