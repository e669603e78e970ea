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
   the main path's shape and the contract shapes and edge cases, and both
   times at 512x512x64: per call between CUDA events (median of 100 calls
   after 10 warm-ups) and the device time of the call's kernels under
   torch.profiler (mean of 20 calls);
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
    ptxas = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
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
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    check(us > 0, "torch.profiler recorded no device time")
    return us / 1e3 / runs


def phase_kernel(torch):
    from ergo_uvo_tpu_torch.features import top2_matcher

    dev = torch.device("cuda")
    cases = []
    for q, t, d in [(512, 512, 64), (37, 91, 64), (384, 200, 64), (8, 3, 128), (256, 512, 48)]:
        mt = torch.ones(t, dtype=torch.bool, device=dev)
        mt[::5] = False  # every 5th column masked
        cases.append((f"{q}x{t}x{d}", _unit(torch, q, d, q, dev), _unit(torch, t, d, t + 1, dev), mt))
    dq = _unit(torch, 512, 64, 7, dev)
    dt = _unit(torch, 512, 64, 8, dev)
    cases.append(("all_masked", dq, dt, torch.zeros(512, dtype=torch.bool, device=dev)))
    cases.append(("T=1", dq, dt[:1].contiguous(), torch.ones(1, dtype=torch.bool, device=dev)))
    cases.append(("duplicate_rows", dq, torch.cat([dq[:256], dq[:256]]),
                  torch.ones(512, dtype=torch.bool, device=dev)))

    max_err = 0.0
    results = []
    for name, q, t, m in cases:
        k1, ki, k2 = top2_matcher.top2_distances(q, t, m)
        r1, ri, r2 = top2_matcher.top2_distances_reference(q, t, m)
        torch.cuda.synchronize()
        # idx exact except where the best and second-best tie within 1e-5.
        tie = (r2 - r1).abs() <= 1e-5 * torch.clamp(r1.abs(), min=1.0)
        idx_ok = bool(((ki == ri) | tie).all())
        errs = []
        for k, r in ((k1, r1), (k2, r2)):
            same_inf = torch.equal(torch.isinf(k), torch.isinf(r))
            check(same_inf, f"{name}: +inf pattern differs")
            fin = torch.isfinite(r)
            errs.append(float((k[fin] - r[fin]).abs().max()) if bool(fin.any()) else 0.0)
        err = max(errs)
        max_err = max(max_err, err)
        results.append({"case": name, "idx_ok": idx_ok, "max_abs_err": err})
        check(idx_ok, f"{name}: idx1 differs from the plain version off ties")
        check(err <= 1e-3, f"{name}: distance error {err} > 1e-3")

    q, t, m = cases[0][1:]
    ms = _time_ms(torch, lambda: top2_matcher.top2_distances(q, t, m))
    plain_ms = _time_ms(torch, lambda: top2_matcher.top2_distances_reference(q, t, m))
    device_ms = _device_ms(torch, lambda: top2_matcher.top2_distances(q, t, m))
    plain_device_ms = _device_ms(torch, lambda: top2_matcher.top2_distances_reference(q, t, m))
    emit({"phase": "kernel", "cases": results, "max_abs_err": max_err,
          "shape": "512x512x64", "ms": ms, "plain_ms": plain_ms,
          "device_ms": device_ms, "plain_device_ms": plain_device_ms})
    return max_err, ms, plain_ms


def phase_slice(torch):
    import numpy as np

    from ergo_uvo_tpu_torch.config import MonoVOConfig, SurfConfig
    from ergo_uvo_tpu_torch.features import top2_matcher
    from ergo_uvo_tpu_torch.io import make_mono_sequence
    from ergo_uvo_tpu_torch.pipeline import run_mono_vo

    dev = torch.device("cuda")
    cfg = MonoVOConfig(surf=SurfConfig(min_hessian=60.0), max_keypoints=512, num_hypotheses=512)
    seq = make_mono_sequence(n_frames=N_FRAMES, height=480, width=640, dt=0.05, seed=1)
    imgs = torch.from_numpy(seq.imgs_left).to(dev)
    ts = torch.from_numpy(seq.timestamps).to(dev)
    rg = torch.from_numpy(seq.ranges).to(dev)
    K = torch.from_numpy(seq.K).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    top2_matcher.LAUNCHES = 0
    # Frames 0-1 (initialization and the first steady frame) untimed, then
    # frames 2..N-1 timed; the state and the generator carry over.
    state, head = run_mono_vo(imgs[:2], ts[:2], rg[:2], K, cfg, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, tail = run_mono_vo(imgs[2:], ts[2:], rg[2:], K, cfg, gen, state=state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = top2_matcher.LAUNCHES

    outs = {f: np.concatenate([getattr(head, f).cpu().numpy(), getattr(tail, f).cpu().numpy()])
            for f in head._fields}
    check(launches >= N_FRAMES - 1, f"kernel launched {launches} times in {N_FRAMES} frames")
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
    max_err, ms, plain_ms = phase_kernel(torch)
    launches = phase_slice(torch)
    emit({"kernels": [{"name": "top2_distances", "route": "cuda", "source": KERNEL_SOURCE,
                       "replaces": KERNEL_REPLACES, "launches": launches,
                       "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
