"""One run of one cell: set-up, the measured window, the traced stretch, the check.

A run drives the port's own served path, the streaming runner of the cell's
pipeline with the traffic's ``chunk_size`` (1 where the mix sets none): a
chunk of frames in, one upload, one ``preprocess_frame``, a step a frame,
one read-back; at 1, as a live node does.  The chunks come from
:class:`ClosedLoop`, which hands in the next chunk only after the runner's
``chunk_callback`` has delivered the previous chunk's outputs to the host: a
closed loop with one stream.  A frame's latency runs from its chunk's
hand-in to that callback.  The loop stops handing in chunks when the
window's time is up; where the window outlasts a pass of the stream, a new
pass starts from a fresh state.

With ``trace`` on, the window runs with every per-layer metric's spans timed,
then a stretch of consecutive frames (the mix's ``profiled_frames``) runs
under ``torch.profiler`` with the spans recording shapes only.
"""

from __future__ import annotations

import json
import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from uvo_bench import judge, scene
from uvo_bench.sources import ClosedLoop
from uvo_bench.spans import OFF, SHAPES, TIMED, Spans
from uvo_bench.spec import ROOT, Cell, load_module
from uvo_bench.devtrace import reduce_profile

TRACE_DIR = ROOT / "build" / "uvo_bench"


def _stream_window(runner, stream, generator, log, deadline):
    """Passes of the closed loop until ``deadline``; returns (state, pass id,
    next frame) of the last pass, for the stretch that may follow."""
    pass_id, state, source = 0, None, None
    while time.perf_counter() < deadline:
        source = ClosedLoop(stream, pass_id, 0, generator, log, runner.frame_batch, deadline)
        state = runner.run(source, generator, source.callback)
        if not source.exhausted:
            break
        pass_id += 1
    return state, pass_id, source.next


def _merged(base: dict, changes: dict) -> dict:
    out = dict(base)
    for key, value in changes.items():
        out[key] = _merged(out[key], value) if isinstance(value, dict) else value
    return out


def _percentile(values, q):
    return float(np.percentile(np.asarray(values, np.float64), q))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_process: float,
             device: str = "cuda", control: bool = False, overrides: dict | None = None,
             log_fn=print):
    """One run; returns the result's dict (without the chip checks of ``run.py``).

    ``overrides`` (``{"config": {...}, "traffic": {...}}``) replaces values of
    the cell's files, nested groups key by key (the CPU tests run a small
    frame); ``control`` judges the plain reference computed in TF32
    in the program's place.
    """
    parts = {"import_s": time.perf_counter() - t_process}
    t = time.perf_counter()
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
    parts["cuda_context_s"] = time.perf_counter() - t

    overrides = overrides or {}
    config = _merged(cell.config, overrides.get("config", {}))
    traffic = _merged(cell.traffic, overrides.get("traffic", {}))
    pipeline = load_module("pipelines", config["pipeline"])

    t = time.perf_counter()
    parts.update(pipeline.load_kernels(device))
    parts["kernels_s"] = time.perf_counter() - t

    t = time.perf_counter()
    stream = scene.make_stream(config["camera"], traffic, config.get("stereo_baseline"), seed,
                               device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    parts["render_s"] = time.perf_counter() - t

    t = time.perf_counter()
    runner = pipeline.Runner(config, traffic, stream, device)
    parts["plan_s"] = time.perf_counter() - t

    readers = {}
    spans = Spans(device)
    if trace:
        for m in cell.per_layer:
            readers[m["name"]] = load_module("metrics", m["name"])
        targets: dict = {}
        shape_fns: dict = {}
        for r in readers.values():
            for label, ts in getattr(r, "SPANS", {}).items():
                targets.setdefault(label, [])
                targets[label] += [x for x in ts if x not in targets[label]]
            shape_fns.update(getattr(r, "SHAPES", {}))
        spans.install(targets, shape_fns)

    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    warm_gen = torch.Generator(device=device)
    warm_gen.manual_seed(seed ^ 0x5EED)
    parts["warm_frames_s"] = runner.warm(warm_gen)
    if trace:
        # The profiler's own first start (CUPTI) is set-up, not the stretch's.
        with torch.profiler.profile(activities=_activities(device)):
            runner.warm(warm_gen, frames=1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    parts["warm_s"] = time.perf_counter() - t

    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    log: list[dict] = []
    spans.mode = TIMED if trace else OFF
    t_window = time.perf_counter()
    parts["total_s"] = t_window - t_process
    log_fn(json.dumps({"setup_parts": parts}), flush=True)
    deadline = t_window + seconds
    state, pass_id, nxt = _stream_window(runner, stream, generator, log, deadline)
    t_closed = time.perf_counter()
    window = list(log)

    reduced, stretch = None, None
    if trace:
        n = traffic["profiled_frames"]
        if nxt + n > len(stream.left):
            state, pass_id, nxt = None, pass_id + 1, 0
        spans.mode = SHAPES
        stretch_log: list[dict] = []
        source = ClosedLoop(stream, pass_id, nxt, generator, stretch_log, runner.frame_batch,
                            count=n)
        with torch.profiler.profile(activities=_activities(device)) as prof:
            t0 = time.perf_counter()
            runner.run(source, generator, source.callback, state=state)
            t1 = time.perf_counter()
        spans.mode = OFF
        t = time.perf_counter()
        reduced = reduce_profile(prof)
        log_fn(json.dumps({"trace_reduce_s": time.perf_counter() - t,
                           "stretch_frames": n}), flush=True)
        del prof
        stretch = SimpleNamespace(frames=len(stretch_log), window_s=t1 - t0)
    spans.remove()
    state = None

    memory_peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)

    # ---- the end-to-end numbers of the window
    lat = [r["t_out"] - r["t_in"] for r in window if r["t_out"] is not None]
    done_in_window = sum(1 for r in window if r["t_out"] is not None and r["t_out"] <= deadline)
    failed = sum(1 for r in window
                 if r["out"] is None or not np.all(np.isfinite(r["out"]["velocity"])))
    passes = 1 + max((r["pass"] for r in window), default=0)
    e2e = {
        "frames_per_s": done_in_window / seconds,
        "frame_ms_p95": 1e3 * _percentile(lat, 95) if lat else math.inf,
        "setup_s": parts["total_s"],
    }
    log_fn(json.dumps({"window": {"frames": len(window), "done_in_window": done_in_window,
                                  "passes": passes, "restarts": passes - 1,
                                  "closed_s": t_closed - t_window,
                                  "frame_ms_p50": 1e3 * _percentile(lat, 50) if lat else None,
                                  "frame_ms_max": 1e3 * max(lat) if lat else None,
                                  **getattr(pipeline, "summary", lambda w, c: {})(window, config)}}),
           flush=True)

    # ---- the check against the plain reference, on a sample of the window
    t = time.perf_counter()
    numbers = runner.check(window, seed, control)
    log_fn(json.dumps({"check_s": time.perf_counter() - t, "numbers": numbers}), flush=True)
    limits = config["limits"]
    correct = judge.verdict(numbers, limits)

    result = {"correct": bool(correct), "attempted": len(window), "failed": failed}
    if trace:
        run = SimpleNamespace(spans=spans, frames=len(window), window=window,
                              trace=reduced, stretch=stretch, config=config, traffic=traffic)
        metrics = {}
        for m in cell.per_layer:
            value = readers[m["name"]].read(run)
            if value is None:
                raise RuntimeError(f"per-layer metric {m['name']}: its reader found nothing to "
                                   f"read in {cell.workload['name']}, which BENCHMARK.json lists")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = device_info(device, cell.workload["chips"], memory_peak)
    if trace:
        result["device"]["busy_s"] = reduced.busy_s
        result["device"]["window_s"] = stretch.window_s
        result["breakdown"] = {"device_ops": reduced.device_ops, "idle_gaps": reduced.idle_gaps}
        TRACE_DIR.mkdir(parents=True, exist_ok=True)
        with open(TRACE_DIR / f"{cell.workload['name']}.trace.json", "w") as f:
            json.dump({"frames": stretch.frames, "window_s": stretch.window_s,
                       "busy_s": reduced.busy_s, "launches": reduced.launches,
                       "kernels": sorted(reduced.kernel_s.items(), key=lambda kv: -kv[1])[:50],
                       "idle_gaps": reduced.idle_gaps}, f)
    result["compared"] = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    return result


def _activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def device_info(device, chips: int, memory_peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(memory_peak)}
