"""Reduction of a ``torch.profiler`` trace of the profiled stretch.

Device time is the union of the intervals in which an operation (kernel,
copy or fill) ran on the card, not their sum; launches are the
``cudaLaunchKernel*`` and ``cuLaunchKernel*`` calls.  The
idle gaps between device operations are summed by the innermost host
operation running at each gap's middle.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from typing import NamedTuple

from torch.autograd import DeviceType

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
TOP = 10  # entries of each breakdown list
NAME_CHARS = 160  # a kernel's name is cut to this many characters in the breakdown
BETWEEN = "(python between operations)"  # a gap that no host operation covers


class Reduced(NamedTuple):
    busy_s: float  # union of device operations
    launches: int
    kernel_s: dict  # kernel name -> summed device seconds
    device_ops: list  # [[name, seconds], ...] the device operations that took most time
    idle_gaps: list  # [[host operation, seconds], ...] idle time by what the host was doing


def _union(intervals):
    total, end = 0, None
    merged = []
    for s, e in sorted(intervals):
        if end is None or s > end:
            merged.append([s, e])
            end = e
        elif e > end:
            merged[-1][1] = e
            end = e
    for s, e in merged:
        total += e - s
    return total, merged


def _is_runtime(name: str) -> bool:
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def reduce_profile(prof) -> Reduced:
    events = prof.profiler.kineto_results.events()
    device, host = [], []
    kernel_ns: dict[str, int] = defaultdict(int)
    launches = 0
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            s, d = e.start_ns(), e.duration_ns()
            device.append((s, s + d))
            kernel_ns[name] += d
        elif name in LAUNCH_CALLS:
            launches += 1
        elif not _is_runtime(name) and not e.is_user_annotation():
            host.append((e.start_ns(), e.end_ns(), name))
    busy_ns, merged = _union(device)
    # Every gap, named by the shortest host operation that covers its middle:
    # a sweep over the middles in order, with a heap of the operations begun
    # so far keyed by length; one that has ended is dropped when it surfaces.
    mids = sorted(((merged[i][1] + merged[i + 1][0]) // 2, merged[i + 1][0] - merged[i][1])
                  for i in range(len(merged) - 1))
    host.sort()
    by_host: dict[str, int] = defaultdict(int)
    heap: list = []
    k = 0
    for mid, length in mids:
        while k < len(host) and host[k][0] <= mid:
            hs, he, name = host[k]
            heapq.heappush(heap, (he - hs, he, name))
            k += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        by_host[heap[0][2] if heap else BETWEEN] += length
    ops = sorted(kernel_ns.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return Reduced(
        busy_s=busy_ns * 1e-9,
        launches=launches,
        kernel_s={k: v * 1e-9 for k, v in kernel_ns.items()},
        device_ops=[[k[:NAME_CHARS], v * 1e-9] for k, v in ops],
        idle_gaps=[[k, v * 1e-9] for k, v in idle],
    )
