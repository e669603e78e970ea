"""Spans and counters of the port: where a frame's host time goes, layer by layer.

A span names a stretch of host time in which one layer works::

    with span("match"):
        ...

Spans are off by default: :func:`span` is then one check of a module-level
flag and returns a shared no-op context, allocating and recording nothing.
:func:`recording` turns them on for the block it covers and yields a
:class:`Recording` that holds

  * for each span name: calls, total and self host ns (self: the span's
    duration less the part its child spans cover);
  * a ring of the last :data:`RING` root spans, each with every span under it
    as a :class:`SpanRecord`: name, id, parent, frame index, host start and
    end (``time.perf_counter_ns``);
  * the counters counted while it was on.

Every span of a frame carries that frame's index: the runners open ``step``
with the frame's global index and the spans under it inherit it; ``chunk``
holds the first frame of its chunk and the count.  Under a running
``torch.profiler`` a recorded span also opens a ``record_function`` range of
its name, so the span lies in the profiler's trace beside the operations it
issued, on the trace's own clock.

Counters (:data:`COUNTERS`, :func:`count`) are always on: one added where a
layer already holds the event on the host.  ``top2_distances.launches``,
``jacobi_eigh.launches``, ``surf_hessian.launches`` and
``pnp_refine.launches`` count the CUDA kernels' launches (5 a SURF
detection on the card, 1 a PnP refinement);
``relative_pose.second_attempts`` the frames whose preferred estimator failed
its gate, so that the other one ran too; ``sift.describe_passes`` SIFT's
describe passes (one an octave, 4 a detection).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from typing import NamedTuple

import torch

COUNTERS: defaultdict[str, int] = defaultdict(int)
RING = 256  # root spans a recording keeps (one frame each when a chunk holds one)


def count(name: str) -> None:
    """Add one to the counter ``name``."""
    COUNTERS[name] += 1


class SpanRecord(NamedTuple):
    name: str
    id: int  # in opening order within its recording
    parent: int  # the enclosing span's id; -1 for a root
    frame: int | None  # the frame's global index, shared by every span of the frame
    frames: int | None  # the frames a ``chunk`` holds; None for other spans
    start_ns: int
    end_ns: int


class SpanTotal(NamedTuple):
    calls: int
    total_ns: int
    self_ns: int


class Recording:
    """What :func:`recording` gathers; see the module doc."""

    def __init__(self):
        self.trees: deque[list[SpanRecord]] = deque(maxlen=RING)
        self._totals: dict[str, list[int]] = {}
        self._stack: list[_Span] = []
        self._tree: list[SpanRecord] = []
        self._next_id = 0
        self._counters_at_start = dict(COUNTERS)
        self._counters_at_end: dict[str, int] | None = None

    @property
    def totals(self) -> dict[str, SpanTotal]:
        return {name: SpanTotal(*v) for name, v in self._totals.items()}

    @property
    def counters(self) -> dict[str, int]:
        """Each counter's count while the recording was on."""
        now = COUNTERS if self._counters_at_end is None else self._counters_at_end
        start = self._counters_at_start
        return {k: v - start.get(k, 0) for k, v in now.items() if v != start.get(k, 0)}

    def spans(self) -> list[SpanRecord]:
        """Every span of the ring's trees, in opening order."""
        return sorted((s for tree in self.trees for s in tree), key=lambda s: s.id)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_RECORDING: Recording | None = None


class _Span:
    __slots__ = ("rec", "name", "frame", "frames", "id", "parent", "start", "child_ns", "range")

    def __init__(self, rec: Recording, name: str, frame: int | None, frames: int | None):
        self.rec, self.name, self.frame, self.frames = rec, name, frame, frames

    def __enter__(self):
        rec = self.rec
        parent = rec._stack[-1] if rec._stack else None
        self.parent = -1 if parent is None else parent.id
        if self.frame is None and parent is not None:
            self.frame = parent.frame
        self.id = rec._next_id
        rec._next_id += 1
        self.child_ns = 0
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        rec._stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        rec = self.rec
        rec._stack.pop()
        dur = end - self.start
        total = rec._totals.get(self.name)
        if total is None:
            total = rec._totals[self.name] = [0, 0, 0]
        total[0] += 1
        total[1] += dur
        total[2] += dur - self.child_ns
        rec._tree.append(SpanRecord(self.name, self.id, self.parent, self.frame, self.frames,
                                    self.start, end))
        if rec._stack:
            rec._stack[-1].child_ns += dur
        else:
            rec.trees.append(rec._tree)
            rec._tree = []
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, frame: int | None = None, frames: int | None = None):
    """A span of host time named ``name`` (see the module doc); ``frame``
    sets the frame index its children inherit, ``frames`` a chunk's count."""
    if _RECORDING is None:
        return _NO_SPAN
    return _Span(_RECORDING, name, frame, frames)


@contextlib.contextmanager
def recording():
    """Record every span opened inside the block; yields the
    :class:`Recording`, whose ring keeps the trees of the last :data:`RING`
    root spans."""
    global _RECORDING
    if _RECORDING is not None:
        raise RuntimeError("profiling.recording() is already on")
    rec = Recording()
    _RECORDING = rec
    try:
        yield rec
    finally:
        _RECORDING = None
        rec._counters_at_end = dict(COUNTERS)
