"""Frame sources for the port's streaming runners (``batches(chunk_size)``).

:class:`ClosedLoop` feeds the measured window and the profiled stretch;
:class:`FrameList` feeds set-up's warm-up.
"""

from __future__ import annotations

import math
import time


class ClosedLoop:
    """A frame source over one pass of ``stream`` from frame ``first``, a chunk
    of ``batch_size`` consecutive frames at a time: each chunk is handed in
    after the previous chunk's outputs reached the host, up to ``deadline``
    (the first chunk always) or ``count`` frames.  A trailing partial chunk
    is not handed in, as the runners drop one.

    One record a frame in ``log``: the chunk's hand-in time ``t_in``, its
    read-back time ``t_out`` and the frame's own outputs ``out``; the
    generator's state before the chunk (``gen_state``) on the chunk's first
    frame, None on the others, which the generator reaches through the chunk.
    """

    def __init__(self, stream, pass_id, first, generator, log, frame_batch,
                 deadline=math.inf, count=None):
        self.stream, self.pass_id, self.first = stream, pass_id, first
        self.generator, self.log, self.frame_batch = generator, log, frame_batch
        self.deadline = deadline
        self.last = len(stream.left) if count is None else min(first + count, len(stream.left))
        self.next = first
        self.size = 1
        self._chunk: list[dict] = []

    @property
    def exhausted(self) -> bool:
        """No whole chunk of the pass is left to hand in."""
        return self.next + self.size > self.last

    def batches(self, batch_size):
        s, self.size = self.stream, batch_size
        for i in range(self.first, self.last - batch_size + 1, batch_size):
            if i > self.first and time.perf_counter() >= self.deadline:
                return
            self._chunk = [{"pass": self.pass_id, "index": j,
                            "gen_state": self.generator.get_state() if j == i else None,
                            "t_out": None, "out": None} for j in range(i, i + batch_size)]
            self.log.extend(self._chunk)
            self.next = i + batch_size
            sl = slice(i, i + batch_size)
            batch = self.frame_batch(
                imgs=s.left[sl],
                imgs_right=None if s.right is None else s.right[sl],
                timestamps=s.timestamps[sl],
                ranges=s.ranges[sl],
            )
            t_in = time.perf_counter()
            for rec in self._chunk:
                rec["t_in"] = t_in
            yield batch

    def callback(self, frames_done, state, chunk_out, generator_state):
        t_out = time.perf_counter()
        outs = chunk_out._asdict()
        for j, rec in enumerate(self._chunk):
            rec["t_out"] = t_out
            rec["out"] = {k: v[j] for k, v in outs.items()}


class FrameList:
    """The frames ``indices`` of ``stream`` (those it has), ``batch_size`` at a
    time (the last batch may be short); ``seconds`` collects each batch's time
    from hand-in to output through :meth:`callback`."""

    def __init__(self, stream, indices, frame_batch):
        self.stream, self.frame_batch = stream, frame_batch
        self.indices = [i for i in indices if i < len(stream.left)]
        self.seconds: list[float] = []

    def batches(self, batch_size):
        s = self.stream
        for k in range(0, len(self.indices), batch_size):
            idx = self.indices[k:k + batch_size]
            if idx == list(range(idx[0], idx[0] + len(idx))):
                idx = slice(idx[0], idx[0] + len(idx))  # a view of the pinned frames
            self._t_in = time.perf_counter()
            yield self.frame_batch(
                imgs=s.left[idx],
                imgs_right=None if s.right is None else s.right[idx],
                timestamps=s.timestamps[idx],
                ranges=s.ranges[idx],
            )

    def callback(self, frames_done, state, chunk_out, generator_state):
        self.seconds.append(time.perf_counter() - self._t_in)
