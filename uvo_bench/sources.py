"""Frame sources for the port's streaming runners (``batches(chunk_size)``).

:class:`ClosedLoop` feeds the measured window and the profiled stretch;
:class:`FrameList` feeds set-up's warm-up.
"""

from __future__ import annotations

import math
import time


class ClosedLoop:
    """A frame source over one pass of ``stream`` from frame ``first``: each
    frame is handed in after the previous one's output reached the host, up
    to ``deadline`` (the first frame always) or ``count`` frames."""

    def __init__(self, stream, pass_id, first, generator, log, frame_batch,
                 deadline=math.inf, count=None):
        self.stream, self.pass_id, self.first = stream, pass_id, first
        self.generator, self.log, self.frame_batch = generator, log, frame_batch
        self.deadline = deadline
        self.last = len(stream.left) if count is None else min(first + count, len(stream.left))
        self.next = first

    def batches(self, batch_size):
        if batch_size != 1:
            raise ValueError("the closed loop hands in one frame at a time")
        s = self.stream
        for i in range(self.first, self.last):
            if i > self.first and time.perf_counter() >= self.deadline:
                return
            rec = {"pass": self.pass_id, "index": i, "gen_state": self.generator.get_state(),
                   "t_out": None, "out": None}
            self.log.append(rec)
            self.next = i + 1
            batch = self.frame_batch(
                imgs=s.left[i:i + 1],
                imgs_right=None if s.right is None else s.right[i:i + 1],
                timestamps=s.timestamps[i:i + 1],
                ranges=s.ranges[i:i + 1],
            )
            rec["t_in"] = time.perf_counter()
            yield batch

    def callback(self, frames_done, state, chunk_out, generator_state):
        rec = self.log[-1]
        rec["t_out"] = time.perf_counter()
        rec["out"] = {k: v[0] for k, v in chunk_out._asdict().items()}


class FrameList:
    """The frames ``indices`` of ``stream`` (those it has), one at a time; ``outputs``
    collects each frame's outputs (numpy) and ``seconds`` each frame's time
    from hand-in to output through :meth:`callback`."""

    def __init__(self, stream, indices, frame_batch):
        self.stream, self.frame_batch = stream, frame_batch
        self.indices = [i for i in indices if i < len(stream.left)]
        self.outputs: list[dict] = []
        self.seconds: list[float] = []

    def batches(self, batch_size):
        s = self.stream
        for i in self.indices:
            self._t_in = time.perf_counter()
            yield self.frame_batch(
                imgs=s.left[i:i + 1],
                imgs_right=None if s.right is None else s.right[i:i + 1],
                timestamps=s.timestamps[i:i + 1],
                ranges=s.ranges[i:i + 1],
            )

    def callback(self, frames_done, state, chunk_out, generator_state):
        self.seconds.append(time.perf_counter() - self._t_in)
        self.outputs.append({k: v[0] for k, v in chunk_out._asdict().items()})
