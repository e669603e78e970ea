"""The closed loop's records, driven by a stand-in runner (no port): at
``chunk_size`` 1 they are those of the one-frame loop the harness had before
chunked streams (kept below as the reference); chunked, every frame has one
record with its own outputs, its chunk's times, and a generator state only
on the chunk's first frame."""

import time
from typing import NamedTuple

import numpy as np
import pytest
import torch

from uvo_bench.sources import ClosedLoop, FrameList


class Stream(NamedTuple):
    left: torch.Tensor
    right: None
    timestamps: torch.Tensor
    ranges: torch.Tensor


class Batch(NamedTuple):
    imgs: torch.Tensor
    imgs_right: None
    timestamps: torch.Tensor
    ranges: torch.Tensor


class Out(NamedTuple):
    frame: np.ndarray
    velocity: np.ndarray


def _stream(n):
    return Stream(torch.arange(n, dtype=torch.uint8)[:, None, None].expand(n, 2, 2).clone(),
                  None, 0.05 * torch.arange(n, dtype=torch.float32), torch.ones(n))


def _runner(source, generator, chunk_size):
    """What the port's streaming runner does with a source: a chunk in, a
    draw from the generator a frame, the chunk's outputs to the callback."""
    done = 0
    for batch in source.batches(chunk_size):
        n = len(batch.imgs)
        draws = [torch.rand(3, generator=generator) for _ in range(n)]
        frames = batch.imgs[:, 0, 0].numpy().astype(np.int64)
        done += n
        source.callback(done, None, Out(frames, torch.stack(draws).numpy()),
                        generator.get_state())


class OneFrameLoop:
    """The harness's closed loop before chunked streams: one frame at a time."""

    def __init__(self, stream, pass_id, first, generator, log, frame_batch, count=None):
        self.stream, self.pass_id, self.first = stream, pass_id, first
        self.generator, self.log, self.frame_batch = generator, log, frame_batch
        self.last = len(stream.left) if count is None else min(first + count, len(stream.left))
        self.next = first

    def batches(self, batch_size):
        if batch_size != 1:
            raise ValueError("the closed loop hands in one frame at a time")
        s = self.stream
        for i in range(self.first, self.last):
            rec = {"pass": self.pass_id, "index": i, "gen_state": self.generator.get_state(),
                   "t_out": None, "out": None}
            self.log.append(rec)
            self.next = i + 1
            batch = self.frame_batch(imgs=s.left[i:i + 1], imgs_right=None,
                                     timestamps=s.timestamps[i:i + 1], ranges=s.ranges[i:i + 1])
            rec["t_in"] = time.perf_counter()
            yield batch

    def callback(self, frames_done, state, chunk_out, generator_state):
        rec = self.log[-1]
        rec["t_out"] = time.perf_counter()
        rec["out"] = {k: v[0] for k, v in chunk_out._asdict().items()}


def _records(cls, chunk_size, first=0, count=None, n=12):
    gen = torch.Generator()
    gen.manual_seed(2**31 + 5)
    log = []
    source = cls(_stream(n), 3, first, gen, log, Batch, count=count)
    _runner(source, gen, chunk_size)
    return source, log


@pytest.mark.parametrize("first,count", [(0, None), (4, 5)])
def test_at_chunk_size_one_the_records_are_the_one_frame_loops(first, count):
    source, log = _records(ClosedLoop, 1, first, count)
    old_source, old = _records(OneFrameLoop, 1, first, count)
    assert len(log) == len(old) and source.next == old_source.next
    for r, o in zip(log, old):
        assert list(r) == list(o)
        assert (r["pass"], r["index"]) == (o["pass"], o["index"])
        assert torch.equal(r["gen_state"], o["gen_state"])
        assert r["out"].keys() == o["out"].keys()
        assert all(np.array_equal(r["out"][k], o["out"][k]) for k in r["out"])
        assert r["t_in"] <= r["t_out"]


def test_a_chunked_loop_gives_every_frame_one_record_with_its_own_output():
    source, log = _records(ClosedLoop, 4, n=14)  # 3 whole chunks; frames 12, 13 not handed in
    assert [r["index"] for r in log] == list(range(12))
    assert source.next == 12 and source.exhausted
    for r in log:
        assert r["out"]["frame"] == r["index"]
        first = r["index"] % 4 == 0
        assert (r["gen_state"] is not None) == first
        chunk = log[r["index"] - r["index"] % 4]
        assert (r["t_in"], r["t_out"]) == (chunk["t_in"], chunk["t_out"])
    # The draws of a chunk's frames follow from its first frame's state.
    for c in range(3):
        gen = torch.Generator()
        gen.set_state(log[4 * c]["gen_state"])
        for r in log[4 * c:4 * c + 4]:
            assert np.array_equal(r["out"]["velocity"], torch.rand(3, generator=gen).numpy())


def test_a_chunked_loop_stops_at_the_deadline_on_a_chunk_boundary():
    gen = torch.Generator()
    log = []
    source = ClosedLoop(_stream(16), 0, 0, gen, log, Batch, deadline=time.perf_counter())
    _runner(source, gen, 4)
    assert [r["index"] for r in log] == [0, 1, 2, 3]  # the first chunk always
    assert all(r["out"] is not None for r in log) and not source.exhausted


def test_the_warm_up_list_runs_whole_chunks():
    stream = _stream(24)
    seen = []

    class Runner:
        def run(self, source, chunk_size):
            for batch in source.batches(chunk_size):
                seen.append(batch.imgs[:, 0, 0].tolist())
                source.callback(0, None, None, None)

    from uvo_bench.pipelines.common import warm_indices

    source = FrameList(stream, warm_indices((0, 8, 9, 10, 11, 12), 4), Batch)
    Runner().run(source, 4)
    assert seen == [[0, 8, 9, 10], [11, 12, 13, 14]] and len(source.seconds) == 2
    seen.clear()
    source = FrameList(stream, warm_indices((0, 8, 9, 10, 11, 12), 1), Batch)
    Runner().run(source, 1)
    assert seen == [[0], [8], [9], [10], [11], [12]]
    assert warm_indices((0, 8, 9), 16, 1) == [0]
