"""The port's program spans and counters (``utils/profiling.py``) on tiny streams.

With recording on, the streaming runners give one ``chunk`` a frame holding
``upload``, ``preprocess``, one ``step``, ``read_back`` and ``callback``, and
each layer's span nests in its parent's interval with the frame's index; self
times are what a span's children leave of its duration.  The outputs equal
those of a run with recording off, bit for bit, and off records nothing.
Under ``torch.profiler`` each span is a user annotation holding the aten ops
issued inside it.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import ergo_uvo_tpu_torch.config as tconfig
from ergo_uvo_tpu_torch.convert import stereo_rig_from_numpy
from ergo_uvo_tpu_torch.image import build_preprocess_plan
from ergo_uvo_tpu_torch.io import make_mono_sequence, make_stereo_sequence
from ergo_uvo_tpu_torch.io.sequence import ArraySource
from ergo_uvo_tpu_torch.pipeline import run_mono_vo_streaming, run_stereo_vo_streaming
from ergo_uvo_tpu_torch.utils import profiling

H, W = 96, 128
MONO_CFG = tconfig.MonoVOConfig(surf=tconfig.SurfConfig(min_hessian=60.0),
                                max_keypoints=64, num_hypotheses=32)
STEREO_CFG = tconfig.StereoVOConfig(surf=tconfig.SurfConfig(min_hessian=60.0, n_octaves=3),
                                    max_keypoints=64, num_hypotheses=32)

CHUNK = {"upload", "preprocess", "step", "read_back", "callback"}
DETECT = {"detect.hessian", "detect.describe"}
RELATIVE_POSE = {"relative_pose.select", "essential.fit", "essential.recover_pose",
                 "homography.fit", "homography.recover_pose"}
MONO_STEP = {"detect": 1, "match": 1, "relative_pose": 1, "triangulate": 1}
STEREO_STEP = {"detect": 2, "match": 2, "triangulate": 1, "pnp": 1}
PNP = {"pnp.minimal": 1, "pnp.score": 1, "pnp.refine": 1}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mono():
    seq = make_mono_sequence(n_frames=4, height=H, width=W, dt=0.25, seed=3)
    plan = build_preprocess_plan(seq.K, np.array([-0.05, 0.01, 0.0, 0.0]), W, H, W, True, 3.0,
                                 device="cpu")

    def run(frames=4):
        src = ArraySource(seq.imgs_left[:frames], seq.timestamps[:frames],
                          ranges=seq.ranges[:frames])
        return run_mono_vo_streaming(src, plan, plan.new_K, MONO_CFG,
                                     torch.Generator().manual_seed(0), chunk_size=1,
                                     chunk_callback=lambda *a: None, device="cpu")[1]
    return run


@pytest.fixture(scope="module")
def stereo():
    seq = make_stereo_sequence(n_frames=3, height=H, width=W, dt=0.25, seed=5)
    K32 = seq.K.astype(np.float32)
    rig = stereo_rig_from_numpy(dict(K_left=K32, K_right=K32, R_right=np.eye(3, dtype=np.float32),
                                     t_right=np.asarray([-0.33, 0.0, 0.0], np.float32)), "cpu")
    plan = build_preprocess_plan(seq.K, np.zeros(4), W, H, W, False, 3.0, device="cpu")

    def run():
        src = ArraySource(seq.imgs_left, seq.timestamps, imgs_right=seq.imgs_right)
        return run_stereo_vo_streaming(src, plan, plan, rig, STEREO_CFG,
                                       torch.Generator().manual_seed(0), chunk_size=1,
                                       chunk_callback=lambda *a: None, device="cpu")[1]
    return run


def _children(spans):
    kids = {s.id: [] for s in spans}
    for s in spans:
        if s.parent >= 0:
            kids[s.parent].append(s)
    return kids


def _names(spans):
    return Counter(s.name for s in spans)


def _check_tree(rec, frames, step_children):
    spans = rec.spans()
    by_id = {s.id: s for s in spans}
    kids = _children(spans)
    chunks = [s for s in spans if s.parent < 0]
    assert [(c.name, c.frame, c.frames) for c in chunks] == [("chunk", i, 1) for i in range(frames)]
    self_ns: dict = {}
    for s in spans:
        if s.parent >= 0:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s, p)
            assert s.frame == p.frame
        own = (s.end_ns - s.start_ns) - sum(c.end_ns - c.start_ns for c in kids[s.id])
        assert own >= 0, s
        self_ns[s.name] = self_ns.get(s.name, 0) + own
    for c in chunks:
        assert set(_names(kids[c.id])) == CHUNK
        (step,) = [k for k in kids[c.id] if k.name == "step"]
        assert _names(kids[step.id]) == step_children
        for d in (k for k in kids[step.id] if k.name == "detect"):
            assert set(_names(kids[d.id])) == DETECT
    totals = rec.totals
    for name, total in totals.items():
        assert total.self_ns == self_ns[name] and 0 <= total.self_ns <= total.total_ns, name
        assert total.calls == _names(spans)[name]
    return spans, kids


def test_mono_spans_nest_by_layer_and_leave_the_outputs_unchanged(mono):
    off = mono()
    with profiling.recording() as rec:
        on = mono()
    for name, a, b in zip(off._fields, off, on):
        np.testing.assert_array_equal(a, b, err_msg=name)
    spans, kids = _check_tree(rec, 4, MONO_STEP)
    both = 0
    for rp in (s for s in spans if s.name == "relative_pose"):
        names = _names(kids[rp.id])
        assert set(names) <= RELATIVE_POSE and names["relative_pose.select"] == 1
        both += "essential.fit" in names and "homography.fit" in names
    for fit in (s for s in spans if s.name == "essential.fit"):
        (refine,) = kids[fit.id]
        assert refine.name == "essential.refine"
        assert [k.name for k in kids[refine.id]] == ["essential.recover_pose"]
    assert rec.counters.get("relative_pose.second_attempts", 0) == both >= 1


def test_stereo_spans_nest_by_layer_and_leave_the_outputs_unchanged(stereo):
    off = stereo()
    with profiling.recording() as rec:
        on = stereo()
    for name, a, b in zip(off._fields, off, on):
        np.testing.assert_array_equal(a, b, err_msg=name)
    spans, kids = _check_tree(rec, 3, STEREO_STEP)
    for pnp in (s for s in spans if s.name == "pnp"):
        assert _names(kids[pnp.id]) == PNP


def test_off_records_nothing_and_the_ring_keeps_the_last_frames(mono, monkeypatch):
    assert profiling.span("detect") is profiling.span("match")  # the shared no-op
    monkeypatch.setattr(profiling, "RING", 2)
    with profiling.recording() as rec:
        mono(3)
    totals = rec.totals
    mono(1)
    assert rec.totals == totals and totals["chunk"].calls == 3
    assert [t[-1].frame for t in rec.trees] == [1, 2]  # a tree closes with its root
    with profiling.recording():
        with pytest.raises(RuntimeError, match="already on"):
            with profiling.recording():
                pass


def test_spans_are_user_annotations_holding_their_ops_under_the_profiler(mono):
    with profiling.recording() as rec:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            mono(2)
    events = prof.profiler.kineto_results.events()
    ranges = [(e.name(), e.start_ns(), e.end_ns()) for e in events if e.is_user_annotation()]
    ops = [(e.name(), e.start_ns(), e.end_ns()) for e in events
           if not e.is_user_annotation() and e.name().startswith("aten::")]
    assert Counter(n for n, _, _ in ranges) == {name: t.calls for name, t in rec.totals.items()}
    for name, s, e in ranges:
        inside = [op for op in ops if s <= op[1] <= e]
        assert all(op[2] <= e for op in inside), name
        assert inside or name == "callback", name  # the callback here issues no op
    for name, s, e in ranges:
        if name == "match":
            assert any(op[0] == "aten::sqrt" and s <= op[1] <= e for op in ops)
