"""The port's streaming runners, stream checkpoints and host copies (CPU).

* The copies of ``io/sequence.py``, ``io/native/``, ``eval/ate.py`` and
  ``utils/records.py`` against their originals in the JAX package.  Only
  host code runs on the JAX side: nothing is compiled.
* Within the port: streaming equals the bulk run bit for bit (mono and
  stereo, chunks of 3 and 4), a crash after chunk 2 and a resume with
  another chunk size equal the uninterrupted run bit for bit, the generator
  state and the VO state survive their files, the nan guard, and the
  program spans.

Sizes: 160x128 frames, at most 9 of them, 128 keypoints, 64 hypotheses.
"""

import json
import os

import numpy as np
import pytest
import torch

import ergo_uvo_tpu.eval.ate as jate
import ergo_uvo_tpu.io.native as jnative
import ergo_uvo_tpu.io.sequence as jsequence
import ergo_uvo_tpu.utils.checkpoint as jcheckpoint
import ergo_uvo_tpu.utils.records as jrecords
import ergo_uvo_tpu_torch.config as tconfig
import ergo_uvo_tpu_torch.eval.ate as tate
import ergo_uvo_tpu_torch.io.native as tnative
import ergo_uvo_tpu_torch.io.sequence as tsequence
import ergo_uvo_tpu_torch.utils.records as trecords
from ergo_uvo_tpu_torch.cli import _make_stream_ckpt_cb
from ergo_uvo_tpu_torch.convert import mono_state_to_numpy, stereo_rig_from_numpy
from ergo_uvo_tpu_torch.image import build_preprocess_plan, preprocess_frame
from ergo_uvo_tpu_torch.io import make_mono_sequence, make_stereo_sequence
from ergo_uvo_tpu_torch.io.sequence import ArraySource
from ergo_uvo_tpu_torch.pipeline import (
    MonoFrameOutput,
    StereoFrameOutput,
    mono_vo_init_from,
    run_mono_vo,
    run_mono_vo_streaming,
    run_stereo_vo,
    run_stereo_vo_streaming,
    stereo_vo_init_from,
)
from ergo_uvo_tpu_torch.utils import recording, span
from ergo_uvo_tpu_torch.utils.checkpoint import (
    append_stream_segment,
    load_stream_checkpoint,
    load_stream_run,
    restore_state,
    save_state,
    save_stream_checkpoint,
    save_stream_head,
)
from ergo_uvo_tpu_torch.utils.debug import assert_finite, check_frame, nan_guard

N = 9
H, W = 128, 160
MONO_CFG = tconfig.MonoVOConfig(surf=tconfig.SurfConfig(min_hessian=60.0),
                                max_keypoints=128, num_hypotheses=64)
STEREO_CFG = tconfig.StereoVOConfig(surf=tconfig.SurfConfig(min_hessian=60.0, n_octaves=3),
                                    max_keypoints=128, num_hypotheses=64)
LENS_DISTORTION = np.array([-0.05, 0.01, 0.0, 0.0])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops on these small images are faster on one thread than spread
    over a shared host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def outs_example(out_type):
    return out_type(*([np.zeros(0)] * len(out_type._fields)))


def assert_all_equal(a, b, n=None):
    """Every field of two output or state tuples equal, bit for bit (the
    first ``n`` rows of each field when ``n`` is given)."""
    assert a._fields == b._fields
    for name, x, y in zip(a._fields, a, b):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        if n is not None:
            x, y = x[:n], y[:n]
        np.testing.assert_array_equal(x, y, err_msg=name)
        assert x.dtype == y.dtype, name


# ---------------------------------------------------------------- mono fixtures


@pytest.fixture(scope="module")
def mono():
    """The mono sequence, a plan with lens distortion and CLAHE, and the bulk
    run: ``preprocess_frame`` then ``run_mono_vo`` on all 9 frames."""
    seq = make_mono_sequence(n_frames=N, height=H, width=W, dt=0.25, seed=3)
    plan = build_preprocess_plan(seq.K, LENS_DISTORTION, W, H, W, True, 3.0, device="cpu")
    frames = preprocess_frame(plan, torch.as_tensor(seq.imgs_left))
    state, outs = run_mono_vo(frames, seq.timestamps, seq.ranges, plan.new_K, MONO_CFG, gen(),
                              device="cpu")
    assert bool(outs.validity[1:].all())
    return seq, plan, state, outs


def mono_stream(seq, plan, chunk, start=0, **kw):
    src = ArraySource(seq.imgs_left[start:], seq.timestamps[start:], ranges=seq.ranges[start:])
    kw.setdefault("generator", gen())
    return run_mono_vo_streaming(src, plan, plan.new_K, MONO_CFG, chunk_size=chunk,
                                 device="cpu", **kw)


@pytest.fixture(scope="module")
def stereo():
    """The stereo sequence, a plan for each eye (without distortion or CLAHE,
    so the frames pass unchanged: the stereo synthetic sequence has no lens),
    and the bulk run ``run_stereo_vo`` on the preprocessed pairs."""
    seq = make_stereo_sequence(n_frames=N, height=H, width=W, dt=0.25, seed=5)
    K32 = seq.K.astype(np.float32)
    rig = stereo_rig_from_numpy(dict(K_left=K32, K_right=K32, R_right=np.eye(3, dtype=np.float32),
                                     t_right=np.asarray([-0.33, 0.0, 0.0], np.float32)), "cpu")
    plan_l = build_preprocess_plan(seq.K, np.zeros(4), W, H, W, False, 3.0, device="cpu")
    plan_r = build_preprocess_plan(seq.K, np.zeros(4), W, H, W, False, 8.0, device="cpu")
    state, outs = run_stereo_vo(preprocess_frame(plan_l, torch.as_tensor(seq.imgs_left)),
                                preprocess_frame(plan_r, torch.as_tensor(seq.imgs_right)),
                                seq.timestamps, rig, STEREO_CFG, gen(), device="cpu")
    assert bool(outs.validity[1:].all())
    return seq, plan_l, plan_r, rig, state, outs


def stereo_stream(stereo, chunk, **kw):
    seq, plan_l, plan_r, rig = stereo[:4]
    src = ArraySource(seq.imgs_left, seq.timestamps, imgs_right=seq.imgs_right)
    return run_stereo_vo_streaming(src, plan_l, plan_r, rig, STEREO_CFG, gen(),
                                   chunk_size=chunk, device="cpu", **kw)


# ------------------------------------------------------- streaming equals bulk


@pytest.mark.parametrize("chunk", [3, 4])
def test_mono_streaming_equals_bulk(mono, chunk):
    """Chunks of 3 (9 frames) and of 4 (8 frames; the partial chunk is not
    streamed): every output field equals the bulk run's bit for bit, as numpy
    with the bulk run's dtypes; the state too where all 9 frames streamed.
    The callback sees (frames_done, state, this chunk's numpy outputs, the
    generator state) after every chunk."""
    seq, plan, bulk_state, bulk = mono
    timings, seen = [], []

    def cb(frames_done, state, chunk_out, generator_state):
        seen.append((frames_done, len(chunk_out.velocity), generator_state.dtype,
                     bool(state.initialized)))

    state, outs = mono_stream(seq, plan, chunk, timings=timings, chunk_callback=cb)
    n = N - N % chunk
    assert all(isinstance(x, np.ndarray) for x in outs) and len(outs.velocity) == n
    assert [k for k, _ in timings] == [chunk] * (n // chunk)
    assert all(s > 0 for _, s in timings)
    assert seen == [(k, chunk, torch.uint8, True) for k in range(chunk, n + 1, chunk)]
    assert_all_equal(outs, bulk, n)
    if n == N:
        assert_all_equal(state, bulk_state)


@pytest.mark.parametrize("chunk", [3, 4])
def test_stereo_streaming_equals_bulk(stereo, chunk):
    """The stereo runner, two plans: equal to the bulk run bit for bit."""
    bulk_state, bulk = stereo[4:]
    state, outs = stereo_stream(stereo, chunk)
    n = N - N % chunk
    assert len(outs.velocity) == n and all(isinstance(x, np.ndarray) for x in outs)
    assert_all_equal(outs, bulk, n)
    if n == N:
        assert_all_equal(state, bulk_state)


def test_streaming_refusals(mono, stereo):
    """A source with no complete chunk raises; a stereo source without right
    frames raises; a plan on another device raises (the meta device stands
    in for it)."""
    seq, plan = mono[:2]
    with pytest.raises(ValueError, match="no complete chunks"):
        mono_stream(seq, plan, N + 1)
    with pytest.raises(ValueError, match="paired source"):
        run_stereo_vo_streaming(ArraySource(seq.imgs_left, seq.timestamps), stereo[1], stereo[2],
                                stereo[3], STEREO_CFG, gen(), chunk_size=3, device="cpu")
    meta_plan = build_preprocess_plan(seq.K, np.zeros(4), W, H, W, False, 3.0, device="meta")
    with pytest.raises(ValueError, match="plan is on meta"):
        mono_stream(seq, meta_plan, 3)


# ---------------------------------------------------------------- checkpoints


class _Crash(Exception):
    pass


@pytest.mark.parametrize("mode", ["mono", "stereo"])
def test_crash_and_resume_equal_the_uninterrupted_run(mono, stereo, tmp_path, mode):
    """Chunks of 2 with a checkpoint after each (the CLI's callback); the run
    dies after chunk 2 (4 frames); the resume restores the state and the
    generator from the checkpoint and streams the other 5 frames in one
    chunk of 5.  Outputs (the checkpoint's 4 frames, then the resumed 5) and
    the final state equal the uninterrupted run's bit for bit."""
    ckpt = str(tmp_path / "run.npz")
    save = _make_stream_ckpt_cb(ckpt, every=1, n_real=N, chunk_size=2, start=0, n_segments=0)

    def crash_after_chunk_2(frames_done, *rest):
        save(frames_done, *rest)
        if frames_done == 4:
            raise _Crash

    if mode == "mono":
        seq, plan, full_state, full = mono
        out_type, init = MonoFrameOutput, mono_vo_init_from(MONO_CFG, device="cpu")
        run = lambda chunk, start=0, **kw: mono_stream(seq, plan, chunk, start, **kw)  # noqa: E731
    else:
        seq, plan_l, plan_r, rig, full_state, full = stereo
        out_type, init = StereoFrameOutput, stereo_vo_init_from(STEREO_CFG, device="cpu")

        def run(chunk, start=0, **kw):
            src = ArraySource(seq.imgs_left[start:], seq.timestamps[start:],
                              imgs_right=seq.imgs_right[start:])
            kw.setdefault("generator", gen())
            return run_stereo_vo_streaming(src, plan_l, plan_r, rig, STEREO_CFG,
                                           chunk_size=chunk, device="cpu", **kw)

    with pytest.raises(_Crash):
        run(2, chunk_callback=crash_after_chunk_2)
    done, state, prefix, generator_state, meta = load_stream_run(
        ckpt, init, outs_example(out_type), device="cpu")
    assert done == 4 and meta == {"n_real": N, "chunk_size": 2, "n_segments": 2, "seq_digest": ""}
    generator = torch.Generator()
    generator.set_state(generator_state)
    state, tail = run(5, start=done, generator=generator, state=state)
    resumed = out_type(*(np.concatenate([a, b]) for a, b in zip(prefix, tail)))
    assert_all_equal(resumed, full)
    assert_all_equal(state, full_state)


@pytest.mark.fast
def test_generator_state_survives_the_head(tmp_path):
    """The head stores ``get_state()`` as uint8; the restored generator draws
    what the saved one would have drawn next."""
    g = gen(123)
    torch.rand(17, generator=g)
    state = mono_vo_init_from(MONO_CFG, device="cpu")
    save_stream_head(str(tmp_path / "h.npz"), 3, state, g.get_state(), 0, 9, 3)
    _, restored_state, outs, generator_state, _ = load_stream_run(
        str(tmp_path / "h.npz"), state, outs_example(MonoFrameOutput), device="cpu")
    assert outs is None and generator_state.dtype == torch.uint8
    assert torch.equal(generator_state, g.get_state())
    g2 = torch.Generator()
    g2.set_state(generator_state)
    assert torch.equal(torch.rand(5, generator=g2), torch.rand(5, generator=g))
    assert_all_equal(restored_state, state)


@pytest.mark.fast
def test_stream_head_has_the_jax_layout(tmp_path):
    """The same state and outputs written by both packages give the same npz
    members with the same values, but for the generator: the port's
    ``generator_state`` stands where the JAX head's ``key`` does."""
    state = mono_vo_init_from(MONO_CFG, device="cpu")
    state_np = mono_state_to_numpy(state)
    outs = MonoFrameOutput(*(np.full((3,), i, np.float32) for i in range(12)))
    jhead, thead = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    from ergo_uvo_tpu.pipeline.mono import MonoVOState as JState

    jcheckpoint.save_stream_head(jhead, 3, JState(**state_np), np.zeros(2, np.uint32), 1, 9, 3,
                                 seq_digest="abc")
    jcheckpoint.append_stream_segment(jhead, 0, outs)
    save_stream_head(thead, 3, state, gen().get_state(), 1, 9, 3, seq_digest="abc")
    append_stream_segment(thead, 0, outs)
    j, t = np.load(jhead), np.load(thead)
    assert set(j.files) - {"key"} == set(t.files) - {"generator_state"}
    for name in set(j.files) - {"key"}:
        np.testing.assert_array_equal(t[name], j[name], err_msg=name)
        assert t[name].dtype == j[name].dtype, name
    js, ts = np.load(jhead + ".seg0000.npz"), np.load(thead + ".seg0000.npz")
    assert js.files == ts.files
    for name in js.files:
        np.testing.assert_array_equal(ts[name], js[name])
    with pytest.raises(ValueError, match="JAX package checkpoint"):
        load_stream_run(jhead, state, outs_example(MonoFrameOutput), device="cpu")


@pytest.mark.fast
def test_flat_stream_checkpoint_round_trips(tmp_path):
    """``save_stream_checkpoint`` / ``load_stream_checkpoint`` over a nested
    tree of tensors and arrays, in JAX's leaf order; a template with another
    leaf count raises."""
    state = mono_vo_init_from(MONO_CFG, device="cpu")
    tree = (np.int64(4), state, {"b": np.arange(3), "a": torch.ones(2)}, None)
    save_stream_checkpoint(str(tmp_path / "c.npz"), tree)
    back = load_stream_checkpoint(str(tmp_path / "c.npz"), tree)
    assert int(back[0]) == 4 and back[3] is None
    assert_all_equal(type(state)(*(torch.from_numpy(x) for x in back[1])), state)
    np.testing.assert_array_equal(back[2]["a"], np.ones(2, np.float32))
    np.testing.assert_array_equal(back[2]["b"], np.arange(3))
    with pytest.raises(ValueError, match="leaves"):
        load_stream_checkpoint(str(tmp_path / "c.npz"), (state,))


@pytest.mark.fast
def test_save_and_restore_state(tmp_path):
    """``save_state`` writes the fields as CPU tensors; ``restore_state``
    gives the same type and bits on the device named; other fields raise."""
    state = mono_vo_init_from(MONO_CFG, device="cpu")._replace(SF=torch.tensor(2.5))
    save_state(str(tmp_path / "s.pt"), state)
    back = restore_state(str(tmp_path / "s.pt"), mono_vo_init_from(MONO_CFG, device="cpu"),
                         device="cpu")
    assert type(back) is type(state)
    assert_all_equal(back, state)
    with pytest.raises(ValueError, match="fields"):
        restore_state(str(tmp_path / "s.pt"), stereo_vo_init_from(STEREO_CFG, device="cpu"),
                      device="cpu")


# ------------------------------------------------------------ debug, profiling


@pytest.mark.fast
def test_nan_guard_raises_at_the_first_non_finite_frame():
    """A NaN stamp on frame 1 makes its velocity NaN: under the guard the
    runner raises there; outside it the run goes through and
    ``assert_finite`` names the field afterwards."""
    seq = make_mono_sequence(n_frames=2, height=96, width=128, dt=0.25, seed=3)
    tss = seq.timestamps.copy()
    tss[1] = np.nan
    args = (seq.imgs_left, tss, seq.ranges, seq.K, MONO_CFG)
    with nan_guard():
        with pytest.raises(FloatingPointError, match=r"frame 1: \['velocity'\]"):
            run_mono_vo(*args, gen(), device="cpu")
    _, outs = run_mono_vo(*args, gen(), device="cpu")
    with pytest.raises(FloatingPointError, match="velocity"):
        assert_finite(outs)
    assert_finite(type(outs)(*(x.numpy() for x in outs))._replace(velocity=np.zeros(3)))
    check_frame(outs, 1)  # no guard: no check


@pytest.mark.fast
def test_profiling_helpers():
    """``span`` records nothing off; under ``recording`` it times nested
    spans (self time: what the children leave) and, under ``torch.profiler``,
    opens a range of its name in the trace."""
    with span("vo_stage"):
        torch.ones(8).sum()
    with recording() as rec:
        with torch.profiler.profile() as prof:
            with span("vo_stage", frame=7):
                with span("inner"):
                    torch.ones(8).sum()
    (inner, outer), = rec.trees
    assert (outer.name, outer.frame, inner.name, inner.frame) == ("vo_stage", 7, "inner", 7)
    assert inner.parent == outer.id and outer.parent == -1
    totals = rec.totals
    assert totals["vo_stage"].calls == 1 and totals["inner"].calls == 1
    assert totals["vo_stage"].self_ns == (outer.end_ns - outer.start_ns) - (
        inner.end_ns - inner.start_ns) >= 0
    assert {"vo_stage", "inner"} <= {e.key for e in prof.key_averages()}


# ------------------------------------------------- copies against originals


@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    """5 JPEGs of 160x128 written with PIL."""
    from PIL import Image

    root = tmp_path_factory.mktemp("jpegs")
    seq = make_mono_sequence(n_frames=5, height=H, width=W, dt=0.25, seed=3)
    paths = []
    for i, img in enumerate(seq.imgs_left):
        paths.append(str(root / f"f_{i:04d}.jpg"))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), "L").save(paths[-1], quality=95)
    return paths


def _batches(source, size):
    return [tuple(None if x is None else np.array(x) for x in b) for b in source.batches(size)]


@pytest.mark.fast
@pytest.mark.parametrize("decoder", ["native", "pil"])
def test_sources_equal_the_originals(jpeg_dir, monkeypatch, decoder):
    """``JpegDirectorySource``, ``JpegPairSource`` and ``ArraySource`` give
    the original's batches exactly, through libjpeg (the native loader of
    each package) and through PIL (both loaders switched off), and drop a
    trailing partial batch as it does (5 frames in batches of 2)."""
    if decoder == "pil":
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    else:
        assert tnative.available(), tnative.build_error()
    tss, rgs = np.arange(5) * 0.25, np.linspace(1.0, 2.0, 5)
    for size in (1, 2, 5):
        a = _batches(jsequence.JpegDirectorySource(jpeg_dir, tss, rgs), size)
        b = _batches(tsequence.JpegDirectorySource(jpeg_dir, tss, rgs), size)
        assert len(a) == len(b) == 5 // size
        for x, y in zip(a, b):
            for u, v in zip(x, y):
                if u is None:
                    assert v is None
                else:
                    np.testing.assert_array_equal(v, u)
                    assert v.dtype == u.dtype
        pa = _batches(jsequence.JpegPairSource(jpeg_dir, jpeg_dir[::-1], tss), size)
        pb = _batches(tsequence.JpegPairSource(jpeg_dir, jpeg_dir[::-1], tss), size)
        assert len(pa) == len(pb)
        for x, y in zip(pa, pb):
            np.testing.assert_array_equal(y[0], x[0])
            np.testing.assert_array_equal(y[1], x[1])
            np.testing.assert_array_equal(y[2], x[2])
    imgs = np.random.default_rng(0).uniform(0, 255, (5, 4, 6)).astype(np.float32)
    for kw in ({}, {"ranges": rgs}, {"imgs_right": imgs[::-1]}):
        a = _batches(jsequence.ArraySource(imgs, tss, **kw), 2)
        b = _batches(tsequence.ArraySource(imgs, tss, **kw), 2)
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            for u, v in zip(x, y):
                assert (u is None and v is None) or np.array_equal(u, v)
    with pytest.raises(ValueError, match="unsynced"):
        tsequence.JpegPairSource(jpeg_dir, jpeg_dir[:3])


@pytest.mark.fast
def test_no_decoder_names_both(jpeg_dir, monkeypatch):
    """Without the native loader and without PIL the source says it needs
    libjpeg or PIL."""
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real_import(name, *args, **kw)

    monkeypatch.setattr(tnative, "available", lambda: False)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(RuntimeError, match="libjpeg .* or PIL"):
        list(tsequence.JpegDirectorySource(jpeg_dir).batches(1))


@pytest.mark.fast
def test_native_decoder_equals_the_original(jpeg_dir):
    """The copy of the native library decodes and demosaics as the original's
    does, byte for byte; its library lies in the build directory."""
    assert tnative.available() and jnative.available()
    assert "build" in tnative._so_path()
    data = open(jpeg_dir[2], "rb").read()
    for gray in (True, False):
        np.testing.assert_array_equal(tnative.decode_jpeg(data, gray), jnative.decode_jpeg(data, gray))
    bayer = np.random.default_rng(1).integers(0, 256, (6, 8), dtype=np.uint8)
    np.testing.assert_array_equal(tnative.demosaic_bggr(bayer), jnative.demosaic_bggr(bayer))


ATE_FUNCTIONS = ["umeyama_alignment", "ate_rmse", "rpe_rmse", "velocity_rmse",
                 "integrate_mono_poses", "integrate_mono_trajectory"]


def _ate_inputs(name, rng):
    n = 12
    pos = np.cumsum(rng.normal(size=(n, 3)), 0)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    rot *= np.sign(np.linalg.det(rot))
    est = 1.3 * pos @ rot.T + rng.normal(scale=0.05, size=(n, 3)) + 0.5
    vel = rng.normal(size=(n, 3))
    rel = np.stack([np.linalg.qr(np.eye(3) + 0.05 * rng.normal(size=(3, 3)))[0] for _ in range(n)])
    rel *= np.sign(np.linalg.det(rel))[:, None, None]
    tss = np.cumsum(rng.uniform(0.04, 0.06, n))
    pub = rng.uniform(size=n) > 0.2
    valid = pub & (rng.uniform(size=n) > 0.3)
    return {
        "umeyama_alignment": [((est, pos), {}), ((est, pos), {"with_scale": False})],
        "ate_rmse": [((est, pos), {}), ((est, pos), {"with_scale": True}),
                     ((est, pos), {"align": False})],
        "rpe_rmse": [((est, pos), {}), ((est, pos), {"delta": 3})],
        "velocity_rmse": [((vel, vel + 0.1), {}), ((vel, vel + 0.1), {"valid": valid}),
                          ((vel, vel), {"valid": np.zeros(n, bool)})],
        "integrate_mono_poses": [((vel, rel, tss, pub), {})],
        "integrate_mono_trajectory": [((vel, rel, tss, pub), {}),
                                      ((vel, rel, tss, pub, valid), {})],
    }[name]


@pytest.mark.fast
@pytest.mark.parametrize("name", ATE_FUNCTIONS)
def test_ate_equals_the_original(name):
    """Each function of eval/ate.py on seeded inputs, against the original,
    rtol 1e-6 (both are the same float64 numpy)."""
    for args, kw in _ate_inputs(name, np.random.default_rng(ATE_FUNCTIONS.index(name))):
        got = getattr(tate, name)(*args, **kw)
        want = getattr(jate, name)(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-6)


@pytest.mark.fast
def test_run_recorder_writes_the_originals_lines(tmp_path, monkeypatch):
    """The same outputs (a NamedTuple of numpy values, a dict, extras) give
    the same JSONL lines; the clock is pinned so ``wall_time`` agrees."""
    monkeypatch.setattr(jrecords.time, "time", lambda: 5.0)
    outs = MonoFrameOutput(*(np.full((3,) if i == 0 else (), i, np.float32) for i in range(12)))
    outs = outs._replace(validity=np.bool_(True), num_features=np.int32(7))
    paths = []
    for mod in (jrecords, trecords):
        paths.append(tmp_path / f"{mod.__name__}.jsonl")
        rec = mod.RunRecorder(str(paths[-1]))
        rec.record_frame(0, outs)
        rec.record_frame(1, {"velocity": np.zeros(3), "ok": True}, note=np.float32(0.5))
        rec.close()
    assert trecords.time is jrecords.time
    a, b = (p.read_text() for p in paths)
    assert a == b and len(a.splitlines()) == 2
    assert json.loads(b.splitlines()[0])["num_features"] == 7
    assert os.path.getsize(paths[1]) > 0
