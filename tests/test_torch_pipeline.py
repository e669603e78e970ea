"""The port's mono slice against JAX ``run_mono_vo`` (CPU), raw, on
preprocessed frames and streamed, the batched-features runner, the state
hand-over between the packages, the host-only copies, the entry points'
default device, and the port's freedom from JAX.

The slice runs under the config of tests/test_pipeline.py:219-227 (SURF,
min_hessian 60, 128 keypoints, 64 hypotheses, LMEDS) on 8 frames of 160x128
from ``make_mono_sequence(seed=3)``: raw and preprocessed frames then have
one shape, so the file's two JAX ``run_mono_vo`` runs go through one jitted
call, which traces and compiles once.
Both packages draw the same minimal sets: the port's sampler calls the JAX
package's ``sample_minimal_sets`` with the keys JAX derives,
``keys = split(key, 8)`` and ``k_e, k_h = split(keys[i])`` for frame i.
"""

import ast
import dataclasses
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ergo_uvo_tpu.cli as jcli
import ergo_uvo_tpu.config as jconfig
import ergo_uvo_tpu.eval.ate as jate
import ergo_uvo_tpu.io.native as jnative
import ergo_uvo_tpu.io.sequence as jsequence
import ergo_uvo_tpu.io.synthetic as jsynthetic
import ergo_uvo_tpu.utils.records as jrecords
from ergo_uvo_tpu.estimation.sampling import sample_minimal_sets as j_sample
from ergo_uvo_tpu.features.frontend import detect_and_describe as j_detect_and_describe
from ergo_uvo_tpu.image import build_preprocess_plan as j_build_plan
from ergo_uvo_tpu.image import preprocess_frame as j_preprocess_frame
from ergo_uvo_tpu.pipeline import run_mono_vo as j_run_mono_vo
import ergo_uvo_tpu_torch.cli as tcli
import ergo_uvo_tpu_torch.config as tconfig
import ergo_uvo_tpu_torch.eval.ate as tate
import ergo_uvo_tpu_torch.io.native as tnative
import ergo_uvo_tpu_torch.io.sequence as tsequence
import ergo_uvo_tpu_torch.io.synthetic as tsynthetic
import ergo_uvo_tpu_torch.utils.records as trecords
from ergo_uvo_tpu_torch.convert import (
    mono_state_from_numpy,
    mono_state_to_numpy,
    stereo_rig_from_numpy,
)
from ergo_uvo_tpu_torch.image import build_preprocess_plan, preprocess_frame
from ergo_uvo_tpu_torch.io.sequence import ArraySource
from ergo_uvo_tpu_torch.pipeline import (
    MonoFrameOutput,
    mono_vo_init,
    mono_vo_init_from,
    mono_vo_step,
    run_mono_vo,
    run_mono_vo_batched_features,
    run_mono_vo_streaming,
    run_stereo_vo,
    run_stereo_vo_streaming,
    stereo_vo_init,
    stereo_vo_init_from,
)
from ergo_uvo_tpu_torch.utils.checkpoint import load_stream_run, restore_state

ROOT_DIR = Path(__file__).resolve().parent.parent
PORT_DIR = ROOT_DIR / "ergo_uvo_tpu_torch"
CFG_KW = dict(surf=dict(min_hessian=60.0), max_keypoints=128, num_hypotheses=64)
N_FRAMES = 8
KEY = jax.random.PRNGKey(0)
MID = 3  # the step test starts from the JAX state after this frame
LENS_DISTORTION = np.array([-0.05, 0.01, 0.0, 0.0])  # the JAX package's benchmark plan
# The file's two JAX runs (raw and preprocessed frames, one shape) share this
# callable, so the second reuses the first's executable.
j_run_mono_vo_jit = jax.jit(j_run_mono_vo, static_argnames="cfg")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops on these small images are faster on one thread than spread
    over a shared host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_of(module):
    return module.MonoVOConfig(
        surf=module.SurfConfig(**CFG_KW["surf"]),
        max_keypoints=CFG_KW["max_keypoints"],
        num_hypotheses=CFG_KW["num_hypotheses"],
    )


def t(a):
    return torch.from_numpy(np.array(a))


def method_keys(i):
    k_e, k_h = jax.random.split(jax.random.split(KEY, N_FRAMES)[i])
    return {"essential": k_e, "homography": k_h}


def jax_minimal_sets(key, mask, num_hypotheses, set_size):
    idx, valid = j_sample(key, jnp.asarray(mask.numpy()), num_hypotheses, set_size)
    return torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(valid))


def frame_sampler(frame, method, mask, num_hypotheses, set_size):
    return jax_minimal_sets(method_keys(frame)[method], mask, num_hypotheses, set_size)


@pytest.fixture(scope="module")
def seq():
    return tsynthetic.make_mono_sequence(n_frames=N_FRAMES, height=128, width=160,
                                         dt=0.25, seed=3)


@pytest.fixture(scope="module")
def jax_outs(seq):
    _, outs = j_run_mono_vo_jit(
        jnp.asarray(seq.imgs_left), jnp.asarray(seq.timestamps), jnp.asarray(seq.ranges),
        jnp.asarray(seq.K), cfg_of(jconfig), KEY)
    return jax.tree.map(np.asarray, outs)


def assert_frames_match(port, ref):
    """The repo's contract for re-scheduled runs (tests/test_pipeline.py:230-241):
    discrete outputs exact, counts within 2, velocity to atol 5e-3, scale
    factor to rtol 1e-2.  The float tolerances absorb float32 reassociation
    between XLA and PyTorch through the LMEDS refit and Gauss-Newton."""
    for name in ("published", "validity", "used_essential", "num_features"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    for name in ("num_matches", "num_inliers", "num_3d_points"):
        diff = np.abs(getattr(port, name).astype(int) - getattr(ref, name))
        assert diff.max() <= 2, (name, getattr(port, name), getattr(ref, name))
    np.testing.assert_allclose(port.velocity, ref.velocity, atol=5e-3)
    np.testing.assert_allclose(port.scale_factor, ref.scale_factor, rtol=1e-2)


def test_run_mono_vo_matches_jax(seq, jax_outs):
    """(a) The whole slice against JAX run_mono_vo, frame by frame."""
    state, outs = run_mono_vo(t(seq.imgs_left), t(seq.timestamps), t(seq.ranges),
                              t(seq.K), cfg_of(tconfig), sampler=frame_sampler, device="cpu")
    port = type(outs)(*(x.numpy() for x in outs))
    assert not jax_outs.published[0] and jax_outs.published[1:].all()
    assert_frames_match(port, jax_outs)
    assert np.isfinite(port.velocity).all()
    assert bool(state.initialized)


def test_batched_features_runner_matches_run_mono_vo(seq):
    """``run_mono_vo_batched_features`` against the port's ``run_mono_vo`` on
    the same 8 frames and generator seed, under the contract of
    tests/test_pipeline.py:230-241 (discrete outputs exact, counts within 2,
    velocity atol 5e-3, scale factor rtol 1e-2).  The batch gives each frame
    the bits it gets alone, so here every field is equal, the state too."""
    cfg = cfg_of(tconfig)
    args = (seq.imgs_left, seq.timestamps, seq.ranges, seq.K, cfg)
    state_a, a = run_mono_vo(*args, torch.Generator().manual_seed(0), device="cpu")
    state_b, b = run_mono_vo_batched_features(*args, torch.Generator().manual_seed(0),
                                              device="cpu")
    assert_frames_match(type(b)(*(x.numpy() for x in b)), type(a)(*(x.numpy() for x in a)))
    assert bool(a.published[1:].all()) and bool(a.validity[1:].any())
    for x, y in zip(tuple(state_a) + tuple(a), tuple(state_b) + tuple(b)):
        assert torch.equal(x, y)
    # the injected sampler reaches the batched runner's frames as well
    _, c = run_mono_vo_batched_features(*(t(x) for x in args[:4]), cfg, sampler=frame_sampler,
                                        device="cpu")
    _, d = run_mono_vo(*(t(x) for x in args[:4]), cfg, sampler=frame_sampler, device="cpu")
    for x, y in zip(c, d):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def jax_preprocessed(seq):
    """JAX's ``preprocess_frame`` then JAX ``run_mono_vo`` with
    ``K = plan.new_K`` under the benchmark's plan (distortion
    [-0.05, 0.01, 0, 0], CLAHE on, clip 3.0): (plan, frames, outputs)."""
    h, w = seq.imgs_left.shape[1:]
    jplan = j_build_plan(seq.K, LENS_DISTORTION, w, h, w, True, 3.0)
    jimgs = jax.vmap(lambda im: j_preprocess_frame(jplan, im))(jnp.asarray(seq.imgs_left))
    _, jouts = j_run_mono_vo_jit(jimgs, jnp.asarray(seq.timestamps), jnp.asarray(seq.ranges),
                                 jplan.new_K, cfg_of(jconfig), KEY)
    return jplan, np.asarray(jimgs), jax.tree.map(np.asarray, jouts)


def port_plan(seq):
    h, w = seq.imgs_left.shape[1:]
    return build_preprocess_plan(seq.K, LENS_DISTORTION, w, h, w, True, 3.0, device="cpu")


def test_preprocessed_slice_matches_jax(seq, jax_preprocessed):
    """The mono path as the JAX package's benchmark runs it: the port's
    ``preprocess_frame`` then ``run_mono_vo`` with ``K = plan.new_K``,
    against JAX's ``preprocess_frame`` then JAX ``run_mono_vo``, under the
    benchmark's plan.

    At 160x128 CLAHE's tiles are 20x16, even, as the 80x60 tiles of the
    benchmark's 640x480 are, so JAX takes the path it takes there, and the
    port's one path rounds as that one does: the preprocessed frames are
    equal bit for bit.  (At 160x120 the tiles are 20x15 and JAX takes its
    other path, whose weights round differently: the frames then differ by
    up to 6e-5 gray levels, which moves one 3-D point across a gate on two
    frames and the scale factor, a median, by 6%.)  The frames' outputs hold
    the same contract as the raw slice."""
    jplan, jimgs, jouts = jax_preprocessed
    tplan = port_plan(seq)
    timgs = preprocess_frame(tplan, t(seq.imgs_left))
    np.testing.assert_array_equal(timgs.numpy(), jimgs)
    np.testing.assert_array_equal(tplan.new_K.numpy(), np.asarray(jplan.new_K))
    assert np.abs(timgs.numpy() - seq.imgs_left).mean() > 5.0  # CLAHE did its work

    _, outs = run_mono_vo(timgs, t(seq.timestamps), t(seq.ranges), tplan.new_K,
                          cfg_of(tconfig), sampler=frame_sampler, device="cpu")
    port = type(outs)(*(x.numpy() for x in outs))
    assert not jouts.published[0] and jouts.published[1:].all()
    assert_frames_match(port, jouts)
    assert np.isfinite(port.velocity).all()


def test_streaming_matches_jax(seq, jax_preprocessed):
    """The port's ``run_mono_vo_streaming`` on the raw frames (an
    ``ArraySource``, chunks of 4, the port's plan), its sampler fed the
    global frame index, against the JAX run of ``jax_preprocessed``, under
    the contract of tests/test_pipeline.py:230-241 (discrete outputs exact,
    counts within 2, velocity atol 5e-3, scale factor rtol 1e-2).  The
    outputs come back as numpy, every frame of the 8 streamed."""
    _, _, jouts = jax_preprocessed
    tplan = port_plan(seq)
    calls = []

    def sampler(frame, *args):
        calls.append(frame)
        return frame_sampler(frame, *args)

    source = ArraySource(seq.imgs_left, seq.timestamps, ranges=seq.ranges)
    _, outs = run_mono_vo_streaming(source, tplan, tplan.new_K, cfg_of(tconfig),
                                    torch.Generator().manual_seed(0), chunk_size=4,
                                    sampler=sampler, device="cpu")
    assert all(isinstance(x, np.ndarray) for x in outs) and outs.velocity.shape == (N_FRAMES, 3)
    assert sorted(set(calls)) == list(range(N_FRAMES))  # global indices across the chunks
    assert_frames_match(outs, jouts)


def test_step_from_jax_state_matches_jax(seq, jax_outs):
    """(b) One port step from a mid-sequence JAX state, via
    mono_state_from_numpy, against JAX's output on the next frame.

    After a steady frame the JAX scan carries that frame's features, its
    timestamp and its (R, t, SF) outputs; the state is assembled from JAX's
    ``detect_and_describe`` on frame MID and the scan's outputs there."""
    kpts, desc = jax.jit(lambda im: j_detect_and_describe(
        im, cfg_of(jconfig).surf, CFG_KW["max_keypoints"]))(jnp.asarray(seq.imgs_left[MID]))
    state_np = dict(
        prev_xy=np.asarray(kpts.xy), prev_desc=np.asarray(desc), prev_mask=np.asarray(kpts.mask),
        prev_time=np.asarray(seq.timestamps[MID]), R=jax_outs.R[MID], t=jax_outs.t[MID],
        SF=jax_outs.scale_factor[MID], initialized=np.asarray(True),
    )
    state = mono_state_from_numpy(state_np, "cpu")
    back = mono_state_to_numpy(state)
    for name, value in state_np.items():
        np.testing.assert_array_equal(back[name], value)
        assert back[name].dtype == value.dtype, name
    keys = method_keys(MID + 1)
    _, out = mono_vo_step(
        state, t(seq.imgs_left[MID + 1]), t(seq.timestamps[MID + 1]),
        t(seq.ranges[MID + 1]), t(seq.K), cfg_of(tconfig),
        sampler=lambda method, m, h, s: jax_minimal_sets(keys[method], m, h, s),
    )
    port = type(out)(*(v.numpy()[None] for v in out))
    ref = type(jax_outs)(*(v[MID + 1:MID + 2] for v in jax_outs))
    assert bool(port.published[0])
    assert_frames_match(port, ref)


@pytest.fixture(scope="module")
def tiny_seq():
    return tsynthetic.make_mono_sequence(n_frames=2, height=48, width=64, dt=0.25, seed=3)


@pytest.fixture(scope="module")
def saved_files(tiny_seq, tmp_path_factory):
    """A stream checkpoint and a saved state, written on the CPU."""
    from ergo_uvo_tpu_torch.utils.checkpoint import save_state, save_stream_head

    root = tmp_path_factory.mktemp("entry_points")
    state = mono_vo_init_from(cfg_of(tconfig), device="cpu")
    save_stream_head(str(root / "run.npz"), 0, state, torch.Generator().get_state(), 0, 2, 2)
    save_state(str(root / "state.pt"), state)
    return root


def _entry_points(tiny_seq, root):
    """Every entry point of the port, called without ``device``."""
    cfg = cfg_of(tconfig)
    scfg = tconfig.StereoVOConfig(surf=cfg.surf, max_keypoints=cfg.max_keypoints,
                                  num_hypotheses=cfg.num_hypotheses)
    mono_np = (tiny_seq.imgs_left, tiny_seq.timestamps, tiny_seq.ranges, tiny_seq.K)
    mono_t = tuple(t(a) for a in mono_np)
    rig = stereo_rig_from_numpy(
        dict(K_left=tiny_seq.K.astype(np.float32), K_right=tiny_seq.K.astype(np.float32),
             R_right=np.eye(3, dtype=np.float32),
             t_right=np.asarray([-0.33, 0.0, 0.0], np.float32)), "cpu")
    stereo_np = (tiny_seq.imgs_left, tiny_seq.imgs_left, tiny_seq.timestamps, rig)
    mono_src = ArraySource(tiny_seq.imgs_left, tiny_seq.timestamps, ranges=tiny_seq.ranges)
    stereo_src = ArraySource(tiny_seq.imgs_left, tiny_seq.timestamps,
                             imgs_right=tiny_seq.imgs_left)
    plan = build_preprocess_plan(tiny_seq.K, np.zeros(4), 64, 48, 64, False, 3.0, device="cpu")
    example = mono_vo_init_from(cfg, device="cpu")
    outs_example = MonoFrameOutput(*([np.zeros(0)] * len(MonoFrameOutput._fields)))
    return {
        "mono_vo_init": lambda: mono_vo_init(),
        "mono_vo_init_from": lambda: mono_vo_init_from(cfg),
        "run_mono_vo[numpy]": lambda: run_mono_vo(*mono_np, cfg),
        "run_mono_vo[tensors]": lambda: run_mono_vo(*mono_t, cfg),
        "run_mono_vo_batched_features": lambda: run_mono_vo_batched_features(*mono_np, cfg),
        "stereo_vo_init": lambda: stereo_vo_init(),
        "stereo_vo_init_from": lambda: stereo_vo_init_from(scfg),
        "run_stereo_vo": lambda: run_stereo_vo(*stereo_np, scfg),
        "build_preprocess_plan": lambda: build_preprocess_plan(
            tiny_seq.K, np.zeros(4), 64, 48, 64, True, 3.0),
        "run_mono_vo_streaming": lambda: run_mono_vo_streaming(
            mono_src, plan, tiny_seq.K, cfg, torch.Generator(), chunk_size=2),
        "run_stereo_vo_streaming": lambda: run_stereo_vo_streaming(
            stereo_src, plan, plan, rig, scfg, torch.Generator(), chunk_size=2),
        "load_stream_run": lambda: load_stream_run(str(root / "run.npz"), example, outs_example),
        "restore_state": lambda: restore_state(str(root / "state.pt"), example),
        "cli": lambda: tcli.main(["mono", "--synthetic", "2", "--synthetic-size", "64x48",
                                  "--out", str(root / "cli.jsonl")]),
    }


@pytest.mark.fast
@pytest.mark.parametrize("name", [
    "mono_vo_init", "mono_vo_init_from", "run_mono_vo[numpy]", "run_mono_vo[tensors]",
    "run_mono_vo_batched_features", "stereo_vo_init", "stereo_vo_init_from", "run_stereo_vo",
    "build_preprocess_plan", "run_mono_vo_streaming", "run_stereo_vo_streaming",
    "load_stream_run", "restore_state", "cli"])
def test_entry_points_default_to_the_card(tiny_seq, saved_files, monkeypatch, name):
    """With no ``device`` (no ``--device`` for the CLI) the entry points ask
    for the card and, where there is none, raise and name ``device="cpu"``;
    they never carry on on the CPU by themselves.  (torch.cuda.is_available
    is pinned to False so that the test says the same on a machine with a
    card.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _entry_points(tiny_seq, saved_files)[name]()
    assert not (saved_files / "cli.jsonl").exists()


@pytest.mark.fast
def test_run_stereo_vo_refuses_a_rig_or_state_on_another_device(tiny_seq):
    """A rig or a state that lies elsewhere than ``device`` raises; the meta
    device stands in for the other device here."""
    scfg = tconfig.StereoVOConfig(max_keypoints=32, num_hypotheses=8)
    rig_np = dict(K_left=tiny_seq.K.astype(np.float32), K_right=tiny_seq.K.astype(np.float32),
                  R_right=np.eye(3, dtype=np.float32), t_right=np.zeros(3, np.float32))
    frames = (tiny_seq.imgs_left, tiny_seq.imgs_left, tiny_seq.timestamps)
    with pytest.raises(ValueError, match="rig.K_left is on meta"):
        run_stereo_vo(*frames, stereo_rig_from_numpy(rig_np, "meta"), scfg, device="cpu")
    with pytest.raises(ValueError, match="state.prev_xy_l is on meta"):
        run_stereo_vo(*frames, stereo_rig_from_numpy(rig_np, "cpu"), scfg,
                      state=stereo_vo_init_from(scfg, device="meta"), device="cpu")


@pytest.mark.fast
def test_stereo_step_reads_nothing_back():
    """``stereo_vo_step`` and the PnP solver it calls hold no ``.item()``,
    ``.cpu()``, ``.tolist()`` or ``bool(...)``/``int(...)``/``float(...)`` of
    a tensor of their own: every gate is a mask (an AST scan of the step's
    body and of estimation/pnp.py and estimation/p3p.py)."""
    import inspect

    import ergo_uvo_tpu_torch.pipeline.stereo as stereo_mod

    sources = [inspect.getsource(stereo_mod.stereo_vo_step),
               (PORT_DIR / "estimation" / "pnp.py").read_text(),
               (PORT_DIR / "estimation" / "p3p.py").read_text()]
    offenders = []
    for src in sources:
        for node in ast.walk(ast.parse(src)):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in ("item", "cpu", "tolist", "numpy"):
                offenders.append(ast.unparse(node))
            if isinstance(f, ast.Name) and f.id in ("bool", "int", "float") and not all(
                    isinstance(a, ast.Constant) for a in node.args):
                offenders.append(ast.unparse(node))
    assert offenders == [], offenders


@pytest.mark.fast
def test_run_mono_vo_takes_numpy_and_tensors_alike():
    """On ``device="cpu"`` numpy inputs and CPU tensors give the same state
    and outputs, bit for bit (the same seed drives the minimal sets), and
    both lie on the device asked for.  Two frames of 128x96, the smallest
    size at which the second frame finds the 20 features it needs to
    publish (64x48 finds 7)."""
    cfg = cfg_of(tconfig)
    seq = tsynthetic.make_mono_sequence(n_frames=2, height=96, width=128, dt=0.25, seed=3)
    arrays = (seq.imgs_left, seq.timestamps, seq.ranges, seq.K)
    runs = []
    for inputs in (arrays, tuple(t(a) for a in arrays)):
        gen = torch.Generator(device="cpu").manual_seed(0)
        runs.append(run_mono_vo(*inputs, cfg, gen, device="cpu"))
    (state_a, outs_a), (state_b, outs_b) = runs
    for a, b in zip(tuple(state_a) + tuple(outs_a), tuple(state_b) + tuple(outs_b)):
        assert a.device.type == "cpu" and torch.equal(a, b)
    assert outs_a.velocity.shape == (2, 3) and bool(state_a.initialized)
    assert outs_a.published.tolist() == [False, True] and int(outs_a.num_matches[1]) >= 20


@pytest.mark.fast
def test_run_mono_vo_refuses_a_state_on_another_device(tiny_seq):
    """A state or a generator that lies elsewhere than ``device`` raises; the
    meta device stands in for the other device here."""
    cfg = cfg_of(tconfig)
    arrays = (tiny_seq.imgs_left, tiny_seq.timestamps, tiny_seq.ranges, tiny_seq.K)
    state = mono_vo_init_from(cfg, device="meta")
    with pytest.raises(ValueError, match="state.prev_xy is on meta"):
        run_mono_vo(*arrays, cfg, state=state, device="cpu")


@pytest.mark.fast
def test_host_copies_equal_their_originals():
    """(c) The host-only copies: config.py and io/synthetic.py hold every
    dataclass with the same fields and defaults, the same constants and
    derived descriptor_dim, and the same sequence arrays for one seed; the
    copies of io/sequence.py, io/native/, eval/ate.py, utils/records.py and
    the CLI's host helpers have the original's names and signatures (their
    outputs are held to the originals by tests/test_torch_streaming.py and
    tests/test_torch_cli.py)."""
    classes = [name for name, obj in vars(jconfig).items()
               if dataclasses.is_dataclass(obj) and isinstance(obj, type)]
    assert {"MonoVOConfig", "SurfConfig", "RansacConfig"} <= set(classes)
    for name in classes:
        jc, tc = getattr(jconfig, name), getattr(tconfig, name)
        jf = [(f.name, f.default) for f in dataclasses.fields(jc)]
        tf = [(f.name, f.default) for f in dataclasses.fields(tc)]
        assert [(n, repr(d)) for n, d in jf] == [(n, repr(d)) for n, d in tf], name
    for const in ("LEAST_SQUARES", "LMEDS", "RANSAC", "PNP_ITERATIVE", "PNP_EPNP"):
        assert getattr(jconfig, const) == getattr(tconfig, const)
    for det in ("SURF", "SIFT", "ORB", "AKAZE"):
        for ext in (False, True):
            kw = dict(feature_detector=det)
            assert (jconfig.MonoVOConfig(surf=jconfig.SurfConfig(extended=ext), **kw).descriptor_dim
                    == tconfig.MonoVOConfig(surf=tconfig.SurfConfig(extended=ext), **kw).descriptor_dim)
    a = jsynthetic.make_mono_sequence(n_frames=3, height=48, width=64, seed=7)
    b = tsynthetic.make_mono_sequence(n_frames=3, height=48, width=64, seed=7)
    for name in a._fields:
        if getattr(a, name) is None:
            assert getattr(b, name) is None
        else:
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name), err_msg=name)
    copies = [
        (jsequence, tsequence, ["FrameBatch", "FrameSource", "JpegDirectorySource",
                                "JpegPairSource", "ArraySource"]),
        (jnative, tnative, ["available", "build_error", "decode_jpeg", "demosaic_bggr",
                            "JpegLoader"]),
        (jate, tate, ["umeyama_alignment", "ate_rmse", "rpe_rmse", "velocity_rmse",
                      "integrate_mono_poses", "integrate_mono_trajectory"]),
        (jrecords, trecords, ["RunRecorder"]),
        (jcli, tcli, ["_list_frames", "_parse_size", "_load_timestamps", "_pair_by_timestamp",
                      "_outs_example"]),
    ]
    for jmod, tmod, names in copies:
        for name in names:
            jobj, tobj = getattr(jmod, name), getattr(tmod, name)
            assert str(inspect.signature(tobj)) == str(inspect.signature(jobj)), name
            for meth in ("batches", "record_frame", "close", "__iter__"):
                if hasattr(jobj, meth):
                    assert (str(inspect.signature(getattr(tobj, meth)))
                            == str(inspect.signature(getattr(jobj, meth)))), (name, meth)
    assert jsequence.FrameBatch._fields == tsequence.FrameBatch._fields


@pytest.mark.fast
def test_port_imports_no_jax():
    """(d) No module of the port, not ``chip_smoke.py`` and not
    ``tools/port_accuracy_cpu.py`` imports jax or
    the JAX package, at any depth of the file.  An AST scan, not
    sys.modules: JAX may be imported into this interpreter by other means."""
    files = sorted(PORT_DIR.rglob("*.py")) + [ROOT_DIR / "chip_smoke.py",
                                               ROOT_DIR / "tools" / "port_accuracy_cpu.py"]
    assert len(files) >= 57 and all(f.is_file() for f in files[-2:])
    for part in ("cli.py", "io/native/__init__.py", "io/sequence.py", "eval/ate.py",
                 "utils/checkpoint.py", "features/sampling.py", "features/orb.py",
                 "features/sift.py", "features/akaze.py", "optim/ba.py",
                 "optim/pose_graph.py", "optim/keyframes.py", "optim/trajectory.py",
                 "geometry/se3.py"):
        assert PORT_DIR / part in files, part
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "ergo_uvo_tpu"):
                    offenders.append(f"{path.relative_to(ROOT_DIR)}: {name}")
    assert not offenders, offenders
