"""The port's mono slice against JAX ``run_mono_vo`` (CPU), the state
hand-over between the packages, the host-only copies, and the port's
freedom from JAX.

The slice runs under the config and sequence of
tests/test_pipeline.py:219-227 (SURF, min_hessian 60, 128 keypoints, 64
hypotheses, LMEDS; 8 frames of 160x120 from ``make_mono_sequence(seed=3)``),
so the JAX scan compiled here is the one that test compiles.  Both packages
draw the same minimal sets: the port's sampler calls the JAX package's
``sample_minimal_sets`` with the keys JAX derives, ``keys = split(key, 8)``
and ``k_e, k_h = split(keys[i])`` for frame i.
"""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ergo_uvo_tpu.config as jconfig
import ergo_uvo_tpu.io.synthetic as jsynthetic
from ergo_uvo_tpu.estimation.sampling import sample_minimal_sets as j_sample
from ergo_uvo_tpu.features.frontend import detect_and_describe as j_detect_and_describe
from ergo_uvo_tpu.pipeline import run_mono_vo as j_run_mono_vo
import ergo_uvo_tpu_torch.config as tconfig
import ergo_uvo_tpu_torch.io.synthetic as tsynthetic
from ergo_uvo_tpu_torch.convert import mono_state_from_numpy, mono_state_to_numpy
from ergo_uvo_tpu_torch.pipeline import mono_vo_init, mono_vo_init_from, mono_vo_step, run_mono_vo

PORT_DIR = Path(__file__).resolve().parent.parent / "ergo_uvo_tpu_torch"
CFG_KW = dict(surf=dict(min_hessian=60.0), max_keypoints=128, num_hypotheses=64)
N_FRAMES = 8
KEY = jax.random.PRNGKey(0)
MID = 3  # the step test starts from the JAX state after this frame


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
    return tsynthetic.make_mono_sequence(n_frames=N_FRAMES, height=120, width=160,
                                         dt=0.25, seed=3)


@pytest.fixture(scope="module")
def jax_outs(seq):
    _, outs = j_run_mono_vo(
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


@pytest.mark.fast
def test_entry_points_default_to_the_card(tiny_seq, monkeypatch):
    """With no ``device`` the entry points ask for the card and, where there
    is none, raise and name ``device="cpu"``; they never carry on on the CPU
    by themselves.  (torch.cuda.is_available is pinned to False so that the
    test says the same on a machine with a card.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = cfg_of(tconfig)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mono_vo_init()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mono_vo_init_from(cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run_mono_vo(tiny_seq.imgs_left, tiny_seq.timestamps, tiny_seq.ranges, tiny_seq.K, cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run_mono_vo(t(tiny_seq.imgs_left), t(tiny_seq.timestamps), t(tiny_seq.ranges),
                    t(tiny_seq.K), cfg)


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
    """(c) config.py and io/synthetic.py are copies: every dataclass with the
    same fields and defaults, the same constants and derived descriptor_dim,
    and the same sequence arrays for one seed."""
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


@pytest.mark.fast
def test_port_imports_no_jax():
    """(d) No module of the port imports jax or the JAX package, at any
    depth of the file.  An AST scan, not sys.modules: JAX may be imported
    into this interpreter by other means."""
    files = sorted(PORT_DIR.rglob("*.py"))
    assert len(files) > 15
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
                    offenders.append(f"{path.relative_to(PORT_DIR)}: {name}")
    assert not offenders, offenders
