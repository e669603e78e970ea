"""Parity of the port's AKAZE (``features/akaze.py``) with the JAX package
(CPU), and the AKAZE checks of tests/test_akaze.py on the port.

The JAX functions run under ``jax.jit``, as tests/test_akaze.py runs them,
with 2 octaves x 2 sublevels and 128 keypoints, on a 160x200 synthetic
seafloor frame.  Not on tests/test_akaze.py's ``textured_image``: its
background is flat, and there the contrast factor's ``|grad| > 1e-8`` test,
which leaves flat pixels out, is decided by float32 rounding noise (~1e-8
gradients): JAX's own jitted and eager runs give k = 0.007726 and 0.007846
and 91 and 93 keypoints on it.  The port takes the checks of
tests/test_akaze.py on that image (the golden fixture, matching under a
shift), whose tolerances hold either way.  Tolerances, each stated where it
is used:

* exact: the M-LDB tables and the sigma schedule, the keypoint mask, count
  and evolution level;
* floats: the contrast factor to 1e-5 relative (the 70th percentile of
  gradient magnitudes ~0.01, each a difference of two blurred pixels whose
  last ulp, ~6e-8, XLA's fused multiply-adds round otherwise), evolution
  levels to 1e-6
  (0-1 images), det-Hessian responses to 1e-6 relative to the largest, xy to
  1e-3 px, sigma to 1e-4, angles to 1e-5 rad;
* bits: >= 99.9% of the valid bits agree, and every bit that differs is a
  near-tie, JAX's own two cell means within 1e-6 of each other.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_features import textured_image

from ergo_uvo_tpu.features import akaze as jakaze
from ergo_uvo_tpu_torch.features import akaze as takaze
from ergo_uvo_tpu_torch.features.detector import Keypoints
from ergo_uvo_tpu_torch.features.matcher import match_descriptors
from ergo_uvo_tpu_torch.io import make_mono_sequence

H, W, K, N_OCT, N_SUB = 160, 200, 128, 2, 2


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops on these small images are faster on one thread than spread
    over a shared host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frame():
    return make_mono_sequence(n_frames=1, height=H, width=W, seed=5).imgs_left[0]


@pytest.fixture(scope="module")
def jax_detected(frame):
    """JAX's keypoints and scale space (L, Lx, Ly per octave)."""
    fn = jax.jit(lambda im: jakaze.detect_akaze(im, K, 1e-3, N_OCT, N_SUB))
    return jax.tree.map(np.asarray, fn(jnp.asarray(frame)))


@pytest.fixture(scope="module")
def port_textured():
    img = textured_image(h=160, w=200, n_blobs=25, seed=11)
    return img, takaze.detect_and_describe_akaze(t(img), max_keypoints=128, n_octaves=2,
                                                 n_sublevels=2)


def jax_cell_diffs(space, kpts, upright):
    """JAX's (K, 162, 3) differences of the paired cell means, which
    describe_akaze thresholds at 0 (its body up to the comparison)."""
    n_k = kpts.xy.shape[0]
    angle = (jnp.zeros((n_k,), jnp.float32) if upright
             else jakaze._orientation(space, kpts, N_SUB))
    ca, sa = jnp.cos(angle), jnp.sin(angle)
    level = kpts.laplacian.astype(jnp.int32)
    pts = jnp.asarray(jakaze._CENTERS)[:, None, :] + jnp.asarray(jakaze._HALVES)[:, None, None] * \
        jnp.asarray(jakaze._SUB)[None]
    C, Pn, _ = pts.shape
    means = jnp.zeros((n_k, C, 3), jnp.float32)
    for o, (ls, lxs, lys) in enumerate(space):
        sel = (level // N_SUB) == o
        s_idx = jnp.clip(level - o * N_SUB, 0, ls.shape[0] - 1)
        step = float(1 << o)
        ext = jakaze.PATTERN_EXTENT * kpts.scale
        px = pts[None, ..., 0] * ext[:, None, None]
        py = pts[None, ..., 1] * ext[:, None, None]
        rx = ca[:, None, None] * px - sa[:, None, None] * py
        ry = sa[:, None, None] * px + ca[:, None, None] * py
        sx = (kpts.xy[:, 0, None, None] + rx) / step
        sy = (kpts.xy[:, 1, None, None] + ry) / step
        sflat = jnp.broadcast_to(s_idx[:, None, None], sx.shape).reshape(-1)
        m = [jnp.mean(jakaze._bilinear_stack(a, sflat, sx.reshape(-1), sy.reshape(-1))
                      .reshape(n_k, C, Pn), -1) for a in (ls, lxs, lys)]
        m_o = jnp.stack([m[0], ca[:, None] * m[1] + sa[:, None] * m[2],
                         -sa[:, None] * m[1] + ca[:, None] * m[2]], -1)
        means = jnp.where(sel[:, None, None], m_o, means)
    pairs = jnp.asarray(jakaze._PAIRS)
    return jnp.take(means, pairs[:, 0], axis=1) - jnp.take(means, pairs[:, 1], axis=1)


@pytest.mark.fast
def test_fixed_tables_equal_jax():
    """The M-LDB tables bit for bit and dtype for dtype, the sigma schedule
    exactly."""
    for name in ("_CENTERS", "_HALVES", "_SUB", "_PAIRS"):
        ours, ref = getattr(takaze, name), getattr(jakaze, name)
        assert ours.dtype == ref.dtype, name
        np.testing.assert_array_equal(ours, ref, err_msg=name)
    assert takaze._sigma_schedule(4, 4) == jakaze._sigma_schedule(4, 4)
    assert takaze.PATTERN_EXTENT == jakaze.PATTERN_EXTENT


def test_scale_space_matches_jax(frame):
    """The contrast factor (``nanquantile`` for ``nanpercentile``, both
    linear) to 1e-5 relative; every evolution level to 1e-6."""
    x = jnp.asarray(frame) / 255.0
    k_ref = float(jax.jit(jakaze._contrast_factor)(x))
    k = float(takaze._contrast_factor(t(frame)[None] / 255.0)[0])
    assert abs(k - k_ref) <= 1e-5 * k_ref, (k, k_ref)
    ref = jax.jit(lambda im: jakaze.build_nonlinear_scale_space(im, N_OCT, N_SUB))(jnp.asarray(frame))
    ours = takaze.build_nonlinear_scale_space(t(frame)[None], N_OCT, N_SUB)
    for a, b in zip(ours, ref):
        assert a.shape[1:] == b.shape
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), atol=1e-6)


def test_octave_response_matches_jax(jax_detected):
    """The sigma^4-normalized det-Hessian and (Lx, Ly) of JAX's levels: 1e-6
    relative to each stack's largest value."""
    _, space = jax_detected
    sigmas = jakaze._sigma_schedule(N_OCT, N_SUB)
    for o, (ls, lxs, lys) in enumerate(space):
        dets, tx, ty = takaze._octave_response(t(ls)[None], o, sigmas[o])
        jd = np.asarray(jakaze._octave_response(jnp.asarray(ls), o, sigmas[o])[0])
        for a, b in ((dets[0], jd), (tx[0], lxs), (ty[0], lys)):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-6 * np.abs(b).max())


def test_detect_akaze_matches_jax(frame, jax_detected):
    """Mask, count and evolution level exact; xy to 1e-3 px, sigma to 1e-4,
    responses to 1e-4 relative."""
    jk, _ = jax_detected
    tk, _ = takaze.detect_akaze(t(frame)[None], K, 1e-3, N_OCT, N_SUB)
    tk = Keypoints(*(f[0].numpy() for f in tk))
    m = jk.mask
    assert int(tk.mask.sum()) == int(m.sum()) > 30
    np.testing.assert_array_equal(tk.mask, m)
    np.testing.assert_array_equal(tk.laplacian, jk.laplacian)
    np.testing.assert_allclose(tk.xy, jk.xy, atol=1e-3)
    np.testing.assert_allclose(tk.scale, jk.scale, atol=1e-4)
    np.testing.assert_allclose(tk.score, jk.score, rtol=1e-4)


@pytest.mark.parametrize("upright", [False, True], ids=["oriented", "upright"])
def test_describe_akaze_bits_agree_but_at_near_ties(jax_detected, upright):
    """On JAX's keypoints and scale space: angles to 1e-5 rad; >= 99.9% of
    the valid bits agree, every bit that differs is a pair of cell means that
    JAX itself finds within 1e-6, the padding is zero, invalid rows zero."""
    jk, space = jax_detected
    jspace = jax.tree.map(jnp.asarray, space)
    jkp = jax.tree.map(jnp.asarray, jk)
    jd = np.asarray(jax.jit(lambda s, k: jakaze.describe_akaze(s, k, N_SUB, upright))(jspace, jkp))
    tspace = [tuple(t(a)[None] for a in o) for o in space]
    tkp = Keypoints(*(t(f)[None] for f in jk))
    td = takaze.describe_akaze(tspace, tkp, N_SUB, upright)[0].numpy()
    m = jk.mask
    if not upright:
        ja = np.asarray(jax.jit(lambda s, k: jakaze._orientation(s, k, N_SUB))(jspace, jkp))
        ta = takaze._orientation(tspace, tkp, N_SUB)[0].numpy()
        np.testing.assert_allclose(ta[m], ja[m], atol=1e-5)
    assert td.shape == (K, 512) and (td[:, 486:] == 0).all() and (td[~m] == 0).all()
    differ = td[m, :486] != jd[m, :486]
    assert differ.mean() <= 1e-3, differ.mean()
    diffs = np.asarray(jax.jit(lambda s, k: jax_cell_diffs(s, k, upright))(jspace, jkp))
    near = np.abs(diffs.reshape(K, -1))[m]
    assert (near[differ] < 1e-6).all(), near[differ]


@pytest.mark.fast
def test_matches_independent_golden():
    """tests/test_akaze.py:192-208 on the port: against the committed golden
    of an independent NumPy AKAZE (tests/fixtures/akaze_golden.npz), 4
    octaves x 4 sublevels, 256 keypoints: over half of the golden keypoints
    have one of the port's within 4 px, and over half of the port's have a
    golden one."""
    g = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "akaze_golden.npz"))
    np.testing.assert_array_equal(g["image_spec"], [160, 200, 25, 11])
    img = textured_image(h=160, w=200, n_blobs=25, seed=11)
    kp, _ = takaze.detect_akaze(t(img)[None], 256, 1e-3, 4, 4)
    xy = kp.xy[0].numpy()[kp.mask[0].numpy()]
    assert len(xy) >= 10
    d_ref = np.linalg.norm(g["xy"][:, None] - xy[None], axis=-1).min(1)
    d_ours = np.linalg.norm(xy[:, None] - g["xy"][None], axis=-1).min(1)
    assert (d_ref < 4.0).mean() > 0.5, (d_ref < 4.0).mean()
    assert (d_ours < 4.0).mean() > 0.5, (d_ours < 4.0).mean()


def test_descriptor_is_padded_binary(port_textured):
    """tests/test_akaze.py:117-124 on the port: 512 columns of {0, 1}, the
    tail past 486 all zero, the real bits varied."""
    _, (kpts, desc) = port_textured
    desc = desc.numpy()
    assert desc.shape == (128, 512)
    assert set(np.unique(desc).tolist()) <= {0.0, 1.0}
    assert (desc[:, 486:] == 0).all()
    assert desc[kpts.mask.numpy()][:, :486].std() > 0.1


def test_self_and_shift_matching(port_textured):
    """tests/test_akaze.py:127-158 on the port's frontend and Hamming
    matcher, ratio 0.8: matched against itself over 95% of the matches keep
    their slot; against the image rolled 6 px over 60% see the true shift
    within 2 px."""
    img, (kpts, desc) = port_textured
    m = match_descriptors(desc, kpts.mask, desc, kpts.mask, ratio=0.8, binary=True)
    ok = m.mask.numpy()
    assert (m.idx.numpy()[ok] == np.arange(128)[ok]).mean() > 0.95
    k2, d2 = takaze.detect_and_describe_akaze(t(np.roll(img, (0, 6), axis=(0, 1))),
                                              max_keypoints=128, n_octaves=2, n_sublevels=2)
    m2 = match_descriptors(desc, kpts.mask, d2, k2.mask, ratio=0.8, binary=True)
    ok = m2.mask.numpy()
    disp = k2.xy.numpy()[m2.idx.numpy()[ok]] - kpts.xy.numpy()[ok]
    assert (np.abs(disp - [6.0, 0.0]) < 2.0).all(axis=1).mean() > 0.6
