"""Parity of the port's SIFT (``features/sift.py``) with the JAX package (CPU).

The JAX functions run under ``jax.jit``, as the JAX tests run its detectors,
on a 160x200 synthetic seafloor frame with 2 octaves and 128 keypoints.
Tolerances, each stated where it is used:

* exact: the Gaussian kernels, the DoG extremum indices (layer, y, x) of
  every octave's slots, the merged keypoint mask and count;
* floats: Gaussian and DoG images to 1e-4 gray levels (0-255 images; the
  blurs add their taps in the same order); xy to 1e-3 px, sigma to 1e-3 px;
  the refined |DoG| score to 1e-4; descriptors to 1e-4;
* orientation: the 36-bin histogram's argmax may land on another bin only
  where JAX's own two top bins are within 1e-5 relative of each other, and
  the angle is then one bin away; elsewhere angles agree to 1e-5 rad (the
  bin's center, ``(bin + 0.5) / 36 * 2 pi - pi``, rounds differently under
  XLA's fusion by up to an ulp).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ergo_uvo_tpu.features import sampling as jsamp
from ergo_uvo_tpu.features import sift as jsift
from ergo_uvo_tpu_torch.features import sift as tsift
from ergo_uvo_tpu_torch.io import make_mono_sequence

H, W, K, N_OCT, N_SCALES, SIGMA0 = 160, 200, 128, 2, 3, 1.6


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
def jax_space(frame):
    fn = jax.jit(lambda im: jsift.build_scale_space(im, N_OCT, N_SCALES, SIGMA0))
    return [tuple(np.asarray(a) for a in o) for o in fn(jnp.asarray(frame))]


@pytest.fixture(scope="module")
def jax_octaves(jax_space):
    """JAX's per-octave keypoints (score, xy, sigma, layer, (y, x), mask)."""
    fn = jax.jit(lambda dog, o: jsift._octave_keypoints(dog, o, N_SCALES, SIGMA0, K, 0.03, 10.0),
                 static_argnums=1)
    return [jax.tree.map(np.asarray, fn(jnp.asarray(dog), o)) for o, (_, dog) in enumerate(jax_space)]


def jax_histogram(gauss, l_i, y_i, x_i, sigma_rel):
    """JAX's smoothed 36-bin orientation histogram, the first half of
    ergo_uvo_tpu/features/sift.py::_orientations_and_desc."""
    n_k = l_i.shape[0]
    spacing = 3.0 * sigma_rel / jsift._PATCH * 2.0
    x_f, y_f = x_i.astype(jnp.float32), y_i.astype(jnp.float32)
    patches = jnp.zeros((n_k, jsift._DESC_Q, jsift._DESC_Q), gauss.dtype)
    for layer in range(1, N_SCALES + 1):
        p_l = jsamp.extract_patches(gauss[layer], x_f, y_f, spacing, jsift._DESC_Q)
        patches = patches + jnp.where((l_i == layer)[:, None, None], p_l, 0.0)
    dxc = 0.5 * (patches[:, 1:-1, 2:] - patches[:, 1:-1, :-2])
    dyc = 0.5 * (patches[:, 2:, 1:-1] - patches[:, :-2, 1:-1])
    g1 = jnp.arange(jsift._PATCH, dtype=jnp.float32) - (jsift._PATCH - 1) / 2.0
    gy_, gx_ = jnp.meshgrid(g1, g1, indexing="ij")
    lo = (jsift._DESC_Q - jsift._PATCH) // 2 - 1
    dx0 = dxc[:, lo:lo + jsift._PATCH, lo:lo + jsift._PATCH]
    dy0 = dyc[:, lo:lo + jsift._PATCH, lo:lo + jsift._PATCH]
    mag0 = jnp.sqrt(dx0 * dx0 + dy0 * dy0)
    th0 = jnp.arctan2(dy0, dx0)
    gw = jnp.exp(-(gx_**2 + gy_**2) / (2.0 * (jsift._PATCH / 3.0) ** 2))
    b = (th0 + jnp.pi) / (2 * jnp.pi) * 36
    b0 = jnp.floor(b)
    fb = (b - b0).reshape(n_k, -1)
    b0i = b0.astype(jnp.int32).reshape(n_k, -1) % 36
    b1i = (b0i + 1) % 36
    wgt = (mag0 * gw[None]).reshape(n_k, -1)
    bins = jnp.arange(36)
    hist = jnp.einsum("ks,ksb->kb", wgt * (1 - fb), (b0i[..., None] == bins).astype(jnp.float32))
    hist = hist + jnp.einsum("ks,ksb->kb", wgt * fb, (b1i[..., None] == bins).astype(jnp.float32))
    for _ in range(2):
        hist = (jnp.roll(hist, 1, -1) + hist + jnp.roll(hist, -1, -1)) / 3.0
    return hist


@pytest.mark.fast
def test_gauss_kernels_equal_jax():
    """The kernel of every blur build_scale_space takes, bit for bit."""
    k = 2.0 ** (1.0 / N_SCALES)
    sigmas = [math.sqrt(SIGMA0**2 - 0.25)]
    sigmas += [math.sqrt((SIGMA0 * k**s) ** 2 - (SIGMA0 * k ** (s - 1)) ** 2) for s in range(1, 6)]
    for s in sigmas:
        ref = jsift._gauss_kernel(s)
        assert tsift._gauss_kernel(s).dtype == ref.dtype
        np.testing.assert_array_equal(tsift._gauss_kernel(s), ref)


def test_scale_space_matches_jax(frame, jax_space):
    """Every octave's Gaussians and DoGs to 1e-4 gray levels."""
    ours = tsift.build_scale_space(t(frame)[None], N_OCT, N_SCALES, SIGMA0)
    for (jg, jd), (tg, td) in zip(jax_space, ours):
        assert tg.shape[1:] == jg.shape
        np.testing.assert_allclose(tg[0].numpy(), jg, atol=1e-4)
        np.testing.assert_allclose(td[0].numpy(), jd, atol=1e-4)


def test_octave_keypoints_match_jax(jax_space, jax_octaves):
    """On JAX's DoG stacks: the extremum slots (layer, y, x) and the mask
    exactly, the refined xy and sigma to 1e-3 px, |DoG| scores to 1e-4."""
    for o, ((_, dog), ref) in enumerate(zip(jax_space, jax_octaves)):
        got = tsift._octave_keypoints(t(dog)[None], o, N_SCALES, SIGMA0, K, 0.03, 10.0)
        score, xy, sigma, l_i, (y_i, x_i), mask = (jax.tree.map(lambda v: v[0].numpy(), g)
                                                   for g in got)
        m = ref[5]
        assert m.sum() > 10
        np.testing.assert_array_equal(mask, m)
        for a, b in ((l_i, ref[3]), (y_i, ref[4][0]), (x_i, ref[4][1])):
            np.testing.assert_array_equal(a[m], b[m])
        np.testing.assert_allclose(score[m], ref[0][m], atol=1e-4)
        np.testing.assert_allclose(xy[m], ref[1][m], atol=1e-3)
        np.testing.assert_allclose(sigma[m], ref[2][m], atol=1e-3)


def test_orientation_and_descriptor_match_jax(jax_space, jax_octaves):
    """On JAX's Gaussians and keypoints: angles to 1e-5 rad except at
    histogram near-ties (module docstring), descriptors to 1e-4 where the
    angles agree, invalid rows zero."""
    fn = jax.jit(jsift._orientations_and_desc, static_argnums=6)
    n_checked = 0
    for o, ((gauss, _), ref) in enumerate(zip(jax_space, jax_octaves)):
        _, _, sigma, l_i, (y_i, x_i), m = ref
        sigma_rel = sigma / float(1 << o)
        j_ang, j_desc = (np.asarray(v) for v in fn(jnp.asarray(gauss), l_i, y_i, x_i, sigma_rel, m,
                                                   N_SCALES))
        t_ang, t_desc = tsift._orientations_and_desc(
            t(gauss)[None], *(t(v)[None] for v in (l_i, y_i, x_i, sigma_rel, m)), N_SCALES)
        t_ang, t_desc = t_ang[0].numpy(), t_desc[0].numpy()
        flip = m & (np.abs(t_ang - j_ang) > 1e-5)
        if flip.any():
            hist = np.sort(np.asarray(jax_histogram(jnp.asarray(gauss), l_i, y_i, x_i, sigma_rel)), -1)
            top, second = hist[flip, -1], hist[flip, -2]
            assert ((top - second) <= 1e-5 * top).all(), (top, second)
            assert np.allclose(np.abs(t_ang - j_ang)[flip], 2 * np.pi / 36, atol=1e-5)
        same = m & ~flip
        assert same.sum() >= 0.99 * m.sum()
        np.testing.assert_allclose(t_desc[same], j_desc[same], atol=1e-4)
        assert (t_desc[~m] == 0).all()
        n_checked += int(same.sum())
    assert n_checked > 20


def test_detect_and_describe_sift_matches_jax(frame):
    """The whole SIFT frontend: mask and count exact, xy and scale to 1e-3 px,
    scores to 1e-4, angles to 1e-5 rad, descriptors to 1e-4 (no orientation
    near-tie on this frame)."""
    fn = jax.jit(lambda im: jsift.detect_and_describe_sift(im, K, n_octaves=N_OCT))
    jk, jd = jax.tree.map(np.asarray, fn(jnp.asarray(frame)))
    tk, td = tsift.detect_and_describe_sift(t(frame), K, n_octaves=N_OCT)
    m = jk.mask
    assert int(tk.count) == int(m.sum()) > 30
    np.testing.assert_array_equal(tk.mask.numpy(), m)
    np.testing.assert_allclose(tk.xy.numpy(), jk.xy, atol=1e-3)
    np.testing.assert_allclose(tk.scale.numpy(), jk.scale, atol=1e-3)
    np.testing.assert_allclose(tk.score.numpy(), jk.score, atol=1e-4)
    np.testing.assert_allclose(tk.laplacian.numpy(), jk.laplacian, atol=1e-5)
    assert td.shape == (K, 128)
    np.testing.assert_allclose(td.numpy(), jd, atol=1e-4)
