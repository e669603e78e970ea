"""Parity of the port's ORB (``features/orb.py``) and patch samplers
(``features/sampling.py``) with the JAX package (CPU), and the ORB checks of
tests/test_features.py on the port.

The JAX detector and descriptor run as the JAX tests run them, under
``jax.jit``, on a 160x200 synthetic seafloor frame at threshold 10 (the
configs' default).  Tolerances, each stated where it is used:

* exact: the BRIEF pattern and the level shapes, FAST score maps on the same
  level image, the keypoint mask, count and slots (xy and scale);
* floats: samples to 1e-4 gray levels; the disc moments to 1e-5 relative;
  angles to 1e-5 rad on the same level image, 1e-4 rad through the pyramid
  (the resize is a float32 matmul in both packages, whose summation order
  moves a level image by ~1e-5 gray levels, and the moments amplify that);
* bits: >= 99.9% of the valid bits agree, and every bit that differs is a
  near-tie, JAX's own two sample intensities within 1e-3 of each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_features import textured_image

from ergo_uvo_tpu.features import orb as jorb
from ergo_uvo_tpu.features import sampling as jsamp
from ergo_uvo_tpu_torch.features import orb as torb
from ergo_uvo_tpu_torch.features import sampling as tsamp
from ergo_uvo_tpu_torch.features.detector import Keypoints
from ergo_uvo_tpu_torch.features.frontend import detect_and_describe
from ergo_uvo_tpu_torch.features.matcher import match_descriptors
from ergo_uvo_tpu_torch.io import make_mono_sequence

H, W, K, THRESHOLD = 160, 200, 256, 10.0


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
def jax_orb(frame):
    img = jnp.asarray(frame)
    kpts = jax.jit(lambda im: jorb.detect_orb(im, K, THRESHOLD))(img)
    desc = jax.jit(jorb.describe_orb)(img, kpts)
    return kpts, np.asarray(desc)


def jax_brief_samples(img, kpts):
    """JAX's two sample intensities of every BRIEF test, as describe_orb
    computes them."""
    pat = jnp.asarray(jorb._PATTERN)
    c, s = jnp.cos(kpts.laplacian)[:, None], jnp.sin(kpts.laplacian)[:, None]
    patches = jsamp.extract_patches(img, kpts.xy[:, 0], kpts.xy[:, 1], kpts.scale, jorb._BRIEF_Q)
    center = (jorb._BRIEF_Q - 1) / 2.0

    def sample(px, py):
        rx, ry = c * px[None] - s * py[None], s * px[None] + c * py[None]
        return jsamp.sample_patch(patches, center + ry, center + rx)

    return sample(pat[:, 0], pat[:, 1]), sample(pat[:, 2], pat[:, 3])


@pytest.mark.fast
def test_fixed_tables_equal_jax():
    """The BRIEF pattern bit for bit, the pyramid's level shapes (Python
    ``round``) and the disc kernels exactly."""
    assert torb._PATTERN.dtype == jorb._PATTERN.dtype
    np.testing.assert_array_equal(torb._PATTERN, jorb._PATTERN)
    for h, w in ((480, 640), (240, 320), (160, 200), (120, 160), (40, 34)):
        assert torb._level_shapes(h, w, 8, 1.2) == jorb._level_shapes(h, w, 8, 1.2)
    gx, gy, disc = jorb._disc_offsets()
    kx, ky = torb._disc_kernels(torch.device("cpu"))
    np.testing.assert_array_equal(kx.numpy(), np.asarray(gx * disc))
    np.testing.assert_array_equal(ky.numpy(), np.asarray(gy * disc))


@pytest.mark.fast
@pytest.mark.parametrize("case", ["test_sampling_positions", "seeded_batch"])
def test_hat_matrix_matches_jax(case):
    """``hat_matrix`` gives the JAX package's weights bit for bit: on the
    positions of tests/test_sampling.py (a tap on the grid, one off each
    end, 4.2 whose partner 5 is off the grid) and on a seeded (3, 17) batch
    of positions around a grid of 11, some off it."""
    if case == "test_sampling_positions":
        pos, n = np.float32([1.25, 0.0, -0.5, 4.2]), 5
    else:
        pos, n = np.random.default_rng(10).uniform(-2.0, 12.0, (3, 17)).astype(np.float32), 11
    want = np.asarray(jsamp.hat_matrix(jnp.asarray(pos), n))
    got = tsamp.hat_matrix(t(pos), n).numpy()
    assert got.shape == want.shape == (*pos.shape, n) and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_extract_patches_and_sample_patch_match_jax():
    """Random centers and spacings, some patches reaching off the image and
    one wholly outside it (all zero in both: a tap off the grid adds zero),
    then random positions inside the patches, some off them: 1e-4 gray
    levels against the hat-weight matmuls."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (60, 80)).astype(np.float32)
    n_k, P = 24, 9
    cx = rng.uniform(-5, 85, n_k).astype(np.float32)
    cy = rng.uniform(-5, 65, n_k).astype(np.float32)
    cx[0], cy[0] = -40.0, 30.0
    spacing = rng.uniform(0.5, 2.5, n_k).astype(np.float32)
    jp = np.asarray(jsamp.extract_patches(jnp.asarray(img), *(jnp.asarray(v) for v in (cx, cy, spacing)), P))
    tp = tsamp.extract_patches(t(img), t(cx), t(cy), t(spacing), P)
    np.testing.assert_allclose(tp.numpy(), jp, atol=1e-4)
    assert (jp[0] == 0).all() and (tp[0] == 0).all()
    assert (jp == 0).any(axis=(1, 2)).sum() > 3  # patches that reach off the image
    u = rng.uniform(-1.5, P + 0.5, (n_k, 40)).astype(np.float32)
    v = rng.uniform(-1.5, P + 0.5, (n_k, 40)).astype(np.float32)
    js = np.asarray(jsamp.sample_patch(jnp.asarray(jp), jnp.asarray(u), jnp.asarray(v)))
    ts = tsamp.sample_patch(t(jp), t(u), t(v)).numpy()
    np.testing.assert_allclose(ts, js, atol=1e-4)


@pytest.mark.fast
def test_conv2d_same_matches_jax():
    """The disc-moment correlations (31x31, SAME) of a random image: 1e-5
    relative to the largest moment (float32 sums of ~700 terms in another
    order)."""
    img = np.random.default_rng(1).uniform(0, 255, (40, 50)).astype(np.float32)
    gx, gy, disc = jorb._disc_offsets()
    for kern in (gx * disc, gy * disc):
        ref = np.asarray(jsamp.conv2d_same(jnp.asarray(img), kern))
        got = tsamp.conv2d_same(t(img), t(kern)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


def test_fast_score_matches_jax(frame):
    """FAST-9 score maps exactly, on the frame and on its second pyramid
    level (the same level image given to both)."""
    lh, lw = jorb._level_shapes(H, W, 8, 1.2)[1]
    level = tsamp.resize_bilinear(t(frame), lh, lw).numpy()
    for img in (frame, level):
        ref = np.asarray(jorb.fast_score(jnp.asarray(img), THRESHOLD, margin=jorb._BRIEF_MARGIN))
        got = torb.fast_score(t(img)[None], THRESHOLD, margin=torb._BRIEF_MARGIN)[0].numpy()
        np.testing.assert_array_equal(got, ref)
        assert (ref > 0).sum() > 20


def test_orientations_match_jax(frame):
    """Intensity-centroid angles at the FAST peaks of the frame, the same
    image in both: 1e-5 rad."""
    score = np.asarray(jorb.fast_score(jnp.asarray(frame), THRESHOLD))
    idx = np.flatnonzero(score > 0)[:300].astype(np.int32)
    ref = np.asarray(jax.jit(jorb._orientations)(jnp.asarray(frame), jnp.asarray(idx)))
    got = torb._orientations(t(frame)[None], t(idx).long()[None])[0].numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_detect_orb_matches_jax(frame, jax_orb):
    """Mask, count and slots exact (xy and scale are pyramid pixel indices
    times 1.2^level); scores to 1e-4 relative; angles to 1e-5 rad on level
    0 and 1e-4 rad on the resized levels (module docstring)."""
    jk, _ = jax_orb
    tk = torb.detect_orb(t(frame), K, THRESHOLD)
    m = np.asarray(jk.mask)
    assert int(tk.count) == int(m.sum()) > 50
    np.testing.assert_array_equal(tk.mask.numpy(), m)
    np.testing.assert_array_equal(tk.xy.numpy(), np.asarray(jk.xy))
    np.testing.assert_array_equal(tk.scale.numpy(), np.asarray(jk.scale))
    np.testing.assert_allclose(tk.score.numpy(), np.asarray(jk.score), rtol=1e-4)
    ang_err = np.abs(tk.laplacian.numpy() - np.asarray(jk.laplacian))
    level0 = np.asarray(jk.scale) == 1.0
    assert level0[m].sum() >= 5 and (~level0[m]).sum() > 10
    assert ang_err[level0].max() <= 1e-5 and ang_err.max() <= 1e-4, ang_err.max()


def test_describe_orb_bits_agree_but_at_near_ties(frame, jax_orb):
    """On JAX's keypoints: >= 99.9% of the valid bits agree, and every bit
    that differs is a test whose two intensities JAX itself finds within
    1e-3 gray levels of each other."""
    jk, jd = jax_orb
    kp = Keypoints(*(t(f) for f in jk))
    td = torb.describe_orb(t(frame), kp).numpy()
    m = np.asarray(jk.mask)
    assert td.shape == (K, 256) and set(np.unique(td).tolist()) <= {0.0, 1.0}
    assert (td[~m] == 0).all()
    differ = td[m] != jd[m]
    assert differ.mean() <= 1e-3, differ.mean()
    i1, i2 = (np.asarray(a)[m] for a in jax.jit(jax_brief_samples)(jnp.asarray(frame), jk))
    assert (np.abs(i1 - i2)[differ] < 1e-3).all(), np.abs(i1 - i2)[differ]


@pytest.mark.fast
def test_featureless_image_is_empty():
    """A flat image has no corner (tests/test_features.py:260-265)."""
    k = torb.detect_orb(torch.full((120, 160), 80.0), max_keypoints=64)
    assert int(k.count) == 0


def test_corners_repeat_under_shift():
    """tests/test_features.py:230-244 on the port: keypoints of a textured
    image and of it rolled 7 px, threshold 12: > 70% of the interior ones
    within 2 px of a keypoint of the shifted image."""
    img = textured_image()
    k1 = torb.detect_orb(t(img), max_keypoints=256, threshold=12.0)
    k2 = torb.detect_orb(t(np.roll(img, (0, 7), axis=(0, 1))), max_keypoints=256, threshold=12.0)
    xy1 = k1.xy.numpy()[k1.mask.numpy()]
    xy2 = k2.xy.numpy()[k2.mask.numpy()]
    assert len(xy1) > 20 and len(xy2) > 20
    moved = xy1 + [7, 0]
    interior = (moved[:, 0] > 25) & (moved[:, 0] < 295)
    d = np.linalg.norm(moved[interior, None, :] - xy2[None, :, :], axis=-1)
    assert (d.min(axis=1) < 2.0).mean() > 0.7


def test_descriptors_match_under_shift():
    """tests/test_features.py:246-258 on the port's frontend and Hamming
    matcher: a textured image against itself rolled 5 px, ratio 0.8: more
    than 15 matches, over 70% of them at the true shift within 1.5 px."""
    img = textured_image()
    k1, d1 = detect_and_describe(t(img), max_keypoints=256, feature_detector="ORB")
    k2, d2 = detect_and_describe(t(np.roll(img, (0, 5), axis=(0, 1))), max_keypoints=256,
                                 feature_detector="ORB")
    assert d1.shape == (256, 256)
    m = match_descriptors(d1, k1.mask, d2, k2.mask, ratio=0.8, binary=True)
    ok = m.mask.numpy()
    assert ok.sum() > 15, ok.sum()
    xy1 = k1.xy.numpy()[ok]
    xy2 = k2.xy.numpy()[m.idx.numpy()[ok]]
    good = (np.abs(xy2[:, 0] - xy1[:, 0] - 5) < 1.5) & (np.abs(xy2[:, 1] - xy1[:, 1]) < 1.5)
    assert good.mean() > 0.7, good.mean()
