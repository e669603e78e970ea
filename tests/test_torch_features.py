"""Parity of the port's feature modules with the JAX package (CPU).

The JAX side runs as the JAX tests run it: ``detect_surf`` under ``jit``,
``top2_distances_pallas(..., interpret=True)`` and the XLA path of
``match_descriptors``.  The CUDA kernel itself is held to the plain version
in tests/test_torch_kernels.py, which imports no JAX so that it runs on the
machine with the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ergo_uvo_tpu.features import detector as jdet
from ergo_uvo_tpu.features.descriptor import describe_upright_surf as j_describe
from ergo_uvo_tpu.features.matcher import match_descriptors as j_match
from ergo_uvo_tpu.features.pallas_matcher import top2_distances_pallas
from ergo_uvo_tpu_torch.features import detector as tdet
from ergo_uvo_tpu_torch.features import top2_matcher
from ergo_uvo_tpu_torch.features.descriptor import describe_upright_surf as t_describe
from ergo_uvo_tpu_torch.features.matcher import match_and_gather, match_descriptors
from ergo_uvo_tpu_torch.io import make_mono_sequence

# The shapes of the kernel's contract: the main path (512 keypoints, 64-d
# SURF) and those of tests/test_features.py (odd Q, T and D, T < 8).
TOP2_SHAPES = [(512, 512, 64), (256, 256, 64), (37, 91, 64), (384, 200, 64),
               (8, 3, 128), (256, 512, 48)]


def t(a):
    return torch.from_numpy(np.array(a))


def unit_descs(n, d, seed):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def frame():
    """A 160x120 synthetic seafloor frame (the slice's test resolution)."""
    return make_mono_sequence(n_frames=1, height=120, width=160, seed=5).imgs_left[0]


@pytest.fixture(scope="module")
def jax_kpts(frame):
    return jax.jit(lambda im: jdet.detect_surf(im, 128, 60.0))(jnp.asarray(frame))


def test_detect_surf_matches_jax(frame, jax_kpts):
    """Same keypoint count (exact); on the valid slots xy and scale to 1e-3,
    laplacian exact, score to 1e-4 relative.  The integral image is bitwise
    equal (blocked scan), so only the last ulps of the box-filter arithmetic
    differ."""
    tk = tdet.detect_surf(t(frame), 128, 60.0)
    jm = np.asarray(jax_kpts.mask)
    assert int(tk.count) == int(jm.sum()) > 20
    np.testing.assert_array_equal(tk.mask.numpy(), jm)
    np.testing.assert_allclose(tk.xy.numpy()[jm], np.asarray(jax_kpts.xy)[jm], atol=1e-3)
    np.testing.assert_allclose(tk.scale.numpy()[jm], np.asarray(jax_kpts.scale)[jm], atol=1e-3)
    np.testing.assert_array_equal(tk.laplacian.numpy(), np.asarray(jax_kpts.laplacian))
    np.testing.assert_allclose(tk.score.numpy(), np.asarray(jax_kpts.score), rtol=1e-4)


@pytest.mark.parametrize("extended", [False, True], ids=["surf64", "surf128"])
def test_describe_upright_surf_matches_jax(frame, jax_kpts, extended):
    """Descriptors on the JAX keypoints to 1e-4: gathers against hat-weight
    matmuls compute the same clamped bilinear samples up to rounding."""
    jd = np.asarray(jax.jit(j_describe, static_argnums=2)(jnp.asarray(frame), jax_kpts, extended))
    kp = tdet.Keypoints(*(t(np.asarray(f)) for f in jax_kpts))
    td = t_describe(t(frame), kp, extended).numpy()
    assert td.shape == (128, 128 if extended else 64)
    np.testing.assert_allclose(td, jd, atol=1e-4)
    assert (td[~np.asarray(jax_kpts.mask)] == 0).all()


@pytest.mark.parametrize("q,tn,d", TOP2_SHAPES)
def test_top2_reference_matches_pallas(q, tn, d):
    """The plain version against the Pallas kernel in interpret mode, every
    5th train row masked: idx exact, distances to 1e-4 (squared distances of
    unit vectors lie in [0, 4])."""
    dq, dt = unit_descs(q, d, q), unit_descs(tn, d, tn + 1)
    mt = np.ones(tn, bool)
    mt[::5] = False
    jmin1, jidx1, jmin2 = top2_distances_pallas(
        jnp.asarray(dq), jnp.asarray(dt), jnp.asarray(mt), interpret=True
    )
    min1, idx1, min2 = top2_matcher.top2_distances(t(dq), t(dt), t(mt))
    assert idx1.dtype == torch.int32
    np.testing.assert_array_equal(idx1.numpy(), np.asarray(jidx1))
    np.testing.assert_allclose(min1.numpy(), np.asarray(jmin1), atol=1e-4)
    np.testing.assert_allclose(min2.numpy(), np.asarray(jmin2), atol=1e-4)


def test_top2_reference_edge_cases():
    """All columns masked -> (inf, 0, inf); T = 1 -> min2 = inf; exact
    duplicate train rows -> the lower index wins and min2 equals min1."""
    dq = unit_descs(6, 64, 1)
    inf = np.full(6, np.inf, np.float32)
    min1, idx1, min2 = top2_matcher.top2_distances(t(dq), t(dq), torch.zeros(6, dtype=torch.bool))
    np.testing.assert_array_equal(min1.numpy(), inf)
    np.testing.assert_array_equal(idx1.numpy(), np.zeros(6, np.int32))
    np.testing.assert_array_equal(min2.numpy(), inf)
    min1, idx1, min2 = top2_matcher.top2_distances(t(dq), t(dq[:1]), torch.ones(1, dtype=torch.bool))
    np.testing.assert_array_equal(idx1.numpy(), np.zeros(6, np.int32))
    np.testing.assert_array_equal(min2.numpy(), inf)
    dup = np.concatenate([dq, dq])
    min1, idx1, min2 = top2_matcher.top2_distances(t(dq), t(dup), torch.ones(12, dtype=torch.bool))
    np.testing.assert_array_equal(idx1.numpy(), np.arange(6, dtype=np.int32))
    np.testing.assert_array_equal(min1.numpy(), min2.numpy())


class TestMatcherContract:
    """The contract cases of tests/test_features.py:292-333 on the port, each
    also held equal to the JAX XLA path (masks and indices exact)."""

    @staticmethod
    def _both(dq, mq, dt, mt, ratio):
        m = match_descriptors(t(dq), t(mq), t(dt), t(mt), ratio)
        jm = j_match(jnp.asarray(dq), jnp.asarray(mq), jnp.asarray(dt), jnp.asarray(mt),
                     ratio=ratio, impl="xla")
        np.testing.assert_array_equal(m.mask.numpy(), np.asarray(jm.mask))
        np.testing.assert_array_equal(m.idx.numpy(), np.asarray(jm.idx))
        # d = sqrt(max(|q|^2 + |t|^2 - 2 q.t, 0)): for a near-duplicate pair
        # the argument is float32 cancellation noise (~1e-7), which the sqrt
        # turns into ~5e-4 in either package.
        np.testing.assert_allclose(m.dist.numpy(), np.asarray(jm.dist), atol=1e-3)
        return m

    @pytest.mark.fast
    def test_matches_numpy_bruteforce(self):
        dq, dt = unit_descs(64, 64, 1), unit_descs(64, 64, 2)
        m = self._both(dq, np.ones(64, bool), dt, np.ones(64, bool), 0.95)
        D = np.linalg.norm(dq[:, None, :] - dt[None, :, :], axis=-1)
        ok = m.mask.numpy()
        np.testing.assert_array_equal(m.idx.numpy()[ok], D.argmin(axis=1)[ok])
        d_sorted = np.sort(D, axis=1)
        np.testing.assert_array_equal(ok, d_sorted[:, 0] < 0.95 * d_sorted[:, 1])

    def test_ratio_test_rejects_ambiguous(self):
        dq = unit_descs(4, 64, 3)
        dt = np.concatenate([dq + 1e-4, dq - 1e-4]).astype(np.float32)
        m = self._both(dq, np.ones(4, bool), dt, np.ones(8, bool), 0.7)
        assert int(m.count) == 0

    def test_invalid_train_excluded(self):
        dq = unit_descs(8, 64, 4)
        dt = np.concatenate([dq * 0 + 99.0, dq]).astype(np.float32)
        mt = np.concatenate([np.zeros(8, bool), np.ones(8, bool)])
        m = self._both(dq, np.ones(8, bool), dt, mt, 0.99)
        assert (m.idx.numpy()[m.mask.numpy()] >= 8).all()

    def test_single_train_descriptor_rejected(self):
        dq = unit_descs(8, 64, 5)
        mt = np.zeros(8, bool)
        mt[0] = True
        m = self._both(dq, np.ones(8, bool), dq, mt, 0.7)
        assert int(m.count) == 0

    def test_match_and_gather_alignment(self):
        dq, dt = unit_descs(16, 64, 6), unit_descs(16, 64, 6)[::-1].copy()
        xy_q = np.random.default_rng(7).uniform(0, 100, (16, 2)).astype(np.float32)
        xy_t = xy_q[::-1].copy()
        prev, curr, m = match_and_gather(t(xy_q), t(dq), torch.ones(16, dtype=torch.bool),
                                         t(xy_t), t(dt), torch.ones(16, dtype=torch.bool))
        assert bool(m.mask.all())
        np.testing.assert_array_equal(prev.numpy(), curr.numpy())
