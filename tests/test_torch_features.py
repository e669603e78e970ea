"""Parity of the port's SURF detector, its upright and oriented descriptors
and the matcher (L2 and Hamming) with the JAX package (CPU), and the SURF
pins of tests/test_surf_pins.py on the port's own front end.

The JAX side runs as the JAX tests run it: ``detect_surf`` under ``jit``,
``top2_distances_pallas(..., interpret=True)`` and the XLA path of
``match_descriptors``.  The CUDA kernel itself is held to the plain version
in tests/test_torch_kernels.py, which imports no JAX so that it runs on the
machine with the card.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_features import textured_image

from ergo_uvo_tpu.features import detector as jdet
from ergo_uvo_tpu.features.descriptor import describe_surf as j_describe_surf
from ergo_uvo_tpu.features.descriptor import describe_upright_surf as j_describe
from ergo_uvo_tpu.features.descriptor import surf_orientations as j_surf_orientations
from ergo_uvo_tpu.features.matcher import match_descriptors as j_match
from ergo_uvo_tpu.features.pallas_matcher import top2_distances_pallas
from ergo_uvo_tpu_torch.features import detector as tdet
from ergo_uvo_tpu_torch.features import top2_matcher
from ergo_uvo_tpu_torch.features.descriptor import describe_surf as t_describe_surf
from ergo_uvo_tpu_torch.features.descriptor import describe_upright_surf as t_describe
from ergo_uvo_tpu_torch.features.descriptor import surf_orientations as t_surf_orientations
from ergo_uvo_tpu_torch.features.matcher import match_and_gather, match_descriptors
from ergo_uvo_tpu_torch.io import make_mono_sequence

# The shapes of the kernel's contract: the main path (512 keypoints, 64-d
# SURF) and those of tests/test_features.py (odd Q, T and D, T < 8).
TOP2_SHAPES = [(512, 512, 64), (256, 256, 64), (37, 91, 64), (384, 200, 64),
               (8, 3, 128), (256, 512, 48)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops on these small images are faster on one thread than spread
    over a shared host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def test_surf_orientations_match_jax(frame, jax_kpts):
    """Oriented SURF's dominant angle on the JAX keypoints to 1e-5 rad: the
    window starts are jnp.linspace's float32 values, so the 60-degree
    windows hold the same responses."""
    ja = np.asarray(jax.jit(j_surf_orientations)(jnp.asarray(frame), jax_kpts))
    kp = tdet.Keypoints(*(t(np.asarray(f))[None] for f in jax_kpts))
    ta = t_surf_orientations(t(frame)[None], kp)[0].numpy()
    m = np.asarray(jax_kpts.mask)
    np.testing.assert_allclose(ta[m], ja[m], atol=1e-5)


@pytest.mark.parametrize("extended", [False, True], ids=["surf64", "surf128"])
def test_describe_oriented_surf_matches_jax(frame, jax_kpts, extended):
    """``describe_surf(upright=False)`` on the JAX keypoints to 1e-4, for one
    frame and for a batch of two frames (the second one flipped)."""
    fn = jax.jit(lambda im, k: j_describe_surf(im, k, extended, False))
    jd = np.asarray(fn(jnp.asarray(frame), jax_kpts))
    kp = tdet.Keypoints(*(t(np.asarray(f)) for f in jax_kpts))
    td = t_describe_surf(t(frame), kp, extended, upright=False).numpy()
    assert td.shape == (128, 128 if extended else 64)
    np.testing.assert_allclose(td, jd, atol=1e-4)
    assert (td[~np.asarray(jax_kpts.mask)] == 0).all()
    pair = t(np.stack([frame, frame[::-1]]))
    kp2 = tdet.Keypoints(*(torch.stack([f, f]) for f in kp))
    tb = t_describe_surf(pair, kp2, extended, upright=False)
    assert torch.equal(tb[0], t(td))
    np.testing.assert_allclose(tb[1].numpy(), np.asarray(fn(jnp.asarray(frame[::-1]), jax_kpts)),
                               atol=1e-4)


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


class TestHammingMatcher:
    """``binary=True`` (ORB 256 bits, AKAZE 512) against the JAX XLA path:
    distances are integers, so masks, indices and distances are exact."""

    @staticmethod
    def _both(dq, mq, dt, mt, ratio):
        m = match_descriptors(t(dq), t(mq), t(dt), t(mt), ratio, binary=True)
        jm = j_match(jnp.asarray(dq), jnp.asarray(mq), jnp.asarray(dt), jnp.asarray(mt),
                     ratio=ratio, impl="xla", binary=True)
        for got, ref in zip(m, jm):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        return m

    @staticmethod
    def _bits(n, d, seed):
        return np.random.default_rng(seed).integers(0, 2, (n, d)).astype(np.float32)

    @pytest.mark.parametrize("d", [256, 512])
    def test_random_bits_match_jax(self, d):
        """Random bit rows, queries near a train row (a few bits flipped),
        every 5th train row masked, ratio 0.8; the distance is the Hamming
        count itself, with no square root."""
        dt = self._bits(96, d, d)
        dq = dt[:64].copy()
        flips = np.random.default_rng(1).integers(0, d, (64, 8))
        np.put_along_axis(dq, flips, 1.0 - np.take_along_axis(dq, flips, 1), 1)
        mt = np.ones(96, bool)
        mt[::5] = False
        m = self._both(dq, np.ones(64, bool), dt, mt, 0.8)
        ok = m.mask.numpy()
        assert ok.sum() > 40
        ham = (dq[:, None, :] != dt[None, :, :]).sum(-1)
        np.testing.assert_array_equal(m.dist.numpy()[ok], ham[ok, m.idx.numpy()[ok]])

    def test_ties_go_to_the_lower_index(self):
        """Duplicate train rows give equal best and second distances (the
        ratio test rejects them); a row that ties two train rows at equal
        distance keeps the lower index in the kernel's distances."""
        dt = self._bits(32, 256, 3)
        dt = np.concatenate([dt, dt])  # every row twice
        min1, idx1, min2 = top2_matcher.top2_distances(t(dt[:32]), t(dt), torch.ones(64, dtype=torch.bool))
        np.testing.assert_array_equal(idx1.numpy(), np.arange(32, dtype=np.int32))
        np.testing.assert_array_equal(min1.numpy(), min2.numpy())
        m = self._both(dt[:32], np.ones(32, bool), dt, np.ones(64, bool), 0.8)
        assert int(m.count) == 0
        same = np.zeros((8, 256), np.float32)  # every train row at distance 0
        self._both(same, np.ones(8, bool), same, np.ones(8, bool), 0.8)

    def test_fewer_than_two_train_rows(self):
        """One valid train row, or none: no match at all."""
        dq = self._bits(8, 256, 4)
        for n_valid in (0, 1):
            mt = np.zeros(8, bool)
            mt[:n_valid] = True
            assert int(self._both(dq, np.ones(8, bool), dq, mt, 0.8).count) == 0


def _nearest(a, b):
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return d2.argmin(1), np.sqrt(d2.min(1))


@pytest.mark.fast
def test_port_surf_matches_independent_golden():
    """The port's detector and descriptor against the committed golden of an
    independent NumPy SURF (tests/fixtures/surf_golden.npz), with the
    thresholds of tests/test_surf_pins.py::test_surf_matches_independent_golden:
    the 40 strongest golden keypoints within 2 px (>= 0.95), all of them
    within 3 px (>= 0.92), median scale ratio in [0.9, 1.1], descriptor
    cosine mean >= 0.97 and min >= 0.90.  torch and numpy only."""
    g = np.load(Path(__file__).resolve().parent / "fixtures" / "surf_golden.npz")
    h, w, n_blobs, seed = (int(v) for v in g["image_spec"])
    img = t(textured_image(h=h, w=w, n_blobs=n_blobs, seed=seed))
    kpts = tdet.detect_surf(img, max_keypoints=256, min_hessian=100.0, n_octaves=2)
    desc = t_describe(img, kpts)
    mask = kpts.mask.numpy()
    xy_e, sc_e, d_e = kpts.xy.numpy()[mask], kpts.scale.numpy()[mask], desc.numpy()[mask]
    assert len(xy_e) >= 60
    j40, dist40 = _nearest(g["xy"][:40], xy_e)
    assert (dist40 < 2.0).mean() >= 0.95, dist40
    _, dist_all = _nearest(g["xy"], xy_e)
    assert (dist_all < 3.0).mean() >= 0.92, (dist_all < 3.0).mean()
    m = dist40 < 2.0
    ratio = sc_e[j40[m]] / g["scales"][:40][m]
    assert 0.9 <= float(np.median(ratio)) <= 1.1, np.median(ratio)
    cos = (d_e[j40[m]] * g["desc"][:40][m]).sum(-1)
    assert float(cos.mean()) >= 0.97, cos.mean()
    assert float(cos.min()) >= 0.90, cos.min()


@pytest.mark.fast
def test_port_surf_match_epipolar_inlier_rate():
    """The port's detector, descriptor and ``match_descriptors`` on the
    synthetic seafloor pair of seed 0, as
    tests/test_surf_pins.py::test_surf_match_epipolar_inlier_rate: at least
    120 matches, and >= 85% of them within 1.5 px of the ground-truth
    epipolar geometry (symmetric epipolar distance)."""
    seq = make_mono_sequence(n_frames=2, height=240, width=320, dt=0.25, seed=0)
    K = seq.K.astype(np.float64)
    Kinv = np.linalg.inv(K)
    ks, ds = [], []
    for i in range(2):
        im = t(seq.imgs_left[i])
        k = tdet.detect_surf(im, max_keypoints=256, min_hessian=60.0)
        ks.append(k)
        ds.append(t_describe(im, k))
    m = match_descriptors(ds[0], ks[0].mask, ds[1], ks[1].mask, 0.7)
    mask = m.mask.numpy()
    xy1 = ks[0].xy.numpy()[mask]
    xy2 = ks[1].xy.numpy()[m.idx.numpy()[mask]]
    assert len(xy1) >= 120, len(xy1)

    Rw, C = seq.rotations, seq.positions
    R_rel = Rw[1] @ Rw[0].T
    t_rel = Rw[1] @ (C[0] - C[1])
    t_rel = t_rel / np.linalg.norm(t_rel)
    E = np.cross(np.eye(3), t_rel) @ R_rel
    p1 = np.concatenate([xy1, np.ones((len(xy1), 1))], 1) @ Kinv.T
    p2 = np.concatenate([xy2, np.ones((len(xy2), 1))], 1) @ Kinv.T
    Ex1 = p1 @ E.T
    Etx2 = p2 @ E
    x2Ex1 = (p2 * Ex1).sum(-1)
    d2 = x2Ex1 ** 2 * (
        1.0 / (Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + 1e-12)
        + 1.0 / (Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2 + 1e-12)
    )
    rate = float((np.sqrt(d2) * K[0, 0] < 1.5).mean())
    assert rate >= 0.85, rate
