"""Parity of the port's geometry modules with the JAX package (CPU).

Inputs are made with numpy from a seed and fed to both packages; the JAX
functions run eagerly (op by op), which is what they compute under ``jit``
up to float reassociation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ergo_uvo_tpu.geometry import linalg as jlinalg
from ergo_uvo_tpu.geometry import rotations as jrot
from ergo_uvo_tpu.geometry import stats as jstats
from ergo_uvo_tpu.geometry import triangulation as jtri
from ergo_uvo_tpu.geometry.camera import projection_matrix as jprojection_matrix
from ergo_uvo_tpu_torch.geometry import linalg as tlinalg
from ergo_uvo_tpu_torch.geometry import rotations as trot
from ergo_uvo_tpu_torch.geometry import stats as tstats
from ergo_uvo_tpu_torch.geometry import triangulation as ttri
from ergo_uvo_tpu_torch.geometry.camera import projection_matrix as tprojection_matrix

K = np.array([[144.0, 0, 80], [0, 144.0, 60], [0, 0, 1]], np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.fast
def test_masked_stats_match_jax():
    """Median, mean and variance over masked lanes, incl. an all-masked row
    (median 0) and an even count.  Same float32 ops in the same order: the
    median is a selection (exact); mean/variance to 1e-6 relative."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(5, 33)).astype(np.float32)
    m = rng.random((5, 33)) < 0.6
    m[0] = False
    m[1, :] = False
    m[1, :10] = True  # even count
    np.testing.assert_array_equal(
        tstats.masked_median(t(v), t(m)).numpy(),
        np.asarray(jstats.masked_median(jnp.asarray(v), jnp.asarray(m))),
    )
    tm, tv = tstats.masked_mean_and_variance(t(v), t(m))
    jm, jv = jstats.masked_mean_and_variance(jnp.asarray(v), jnp.asarray(m))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)


def test_jacobi_eigh_matches_jax():
    """The literal Jacobi port: eigenvalues to 1e-5 (relative to the largest
    magnitude, float32 rounding over 252 rotations), eigenvectors to 1e-4 up
    to sign (their sign feeds E, so it must agree wherever the spectrum is
    well separated, which random matrices give)."""
    rng = np.random.default_rng(1)
    A = rng.normal(size=(16, 9, 9)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + np.eye(9, dtype=np.float32)
    with jax.disable_jit():
        jw, jv = jlinalg.jacobi_eigh(jnp.asarray(A))
    tw, tv = tlinalg.jacobi_eigh(t(A))
    jw, jv = np.asarray(jw), np.asarray(jv)
    scale = np.abs(jw).max(-1, keepdims=True)
    np.testing.assert_allclose(tw.numpy() / scale, jw / scale, atol=1e-5)
    sign = np.sign(np.einsum("bij,bij->bj", tv.numpy(), jv))
    np.testing.assert_array_equal(sign, np.ones_like(sign))
    np.testing.assert_allclose(tv.numpy(), jv, atol=1e-4)
    # the input is not modified in place
    np.testing.assert_array_equal(t(A).numpy(), A)


def test_smallest_eigvec_and_so3_match_jax():
    """smallest_eigvec on rank-deficient 9x9 normal matrices (the 8-point
    case) up to sign, to 1e-4; so3_exp/skew/project_to_so3 to 1e-6."""
    rng = np.random.default_rng(2)
    B = rng.normal(size=(8, 9, 8)).astype(np.float32)
    A = B @ B.transpose(0, 2, 1)
    with jax.disable_jit():
        je = np.asarray(jlinalg.smallest_eigvec(jnp.asarray(A)))
    te = tlinalg.smallest_eigvec(t(A)).numpy()
    sign = np.sign((te * je).sum(-1, keepdims=True))
    np.testing.assert_allclose(te * sign, je, atol=1e-4)

    w = rng.normal(size=(6, 3)).astype(np.float32)
    w[0] = 0.0  # the Taylor branch
    np.testing.assert_allclose(
        trot.so3_exp(t(w)).numpy(), np.asarray(jrot.so3_exp(jnp.asarray(w))), atol=1e-6
    )
    np.testing.assert_allclose(
        trot.skew(t(w)).numpy(), np.asarray(jrot.skew(jnp.asarray(w))), atol=0
    )
    M = np.asarray(jrot.so3_exp(jnp.asarray(w))) + 0.01 * rng.normal(size=(6, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        trot.project_to_so3(t(M)).numpy(),
        np.asarray(jrot.project_to_so3(jnp.asarray(M))), atol=1e-5,
    )


def _two_view(n=64, seed=3):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 8, n)], -1)
    w = np.array([0.02, -0.05, 0.01], np.float32)
    R = np.asarray(jrot.so3_exp(jnp.asarray(w)))
    tr = np.array([0.5, 0.05, 0.1], np.float32)

    def proj(P):
        return (P @ K.T)[:, :2] / P[:, 2:3]

    x1 = proj(X) + 0.3 * rng.normal(size=(n, 2))
    x2 = proj(X @ R.T + tr) + 0.3 * rng.normal(size=(n, 2))
    x2[:6] += 15.0  # gross outliers for the reprojection gate
    X[6:9, 2] = -X[6:9, 2]  # behind the camera
    mask = rng.random(n) < 0.9
    return (X.astype(np.float32), R.astype(np.float32), tr, x1.astype(np.float32),
            x2.astype(np.float32), mask)


def test_triangulation_and_gates_match_jax():
    """triangulate_points to 1e-4 relative; reprojection errors to 1e-3 px;
    filter_3d_points (reprojection + 3-sigma depth gates, with and without
    min_points) and cheirality masks exact."""
    X, R, tr, x1, x2, mask = _two_view()
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    jP1 = jprojection_matrix(jnp.asarray(K), jnp.asarray(eye), jnp.asarray(zero))
    jP2 = jprojection_matrix(jnp.asarray(K), jnp.asarray(R), jnp.asarray(tr))
    tP1 = tprojection_matrix(t(K), t(eye), t(zero))
    tP2 = tprojection_matrix(t(K), t(R), t(tr))
    np.testing.assert_allclose(tP2.numpy(), np.asarray(jP2), rtol=1e-6)

    jX = np.asarray(jtri.triangulate_points(jP1, jP2, jnp.asarray(x1), jnp.asarray(x2)))
    tX = ttri.triangulate_points(tP1, tP2, t(x1), t(x2)).numpy()
    np.testing.assert_allclose(tX, jX, rtol=1e-4, atol=1e-4)

    np.testing.assert_allclose(
        ttri.reprojection_errors(t(K), t(R), t(tr), t(X), t(x2)).numpy(),
        np.asarray(jtri.reprojection_errors(jnp.asarray(K), jnp.asarray(R), jnp.asarray(tr),
                                            jnp.asarray(X), jnp.asarray(x2))),
        atol=1e-3,
    )
    for min_points in (0, 5, 200):
        for thr in (0.5, 3.0):
            jm, je = jtri.filter_3d_points(
                jnp.asarray(jX), jnp.asarray(mask), jnp.asarray(K), jnp.asarray(eye),
                jnp.asarray(zero), jnp.asarray(K), jnp.asarray(R), jnp.asarray(tr),
                jnp.asarray(x1), jnp.asarray(x2), thr, min_points=min_points,
            )
            tm, te = ttri.filter_3d_points(
                t(jX), t(mask), t(K), t(eye), t(zero), t(K), t(R), t(tr),
                t(x1), t(x2), thr, min_points=min_points,
            )
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
            np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-3)
    for max_depth in (None, 6.0):
        np.testing.assert_array_equal(
            ttri.cheirality_mask(t(R), t(tr), t(X), max_depth).numpy(),
            np.asarray(jtri.cheirality_mask(jnp.asarray(R), jnp.asarray(tr), jnp.asarray(X), max_depth)),
        )
