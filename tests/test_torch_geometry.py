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


# ---------------------------------------------- rotations, SE(3), camera model

from ergo_uvo_tpu.geometry import camera as jcam  # noqa: E402
from ergo_uvo_tpu.geometry import se3 as jse3  # noqa: E402
from ergo_uvo_tpu_torch.geometry import camera as tcam  # noqa: E402
from ergo_uvo_tpu_torch.geometry import se3 as tse3  # noqa: E402


def _rotations(n, seed, lo=0.1, hi=np.pi - 0.2):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, 3))
    w = w / np.linalg.norm(w, axis=-1, keepdims=True) * rng.uniform(lo, hi, (n, 1))
    return np.asarray(jrot.so3_exp(jnp.asarray(w, jnp.float32)))


def _close(tout, jout, atol, rtol=0.0):
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=atol, rtol=rtol)


@pytest.mark.fast
def test_euler_quaternion_helpers_match_jax():
    """rotx/roty/rotz, Euler <-> R (gimbal lock included), Euler ->
    quaternion, quaternion <-> R (each of the four pivots), is_rotation_matrix,
    wrap2pi (+-pi, +-3pi, far out) and rpy_rate_jacobian against JAX, batched,
    to 1e-6 (float32, the same operations in the same order); the masks
    exact."""
    rng = np.random.default_rng(4)
    ang = rng.uniform(-3.0, 3.0, 16).astype(np.float32)
    for name in ("rotx", "roty", "rotz"):
        _close(getattr(trot, name)(t(ang)), getattr(jrot, name)(jnp.asarray(ang)), 1e-6)
    rpy = rng.uniform(-1.4, 1.4, (16, 3)).astype(np.float32)
    rpy[0] = [0.3, np.pi / 2, 0.2]  # gimbal lock: cos(pitch) ~ 0
    R = np.asarray(jrot.euler_to_rotation(jnp.asarray(rpy)))
    _close(trot.euler_to_rotation(t(rpy)), R, 1e-6)
    _close(trot.rotation_to_euler(t(R)), jrot.rotation_to_euler(jnp.asarray(R)), 1e-5)
    q = np.asarray(jrot.euler_to_quaternion(jnp.asarray(rpy)))
    _close(trot.euler_to_quaternion(t(rpy)), q, 1e-6)
    q_raw = 2.5 * rng.normal(size=(16, 4)).astype(np.float32)  # normalized inside
    _close(trot.quaternion_to_rotation(t(q_raw)), jrot.quaternion_to_rotation(jnp.asarray(q_raw)),
           1e-6)
    # Pivots: trace (small angle), then the largest diagonal entry x, y, z.
    pivots = np.stack([np.asarray(jrot.so3_exp(jnp.asarray(w, jnp.float32))) for w in (
        [0.1, 0.2, -0.1], [3.0, 0.1, 0.2], [0.1, -3.0, 0.3], [0.2, 0.1, 3.05])])
    Rq = np.concatenate([R, _rotations(8, 5), pivots])
    _close(trot.rotation_to_quaternion(t(Rq)), jrot.rotation_to_quaternion(jnp.asarray(Rq)),
           1e-6)
    noisy = Rq + np.float32(1e-3) * rng.normal(size=Rq.shape).astype(np.float32)
    for M in (Rq, noisy):
        for tol in (1e-6, 1e-4, 1e-2):
            np.testing.assert_array_equal(
                trot.is_rotation_matrix(t(M), tol).numpy(),
                np.asarray(jrot.is_rotation_matrix(jnp.asarray(M), tol)))
    a = np.concatenate([np.float32([np.pi, -np.pi, 3 * np.pi, -3 * np.pi, 0.5, 10.0, -17.0]),
                        rng.uniform(-20, 20, 16).astype(np.float32)])
    _close(trot.wrap2pi(t(a)), jrot.wrap2pi(jnp.asarray(a)), 1e-6)
    _close(trot.rpy_rate_jacobian(t(rpy[1:])), jrot.rpy_rate_jacobian(jnp.asarray(rpy[1:])), 1e-6,
           rtol=1e-6)


@pytest.mark.fast
@pytest.mark.parametrize("theta", [0.0, 1e-5, 0.5, 2.0, np.pi - 1e-2, np.pi - 1e-4, np.pi])
def test_so3_log_matches_jax_at_edge_angles(theta):
    """so3_log on rotations of angle ``theta`` about 16 random axes (signs of
    every component, and the coordinate axes, which zero the off-diagonal
    sign tests) against JAX to 1e-5 rad: the Taylor branch below 1e-4, the
    generic one, and the diagonal branch above pi - 1e-3 with its sign
    fixes."""
    rng = np.random.default_rng(int(theta * 1e4) % 2**32)
    axes = rng.normal(size=(16, 3))
    axes[:3] = np.eye(3)
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    # Rodrigues in float64, then float32: the same matrices for both.
    Kx = np.asarray(jrot.skew(jnp.asarray(axes, jnp.float32)), np.float64)
    R = (np.eye(3) + np.sin(theta) * Kx + (1 - np.cos(theta)) * Kx @ Kx).astype(np.float32)
    _close(trot.so3_log(t(R)), jrot.so3_log(jnp.asarray(R)), 1e-5)


@pytest.mark.fast
def test_se3_matches_jax():
    """SE3 compose / inverse / apply (both point layouts) / matrix /
    identity, se3_exp and se3_log (Taylor branches below theta^2 = 1e-12, the
    generic one, near pi) against JAX to 1e-5."""
    rng = np.random.default_rng(6)
    Ra, Rb = _rotations(8, 7), _rotations(8, 8)
    ta, tb = (rng.normal(size=(8, 3)).astype(np.float32) for _ in range(2))
    jA, jB = jse3.SE3(jnp.asarray(Ra), jnp.asarray(ta)), jse3.SE3(jnp.asarray(Rb), jnp.asarray(tb))
    tA, tB = tse3.SE3(t(Ra), t(ta)), tse3.SE3(t(Rb), t(tb))
    for tout, jout in zip(tA.compose(tB.inverse()), jA.compose(jB.inverse())):
        _close(tout, jout, 1e-5)
    pts = rng.normal(size=(8, 5, 3)).astype(np.float32)
    jA0, tA0 = jse3.SE3(jA.R[0], jA.t[0]), tse3.SE3(tA.R[0], tA.t[0])
    _close(tA0.apply(t(pts[0])), jA0.apply(jnp.asarray(pts[0])), 1e-5)
    _close(tA.apply(t(pts[:, 0])), jA.apply(jnp.asarray(pts[:, 0])), 1e-5)
    _close(tA.matrix(), jA.matrix(), 0)
    for tout, jout in zip(tse3.SE3.identity((2,)), jse3.SE3.identity((2,))):
        _close(tout, jout, 0)
    with pytest.raises(ValueError):
        tA.apply(t(pts[..., :2]))
    xi = rng.normal(size=(12, 6)).astype(np.float32)
    xi[0, 3:] = [1e-7, -2e-7, 1e-7]  # theta^2 < 1e-12
    xi[1, 3:] = 0.0
    xi[2, 3:] = np.float32([0.0, 0.0, np.pi - 1e-3])
    for tout, jout in zip(tse3.se3_exp(t(xi)), jse3.se3_exp(jnp.asarray(xi))):
        _close(tout, jout, 1e-5)
    T = jse3.se3_exp(jnp.asarray(xi))
    _close(tse3.se3_log(tse3.SE3(t(T.R), t(T.t))), jse3.se3_log(T), 1e-4, rtol=1e-4)


@pytest.mark.fast
def test_camera_model_matches_jax():
    """PinholeCamera (K, zero distortion), distort / undistort (8 and 12
    fixed-point steps), pixel <-> normalized, project_points with and without
    distortion (depths at and near 0, negative), resize_camera_matrix and
    resized_height, transform_points, against JAX to 1e-5 relative."""
    rng = np.random.default_rng(9)
    args = (500.0, 510.0, 320.0, 240.0, -0.28, 0.07, 1e-4, -2e-4)
    jc, tc = jcam.PinholeCamera.create(*args), tcam.PinholeCamera.create(*args)
    _close(tc.K, jc.K, 0)
    _close(tc.with_zero_distortion().K, jc.with_zero_distortion().K, 0)
    assert all(float(v) == 0.0 for v in tc.with_zero_distortion()[4:])
    xy = rng.uniform(-0.4, 0.4, (50, 2)).astype(np.float32)
    _close(tcam.distort_normalized(tc, t(xy)), jcam.distort_normalized(jc, jnp.asarray(xy)), 1e-6)
    for iters in (8, 12):
        _close(tcam.undistort_normalized(tc, t(xy), iters),
               jcam.undistort_normalized(jc, jnp.asarray(xy), iters), 1e-6)
    uv = rng.uniform(0, 640, (50, 2)).astype(np.float32)
    _close(tcam.pixel_to_normalized(tc, t(uv)), jcam.pixel_to_normalized(jc, jnp.asarray(uv)), 1e-6)
    _close(tcam.normalized_to_pixel(tc, t(xy)), jcam.normalized_to_pixel(jc, jnp.asarray(xy)), 1e-4)
    P = (rng.normal(size=(40, 3)) + [0, 0, 5]).astype(np.float32)
    P[:4, 2] = [0.0, 1e-10, -1e-10, -3.0]
    for dist in (False, True):
        _close(tcam.project_points(tc, t(P), with_distortion=dist),
               jcam.project_points(jc, jnp.asarray(P), with_distortion=dist), 1e-6, rtol=1e-5)
    Kc = np.asarray(jc.K).copy()
    Kc[0, 1] = 0.7  # skew survives the resize
    for w0, w1 in ((1280, 640), (640, 160), (1920, 1000)):
        _close(tcam.resize_camera_matrix(t(Kc), w0, w1), jcam.resize_camera_matrix(jnp.asarray(Kc), w0, w1),
               1e-6, rtol=1e-6)
        assert tcam.resized_height(w0, 480, w1) == jcam.resized_height(w0, 480, w1)
    R, tr = _rotations(1, 10)[0], np.float32([0.3, -0.1, 2.0])
    _close(ttri.transform_points(t(R), t(tr), t(P)),
           jtri.transform_points(jnp.asarray(R), jnp.asarray(tr), jnp.asarray(P)), 1e-5)


@pytest.mark.fast
def test_port_geometry_keeps_the_jax_contracts():
    """The JAX package's own geometry contracts (tests/test_geometry.py,
    tests/test_geodesy_viz.py::TestRpyRateJacobian) on the port: round trips
    of Euler angles, quaternions, so3 and se3 exp/log, the distortion model,
    a known projection, K rescaling and wrap2pi's fixed points."""
    for fn in (trot.rotx, trot.roty, trot.rotz):
        assert bool(trot.is_rotation_matrix(fn(torch.tensor(0.7)), tol=1e-5))
    rpy = torch.tensor([0.3, -0.4, 1.2])
    _close(trot.rotation_to_euler(trot.euler_to_rotation(rpy)), rpy.numpy(), 1e-5)
    R = t(_rotations(10, 11))
    _close(trot.quaternion_to_rotation(trot.rotation_to_quaternion(R)), R.numpy(), 1e-5)
    rpy = torch.tensor([0.2, 0.5, -0.9])
    _close(trot.quaternion_to_rotation(trot.euler_to_quaternion(rpy)),
           trot.euler_to_rotation(rpy).numpy(), 1e-5)
    for scale in (1e-6, 0.1, 1.0, 3.0):
        w = torch.tensor([0.3, -0.2, 0.9])
        w = w / torch.linalg.vector_norm(w) * scale
        _close(trot.so3_log(trot.so3_exp(w)), w.numpy(), 1e-4)
    xi = torch.tensor([0.1, -0.3, 0.2, 0.4, -0.1, 0.8])
    _close(tse3.se3_log(tse3.se3_exp(xi)), xi.numpy(), 1e-4)
    small = torch.tensor([1e-6, 2e-6, -1e-6, 1e-7, -2e-7, 1e-7])
    _close(tse3.se3_exp(small).t, small[:3].numpy(), 1e-8)
    T = tse3.SE3(R[0], torch.tensor([0.1, -2.0, 0.5]))
    Id = T.compose(T.inverse())
    _close(Id.R, np.eye(3), 1e-5)
    _close(Id.t, np.zeros(3), 1e-5)
    cam = tcam.PinholeCamera.create(500.0, 510.0, 320.0, 240.0, -0.28, 0.07, 1e-4, -2e-4)
    xy = t(np.random.default_rng(12).uniform(-0.4, 0.4, (50, 2)).astype(np.float32))
    _close(tcam.undistort_normalized(cam, tcam.distort_normalized(cam, xy), iters=12), xy.numpy(),
           1e-4)
    uv = tcam.project_points(tcam.PinholeCamera.create(100.0, 100.0, 50.0, 50.0),
                             torch.tensor([[1.0, 2.0, 10.0]]))
    _close(uv, [[60.0, 70.0]], 1e-5)
    K2 = tcam.resize_camera_matrix(cam.K, 1280, 640)
    assert abs(float(K2[0, 0]) - 250.0) < 1e-4 and abs(float(K2[1, 2]) - 120.0) < 1e-4
    assert float(K2[2, 2]) == 1.0
    for a, want in ((3 * np.pi, np.pi), (-3 * np.pi, -np.pi), (0.5, 0.5)):
        assert abs(float(trot.wrap2pi(torch.tensor(a))) - want) < 1e-5
    _close(trot.rpy_rate_jacobian(torch.zeros(3)), np.eye(3), 1e-7)
    r, p = 0.3, -0.2
    ref = [[1, np.sin(r) * np.tan(p), np.cos(r) * np.tan(p)], [0, np.cos(r), -np.sin(r)],
           [0, np.sin(r) / np.cos(p), np.cos(r) / np.cos(p)]]
    _close(trot.rpy_rate_jacobian(torch.tensor([r, p, 1.1], dtype=torch.float64)), ref, 1e-6)
