"""Parity of the port's stereo path with the JAX package (CPU): the small
linear algebra, P3P, PnP RANSAC and ``run_stereo_vo`` as a whole.

The same inputs (numpy, from a seed) go through both packages, and both draw
the same minimal sets: the port's ``sampler`` hook calls the JAX package's
``sample_minimal_sets`` with the key JAX uses (``split(key, T)[i]`` for frame
i, passed whole to ``solve_pnp_ransac``).  The JAX solvers run eagerly under
``jax.disable_jit()``, which shares the per-op compiles across tests; the
JAX pipeline runs as its own tests run it, one scanned program.

The slice runs at 6 frames of 160x120, 128 keypoints and 64 minimal sets
(768 candidate poses), the smallest size at which both packages publish and
are valid on every frame after the first.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ergo_uvo_tpu.config as jconfig
from ergo_uvo_tpu.estimation.robust import score_hypotheses as j_score
from ergo_uvo_tpu.estimation.sampling import sample_minimal_sets as j_sample
from ergo_uvo_tpu.geometry import linalg as jlinalg
from ergo_uvo_tpu.pipeline import run_stereo_vo as j_run_stereo_vo
from ergo_uvo_tpu.pipeline.stereo import StereoRig as JStereoRig
import ergo_uvo_tpu_torch.config as tconfig
import ergo_uvo_tpu_torch.io.synthetic as tsynthetic
from ergo_uvo_tpu_torch.convert import (
    stereo_rig_from_numpy,
    stereo_state_from_numpy,
    stereo_state_to_numpy,
)
from ergo_uvo_tpu_torch.estimation.robust import score_hypotheses as t_score
from ergo_uvo_tpu_torch.geometry import linalg as tlinalg
from ergo_uvo_tpu_torch.geometry.rotations import so3_exp
from ergo_uvo_tpu_torch.pipeline import run_stereo_vo, stereo_vo_step

# By module path: the packages' ``__init__`` export the function ``p3p``
# under the module's name.
jp3p = importlib.import_module("ergo_uvo_tpu.estimation.p3p")
jpnp = importlib.import_module("ergo_uvo_tpu.estimation.pnp")
tp3p = importlib.import_module("ergo_uvo_tpu_torch.estimation.p3p")
tpnp = importlib.import_module("ergo_uvo_tpu_torch.estimation.pnp")

K = np.array([[400.0, 0, 320], [0, 400, 240], [0, 0, 1]], np.float32)


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


def random_poses(rng, h):
    w = 0.3 * rng.standard_normal((h, 3)).astype(np.float32)
    R = so3_exp(t(w)).numpy()
    tr = rng.uniform(-1, 1, (h, 3)).astype(np.float32)
    tr[:, 2] += 6.0
    return R, tr


def jax_sampler(key):
    """The port's estimator-level sampler: JAX's minimal sets for ``key``."""

    def sampler(mask, num_hypotheses, set_size):
        idx, valid = j_sample(key, jnp.asarray(mask.numpy()), num_hypotheses, set_size)
        return torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(valid))

    return sampler


# ---------------------------------------------------------------- linalg

@pytest.mark.fast
def test_inv33_matches_jax():
    """Random well-conditioned matrices, a batch of batches, and a singular
    one (the eps guard): rtol 1e-5, and A @ inv(A) = I to 1e-4."""
    rng = np.random.default_rng(0)
    A = (rng.standard_normal((4, 16, 3, 3)) + 2.0 * np.eye(3)).astype(np.float32)
    A[0, 0] = 0.0
    ours = tlinalg.inv33(t(A)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jlinalg.inv33(jnp.asarray(A))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose((A @ ours)[1:], np.broadcast_to(np.eye(3), (3, 16, 3, 3)), atol=1e-4)


@pytest.mark.fast
def test_polar_so3_matches_jax():
    """Noisy rotations and a reflected one: atol 1e-5 against JAX, and the
    result is a proper rotation."""
    rng = np.random.default_rng(1)
    R, _ = random_poses(rng, 32)
    M = (1.7 * R + 0.05 * rng.standard_normal(R.shape)).astype(np.float32)
    M[0] = M[0] @ np.diag([1.0, 1.0, -1.0]).astype(np.float32)
    ours = tlinalg.polar_so3(t(M)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jlinalg.polar_so3(jnp.asarray(M))), atol=1e-5)
    np.testing.assert_allclose(ours @ ours.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), ours.shape), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(ours), 1.0, atol=1e-5)


# ------------------------------------------------------------------- p3p

@pytest.mark.fast
@pytest.mark.parametrize("coeffs,expect", [
    ((-6.0, 11.0, -6.0, 1.0), [1.0, 2.0, 3.0]),   # (x-1)(x-2)(x-3)
    ((1.0, 1.0, 0.0, 1.0), [-0.68232780]),        # x^3 + x + 1: one real root
    ((2.0, -3.0, 1.0, 0.0), [1.0, 2.0]),          # k3 = 0: x^2 - 3x + 2
], ids=["three_real", "one_real", "quadratic"])
def test_cubic_known_roots(coeffs, expect):
    """Known roots to 1e-5 (tests/test_p3p.py:36-54), and the same roots and
    validity as JAX: ``sign(x) |x|^(1/3)`` stands in for ``cbrt``."""
    ks = [np.asarray([c], np.float32) for c in coeffs]
    roots, valid = tp3p._cubic_real_roots(*(t(k) for k in ks))
    jroots, jvalid = jp3p._cubic_real_roots(*(jnp.asarray(k) for k in ks))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    got = np.sort(roots.numpy()[0][valid.numpy()[0]])
    np.testing.assert_allclose(got, expect, atol=1e-5)
    np.testing.assert_allclose(roots.numpy()[np.asarray(jvalid)],
                               np.asarray(jroots)[np.asarray(jvalid)], atol=1e-5)


@pytest.mark.fast
def test_cubic_random_matches_jax():
    """Random cubics: validity exact, valid roots to rtol 1e-4."""
    rng = np.random.default_rng(2)
    ks = [rng.standard_normal(512).astype(np.float32) for _ in range(4)]
    roots, valid = tp3p._cubic_real_roots(*(t(k) for k in ks))
    jroots, jvalid = jp3p._cubic_real_roots(*(jnp.asarray(k) for k in ks))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    v = np.asarray(jvalid)
    np.testing.assert_allclose(roots.numpy()[v], np.asarray(jroots)[v], rtol=1e-4, atol=1e-5)


def p3p_case(kind, h, seed):
    rng = np.random.default_rng(seed)
    R_gt, t_gt = random_poses(rng, h)
    if kind == "general":
        Xw = rng.uniform(-2, 2, (h, 3, 3))
    elif kind == "coplanar":
        Xw = np.concatenate([rng.uniform(-2, 2, (h, 3, 2)), np.zeros((h, 3, 1))], -1)
    else:  # collinear
        base = rng.uniform(-2, 2, (h, 1, 3))
        direction = rng.uniform(-1, 1, (h, 1, 3))
        Xw = base + np.asarray([0.0, 1.0, 2.0])[None, :, None] * direction
    Xw = Xw.astype(np.float32)
    pc = np.einsum("hij,hnj->hni", R_gt, Xw) + t_gt[:, None, :]
    y = (pc / np.linalg.norm(pc, axis=-1, keepdims=True)).astype(np.float32)
    return Xw, y, R_gt, t_gt


@pytest.mark.fast
@pytest.mark.parametrize("kind", ["general", "coplanar", "collinear"])
def test_p3p_matches_jax(kind):
    """The cases of tests/test_p3p.py:58-90.  Against JAX: the 12 candidates
    in the same order and ``valid`` exact.  (R, t) of the valid candidates: a
    candidate near a double root of the cubic or of the plane-quadric
    intersection is ill conditioned, and there each package's float32 result
    lies further from a float64 solve than from the other package's.  So:
    the median difference is under 1e-5, at least 98% (general) or 90%
    (coplanar) of the valid candidates agree to atol 1e-4, and no candidate
    differs by more than 1e-4 plus 25 times the JAX result's own distance
    from the float64 solve.  And that file's own bounds on the port: the
    best valid candidate recovers the pose; collinear triples are flagged
    invalid."""
    h = 256 if kind != "collinear" else 64
    Xw, y, R_gt, t_gt = p3p_case(kind, h, seed=3)
    R, tr, valid = (a.numpy() for a in tp3p.p3p(t(Xw), t(y)))
    jR, jt, jvalid = (np.asarray(a) for a in jp3p.p3p(jnp.asarray(Xw), jnp.asarray(y)))
    assert R.shape == (h, 12, 3, 3) and tr.shape == (h, 12, 3) and valid.shape == (h, 12)
    np.testing.assert_array_equal(valid, jvalid)
    R64, t64, v64 = (a.numpy() for a in tp3p.p3p(t(Xw).double(), t(y).double()))

    def dist(Ra, ta, Rb, tb):
        return np.maximum(np.abs(Ra - Rb).max((-1, -2)), np.abs(ta - tb).max(-1))

    d = dist(R, tr, jR, jt)[valid]
    if kind != "collinear":
        assert np.median(d) < 1e-5, np.median(d)
        share = float((d <= 1e-4).mean())
        assert share >= (0.98 if kind == "general" else 0.90), share
    own = dist(jR, jt, R64, t64)
    both = valid & v64
    assert (dist(R, tr, jR, jt)[both] <= 1e-4 + 25 * own[both]).all()
    if kind == "collinear":
        assert valid.mean() < 0.2
        return
    err = np.where(valid, np.linalg.norm(R - R_gt[:, None], axis=(-2, -1))
                   + np.linalg.norm(tr - t_gt[:, None], axis=-1), np.inf).min(-1)
    if kind == "general":
        assert valid.any(-1).mean() > 0.98
        assert np.median(err) < 1e-3
        assert np.mean(err < 1e-2) > 0.95
    else:
        assert valid.any(-1).mean() > 0.9
        assert np.mean(err < 1e-2) > 0.85


# ------------------------------------------------------------------- pnp

N, H = 128, 64


def pnp_scene(seed, outlier_frac=0.15):
    """A near-planar cloud seen from a moved camera: 0.3 px noise, gross
    outliers, 8 invalid slots holding garbage."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N),
                  6.0 + 0.2 * rng.standard_normal(N)], -1)
    R = so3_exp(t(np.asarray([0.02, -0.03, 0.05], np.float32))).numpy().astype(np.float64)
    tr = np.array([0.25, -0.05, 0.1])
    pc = X @ R.T + tr
    xy = (pc @ K.T.astype(np.float64))[:, :2] / pc[:, 2:3] + 0.3 * rng.standard_normal((N, 2))
    out = rng.random(N) < outlier_frac
    xy[out] += rng.uniform(-40, 40, (out.sum(), 2))
    mask = np.ones(N, bool)
    mask[-8:] = False
    X[~mask] = 1e6
    xy[~mask] = -1e6
    return (X.astype(np.float32), xy.astype(np.float32), mask,
            R.astype(np.float32), tr.astype(np.float32))


@pytest.mark.fast
def test_score_hypotheses_ransac_matches_jax():
    """The RANSAC branch at the shape PnP gives it, (12 H, N): residuals with
    +inf and NaN entries, invalid candidates and duplicated rows (ties go to
    the lowest index).  Winner and inlier mask exact."""
    rng = np.random.default_rng(4)
    r2 = rng.gamma(1.0, 2.0, (12 * H, N)).astype(np.float32)
    r2[rng.random(r2.shape) < 0.05] = np.inf
    r2[rng.random(r2.shape) < 0.01] = np.nan
    r2[100] = 0.01          # the winner ...
    r2[300] = r2[100]       # ... and its duplicate further down
    r2[7] = 0.0             # better still, but its set is invalid
    sets_valid = rng.random(12 * H) < 0.7
    sets_valid[[100, 300]] = True
    sets_valid[7] = False
    mask = rng.random(N) < 0.8
    best, inl = t_score(t(r2), t(mask), t(sets_valid), tconfig.RANSAC, 1.0, 3)
    jbest, jinl = j_score(jnp.asarray(r2), jnp.asarray(mask), jnp.asarray(sets_valid),
                          jconfig.RANSAC, 1.0, model_points=3)
    assert int(best) == int(jbest) == 100
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    assert int(inl.sum()) == int(mask.sum())


@pytest.mark.fast
def test_reproj_error_and_gauss_newton_match_jax():
    """``_reproj_error_sq`` on a batch of poses (rtol 1e-4, the +inf pattern
    of points behind the camera exact) and 6 Gauss-Newton steps from a
    perturbed pose under given weights: (R, t) to atol 1e-4, and close to the
    true pose."""
    X, xy, mask, R_true, t_true = pnp_scene(5, outlier_frac=0.0)
    Xs = np.where(mask[:, None], X, np.float32([0, 0, 1]))
    xys = np.where(mask[:, None], xy, np.float32(0))
    rng = np.random.default_rng(5)
    Rs, ts = random_poses(rng, 16)
    ts[::2, 2] -= 14.0  # every other pose puts the points behind the camera
    e = tpnp._reproj_error_sq(t(Rs), t(ts), t(K), t(Xs), t(xys)).numpy()
    je = np.asarray(jpnp._reproj_error_sq(jnp.asarray(Rs), jnp.asarray(ts), jnp.asarray(K),
                                          jnp.asarray(Xs), jnp.asarray(xys)))
    np.testing.assert_array_equal(np.isinf(e), np.isinf(je))
    assert np.isinf(e).any() and np.isfinite(e).any()
    np.testing.assert_allclose(e[np.isfinite(je)], je[np.isfinite(je)], rtol=1e-4)

    R0 = (so3_exp(t(np.float32([0.01, -0.02, 0.015]))).numpy() @ R_true).astype(np.float32)
    t0 = t_true + np.float32([0.05, -0.03, 0.04])
    w = mask.astype(np.float32) * rng.uniform(0.2, 1.0, N).astype(np.float32)
    R, tr = tpnp.gauss_newton_pnp(t(R0), t(t0), t(K), t(Xs), t(xys), t(w), iters=6)
    with jax.disable_jit():
        jR, jt = jpnp.gauss_newton_pnp(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(K),
                                       jnp.asarray(Xs), jnp.asarray(xys), jnp.asarray(w), iters=6)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(R.numpy(), R_true, atol=2e-3)
    np.testing.assert_allclose(tr.numpy(), t_true, atol=2e-2)


@pytest.mark.fast
def test_dlt_projection_matches_jax():
    """Twelve non-planar points per hypothesis, exact projections: (R, t) to
    atol 1e-3 against JAX (a 12x12 Jacobi null vector, then the polar
    projection), and the true pose recovered."""
    rng = np.random.default_rng(6)
    h = 8
    R_gt, t_gt = random_poses(rng, h)
    Xw = rng.uniform(-2, 2, (h, 12, 3)).astype(np.float32)
    pc = np.einsum("hij,hnj->hni", R_gt, Xw) + t_gt[:, None, :]
    xn = (pc[..., :2] / pc[..., 2:3]).astype(np.float32)
    R, tr = tpnp._dlt_projection(t(Xw), t(xn))
    jR, jt = jpnp._dlt_projection(jnp.asarray(Xw), jnp.asarray(xn))
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-3)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jt), atol=1e-3)
    np.testing.assert_allclose(R.numpy(), R_gt, atol=1e-2)


@pytest.mark.parametrize("case", ["scene", "all_masked"])
def test_solve_pnp_ransac_matches_jax(case):
    """The whole solver with JAX's minimal sets injected: ``success`` exact,
    the inlier count within 2, (R, t) to atol 1e-3; the estimate is the true
    pose to 0.2 degrees.  With an all-false mask (a frame whose gates
    failed) both give ``success`` False, no inlier, and nothing raises."""
    X, xy, mask, R_true, t_true = pnp_scene(7)
    if case == "all_masked":
        mask = np.zeros(N, bool)
    key = jax.random.PRNGKey(11)
    with jax.disable_jit():
        jr = jpnp.solve_pnp_ransac(key, jnp.asarray(X), jnp.asarray(xy), jnp.asarray(mask),
                                   jnp.asarray(K), 1.0, H, min_inliers=5)
    tr = tpnp.solve_pnp_ransac(t(X), t(xy), t(mask), t(K), 1.0, H, min_inliers=5,
                               sampler=jax_sampler(key))
    assert bool(tr.success) == bool(jr.success) == (case == "scene")
    assert abs(int(tr.inliers.sum()) - int(jr.inliers.sum())) <= 2
    if case == "all_masked":
        assert int(tr.inliers.sum()) == 0
        return
    assert int(tr.inliers.sum()) > 60
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=1e-3)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-3)
    c = (np.trace(R_true.T @ tr.R.numpy()) - 1) / 2
    assert np.degrees(np.arccos(np.clip(c, -1, 1))) < 0.2
    np.testing.assert_allclose(tr.t.numpy(), t_true, atol=2e-2)


def test_solve_pnp_ransac_free_running():
    """Without a sampler the sets come from the generator: the same seed
    gives the same bits, and the pose is still right."""
    X, xy, mask, R_true, _ = pnp_scene(8)
    runs = [tpnp.solve_pnp_ransac(t(X), t(xy), t(mask), t(K), 1.0, H,
                                  generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert bool(runs[0].success)
    c = (np.trace(R_true.T @ runs[0].R.numpy()) - 1) / 2
    assert np.degrees(np.arccos(np.clip(c, -1, 1))) < 0.2


# ----------------------------------------------------------------- slice

CFG_KW = dict(surf=dict(min_hessian=60.0), max_keypoints=128, num_hypotheses=64)
N_FRAMES = 6
KEY = jax.random.PRNGKey(0)
RIG_NP = dict(K_left=None, K_right=None, R_right=np.eye(3, dtype=np.float32),
              t_right=np.asarray([-0.33, 0.0, 0.0], np.float32))


def cfg_of(module):
    return module.StereoVOConfig(
        surf=module.SurfConfig(**CFG_KW["surf"]),
        max_keypoints=CFG_KW["max_keypoints"],
        num_hypotheses=CFG_KW["num_hypotheses"],
    )


def frame_sampler(frame, method, mask, num_hypotheses, set_size):
    assert method == "pnp" and set_size == 3
    return jax_sampler(jax.random.split(KEY, N_FRAMES)[frame])(mask, num_hypotheses, set_size)


@pytest.fixture(scope="module")
def seq():
    """One frame more than JAX runs: the hand-over test continues onto it."""
    return tsynthetic.make_stereo_sequence(n_frames=N_FRAMES + 1, height=120, width=160,
                                           dt=0.25, baseline=0.33, seed=6)


def rig_np(seq):
    return dict(RIG_NP, K_left=seq.K.astype(np.float32), K_right=seq.K.astype(np.float32))


def jax_run(seq, imgs_l):
    rig = JStereoRig(**{k: jnp.asarray(v) for k, v in rig_np(seq).items()})
    state, outs = j_run_stereo_vo(
        jnp.asarray(imgs_l[:N_FRAMES]), jnp.asarray(seq.imgs_right[:N_FRAMES]),
        jnp.asarray(seq.timestamps[:N_FRAMES]), rig, cfg_of(jconfig), KEY)
    return jax.tree.map(np.asarray, state), jax.tree.map(np.asarray, outs)


def port_run(seq, imgs_l, **kw):
    rig = stereo_rig_from_numpy(rig_np(seq), "cpu")
    state, outs = run_stereo_vo(imgs_l[:N_FRAMES], seq.imgs_right[:N_FRAMES],
                                seq.timestamps[:N_FRAMES], rig, cfg_of(tconfig),
                                device="cpu", **kw)
    return state, type(outs)(*(x.numpy() for x in outs))


def assert_frames_match(port, ref):
    """Discrete outputs exact, the match and point counts within 2, velocity
    to atol 5e-3 (m/s; float32 reassociation between XLA and PyTorch through
    P3P and 32 Gauss-Newton steps)."""
    for name in ("published", "validity", "num_features_l", "num_features_r"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    for name in ("num_stereo_matches", "num_triangular_matches", "num_3d_points",
                 "num_pnp_inliers"):
        diff = np.abs(getattr(port, name).astype(int) - getattr(ref, name))
        assert diff.max() <= 2, (name, getattr(port, name), getattr(ref, name))
    np.testing.assert_allclose(port.velocity, ref.velocity, atol=5e-3)
    np.testing.assert_allclose(port.t, ref.t, atol=2e-3)
    np.testing.assert_allclose(port.R, ref.R, atol=1e-3)


@pytest.fixture(scope="module")
def jax_slice(seq):
    return jax_run(seq, seq.imgs_left)


def test_run_stereo_vo_matches_jax(seq, jax_slice):
    """The whole slice against JAX run_stereo_vo, frame by frame."""
    _, jouts = jax_slice
    state, port = port_run(seq, seq.imgs_left, sampler=frame_sampler)
    assert not jouts.published[0] and jouts.published[1:].all() and jouts.validity[1:].all()
    assert_frames_match(port, jouts)
    assert np.isfinite(port.velocity).all() and bool(state.initialized)
    gt = seq.velocities_prevcam[:N_FRAMES]
    v = port.validity
    rmse = np.sqrt(((port.velocity[v] - gt[v]) ** 2).sum(-1).mean())
    assert rmse < 0.35 * np.linalg.norm(gt[1:], axis=-1).mean()


def test_state_hand_over_matches_jax(seq, jax_slice):
    """After the 6 frames the port's carried state equals JAX's (mask exact,
    floats to 1e-3); JAX's state goes through ``stereo_state_from_numpy`` and
    back with values and dtypes kept; and one more port step from it gives
    what the step from the port's own state gives (same generator seed)."""
    jstate, _ = jax_slice
    state, _ = port_run(seq, seq.imgs_left, sampler=frame_sampler)
    state_np = jstate._asdict()
    handed = stereo_state_from_numpy(state_np, "cpu")
    back = stereo_state_to_numpy(handed)
    assert list(back) == list(state._fields)
    for name, value in state_np.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)
        assert back[name].dtype == value.dtype, name
    np.testing.assert_array_equal(state.prev_mask.numpy(), jstate.prev_mask)
    assert bool(state.initialized) and bool(jstate.initialized)
    for name in ("prev_xy_l", "prev_xy_r", "prev_desc_l", "prev_time", "t_prev_curr",
                 "R_curr_prev"):
        np.testing.assert_allclose(getattr(state, name).numpy(), state_np[name], atol=1e-3,
                                   err_msg=name)
    with pytest.raises(KeyError, match="prev_mask"):
        stereo_state_from_numpy({k: v for k, v in state_np.items() if k != "prev_mask"}, "cpu")

    rig = stereo_rig_from_numpy(rig_np(seq), "cpu")
    outs = []
    for start in (handed, state):
        _, out = stereo_vo_step(
            start, t(seq.imgs_left[N_FRAMES]), t(seq.imgs_right[N_FRAMES]),
            t(seq.timestamps[N_FRAMES]), rig, cfg_of(tconfig),
            generator=torch.Generator().manual_seed(5))
        outs.append(type(out)(*(v.numpy()[None] for v in out)))
    assert bool(outs[0].published[0]) and bool(outs[0].validity[0])
    assert_frames_match(outs[0], outs[1])


def test_bad_pair_constant_motion_matches_jax(seq):
    """A featureless left frame (tests/test_pipeline.py:190-206): the frame
    is published without validity, holds the previous translation, the
    carried set empties so the next frame is invalid too, nothing raises and
    everything stays finite; frame by frame as JAX."""
    imgs_l = seq.imgs_left.copy()
    imgs_l[3] = 50.0
    _, jouts = jax_run(seq, imgs_l)
    _, port = port_run(seq, imgs_l, sampler=frame_sampler)
    assert port.published[3] and not port.validity[3]
    np.testing.assert_array_equal(port.t[3], port.t[2])
    assert not port.validity[4] and port.validity[5]
    assert np.isfinite(port.velocity).all() and np.isfinite(port.R).all()
    assert_frames_match(port, jouts)
