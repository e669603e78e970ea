"""Parity of the port's relative-pose estimators with the JAX package (CPU).

Both packages get the same correspondences (numpy, from a seed) and the
same minimal sets: the port's ``sampler`` hook calls the JAX package's
``sample_minimal_sets`` with the keys the JAX code derives.  The discrete
outputs (inlier masks, the chosen method, success) must then match exactly,
and (R, t) to 1e-4.  The JAX functions run eagerly under
``jax.disable_jit()``, which shares the per-op compiles across tests.

Then ``optim/trajectory.py::verify_loop_candidate`` on a loop pair of
``make_loop_sequence``, here because it runs this relative pose at the same
shapes (a jitted JAX one compiles for minutes).

Two scenes: a non-planar random 3-D scene, where the essential branch is
preferred and accepted, and a planar one with the same parallax, where the
8-point essential is degenerate, fails its gate, and the estimate falls
through to the homography — the case that decides every frame of the
synthetic seafloor sequences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ergo_uvo_tpu.estimation import essential as jess
from ergo_uvo_tpu.estimation import homography as jhom
from ergo_uvo_tpu.estimation.relative_pose import estimate_relative_pose as j_estimate
from ergo_uvo_tpu.estimation.sampling import sample_minimal_sets as j_sample
from ergo_uvo_tpu_torch.config import LMEDS, RANSAC, MonoVOConfig
from ergo_uvo_tpu_torch.estimation import essential as tess
from ergo_uvo_tpu_torch.estimation import homography as thom
from ergo_uvo_tpu_torch.estimation.relative_pose import estimate_relative_pose as t_estimate

K = np.array([[400.0, 0, 320], [0, 400, 240], [0, 0, 1]], np.float32)
N, H = 128, 64
CFG = MonoVOConfig(max_keypoints=N, num_hypotheses=H)


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


def rodrigues(w):
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def make_scene(planar: bool, seed: int, outlier_frac: float = 0.12):
    """(xy1, xy2, mask, R, t): 0.2 px noise, gross outliers, 8 invalid slots."""
    rng = np.random.default_rng(seed)
    if planar:
        # A downward camera gliding over the seafloor: yaw and lateral motion.
        X = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N), np.full(N, 6.0)], -1)
        R = rodrigues(np.array([0.0, 0.0, 1.0]) * 0.02)
        tr = np.array([0.3, 0.05, 0.0])
    else:
        X = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N), rng.uniform(4, 10, N)], -1)
        R = rodrigues(np.array([0.2, 1.0, 0.1]) * 0.05)
        tr = np.array([0.4, -0.05, 0.08])
        tr = tr / np.linalg.norm(tr)

    def proj(P):
        return (P @ K.T)[:, :2] / P[:, 2:3]

    xy1 = proj(X) + 0.2 * rng.normal(size=(N, 2))
    xy2 = proj(X @ R.T + tr) + 0.2 * rng.normal(size=(N, 2))
    out = rng.random(N) < outlier_frac
    xy2[out] += rng.uniform(-40, 40, (out.sum(), 2))
    mask = np.ones(N, bool)
    mask[-8:] = False
    xy1[~mask] = 0.0
    xy2[~mask] = 0.0
    return (xy1.astype(np.float32), xy2.astype(np.float32), mask,
            R.astype(np.float32), tr.astype(np.float32))


def jax_sampler(key):
    """The port's estimator-level sampler: JAX's minimal sets for ``key``."""

    def sampler(mask, num_hypotheses, set_size):
        idx, valid = j_sample(key, jnp.asarray(mask.numpy()), num_hypotheses, set_size)
        return torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(valid))

    return sampler


def assert_same_up_to_sign(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    s = np.sign((a * b).sum())
    np.testing.assert_allclose(a * s, b, atol=atol)


def test_find_essential_matches_jax():
    """Non-planar scene under LMEDS (the slice's method): inlier masks exact,
    E up to sign to 1e-4, and recoverPose's (R, t) to 1e-4 and mask exact."""
    method = LMEDS
    xy1, xy2, mask, _, _ = make_scene(planar=False, seed=0)
    key = jax.random.PRNGKey(3)
    with jax.disable_jit():
        jE, jinl = jess.find_essential(key, jnp.asarray(xy1), jnp.asarray(xy2),
                                       jnp.asarray(mask), jnp.asarray(K), method, 1.0, H)
    tE, tinl = tess.find_essential(t(xy1), t(xy2), t(mask), t(K), method, 1.0, H,
                                   sampler=jax_sampler(key))
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    assert int(tinl.sum()) > 80
    assert_same_up_to_sign(tE.numpy(), jE, atol=1e-4)

    x1n, x2n = jess._normalized(jnp.asarray(K), jnp.asarray(xy1)), jess._normalized(jnp.asarray(K), jnp.asarray(xy2))
    jR, jt, jm = jess.recover_pose_from_essential(jE, x1n, x2n, jinl)
    tR, tt, tm = tess.recover_pose_from_essential(
        t(np.asarray(jE)), t(np.asarray(x1n)), t(np.asarray(x2n)), t(np.asarray(jinl)))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("method", [LMEDS, RANSAC])
def test_find_homography_matches_jax(method):
    """Planar scene: inlier masks exact, H (h33 = 1) to 1e-4 relative; the
    candidate vote's chosen (R, t) to 1e-4 and its vote count exact."""
    xy1, xy2, mask, _, _ = make_scene(planar=True, seed=1)
    key = jax.random.PRNGKey(4)
    with jax.disable_jit():
        jH, jinl = jhom.find_homography(key, jnp.asarray(xy1), jnp.asarray(xy2),
                                        jnp.asarray(mask), method, 1.0, H)
        jR, jt, jn = jhom.recover_pose_homography(
            jH, jnp.asarray(xy1), jnp.asarray(xy2), jinl, jnp.asarray(K), 50.0,
            jnp.eye(3), jnp.zeros(3))
    tH, tinl = thom.find_homography(t(xy1), t(xy2), t(mask), method, 1.0, H,
                                    sampler=jax_sampler(key))
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    assert int(tinl.sum()) > 80
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=1e-4, atol=1e-5)
    tR, tt, tn = thom.recover_pose_homography(
        t(np.asarray(jH)), t(xy1), t(xy2), t(np.asarray(jinl)), t(K), 50.0,
        torch.eye(3), torch.zeros(3))
    assert int(tn) == int(jn) > 0
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)


@pytest.mark.parametrize("planar", [False, True], ids=["nonplanar", "planar"])
def test_estimate_relative_pose_matches_jax(planar):
    """The switch-once logic: used_essential, success, num_inliers and the
    triangulation inlier mask exact; (R, t) to 1e-4.  The non-planar scene
    accepts the essential; the planar one falls through to the homography."""
    # Without gross outliers on the plane, as on the synthetic seafloor: with
    # them the degenerate essential can still pass the 0.4 VPF gate.
    xy1, xy2, mask, R_true, _ = make_scene(planar=planar, seed=2,
                                           outlier_frac=0.0 if planar else 0.12)
    key = jax.random.PRNGKey(5)
    with jax.disable_jit():
        jr = j_estimate(key, jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(mask),
                        jnp.asarray(K), CFG, jnp.eye(3), jnp.zeros(3))
    k_e, k_h = jax.random.split(key)
    keys = {"essential": k_e, "homography": k_h}

    def sampler(method, m, h, s):
        return jax_sampler(keys[method])(m, h, s)

    tr = t_estimate(t(xy1), t(xy2), t(mask), t(K), CFG, torch.eye(3), torch.zeros(3),
                    sampler=sampler)
    assert bool(tr.used_essential) == bool(jr.used_essential) == (not planar)
    assert bool(tr.success) == bool(jr.success)
    assert bool(tr.success)
    assert int(tr.num_inliers) == int(jr.num_inliers)
    np.testing.assert_array_equal(tr.triangulation_inliers.numpy(),
                                  np.asarray(jr.triangulation_inliers))
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=1e-4)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-4)
    # and the estimate is right, not only equal
    c = (np.trace(R_true.T @ tr.R.numpy()) - 1) / 2
    assert np.degrees(np.arccos(np.clip(c, -1, 1))) < 1.0


def test_verify_loop_candidate_matches_jax():
    """Mono loop verification on frames 0 and 19 of the 160x128 loop fixture
    (a loop), the port's detections fed to both: match, relative pose with
    JAX's key of the first verified candidate (``key, sub = split(key)``
    from PRNGKey(0), then ``split(sub)`` into the two methods' keys),
    triangulation, gates and range scale.  ok and the inlier count exact, R
    to 1e-4, the metric t to 1e-3.  (JAX's jitted verification counts 49
    inliers where its eager run and the port count 45: XLA reassociates the
    LMEDS scores.)"""
    from ergo_uvo_tpu.config import MonoVOConfig as JMonoVOConfig
    from ergo_uvo_tpu.config import SurfConfig as JSurfConfig
    from ergo_uvo_tpu.features.detector import Keypoints as JKeypoints
    from ergo_uvo_tpu.optim.trajectory import verify_loop_candidate as j_verify
    from ergo_uvo_tpu_torch.config import SurfConfig
    from ergo_uvo_tpu_torch.features.frontend import detect_and_describe_cfg
    from ergo_uvo_tpu_torch.io import make_loop_sequence
    from ergo_uvo_tpu_torch.optim.trajectory import verify_loop_candidate as t_verify

    seq = make_loop_sequence(n_frames=20, height=128, width=160, seed=2)
    cfg_t = MonoVOConfig(surf=SurfConfig(min_hessian=60.0), max_keypoints=N, num_hypotheses=H)
    cfg_j = JMonoVOConfig(surf=JSurfConfig(min_hessian=60.0), max_keypoints=N, num_hypotheses=H)
    frames = []
    for f in (0, 19):
        kp, desc = detect_and_describe_cfg(t(seq.imgs_left[f]), cfg_t)
        frames.append((kp, desc, JKeypoints(*(jnp.asarray(x.numpy()) for x in kp)),
                       jnp.asarray(desc.numpy())))
    (ti, di, ji, dji), (tj, dj, jj, djj) = frames
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    keys = dict(zip(("essential", "homography"), jax.random.split(sub)))
    Kl = seq.K.astype(np.float32)
    with jax.disable_jit():
        ref = [np.asarray(x) for x in j_verify(sub, ji.xy, ji.mask, dji, jj.xy, jj.mask, djj,
                                               jnp.asarray(Kl), cfg_j, jnp.float32(5.0))]
    got = [x.numpy() for x in t_verify(
        ti.xy, ti.mask, di, tj.xy, tj.mask, dj, t(Kl), cfg_t, torch.tensor(5.0),
        sampler=lambda method, m, h, s: jax_sampler(keys[method])(m, h, s))]
    assert bool(ref[0]) and int(ref[3]) >= 20
    assert bool(got[0]) == bool(ref[0]) and int(got[3]) == int(ref[3])
    np.testing.assert_allclose(got[1], ref[1], atol=1e-4)
    np.testing.assert_allclose(got[2], ref[2], atol=1e-3)
