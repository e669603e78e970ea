"""The port's mono trajectory refinement (window BA, loop closure) on the CPU.

* ``tests/test_trajectory.py``'s integration gates on the port: window BA
  lowers the ATE of a starved mono run (the port's own, from a
  ``torch.Generator`` seeded 0); retrieval, verification and the pose graph
  close the loop of ``make_loop_sequence``.
* Parity with JAX on the same inputs: ``refine_mono_trajectory`` given the
  port's ``run_mono_vo`` outputs as numpy (JAX's accepts numpy outputs, so
  no JAX pipeline is compiled) and the pose-graph tail
  ``_optimize_with_loops``.  ``verify_loop_candidate`` is held to JAX in
  tests/test_torch_estimation.py, which runs JAX's relative pose eagerly at
  the same shapes (a jitted one compiles for minutes); the stereo ones
  in tests/test_torch_stereo_loops.py.  The helpers here that rebuild JAX's
  keys candidate by candidate serve both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ergo_uvo_tpu.config as jconfig
from ergo_uvo_tpu.estimation.sampling import sample_minimal_sets as j_sample
from ergo_uvo_tpu.features.detector import Keypoints as JKeypoints
from ergo_uvo_tpu.optim import trajectory as jtraj
import ergo_uvo_tpu_torch.config as tconfig
from ergo_uvo_tpu_torch.eval import ate_rmse
from ergo_uvo_tpu_torch.features.frontend import detect_and_describe_cfg
from ergo_uvo_tpu_torch.io import make_loop_sequence, make_mono_sequence
from ergo_uvo_tpu_torch.optim import trajectory as ttraj
from ergo_uvo_tpu_torch.pipeline import run_mono_vo

KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops on these small images are faster on one thread than spread
    over a shared host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def host(tup):
    return type(tup)(*(np.asarray(x) for x in tup))


def rig_np(K, baseline=0.33):
    K = np.asarray(K, np.float32)
    return dict(K_left=K, K_right=K, R_right=np.eye(3, dtype=np.float32),
                t_right=np.asarray([-baseline, 0.0, 0.0], np.float32))


def drifted(seq):
    """tests/test_trajectory.py's drift: position error growing linearly to
    6% of the path at the end, orientation exact.  (R_wc, t_wc, positions)."""
    T = len(seq.imgs_left)
    rng = np.random.default_rng(0)
    step = np.linalg.norm(np.diff(seq.positions, axis=0), axis=-1).mean()
    d = rng.standard_normal(3)
    d /= np.linalg.norm(d)
    pos = seq.positions + np.outer(np.arange(T), d) * (0.06 * step)
    return seq.rotations, -np.einsum("tij,tj->ti", seq.rotations, pos), pos


def assert_loop_closed(seq, pos_drift, res):
    """The loop gates of tests/test_trajectory.py: one accepted loop with
    j - i >= 12, and the aligned endpoint error shrunk at least 5x."""
    before = np.linalg.norm(pos_drift[-1] - seq.positions[-1])
    assert before > 0.2
    assert any(lp.j - lp.i >= 12 for lp in res.loops), res.loops
    after = np.linalg.norm((res.positions[-1] - res.positions[0])
                           - (seq.positions[-1] - seq.positions[0]))
    assert after < before / 5.0, (before, after)


# -------------------------------------------------- the JAX gates, on the port


@pytest.fixture(scope="module")
def mono_vo_run():
    """tests/test_trajectory.py's starved mono run (96 keypoints, 16 sets) on
    36 frames of 320x240, and its BA config (256 keypoints)."""
    cfg_vo = tconfig.MonoVOConfig(surf=tconfig.SurfConfig(min_hessian=150.0), max_keypoints=96,
                                  num_hypotheses=16)
    cfg_ba = tconfig.MonoVOConfig(surf=tconfig.SurfConfig(min_hessian=60.0), max_keypoints=256,
                                  num_hypotheses=16)
    seq = make_mono_sequence(n_frames=36, height=240, width=320, dt=0.25, seed=5, speed=0.5)
    _, outs = run_mono_vo(seq.imgs_left, seq.timestamps, seq.ranges, seq.K, cfg_vo, gen(),
                          device="cpu")
    return cfg_ba, seq, host(outs)


class TestWindowBAEndToEnd:
    def test_ba_reduces_ate(self, mono_vo_run):
        """ATE after BA below 0.7x the raw ATE; every cost curve
        non-increasing (LM accept/reject)."""
        cfg, seq, outs = mono_vo_run
        _, _, raw = ttraj.integrate_mono_poses(outs.velocity, outs.R, seq.timestamps,
                                               outs.published)
        gt = seq.positions - seq.positions[0]
        res = ttraj.refine_mono_trajectory(seq.imgs_left, seq.timestamps, outs, seq.K, cfg,
                                           window_size=6, keyframe_stride=2, ba_iters=12,
                                           device="cpu")
        assert ate_rmse(res.positions, gt) < 0.7 * ate_rmse(raw, gt)
        assert res.costs.shape[0] >= 1 and res.ba_iters_per_s > 0
        diffs = np.diff(res.costs, axis=1)
        assert (diffs <= 1e-3 * np.abs(res.costs[:, :-1]) + 1e-5).all()

    def test_keyframe_bookkeeping(self, mono_vo_run):
        cfg, seq, outs = mono_vo_run
        res = ttraj.refine_mono_trajectory(seq.imgs_left, seq.timestamps, outs, seq.K, cfg,
                                           window_size=6, keyframe_stride=2, ba_iters=5,
                                           device="cpu")
        assert len(res.kf_indices) == len(res.kf_positions)
        assert (np.diff(res.kf_indices) > 0).all()
        assert res.positions.shape == (36, 3) and np.isfinite(res.positions).all()
        assert res.R_wc.shape == (36, 3, 3) and res.t_wc.shape == (36, 3)


def test_pose_graph_closes_loop():
    """Mono retrieval + essential verification + pose graph on
    ``make_loop_sequence(20, 240, 320, seed=2)`` with injected drift."""
    cfg = tconfig.MonoVOConfig(surf=tconfig.SurfConfig(min_hessian=60.0), max_keypoints=256,
                               num_hypotheses=256)
    seq = make_loop_sequence(n_frames=20, height=240, width=320, seed=2)
    R_wc, t_drift, pos_drift = drifted(seq)
    res = ttraj.close_loops_and_optimize(seq.imgs_left, R_wc, t_drift, seq.ranges, seq.K, cfg,
                                         min_gap=12, top_k=6, min_similarity=0.8, iters=25,
                                         device="cpu")
    assert_loop_closed(seq, pos_drift, res)
    assert res.costs.shape == (25,)


# ------------------------------------------------------------- parity with JAX


def small_mono_cfg(module):
    return module.MonoVOConfig(surf=module.SurfConfig(min_hessian=60.0), max_keypoints=128,
                               num_hypotheses=64)


def test_refine_mono_trajectory_matches_jax():
    """The port's ``run_mono_vo`` on 7 frames of 160x128, its outputs as
    numpy into both packages' ``refine_mono_trajectory`` (window 3, stride
    1, 6 iterations: 4 solves): keyframes exact; the first solve's costs to
    1e-4 relative, the later ones' to 1e-2 (each window starts from the last
    solve's float32 result, whose reduced system has a condition number of
    ~1e7, see tests/test_torch_optim.py); the corrected poses and positions
    to 5e-3 (of positions up to 0.41 m)."""
    seq = make_mono_sequence(n_frames=7, height=128, width=160, dt=0.25, seed=3)
    _, outs = run_mono_vo(seq.imgs_left, seq.timestamps, seq.ranges, seq.K,
                          small_mono_cfg(tconfig), gen(), device="cpu")
    outs = host(outs)
    kw = dict(window_size=3, keyframe_stride=1, ba_iters=6)
    ref = jtraj.refine_mono_trajectory(seq.imgs_left, seq.timestamps, outs, seq.K,
                                       small_mono_cfg(jconfig), **kw)
    res = ttraj.refine_mono_trajectory(seq.imgs_left, seq.timestamps, outs, seq.K,
                                       small_mono_cfg(tconfig), device="cpu", **kw)
    np.testing.assert_array_equal(res.kf_indices, ref.kf_indices)
    assert res.costs.shape == ref.costs.shape == (4, 6)
    np.testing.assert_allclose(res.costs[0], ref.costs[0], rtol=1e-4)
    np.testing.assert_allclose(res.costs[1:], ref.costs[1:], rtol=1e-2)
    for name in ("positions", "kf_positions", "R_wc", "t_wc"):
        np.testing.assert_allclose(getattr(res, name), getattr(ref, name), atol=5e-3,
                                   err_msg=name)


def candidate_keys(n):
    """The keys the JAX loop closures verify candidates 0..n-1 with: ``key, sub =
    split(key)`` once a candidate, from PRNGKey(0)."""
    key, subs = KEY, []
    for _ in range(n):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


def jax_sets(key, mask, num_hypotheses, set_size):
    idx, valid = j_sample(key, jnp.asarray(np.asarray(mask)), num_hypotheses, set_size)
    return torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(valid))


def relative_pose_sampler(sub):
    """``estimate_relative_pose`` splits its key into (essential, homography)."""
    keys = dict(zip(("essential", "homography"), jax.random.split(sub)))
    return lambda method, mask, h, m: jax_sets(keys[method], mask, h, m)


def candidates_sampler(n, method, mask, h, m):
    sub = candidate_keys(n + 1)[n]
    if method == "pnp":
        return jax_sets(sub, mask, h, m)
    return relative_pose_sampler(sub)(method, mask, h, m)


def detections(img, cfg):
    """The port's (Keypoints, descriptors) of one frame, and JAX's tuple of the same arrays."""
    kp, desc = detect_and_describe_cfg(torch.as_tensor(img), cfg)
    return kp, desc, JKeypoints(*(jnp.asarray(x.numpy()) for x in kp)), jnp.asarray(desc.numpy())


def test_optimize_with_loops_matches_jax():
    """The loop closures' shared tail: odometry edges from drifted poses plus two
    loop edges (one of weight 10 into node 0), 25 Gauss-Newton steps, in
    both packages: the positions to 1e-3, the costs to 1e-3 of the first."""
    seq = make_loop_sequence(n_frames=12, height=64, width=80, seed=2)
    R_wc, t_drift, _ = drifted(seq)
    loops = []
    for i, j in ((0, 11), (1, 10)):
        R_rel = seq.rotations[j] @ seq.rotations[i].T
        t_wc = -np.einsum("ij,j->i", seq.rotations[j], seq.positions[j])
        t_rel = t_wc - R_rel @ -np.einsum("ij,j->i", seq.rotations[i], seq.positions[i])
        loops.append(jtraj.LoopClosure(i, j, R_rel.astype(np.float32), t_rel.astype(np.float32), 50))
    ref = jtraj._optimize_with_loops(R_wc, t_drift, loops, 10.0, 25)
    res = ttraj._optimize_with_loops(R_wc, t_drift, [ttraj.LoopClosure(*lp) for lp in loops],
                                     10.0, 25, torch.device("cpu"))
    np.testing.assert_allclose(res.positions, ref.positions, atol=1e-3)
    np.testing.assert_allclose(res.costs, ref.costs, atol=1e-3 * ref.costs[0])
    assert res.loops == [ttraj.LoopClosure(*lp) for lp in loops]
