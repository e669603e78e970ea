"""The port's stereo trajectory refinement (window BA on the left eye, stereo
loop closure) on the CPU.

* ``tests/test_stereo_refine.py``'s gates on the port: window BA lowers the
  ATE of a starved stereo run; PnP-verified loop edges and the pose graph
  close the stereo loop fixture.  The port's own VO run feeds the first,
  from a ``torch.Generator`` seeded 0.
* Parity with JAX on the same inputs, 160x128: ``_stereo_frame_landmarks``
  and ``verify_loop_candidate_pnp``, then the whole
  ``close_loops_and_optimize_stereo``, JAX's minimal sets injected through
  the ``sampler`` hook with the keys rebuilt candidate by candidate as the
  JAX function splits them (its PnP compiles in seconds under ``jax.jit``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ergo_uvo_tpu.config as jconfig
from ergo_uvo_tpu.optim import trajectory as jtraj
from ergo_uvo_tpu.pipeline.stereo import StereoRig as JStereoRig
import ergo_uvo_tpu_torch.config as tconfig
from ergo_uvo_tpu_torch.convert import stereo_rig_from_numpy
from ergo_uvo_tpu_torch.eval import ate_rmse
from ergo_uvo_tpu_torch.io import make_loop_sequence, make_stereo_sequence
from ergo_uvo_tpu_torch.optim import trajectory as ttraj
from ergo_uvo_tpu_torch.pipeline import run_stereo_vo
from test_torch_trajectory import (  # noqa: F401  (one_torch_thread is a fixture)
    assert_loop_closed,
    candidate_keys,
    detections,
    drifted,
    candidates_sampler,
    gen,
    host,
    jax_sets,
    one_torch_thread,
    rig_np,
)


def small_stereo_cfg(module):
    return module.StereoVOConfig(surf=module.SurfConfig(min_hessian=60.0), max_keypoints=128,
                                 num_hypotheses=64)


@pytest.fixture(scope="module")
def loop_seq():
    return make_loop_sequence(n_frames=20, height=128, width=160, seed=2, baseline=0.33)


def test_stereo_window_ba_refines_trajectory():
    """tests/test_stereo_refine.py's starved stereo run (48 keypoints, 8
    sets) then window BA over the left frames: ATE below 0.7x."""
    cfg_vo = tconfig.StereoVOConfig(surf=tconfig.SurfConfig(min_hessian=300.0), max_keypoints=48,
                                    num_hypotheses=8)
    cfg_ba = tconfig.StereoVOConfig(surf=tconfig.SurfConfig(min_hessian=60.0), max_keypoints=256,
                                    num_hypotheses=16)
    seq = make_stereo_sequence(n_frames=24, height=240, width=320, dt=0.25, seed=5, speed=0.5)
    _, outs = run_stereo_vo(seq.imgs_left, seq.imgs_right, seq.timestamps,
                            stereo_rig_from_numpy(rig_np(seq.K), "cpu"), cfg_vo, gen(),
                            device="cpu")
    outs = host(outs)
    _, _, raw = ttraj.integrate_mono_poses(outs.velocity, outs.R, seq.timestamps, outs.published)
    gt = seq.positions - seq.positions[0]
    res = ttraj.refine_mono_trajectory(seq.imgs_left, seq.timestamps, outs, seq.K, cfg_ba,
                                       window_size=6, keyframe_stride=2, ba_iters=10,
                                       device="cpu")
    assert np.isfinite(res.positions).all() and len(res.kf_indices) >= 6
    assert ate_rmse(res.positions, gt) < 0.7 * ate_rmse(raw, gt)


def test_stereo_pose_graph_closes_loop():
    """Stereo retrieval + PnP verification against stereo landmarks + pose
    graph on the stereo loop fixture."""
    cfg = tconfig.StereoVOConfig(surf=tconfig.SurfConfig(min_hessian=60.0), max_keypoints=256,
                                 num_hypotheses=256)
    seq = make_loop_sequence(n_frames=20, height=240, width=320, seed=2, baseline=0.33)
    R_wc, t_drift, pos_drift = drifted(seq)
    res = ttraj.close_loops_and_optimize_stereo(
        seq.imgs_left, seq.imgs_right, R_wc, t_drift, stereo_rig_from_numpy(rig_np(seq.K), "cpu"),
        cfg, min_gap=12, top_k=6, min_similarity=0.8, iters=25, device="cpu")
    assert_loop_closed(seq, pos_drift, res)


def test_stereo_landmarks_and_pnp_verify_match_jax(loop_seq):
    """Stereo landmarks of frame 0 (the valid mask exact, X to 1e-3 relative
    where valid), then PnP of them against frame 19's left pixels with
    JAX's key of candidate 0: ok and the inlier count exact, R to 1e-4, t
    to 1e-3."""
    cfg_t, cfg_j = small_stereo_cfg(tconfig), small_stereo_cfg(jconfig)
    rig = rig_np(loop_seq.K)
    jrig = JStereoRig(**{k: jnp.asarray(v) for k, v in rig.items()})
    trig = stereo_rig_from_numpy(rig, "cpu")
    kt_l, dt_l, kj_l, dj_l = detections(loop_seq.imgs_left[0], cfg_t)
    kt_r, dt_r, kj_r, dj_r = detections(loop_seq.imgs_right[0], cfg_t)
    kt_j, dt_j, kj_j, dj_j = detections(loop_seq.imgs_left[19], cfg_t)
    jX, jgood = (np.asarray(x) for x in jax.jit(
        lambda a, b, c, d: jtraj._stereo_frame_landmarks(a, b, c, d, jrig, cfg_j, False))(
            kj_l, dj_l, kj_r, dj_r))
    tX, tgood = ttraj._stereo_frame_landmarks(kt_l, dt_l, kt_r, dt_r, trig, cfg_t, False)
    np.testing.assert_array_equal(tgood.numpy(), jgood)
    assert jgood.sum() >= 20
    np.testing.assert_allclose(tX.numpy()[jgood], jX[jgood], rtol=1e-3, atol=1e-4)

    sub = candidate_keys(1)[0]
    verify = jax.jit(lambda key, a, b, c, d, e, f: jtraj.verify_loop_candidate_pnp(
        key, a, b, c, d, e, f, jrig.K_left, cfg_j, lowe_ratio=cfg_j.lowe_ratio_test))
    ref = [np.asarray(x) for x in verify(sub, jnp.asarray(jX), jnp.asarray(jgood), dj_l,
                                         kj_j.xy, kj_j.mask, dj_j)]
    got = [x.numpy() for x in ttraj.verify_loop_candidate_pnp(
        torch.from_numpy(jX), torch.from_numpy(jgood), dt_l, kt_j.xy, kt_j.mask, dt_j,
        trig.K_left, cfg_t, lowe_ratio=cfg_t.lowe_ratio_test,
        sampler=lambda mask, h, m: jax_sets(sub, mask, h, m))]
    assert bool(ref[0])
    assert bool(got[0]) == bool(ref[0]) and int(got[3]) == int(ref[3])
    np.testing.assert_allclose(got[1], ref[1], atol=1e-4)
    np.testing.assert_allclose(got[2], ref[2], atol=1e-3)


def test_close_loops_and_optimize_stereo_matches_jax(loop_seq):
    """The whole stereo loop closure on the 160x128 loop fixture with
    drift, min_gap 12, top_k 6, similarity 0.8, JAX's key of each verified
    candidate injected: the same accepted loops (i, j, inliers) in the same
    order, their edges to 1e-3, the optimized positions to 1e-3 and the
    pose-graph costs to 1e-3 of the first."""
    R_wc, t_drift, _ = drifted(loop_seq)
    kw = dict(min_gap=12, top_k=6, min_similarity=0.8, iters=10)
    rig = rig_np(loop_seq.K)
    ref = jtraj.close_loops_and_optimize_stereo(
        loop_seq.imgs_left, loop_seq.imgs_right, R_wc, t_drift,
        JStereoRig(**{k: jnp.asarray(v) for k, v in rig.items()}), small_stereo_cfg(jconfig),
        **kw)
    res = ttraj.close_loops_and_optimize_stereo(
        loop_seq.imgs_left, loop_seq.imgs_right, R_wc, t_drift,
        stereo_rig_from_numpy(rig, "cpu"), small_stereo_cfg(tconfig),
        sampler=candidates_sampler, device="cpu", **kw)
    assert len(ref.loops) >= 1
    assert [(lp.i, lp.j, lp.num_inliers) for lp in res.loops] == [
        (lp.i, lp.j, lp.num_inliers) for lp in ref.loops]
    for a, b in zip(res.loops, ref.loops):
        np.testing.assert_allclose(a.R_rel, b.R_rel, atol=1e-3)
        np.testing.assert_allclose(a.t_rel, b.t_rel, atol=1e-3)
    np.testing.assert_allclose(res.positions, ref.positions, atol=1e-3)
    np.testing.assert_allclose(res.costs, ref.costs, atol=1e-3 * ref.costs[0])
