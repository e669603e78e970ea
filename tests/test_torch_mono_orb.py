"""The port's mono path with ORB against JAX ``run_mono_vo`` (CPU).

ORB's contract is the JAX package's outputs, not the thresholds of
tests/test_pipeline.py::test_mono_vo_with_alternate_detector[ORB] (which
fails in the JAX package itself).  Both packages run ``run_mono_vo`` on 6
frames of 160x128 from ``make_mono_sequence(seed=3)`` under ORB (threshold
10, 128 keypoints, 64 hypotheses, Lowe 0.8), with the port's minimal sets
those JAX draws (``split(split(key, 6)[i])`` for frame i).  This exercises
the Hamming matcher end to end: ``binary=True`` on 256-bit descriptors.

The whole run is compared, not the JAX frontend fed into the port's step:
at this size no near-tie bit flip reaches a match, so the discrete outputs
are exact.  JAX runs under ``jax.disable_jit()``, the run the port is held
to: at this size it gives the jitted run's discrete outputs in about half
the time that tracing and compiling the scanned ORB program takes on a cold
cache.  Even so it takes minutes on one CPU worker, so this file holds it
alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ergo_uvo_tpu.config as jconfig
from ergo_uvo_tpu.estimation.sampling import sample_minimal_sets as j_sample
from ergo_uvo_tpu.pipeline import run_mono_vo as j_run_mono_vo
import ergo_uvo_tpu_torch.config as tconfig
from ergo_uvo_tpu_torch.io import make_mono_sequence
from ergo_uvo_tpu_torch.pipeline import run_mono_vo

N_FRAMES = 6
KEY = jax.random.PRNGKey(0)


def cfg_of(module):
    return module.MonoVOConfig(feature_detector="ORB", max_keypoints=128, num_hypotheses=64,
                               lowe_ratio_test=0.8)


def frame_sampler(frame, method, mask, num_hypotheses, set_size):
    k_e, k_h = jax.random.split(jax.random.split(KEY, N_FRAMES)[frame])
    key = {"essential": k_e, "homography": k_h}[method]
    idx, valid = j_sample(key, jnp.asarray(mask.numpy()), num_hypotheses, set_size)
    return torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(valid))


@pytest.fixture(scope="module")
def seq():
    return make_mono_sequence(n_frames=N_FRAMES, height=128, width=160, dt=0.25, seed=3)


def test_run_mono_vo_orb_matches_jax(seq):
    """Frame by frame: published, validity, the chosen method and every
    count exact; velocity to 5e-3 m/s and the scale factor to 1e-2 relative
    (tests/test_torch_pipeline.py's tolerances for float32 reassociation
    through the LMEDS refit and Gauss-Newton); R to 1e-3."""
    with jax.disable_jit():
        _, ref = j_run_mono_vo(
            jnp.asarray(seq.imgs_left), jnp.asarray(seq.timestamps), jnp.asarray(seq.ranges),
            jnp.asarray(seq.K), cfg_of(jconfig), KEY)
    ref = jax.tree.map(np.asarray, ref)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, outs = run_mono_vo(seq.imgs_left, seq.timestamps, seq.ranges, seq.K, cfg_of(tconfig),
                              sampler=frame_sampler, device="cpu")
    finally:
        torch.set_num_threads(n)
    outs = type(outs)(*(x.numpy() for x in outs))
    assert not ref.published[0] and ref.published[1:].all() and ref.validity[1:].all()
    for name in ("published", "validity", "used_essential", "num_features", "num_matches",
                 "num_inliers", "num_3d_points"):
        np.testing.assert_array_equal(getattr(outs, name), getattr(ref, name), err_msg=name)
    np.testing.assert_allclose(outs.velocity, ref.velocity, atol=5e-3)
    np.testing.assert_allclose(outs.scale_factor, ref.scale_factor, rtol=1e-2)
    np.testing.assert_allclose(outs.R, ref.R, atol=1e-3)
