"""The SIFT, ORB and AKAZE frontends through the port's pipelines (CPU).

* Stereo, SIFT: ``run_stereo_vo`` in both packages on 6 pairs of 160x120
  (128 keypoints, 64 minimal sets; the size of tests/test_torch_stereo.py),
  the minimal sets injected through the ``sampler`` hook (JAX's sets of
  ``split(key, 6)[i]``): discrete outputs exact, floats to
  tests/test_torch_stereo.py's tolerances.
* Batched runner, SIFT: ``run_mono_vo_batched_features`` equals the port's
  ``run_mono_vo`` bit for bit, every field.
* Every detector through every entry point of the port: the bulk runners,
  the streaming runners (bit-equal to ``preprocess_frame`` then the bulk
  runner) and the CLI with ``--params`` naming the detector.
* The new frontends read nothing back to the host (an AST scan).
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ergo_uvo_tpu.config as jconfig
from ergo_uvo_tpu.estimation.sampling import sample_minimal_sets as j_sample
from ergo_uvo_tpu.pipeline import run_stereo_vo as j_run_stereo_vo
from ergo_uvo_tpu.pipeline.stereo import StereoRig as JStereoRig
import ergo_uvo_tpu_torch.config as tconfig
from ergo_uvo_tpu_torch import cli
from ergo_uvo_tpu_torch.convert import stereo_rig_from_numpy
from ergo_uvo_tpu_torch.image import build_preprocess_plan, preprocess_frame
from ergo_uvo_tpu_torch.io import ArraySource, make_mono_sequence, make_stereo_sequence
from ergo_uvo_tpu_torch.pipeline import (
    run_mono_vo,
    run_mono_vo_batched_features,
    run_mono_vo_streaming,
    run_stereo_vo,
    run_stereo_vo_streaming,
)

PORT_DIR = Path(__file__).resolve().parent.parent / "ergo_uvo_tpu_torch"
DETECTORS = ["SIFT", "ORB", "AKAZE"]
KEY = jax.random.PRNGKey(0)
N_STEREO = 6
RIG = dict(R_right=np.eye(3, dtype=np.float32), t_right=np.asarray([-0.33, 0.0, 0.0], np.float32))


def mono_cfg(det):
    return tconfig.MonoVOConfig(feature_detector=det, max_keypoints=128, num_hypotheses=64,
                                lowe_ratio_test=0.8)


def stereo_cfg(module, det):
    return module.StereoVOConfig(feature_detector=det, max_keypoints=128, num_hypotheses=64)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def host(tup):
    return type(tup)(*(np.asarray(x) for x in tup))


def assert_bit_equal(a, b):
    for name, x, y in zip(a._fields, host(a), host(b)):
        np.testing.assert_array_equal(x, y, err_msg=name)
        assert x.dtype == y.dtype, name


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops on these small images are faster on one thread than spread
    over a shared host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mono_seq():
    return make_mono_sequence(n_frames=5, height=128, width=160, dt=0.25, seed=3)


@pytest.fixture(scope="module")
def stereo_seq():
    return make_stereo_sequence(n_frames=N_STEREO, height=120, width=160, dt=0.25,
                                baseline=0.33, seed=6)


def rig_np(seq):
    return dict(RIG, K_left=seq.K.astype(np.float32), K_right=seq.K.astype(np.float32))


def stereo_sampler(frame, method, mask, num_hypotheses, set_size):
    assert method == "pnp" and set_size == 3
    key = jax.random.split(KEY, N_STEREO)[frame]
    idx, valid = j_sample(key, jnp.asarray(mask.numpy()), num_hypotheses, set_size)
    return torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(valid))


def test_run_stereo_vo_sift_matches_jax(stereo_seq):
    """SIFT stereo against JAX ``run_stereo_vo`` frame by frame (two
    matches a pair at D = 128): published, validity and every count exact;
    velocity to 5e-3 m/s, t to 2e-3, R to 1e-3 (as tests/test_torch_stereo.py)."""
    seq = stereo_seq
    rig = JStereoRig(**{k: jnp.asarray(v) for k, v in rig_np(seq).items()})
    _, ref = j_run_stereo_vo(jnp.asarray(seq.imgs_left), jnp.asarray(seq.imgs_right),
                             jnp.asarray(seq.timestamps), rig, stereo_cfg(jconfig, "SIFT"), KEY)
    ref = host(ref)
    _, outs = run_stereo_vo(seq.imgs_left, seq.imgs_right, seq.timestamps,
                            stereo_rig_from_numpy(rig_np(seq), "cpu"), stereo_cfg(tconfig, "SIFT"),
                            sampler=stereo_sampler, device="cpu")
    outs = host(outs)
    assert not ref.published[0] and ref.published[1:].all() and ref.validity[1:].all()
    for name in ("published", "validity", "num_features_l", "num_features_r",
                 "num_stereo_matches", "num_triangular_matches", "num_3d_points",
                 "num_pnp_inliers"):
        np.testing.assert_array_equal(getattr(outs, name), getattr(ref, name), err_msg=name)
    np.testing.assert_allclose(outs.velocity, ref.velocity, atol=5e-3)
    np.testing.assert_allclose(outs.t, ref.t, atol=2e-3)
    np.testing.assert_allclose(outs.R, ref.R, atol=1e-3)


def test_batched_features_runner_sift_equals_run_mono_vo(mono_seq):
    """SIFT detected on all frames at once gives each frame the bits it gets
    alone: every output field and the state equal ``run_mono_vo``'s."""
    seq, cfg = mono_seq, mono_cfg("SIFT")
    args = (seq.imgs_left, seq.timestamps, seq.ranges, seq.K, cfg)
    s1, o1 = run_mono_vo(*args, gen(), device="cpu")
    s2, o2 = run_mono_vo_batched_features(*args, gen(), device="cpu")
    assert bool(o1.published[1:].all())
    assert_bit_equal(o2, o1)
    assert_bit_equal(s2, s1)


@pytest.mark.parametrize("det", DETECTORS)
def test_mono_entry_points_run_every_detector(mono_seq, det):
    """``run_mono_vo`` publishes every frame after the first with finite
    velocities and a state sized by ``descriptor_dim``; the streaming runner
    (chunks of 2) equals preprocess then ``run_mono_vo`` bit for bit."""
    seq, cfg = mono_seq, mono_cfg(det)
    plan = build_preprocess_plan(seq.K, np.zeros(4), 160, 128, 160, True, 3.0, device="cpu")
    frames = preprocess_frame(plan, torch.as_tensor(seq.imgs_left))
    state, outs = run_mono_vo(frames, seq.timestamps, seq.ranges, plan.new_K, cfg, gen(),
                              device="cpu")
    assert bool(outs.published[1:].all()) and bool(torch.isfinite(outs.velocity).all())
    assert state.prev_desc.shape == (128, cfg.descriptor_dim)
    source = ArraySource(seq.imgs_left[:4], seq.timestamps[:4], ranges=seq.ranges[:4])
    s_state, s_outs = run_mono_vo_streaming(source, plan, plan.new_K, cfg, gen(), chunk_size=2,
                                            device="cpu")
    b_state, b_outs = run_mono_vo(frames[:4], seq.timestamps[:4], seq.ranges[:4], plan.new_K,
                                  cfg, gen(), device="cpu")
    assert_bit_equal(s_outs, b_outs)
    assert_bit_equal(s_state, b_state)


@pytest.mark.parametrize("det", ["ORB", "AKAZE"])
def test_stereo_entry_points_run_binary_detectors(stereo_seq, det):
    """``run_stereo_vo`` with a binary detector publishes every pair after
    the first with finite velocities; the streaming runner equals the bulk
    runner bit for bit."""
    seq, cfg = stereo_seq, stereo_cfg(tconfig, det)
    rig = stereo_rig_from_numpy(rig_np(seq), "cpu")
    state, outs = run_stereo_vo(seq.imgs_left, seq.imgs_right, seq.timestamps, rig, cfg, gen(),
                                device="cpu")
    assert bool(outs.published[1:].all()) and bool(torch.isfinite(outs.velocity).all())
    assert state.prev_desc_l.shape == (128, cfg.descriptor_dim)
    plans = [build_preprocess_plan(seq.K, np.zeros(4), 160, 120, 160, False, 3.0, device="cpu")
             for _ in range(2)]
    source = ArraySource(seq.imgs_left, seq.timestamps, imgs_right=seq.imgs_right)
    s_state, s_outs = run_stereo_vo_streaming(source, *plans, rig, cfg, gen(), chunk_size=3,
                                              device="cpu")
    assert_bit_equal(s_outs, outs)
    assert_bit_equal(s_state, state)


@pytest.mark.parametrize("det", DETECTORS)
def test_cli_runs_every_detector_from_params(capsys, tmp_path, det):
    """``python -m ergo_uvo_tpu_torch.cli mono --params`` with
    ``vo_params.feature_detector`` set: 4 synthetic 160x128 frames on the
    CPU, a record a frame, a finite ATE."""
    params = tmp_path / "params.yaml"
    params.write_text(f"vo_params:\n  feature_detector: {det}\n  lowe_ratio_test: 0.8\n"
                      "tpu_params:\n  max_keypoints: 128\n  num_hypotheses: 64\n")
    out = tmp_path / "m.jsonl"
    cli.main(["mono", "--synthetic", "4", "--synthetic-size", "160x128", "--device", "cpu",
              "--chunk-size", "2", "--params", str(params), "--out", str(out)])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["frames"] == 4 and np.isfinite(summary["ate_m"])
    assert len(out.read_text().splitlines()) == 4


@pytest.mark.fast
def test_new_frontends_read_nothing_back():
    """``features/{sampling,orb,sift,akaze}.py`` call no ``.item()``,
    ``.cpu()``, ``.tolist()``, ``.numpy()`` and no ``nonzero`` /
    ``masked_select`` / ``argwhere`` (shapes that depend on the data): the
    frontends queue their work without waiting for the card."""
    banned = {"item", "cpu", "tolist", "numpy", "nonzero", "masked_select", "argwhere"}
    offenders = []
    for name in ("sampling", "orb", "sift", "akaze"):
        path = PORT_DIR / "features" / f"{name}.py"
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in banned):
                offenders.append(f"{name}.py: {ast.unparse(node)}")
    assert offenders == [], offenders
