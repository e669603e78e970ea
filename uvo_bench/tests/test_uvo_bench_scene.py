"""The benchmark's scene: the traffic lever (jitter) turns the mono essential
estimator on for about half the frames of ``survey_20hz`` and off for every
frame of ``steady_20hz``, on the mix's own trajectory and on another; the
same seed gives the same frames."""

import numpy as np
import pytest
import torch

from uvo_bench import scene, spec

CAMERA = spec.load_json(spec.BENCH_DIR / "configs" / "mono_surf_vga.json")["camera"]
DISTANCE = spec.load_json(spec.BENCH_DIR / "configs" / "mono_surf_vga.json")["distance"]


def _essential_share(traffic_name, seed, frames=1200):
    traffic = spec.load_json(spec.BENCH_DIR / "traffic" / f"{traffic_name}.json")
    seed = traffic["trajectory_seed"] if seed is None else seed
    _, C, R = scene.trajectory(frames, traffic, np.random.default_rng(seed))
    parallax = scene.median_parallax(scene.camera_matrix(CAMERA), R, C)[1:]
    return float((parallax >= DISTANCE).mean())


@pytest.mark.parametrize("seed", [None, 2**31 + 3])
def test_steady_mix_never_prefers_the_essential_matrix(seed):
    assert _essential_share("steady_20hz", seed) == 0.0


@pytest.mark.parametrize("seed", [None, 2**31 + 3])
def test_survey_mix_prefers_it_on_about_half_the_frames(seed):
    assert 0.4 <= _essential_share("survey_20hz", seed) <= 0.7


def test_same_seed_same_frames_and_the_stereo_eye_is_offset():
    traffic = {**spec.load_json(spec.BENCH_DIR / "traffic" / "survey_20hz.json"),
               "texture_size": 128}
    cam = {**CAMERA, "width": 64, "height": 48}
    a = scene.make_stream(cam, traffic, 0.33, 2**31 + 5, "cpu", frames=3)
    b = scene.make_stream(cam, traffic, 0.33, 2**31 + 5, "cpu", frames=3)
    c = scene.make_stream(cam, traffic, 0.33, 6, "cpu", frames=3)
    assert a.left.dtype == torch.uint8 and a.left.shape == (3, 48, 64)
    assert torch.equal(a.left, b.left) and torch.equal(a.right, b.right)
    assert not torch.equal(a.left, c.left)
    assert not torch.equal(a.left, a.right)
    assert float(a.left.float().std()) > 5.0
