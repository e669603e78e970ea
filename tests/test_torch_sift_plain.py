"""The port's SIFT (``features/sift.py``) against the benchmark's plain SIFT
(``uvo_bench/reference/features/sift.py``), and the port's SIFT spans (CPU).

Both follow the same mathematics in the same order, the port batched, the
plain file one frame at a time.  Tolerances:

* exact: the keypoint mask and count;
* xy and scale to 1e-4 px, descriptors to 1e-5: both sides add the same
  float32 terms in the same order, so they agree here to the bit; the room
  left is for a matmul library that blocks the histogram sums of a batch of
  frames otherwise than those of one.  A descriptor differs from its
  unclipped self by more than 1e-2 wherever the 0.2 clip acts, so leaving
  the clip out on either side fails the check.
"""

import numpy as np
import pytest
import torch

from ergo_uvo_tpu_torch.config import MonoVOConfig
from ergo_uvo_tpu_torch.features import frontend
from ergo_uvo_tpu_torch.features.sift import detect_and_describe_sift
from ergo_uvo_tpu_torch.io import make_mono_sequence
from ergo_uvo_tpu_torch.utils import profiling
from uvo_bench import spec
from uvo_bench.reference import config as ref_config
from uvo_bench.reference.features import frontend as ref_frontend
from uvo_bench.reference.features import sift as ref_sift

K = 64
SIFT_CONFIG = spec.load_json(spec.BENCH_DIR / "configs" / "mono_sift_vga.json")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops on these small images are faster on one thread than spread
    over a shared host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frames(h, w, n, seed):
    """``n`` seeded seafloor frames (n, h, w), gray levels 0-255."""
    seq = make_mono_sequence(n_frames=n, height=h, width=w, seed=seed)
    return torch.from_numpy(seq.imgs_left.astype(np.float32))


CASES = {
    "96x128": lambda: frames(96, 128, 1, 3)[0],
    "120x160": lambda: frames(120, 160, 1, 4)[0],
    "batch_of_2": lambda: frames(96, 128, 2, 5),
    "flat": lambda: torch.full((96, 128), 128.0),
}


def assert_same_features(port, plain):
    (pk, pd), (rk, rd) = port, plain
    np.testing.assert_array_equal(pk.mask.numpy(), rk.mask.numpy())
    np.testing.assert_array_equal(pk.count.numpy(), rk.count.numpy())
    np.testing.assert_allclose(pk.xy.numpy(), rk.xy.numpy(), atol=1e-4)
    np.testing.assert_allclose(pk.scale.numpy(), rk.scale.numpy(), atol=1e-4)
    np.testing.assert_allclose(pk.score.numpy(), rk.score.numpy(), atol=1e-4)
    np.testing.assert_allclose(pk.laplacian.numpy(), rk.laplacian.numpy(), atol=1e-5)
    np.testing.assert_allclose(pd.numpy(), rd.numpy(), atol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_port_sift_matches_the_plain_sift(case):
    img = CASES[case]()
    port = detect_and_describe_sift(img, K)
    plain = ref_sift.detect_and_describe_cfg(
        img, ref_config.MonoVOConfig(feature_detector="SIFT", max_keypoints=K))
    assert_same_features(port, plain)
    count = port[0].count
    if case == "flat":
        assert (count == 0).all() and (port[1] == 0).all()
    else:
        assert (count > 20).all()


def test_the_configurations_frontend_matches_the_plain_one():
    """``detect_and_describe_cfg`` under ``mono_sift_vga.json``'s settings (SIFT,
    512 keypoints, contrast 0.03, edge 10), against the plain frontend, which
    finds the plain SIFT by the detector's name."""
    port_cfg = spec.build_config(MonoVOConfig, SIFT_CONFIG)
    plain_cfg = spec.build_config(ref_config.MonoVOConfig, SIFT_CONFIG)
    assert port_cfg.feature_detector == "SIFT" and port_cfg.max_keypoints == 512
    assert port_cfg.descriptor_dim == plain_cfg.descriptor_dim == 128
    img = frames(120, 160, 1, 6)[0]
    port = frontend.detect_and_describe_cfg(img, port_cfg)
    plain = ref_frontend.detect_and_describe_cfg(img, plain_cfg)
    assert port[1].shape == (512, 128)
    assert not frontend.is_binary(port_cfg) and not ref_frontend.is_binary(plain_cfg)
    assert_same_features(port, plain)


SIFT_SPANS = {"detect.sift.scale_space": 1, "detect.sift.extrema": 4,
              "detect.sift.describe": 4, "detect.sift.select": 1}


@pytest.mark.parametrize("recording", [True, False], ids=["recording", "off"])
def test_sift_spans_nest_under_detect_and_the_counter_counts_every_pass(recording):
    """Each span a detection once, but extrema and describe once an octave, all
    children of ``detect``; ``sift.describe_passes`` counts the 4 describe
    passes of a detection whether or not spans are recorded."""
    cfg = MonoVOConfig(feature_detector="SIFT", max_keypoints=K)
    img = frames(96, 128, 1, 7)[0]
    before = profiling.COUNTERS["sift.describe_passes"]
    if recording:
        with profiling.recording() as rec:
            frontend.detect_and_describe_cfg(img, cfg)
            frontend.detect_and_describe_cfg(img, cfg)
        spans = rec.spans()
        roots = [s for s in spans if s.parent == -1]
        assert [s.name for s in roots] == ["detect", "detect"]
        for root in roots:
            children = [s for s in spans if s.parent == root.id]
            assert {n: sum(s.name == n for s in children) for n in SIFT_SPANS} == SIFT_SPANS
            assert len(children) == sum(SIFT_SPANS.values())
            assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in children)
        assert {n: rec.totals[n].calls for n in SIFT_SPANS} == {
            n: 2 * c for n, c in SIFT_SPANS.items()}
        assert rec.counters["sift.describe_passes"] == 8
    else:
        frontend.detect_and_describe_cfg(img, cfg)
        frontend.detect_and_describe_cfg(img, cfg)
    assert profiling.COUNTERS["sift.describe_passes"] - before == 8
