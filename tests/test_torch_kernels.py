"""The top-2 CUDA kernel against its plain PyTorch version.

This file imports no JAX, so that it also runs on the machine with the card,
where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels.py

Here, without a card, the CUDA test skips and the dispatch tests run.
"""

import numpy as np
import pytest
import torch

from ergo_uvo_tpu_torch import cuda_build
from ergo_uvo_tpu_torch.features import top2_matcher

# The main path's shape (512 keypoints, 64-d SURF) and those of
# tests/test_features.py: odd Q, T and D, and T < 8.
SHAPES = [(512, 512, 64), (256, 256, 64), (37, 91, 64), (384, 200, 64),
          (8, 3, 128), (256, 512, 48)]


def unit_descs(n, d, seed, device="cpu"):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=-1, keepdims=True)).to(device)


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never reaches the kernel: same result as the plain
    version and no launch counted."""
    dq, dt = unit_descs(37, 64, 1), unit_descs(91, 64, 2)
    mt = torch.ones(91, dtype=torch.bool)
    mt[::5] = False
    before = top2_matcher.LAUNCHES
    got = top2_matcher.top2_distances(dq, dt, mt)
    ref = top2_matcher.top2_distances_reference(dq, dt, mt)
    assert top2_matcher.LAUNCHES == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """Without nvcc the build raises and says so; nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build._nvcc()


@pytest.mark.cuda
def test_top2_kernel_matches_reference_on_cuda():
    """On the card, at every contract shape with every 5th train row masked,
    and on the edge cases (all rows masked, T = 1, exact duplicate rows):
    idx exact except on rows whose best and second-best distances tie within
    1e-5 (fp32 sums in another order), distances to 1e-3 (squared distances
    of unit vectors lie in [0, 4]); one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    dev = torch.device("cuda")
    cases = []
    for q, tn, d in SHAPES:
        mt = torch.ones(tn, dtype=torch.bool, device=dev)
        mt[::5] = False
        cases.append((unit_descs(q, d, q, dev), unit_descs(tn, d, tn + 1, dev), mt))
    dq = unit_descs(64, 64, 3, dev)
    cases.append((dq, unit_descs(64, 64, 4, dev), torch.zeros(64, dtype=torch.bool, device=dev)))
    cases.append((dq, dq[:1].contiguous(), torch.ones(1, dtype=torch.bool, device=dev)))
    cases.append((dq, torch.cat([dq, dq]), torch.ones(128, dtype=torch.bool, device=dev)))
    for dq, dt, mt in cases:
        before = top2_matcher.LAUNCHES
        k1, ki, k2 = top2_matcher.top2_distances(dq, dt, mt)
        assert top2_matcher.LAUNCHES == before + 1
        r1, ri, r2 = top2_matcher.top2_distances_reference(dq, dt, mt)
        torch.cuda.synchronize()
        tie = (r2 - r1).abs() <= 1e-5 * torch.clamp(r1.abs(), min=1.0)
        assert bool(((ki == ri) | tie).all()), tuple(dq.shape) + tuple(dt.shape)
        torch.testing.assert_close(k1, r1, atol=1e-3, rtol=0)
        torch.testing.assert_close(k2, r2, atol=1e-3, rtol=0)
