"""Hypothesis minimal-set sampling — counterpart of ``ergo_uvo_tpu/estimation/sampling.py``.

All minimal sets are drawn up front with one Gumbel-top-k pass on a
``torch.Generator``.  PyTorch cannot reproduce JAX's threefry streams, so the
estimators also take an injected ``sampler`` (see :data:`Sampler`); the
parity tests pass one that calls the JAX package's sampler with the keys it
derives, and the main path never passes one.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from uvo_bench.reference.features.detector import top_k

# sampler(mask, num_hypotheses, set_size) -> (idx (H, m) int64, sets_valid (H,) bool),
# as the estimators take it; the pipeline binds the frame and the method first
# (see pipeline/mono.py).
Sampler = Callable[[torch.Tensor, int, int], tuple]


def hypotheses_for_confidence(
    confidence: float, outlier_frac: float, model_points: int
) -> int:
    """Minimal hypothesis count for >= ``confidence`` probability that one
    minimal set is outlier-free (OpenCV's RANSACUpdateNumIters formula)."""
    eps = min(max(outlier_frac, 0.0), 0.95)
    p_good = (1.0 - eps) ** model_points
    if p_good >= 1.0:
        return 1
    return int(math.ceil(math.log(1.0 - confidence) / math.log(1.0 - p_good)))


def implied_inlier_rate(confidence: float, budget: int, model_points: int) -> float:
    """The inlier rate a budget of ``budget`` minimal sets is sized for."""
    conf = min(max(confidence, 0.5), 1.0 - 1e-9)
    p_good = 1.0 - (1.0 - conf) ** (1.0 / max(budget, 1))
    return p_good ** (1.0 / model_points)


def derive_hypothesis_budget(
    confidence: float,
    reference_max_iters: int,
    model_points: int = 8,
    reference_model_points: int = 5,
    floor: int = 512,
    cap: int = 2048,
) -> int:
    """Map the reference's sequential-RANSAC budget onto the batched sampler,
    clamped to [floor, cap] and rounded up to a multiple of 256."""
    rate = implied_inlier_rate(confidence, reference_max_iters, reference_model_points)
    n = hypotheses_for_confidence(confidence, 1.0 - rate, model_points)
    n = max(floor, min(cap, n))
    return int(-(-n // 256) * 256)


def sample_minimal_sets(
    mask: torch.Tensor,
    num_hypotheses: int,
    set_size: int,
    generator: torch.Generator | None = None,
):
    """(H, m) indices of valid entries, distinct within each hypothesis.

    Gumbel-top-k: iid uniforms over all N slots per hypothesis, invalid slots
    pushed to -inf, the top m kept.  With fewer than m valid entries the
    surplus picks land on invalid slots and ``sets_valid`` is False.
    """
    n = mask.shape[0]
    u = torch.rand((num_hypotheses, n), generator=generator, device=mask.device)
    u = torch.where(mask[None, :], u, float("-inf"))
    _, idx = top_k(u, set_size)
    enough = mask.sum() >= set_size
    sets_valid = enough.expand(num_hypotheses)
    return idx, sets_valid


def draw_minimal_sets(
    mask: torch.Tensor,
    num_hypotheses: int,
    set_size: int,
    generator: torch.Generator | None,
    sampler: Sampler | None,
):
    """The injected sampler's sets if one is given, else :func:`sample_minimal_sets`."""
    if sampler is None:
        return sample_minimal_sets(mask, num_hypotheses, set_size, generator)
    idx, sets_valid = sampler(mask, num_hypotheses, set_size)
    return idx.to(mask.device, torch.long), sets_valid.to(mask.device, torch.bool)
