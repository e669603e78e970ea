"""Masked statistics — counterpart of ``ergo_uvo_tpu/geometry/stats.py``.

Every statistic takes a boolean mask over the last axis and ignores invalid
lanes, so shapes stay fixed (the reference's ``compute_median`` and
``compute_mean_and_variance``, math_utility.cpp:35-86).
"""

from __future__ import annotations

import torch


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over the valid lanes of the last axis; 0 if no lane is valid.

    Odd count: the middle element; even count: the mean of the two middle
    elements.  Invalid lanes are filled with ``finfo.max`` (as in the JAX
    package; not inf) and sorted past every valid lane.
    """
    big = torch.finfo(values.dtype).max
    filled = torch.where(mask, values, torch.full_like(values, big))
    sorted_vals = torch.sort(filled, dim=-1).values
    n = mask.sum(dim=-1)
    lo_idx = torch.clamp((n - 1) // 2, min=0)
    hi_idx = torch.clamp(n // 2, min=0)
    lo = torch.gather(sorted_vals, -1, lo_idx[..., None])[..., 0]
    hi = torch.gather(sorted_vals, -1, hi_idx[..., None])[..., 0]
    med = 0.5 * (lo + hi)
    return torch.where(n > 0, med, torch.zeros_like(med))


def masked_mean(values: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    n = mask.sum(dim=dim)
    s = torch.where(mask, values, torch.zeros_like(values)).sum(dim=dim)
    return s / torch.clamp(n, min=1)


def masked_mean_and_variance(values: torch.Tensor, mask: torch.Tensor):
    """(mean, population variance) over the valid lanes of the last axis."""
    n = mask.sum(dim=-1)
    mean = masked_mean(values, mask)
    sq = torch.where(mask, (values - mean[..., None]) ** 2, torch.zeros_like(values))
    var = sq.sum(dim=-1) / torch.clamp(n, min=1)
    return mean, var
