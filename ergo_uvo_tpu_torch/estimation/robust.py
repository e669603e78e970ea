"""Robust model scoring — counterpart of ``ergo_uvo_tpu/estimation/robust.py``.

One masked reduction over a (num_hypotheses, N) residual matrix:

* RANSAC: maximize the count of residuals below threshold;
* LMEDS: minimize the masked median of squared residuals, then take inliers
  from OpenCV's robust scale sigma = 2.5 * 1.4826 * (1 + 3/(n - m)) * sqrt(med).

Ties go to the lowest hypothesis index (``torch.argmax``/``argmin`` return the
first extremum, like ``jnp.argmax``/``argmin``).
"""

from __future__ import annotations

import torch

from ergo_uvo_tpu_torch.config import LMEDS, RANSAC
from ergo_uvo_tpu_torch.geometry.stats import masked_median


def lmeds_sigma(median_sq: torch.Tensor, n: torch.Tensor, model_points: int) -> torch.Tensor:
    """OpenCV LMeDS robust scale from the median squared residual."""
    n_f = torch.clamp(n.to(median_sq.dtype) - model_points, min=1.0)
    return 2.5 * 1.4826 * (1.0 + 3.0 / n_f) * torch.sqrt(torch.clamp(median_sq, min=0.0))


def lmeds_inlier_mask(
    residual_sq: torch.Tensor, mask: torch.Tensor, model_points: int
) -> torch.Tensor:
    """Inlier mask for the winning LMEDS model (OpenCV semantics)."""
    med = masked_median(residual_sq, mask)
    sigma = lmeds_sigma(med, mask.sum(), model_points)
    return mask & (residual_sq <= sigma * sigma)


def inlier_mask_for_model(
    residual_sq: torch.Tensor,
    mask: torch.Tensor,
    method: int,
    threshold: float,
    model_points: int,
) -> torch.Tensor:
    """Method-consistent inlier mask for a single (e.g. refit) model."""
    finite = torch.isfinite(residual_sq)
    if method == RANSAC:
        return mask & finite & (residual_sq <= threshold * threshold)
    if method == LMEDS:
        r2 = torch.where(finite, residual_sq, 1e30)
        return lmeds_inlier_mask(r2, mask, model_points)
    raise NotImplementedError(f"outlier method {method}")


def score_hypotheses(
    residual_sq: torch.Tensor,
    mask: torch.Tensor,
    sets_valid: torch.Tensor,
    method: int,
    threshold: float,
    model_points: int,
):
    """Pick the best hypothesis; return (best_idx (0-d int64), inlier_mask_of_best)."""
    finite = torch.isfinite(residual_sq)
    if method == RANSAC:
        t2 = threshold * threshold
        r2 = torch.where(finite & mask[None, :], residual_sq, float("inf"))
        scores = (r2 <= t2).sum(-1)
        scores = torch.where(sets_valid, scores, -1)
        best = torch.argmax(scores)
        inliers = mask & (r2[best] <= t2)
        return best, inliers
    if method == LMEDS:
        # Non-finite residuals become huge rather than masked out: a
        # hypothesis that produces NaNs must score badly.
        r2_clean = torch.where(finite, residual_sq, 1e30)
        meds = masked_median(r2_clean, mask[None, :].expand(r2_clean.shape))
        meds = torch.where(sets_valid, meds, float("inf"))
        best = torch.argmin(meds)
        inliers = lmeds_inlier_mask(r2_clean[best], mask, model_points)
        return best, inliers
    raise NotImplementedError(f"outlier method {method} (supported: RANSAC=8, LMEDS=4)")
