"""Brute-force kNN (k=2) matching with the Lowe ratio test.

Counterpart of ``ergo_uvo_tpu/features/matcher.py`` (the reference's
``match_features``, VO_utility.cpp:515-573): the row top-2 of the squared
distance matrix, then ``d0 < ratio * d1`` as a validity mask instead of
compacted vectors.  The JAX package's ``impl=`` switch and its VMEM-fit
fallback are gone: a CUDA tensor always goes to the kernel and a CPU tensor
always to the plain version (:mod:`ergo_uvo_tpu_torch.features.top2_matcher`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ergo_uvo_tpu_torch.features.top2_matcher import top2_distances


class Matches(NamedTuple):
    """For each query keypoint: best train index + distances + validity."""

    idx: torch.Tensor  # (Q,) int32 — best match in the train set
    dist: torch.Tensor  # (Q,) float32 — best L2 distance
    second_dist: torch.Tensor  # (Q,) float32 — second-best L2 distance
    mask: torch.Tensor  # (Q,) bool — valid & passed ratio test

    @property
    def count(self) -> torch.Tensor:
        return self.mask.sum(dtype=torch.int32)


def match_descriptors(
    desc_q: torch.Tensor,
    mask_q: torch.Tensor,
    desc_t: torch.Tensor,
    mask_t: torch.Tensor,
    ratio: float = 0.7,
) -> Matches:
    """kNN(k=2) + Lowe ratio matching of query descriptors against train.

    The JAX package's ``binary=`` (Hamming-scale ratio test for ORB/AKAZE
    bit vectors) comes with those detectors (ROADMAP.md Queue 1, item 10).
    """
    min1, idx1, min2 = top2_distances(desc_q, desc_t, mask_t)
    d1 = torch.sqrt(torch.clamp(min1, min=0.0))
    d2nd = torch.sqrt(torch.clamp(min2, min=0.0))
    n_train = mask_t.sum()
    # OpenCV knnMatch(k=2) yields no pair when < 2 train descriptors exist.
    ok = (
        mask_q
        & torch.isfinite(d1)
        & torch.isfinite(d2nd)
        & (d1 < ratio * d2nd)
        & (n_train >= 2)
    )
    return Matches(
        idx=torch.where(ok, idx1, 0),
        dist=torch.where(ok, d1, 0.0),
        second_dist=torch.where(ok, d2nd, 0.0),
        mask=ok,
    )


def match_and_gather(
    xy_q: torch.Tensor,
    desc_q: torch.Tensor,
    mask_q: torch.Tensor,
    xy_t: torch.Tensor,
    desc_t: torch.Tensor,
    mask_t: torch.Tensor,
    ratio: float = 0.7,
):
    """Matching + coordinates aligned on the query slot, zeros where invalid.

    Returns (prev_xy (Q, 2), curr_xy (Q, 2), matches).
    """
    m = match_descriptors(desc_q, mask_q, desc_t, mask_t, ratio)
    curr = xy_t[m.idx.long()]
    prev = torch.where(m.mask[:, None], xy_q, 0.0)
    curr = torch.where(m.mask[:, None], curr, 0.0)
    return prev, curr, m
