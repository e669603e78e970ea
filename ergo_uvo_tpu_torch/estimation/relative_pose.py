"""Relative-pose orchestration — counterpart of ``ergo_uvo_tpu/estimation/relative_pose.py``.

The reference's ``estimate_relative_pose`` (VO_utility.cpp:134-180): try the
method that ``select_estimation_method`` prefers; if its valid-point-fraction
or inlier-count gate fails, switch method once; on total failure output the
last attempt.  The JAX package's two nested ``lax.cond`` become Python ``if``
on ``.item()``: one host sync for the preference and one for the first gate,
per frame.  That keeps the common frame to one robust estimator, as the
``cond`` did.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ergo_uvo_tpu_torch.config import MonoVOConfig
from ergo_uvo_tpu_torch.estimation.essential import (
    _normalized,
    find_essential,
    recover_pose_from_essential,
)
from ergo_uvo_tpu_torch.estimation.homography import find_homography, recover_pose_homography
from ergo_uvo_tpu_torch.geometry.stats import masked_median
from ergo_uvo_tpu_torch.utils.profiling import count, span

# sampler(method, mask, num_hypotheses, set_size) -> (idx, sets_valid), with
# method "essential" or "homography"; see estimation/sampling.py.
MethodSampler = Callable[[str, torch.Tensor, int, int], tuple]


class RelativePoseResult(NamedTuple):
    R: torch.Tensor  # (3,3) curr <- prev
    t: torch.Tensor  # (3,) unit scale
    triangulation_inliers: torch.Tensor  # (N,) epipolar/RANSAC inlier mask
    success: torch.Tensor  # bool — VPF and inlier-count gates passed
    used_essential: torch.Tensor  # bool — which method produced the output
    num_inliers: torch.Tensor  # int — the VPF numerator actually used


def select_estimation_method(
    xy1: torch.Tensor, xy2: torch.Tensor, mask: torch.Tensor, distance: float
) -> torch.Tensor:
    """True -> essential, False -> homography (median parallax < ``distance`` px)."""
    disp = torch.linalg.vector_norm(xy1 - xy2, dim=-1)
    return masked_median(disp, mask) >= distance


def estimate_relative_pose(
    xy1: torch.Tensor,
    xy2: torch.Tensor,
    mask: torch.Tensor,
    K: torch.Tensor,
    cfg: MonoVOConfig,
    R_prev: torch.Tensor,
    t_prev: torch.Tensor,
    generator: torch.Generator | None = None,
    sampler: MethodSampler | None = None,
) -> RelativePoseResult:
    """The reference's estimate + switch-once logic on masked fixed-shape tensors.

    ``xy1``/``xy2``: (N, 2) matched previous/current pixels (zeros invalid);
    ``R_prev``/``t_prev``: the carried pose, passed through on total failure
    and into the homography vote's no-candidate case.  Each method draws its
    minimal sets from its own sampler stream (``sampler`` bound to
    "essential" or "homography"), so results do not depend on which branch
    runs first — as the JAX package's fixed per-method keys.
    """
    with span("relative_pose"):
        n_matches = mask.sum()
        x1n = _normalized(K, xy1)
        x2n = _normalized(K, xy2)

        def method_sampler(method):
            if sampler is None:
                return None
            return lambda m, h, k: sampler(method, m, h, k)

        def essential_branch():
            E, epi_inliers = find_essential(
                xy1, xy2, mask, K,
                cfg.essential.outlier_method, cfg.essential.threshold,
                cfg.num_hypotheses, generator, method_sampler("essential"),
            )
            R_e, t_e, mask_e = recover_pose_from_essential(E, x1n, x2n, epi_inliers)
            # VPF counts the recoverPose-updated mask (VO_utility.cpp:157);
            # triangulation takes findEssentialMat's mask (:148).
            return R_e, t_e, epi_inliers, mask_e.sum()

        def homography_branch():
            Hm, h_inliers = find_homography(
                xy1, xy2, mask,
                cfg.homography.outlier_method, cfg.homography.threshold,
                cfg.num_hypotheses, generator, method_sampler("homography"),
            )
            R_h, t_h, _ = recover_pose_homography(
                Hm, xy1, xy2, h_inliers, K, cfg.homography_distance, R_prev, t_prev
            )
            return R_h, t_h, h_inliers, h_inliers.sum()

        def gate(num_inl):
            # Accept iff VPF and inlier-count thresholds pass (VO_utility.cpp:157-160).
            vpf = num_inl / torch.clamp(n_matches, min=1)
            return (vpf >= cfg.valid_point_fraction) & (num_inl >= cfg.min_num_inliers)

        with span("relative_pose.select"):
            prefer_essential = select_estimation_method(xy1, xy2, mask, cfg.distance)
            prefer = bool(prefer_essential.item())

        first = essential_branch() if prefer else homography_branch()
        first_ok = gate(first[3])
        if first_ok.item():
            second = first
        else:
            # On total failure the output holds the LAST attempt, i.e. this one.
            count("relative_pose.second_attempts")
            second = homography_branch() if prefer else essential_branch()
        R, t, tri_inliers, num_inliers = second
        success = first_ok | gate(num_inliers)
        use_essential = torch.where(first_ok, prefer_essential, ~prefer_essential)
        return RelativePoseResult(
            R=R,
            t=t,
            triangulation_inliers=tri_inliers,
            success=success,
            used_essential=use_essential,
            num_inliers=num_inliers,
        )
