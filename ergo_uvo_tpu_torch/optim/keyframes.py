"""Keyframe window bookkeeping: VO keyframes into BA problems.

Counterpart of ``ergo_uvo_tpu/optim/keyframes.py``.  A window of P keyframes
with fixed K feature slots; landmarks are the oldest keyframe's slots
(L = K), every other keyframe observes them through descriptor matching
against that anchor, and their positions start from triangulating the anchor
against the newest keyframe.  Every array stays (P, L)-shaped.

The JAX package vmaps the matcher over the window (with ``impl="xla"``).
Here each member but the anchor is matched in turn, through
``match_descriptors`` and so, on the card, through the top-2 kernel: P - 1
launches a window (the anchor's own row is overwritten by its slots, so it is
not matched).  :class:`WindowedBA` keeps the JAX API; it has no cache of
compiled programs, since the port runs eagerly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ergo_uvo_tpu_torch.features.matcher import match_descriptors
from ergo_uvo_tpu_torch.geometry.camera import projection_matrix
from ergo_uvo_tpu_torch.geometry.triangulation import triangulate_points
from ergo_uvo_tpu_torch.optim.ba import BAProblem, ba_solve, reprojection_residuals


class KeyframeWindow(NamedTuple):
    """Stacked keyframe data, oldest first (index 0 = BA anchor)."""

    xy: torch.Tensor  # (P, K, 2)
    desc: torch.Tensor  # (P, K, D)
    kp_mask: torch.Tensor  # (P, K)
    R: torch.Tensor  # (P, 3, 3) world -> camera initial poses
    t: torch.Tensor  # (P, 3)


def build_ba_problem(
    window: KeyframeWindow,
    K_cam: torch.Tensor,
    lowe_ratio: float = 0.8,
    min_track_length: int = 2,
    num_fixed_poses: int = 2,
    obs_gate_px: float = 6.0,
    binary: bool = False,
):
    """Associate the window's features with the anchor's landmarks.

    Observations whose initial reprojection error (VO poses, triangulated
    landmarks) exceeds ``obs_gate_px`` are masked out: the few mismatches
    that pass the ratio test would dominate a least-squares cost.  Two fixed
    poses: monocular BA has a 7-dof gauge, one pose pins the frame and the
    second the scale.

    Returns (problem, X0 (L, 3) landmark init, lm_mask (L,)).
    """
    anchor_desc = window.desc[0]
    anchor_mask = window.kp_mask[0]
    obs_uv, obs_mask = [window.xy[0]], [anchor_mask]  # the anchor observes its own slots
    for p in range(1, window.xy.shape[0]):
        m = match_descriptors(anchor_desc, anchor_mask, window.desc[p], window.kp_mask[p],
                              lowe_ratio, binary=binary)
        uv = window.xy[p][m.idx.long()]
        obs_uv.append(torch.where(m.mask[:, None], uv, 0.0))
        obs_mask.append(m.mask)
    obs_uv = torch.stack(obs_uv)  # (P, L, 2)
    obs_mask = torch.stack(obs_mask)  # (P, L)

    # Landmark init: anchor against the newest keyframe (widest baseline).
    P0 = projection_matrix(K_cam, window.R[0], window.t[0])
    P_last = projection_matrix(K_cam, window.R[-1], window.t[-1])
    X0 = triangulate_points(P0, P_last, obs_uv[0], obs_uv[-1])
    lm_finite = anchor_mask & obs_mask[-1] & torch.isfinite(X0).all(-1)
    z0 = (X0 @ window.R[0].T + window.t[0])[:, 2]
    lm_finite = lm_finite & (z0 > 0)  # in front of the anchor camera

    # Outlier gate on the initial geometry, then the track length again on
    # what survives.
    X0_safe = torch.where(lm_finite[:, None], X0,
                          torch.tensor([0.0, 0.0, 1.0], dtype=X0.dtype, device=X0.device))
    r0, _, _ = reprojection_residuals(K_cam, window.R, window.t, X0_safe, obs_uv, obs_mask)
    err0 = torch.linalg.vector_norm(r0, dim=-1)
    obs_mask = obs_mask & lm_finite[None, :] & (err0 < obs_gate_px)
    seen = obs_mask.sum(0)
    lm_mask = lm_finite & obs_mask[0] & obs_mask[-1] & (seen >= min_track_length)
    obs_mask = obs_mask & lm_mask[None, :]
    problem = BAProblem(K=K_cam, obs_uv=obs_uv, obs_mask=obs_mask,
                        num_fixed_poses=num_fixed_poses)
    return problem, torch.where(lm_mask[:, None], X0, 0.0), lm_mask


class WindowedBA:
    """Sliding-window BA: push keyframes, get refined poses.

    A host-side ring of the keyframes' tensors; :meth:`refine` associates the
    window and solves it where the tensors lie.
    """

    def __init__(self, window_size: int = 8, iters: int = 15):
        self.window_size = window_size
        self.iters = iters
        self._frames: list = []

    def push_keyframe(self, xy, desc, kp_mask, R_wc, t_wc):
        self._frames.append((xy, desc, kp_mask, R_wc, t_wc))
        if len(self._frames) > self.window_size:
            self._frames.pop(0)

    @property
    def full(self) -> bool:
        return len(self._frames) >= self.window_size

    def window(self) -> KeyframeWindow:
        xy, desc, mask, R, t = (torch.stack(v) for v in zip(*self._frames))
        return KeyframeWindow(xy=xy, desc=desc, kp_mask=mask, R=R, t=t)

    def refine(self, K_cam: torch.Tensor, lowe_ratio: float = 0.8, binary: bool = False):
        """Run window BA; returns (BAState, costs, lm_mask) and writes the
        refined poses back into the window."""
        w = self.window()
        problem, X0, lm_mask = build_ba_problem(w, K_cam, lowe_ratio, binary=binary)
        state, costs = ba_solve(problem, w.R, w.t, X0, iters=self.iters)
        self._frames = [(f[0], f[1], f[2], state.R[i], state.t[i])
                        for i, f in enumerate(self._frames)]
        return state, costs, lm_mask
