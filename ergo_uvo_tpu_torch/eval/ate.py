"""ATE / RPE trajectory metrics + trajectory integration from VO outputs.

A numpy copy of ``ergo_uvo_tpu/eval/ate.py`` (whose package imports JAX).
NumPy host-side tooling (evaluation is not a hot path).  ATE follows the
standard TUM-benchmark definition: RMSE of position residuals after an
(optionally scaled) Umeyama alignment; RPE is the RMSE of relative-pose
translation errors over a fixed frame delta.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst: (s, R, t)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    est_positions: np.ndarray,
    gt_positions: np.ndarray,
    align: bool = True,
    with_scale: bool = False,
) -> float:
    """Absolute trajectory error (RMSE, meters)."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    if align:
        s, R, t = umeyama_alignment(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    return float(np.sqrt(((est - gt) ** 2).sum(-1).mean()))


def rpe_rmse(est_positions, gt_positions, delta: int = 1) -> float:
    """Relative pose error on translation over `delta`-frame steps."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    de = est[delta:] - est[:-delta]
    dg = gt[delta:] - gt[:-delta]
    return float(np.sqrt(((de - dg) ** 2).sum(-1).mean()))


def velocity_rmse(est_vel, gt_vel, valid=None) -> float:
    est = np.asarray(est_vel, np.float64)
    gt = np.asarray(gt_vel, np.float64)
    if valid is not None:
        valid = np.asarray(valid, bool)
        est, gt = est[valid], gt[valid]
    if len(est) == 0:
        return float("inf")
    return float(np.sqrt(((est - gt) ** 2).sum(-1).mean()))


def integrate_mono_poses(velocities, rotations_rel, timestamps, published):
    """Integrate per-frame VO outputs into absolute world->cam poses.

    The mono output velocity is the camera displacement in
    the PREVIOUS camera frame / dt (mono_output_computation,
    visual_odometry.h:126-140) and R_rel maps prev-cam -> curr-cam coords;
    stereo publishes the same convention (:148-159).  Orientation composes as
    R_wc[k] = R_rel[k] @ R_wc[k-1]; unpublished frames hold the pose.

    Vectorized: dt-scaled displacements once, then one Python pass for the
    sequential rotation chain with all per-frame O(1) work precomputed.
    Returns (R_wc (n,3,3), t_wc (n,3), positions (n,3)) with
    x_cam = R_wc @ (X - C), i.e. t_wc = -R_wc @ C.
    """
    velocities = np.asarray(velocities, np.float64)
    rotations_rel = np.asarray(rotations_rel, np.float64)
    timestamps = np.asarray(timestamps, np.float64)
    published = np.asarray(published, bool)
    n = len(velocities)
    dts = np.empty(n)
    dts[0] = 0.0
    dts[1:] = np.diff(timestamps)
    disp = velocities * dts[:, None] * published[:, None]  # prev-cam frame
    R_wc = np.empty((n, 3, 3))
    pos = np.empty((n, 3))
    R = np.eye(3)
    p = np.zeros(3)
    for k in range(n):
        if published[k]:
            p = p + R.T @ disp[k]
            R = rotations_rel[k] @ R
        R_wc[k] = R
        pos[k] = p
    t_wc = -np.einsum("nij,nj->ni", R_wc, pos)
    return R_wc, t_wc, pos


def integrate_mono_trajectory(
    velocities: np.ndarray,
    rotations_rel: np.ndarray,
    timestamps: np.ndarray,
    published: np.ndarray,
    validity: np.ndarray | None = None,
):
    """Positions from :func:`integrate_mono_poses` (shared semantics).

    Invalid frames still integrate — the reference's constant-motion
    semantics (stale pose + stale SF, visual_odometry.h:342-344).  With
    `validity` given, also returns `dead_reckoned (n,) bool` marking frames
    integrated under constant-motion hold.
    """
    _, _, pos = integrate_mono_poses(
        velocities, rotations_rel, timestamps, published
    )
    if validity is not None:
        dead = np.asarray(published, bool) & ~np.asarray(validity, bool)
        return pos, dead
    return pos
