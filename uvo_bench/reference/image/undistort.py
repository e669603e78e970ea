"""Undistortion plan: optimal new camera (alpha=0) + inverse-distortion grid.

Host-side, init-time equivalents of the reference's camera finalization
(``resize_camera_matrix`` → ``getOptimalNewCameraMatrix(alpha=0)``
VO_utility.cpp:658-675) and of ``cv::undistort``'s internal remap
(VO_utility.cpp:360-366).  The per-frame work — a bilinear gather through the
precomputed grid — lives in :mod:`uvo_bench.reference.image.preprocess` and runs
on the device.

A copy of ``ergo_uvo_tpu/image/undistort.py``: the original is numpy too, but
importing it runs the JAX package's ``__init__``, which imports JAX.

Everything here is NumPy float64 on purpose: it runs once at startup, and the
grid quality bounds feature-position accuracy (SURVEY.md §7.3 last bullet).
"""

from __future__ import annotations

import numpy as np


def _undistort_points_np(
    pts: np.ndarray, K: np.ndarray, dist: np.ndarray, iters: int = 20
) -> np.ndarray:
    """Pixel points -> normalized undistorted coords (fixed-point iteration).

    NumPy mirror of cv::undistortPoints for the 4-coeff (k1,k2,p1,p2) model.
    """
    k1, k2, p1, p2 = dist[:4]
    x = (pts[:, 0] - K[0, 2]) / K[0, 0]
    y = (pts[:, 1] - K[1, 2]) / K[1, 1]
    x0, y0 = x.copy(), y.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    return np.stack([x, y], -1)


def _distort_normalized_np(xy: np.ndarray, dist: np.ndarray) -> np.ndarray:
    k1, k2, p1, p2 = dist[:4]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.stack([xd, yd], -1)


def optimal_new_camera(
    K: np.ndarray,
    dist: np.ndarray,
    width: int,
    height: int,
    grid_n: int = 9,
) -> np.ndarray:
    """``getOptimalNewCameraMatrix(alpha=0, newImgSize=imgSize)`` re-derivation.

    OpenCV's algorithm (calibration.cpp `icvGetRectangles`): undistort a
    `grid_n` x `grid_n` grid of border-inclusive pixel points to normalized
    coords; the *inner* rectangle is bounded by the extreme first/last
    row/column points; alpha=0 maps that inner rectangle to the full viewport
    with independent fx, fy.
    """
    xs = np.linspace(0, width - 1, grid_n)
    ys = np.linspace(0, height - 1, grid_n)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], -1)
    und = _undistort_points_np(pts, K, dist).reshape(grid_n, grid_n, 2)

    inner_x0 = und[:, 0, 0].max()
    inner_x1 = und[:, -1, 0].min()
    inner_y0 = und[0, :, 1].max()
    inner_y1 = und[-1, :, 1].min()

    fx = (width - 1) / (inner_x1 - inner_x0)
    fy = (height - 1) / (inner_y1 - inner_y0)
    cx = -fx * inner_x0
    cy = -fy * inner_y0
    return np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], np.float64)


def build_undistort_grid(
    K: np.ndarray,
    dist: np.ndarray,
    new_K: np.ndarray,
    width: int,
    height: int,
) -> np.ndarray:
    """(H, W, 2) source-pixel sampling grid for undistortion via remap.

    For each output pixel: new-K back-projection -> forward distortion ->
    original-K projection — exactly cv::initUndistortRectifyMap's map (with
    identity rectification), consumed by the device-side bilinear gather.
    Returned as float32 (x, y) source coordinates.
    """
    xs = np.arange(width, dtype=np.float64)
    ys = np.arange(height, dtype=np.float64)
    gx, gy = np.meshgrid(xs, ys)
    xn = (gx - new_K[0, 2]) / new_K[0, 0]
    yn = (gy - new_K[1, 2]) / new_K[1, 1]
    xyd = _distort_normalized_np(np.stack([xn, yn], -1), np.asarray(dist, np.float64))
    src_x = xyd[..., 0] * K[0, 0] + K[0, 2]
    src_y = xyd[..., 1] * K[1, 1] + K[1, 2]
    return np.stack([src_x, src_y], -1).astype(np.float32)
