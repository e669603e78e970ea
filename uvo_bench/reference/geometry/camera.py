"""Pinhole camera with radial-tangential distortion — counterpart of ``ergo_uvo_tpu/geometry/camera.py``.

The reference's camera handling: K from fx, fy, ccx, ccy
(visual_odometry.h:187-188), the 4-coefficient distortion (k1, k2, p1, p2)
of ``get_mono_camera_parameters`` (VO_utility.cpp:387-400), K rescaling on
resize (``resize_camera_matrix``, VO_utility.cpp:658-675), P = K [R|t]
(``compute_projection_matrix``, VO_utility.cpp:9-15) and the projection of
``reproject_errors`` (VO_utility.cpp:632-651, zero distortion there).
Full-image undistortion is ``uvo_bench.reference.image``'s; this module holds
the point-wise model.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PinholeCamera(NamedTuple):
    """Intrinsics and distortion, every entry a 0-d tensor."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, dtype=torch.float32,
               device=None):
        return PinholeCamera(
            *(torch.as_tensor(v, dtype=dtype, device=device) for v in (fx, fy, cx, cy, k1, k2, p1, p2))
        )

    @property
    def K(self) -> torch.Tensor:
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack([
            torch.stack([self.fx, z, self.cx], -1),
            torch.stack([z, self.fy, self.cy], -1),
            torch.stack([z, z, o], -1),
        ], -2)

    def with_zero_distortion(self) -> "PinholeCamera":
        z = torch.zeros_like(self.fx)
        return PinholeCamera(self.fx, self.fy, self.cx, self.cy, z, z, z, z)


def distort_normalized(cam: PinholeCamera, xy: torch.Tensor) -> torch.Tensor:
    """Radial-tangential distortion of normalized coordinates (..., 2), OpenCV's model:
    x' = x (1 + k1 r² + k2 r⁴) + 2 p1 x y + p2 (r² + 2 x²)."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xd, yd], -1)


def undistort_normalized(cam: PinholeCamera, xy_dist: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Invert the distortion by ``iters`` fixed-point steps (cv::undistortPoints' scheme)."""
    xy = xy_dist
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2
        dx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
        xy = torch.stack([(xy_dist[..., 0] - dx) / radial, (xy_dist[..., 1] - dy) / radial], -1)
    return xy


def pixel_to_normalized(cam: PinholeCamera, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> the normalized image plane (no undistortion)."""
    return torch.stack([(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], -1)


def normalized_to_pixel(cam: PinholeCamera, xy: torch.Tensor) -> torch.Tensor:
    return torch.stack([xy[..., 0] * cam.fx + cam.cx, xy[..., 1] * cam.fy + cam.cy], -1)


def project_points(
    cam: PinholeCamera,
    points_cam: torch.Tensor,
    eps: float = 1e-9,
    with_distortion: bool = False,
) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixels (..., 2); without distortion by
    default, as ``reproject_errors`` (VO_utility.cpp:640) on undistorted images."""
    z = points_cam[..., 2]
    safe_z = torch.where(z.abs() < eps, torch.where(z < 0, -eps, eps), z)
    xy = points_cam[..., :2] / safe_z[..., None]
    if with_distortion:
        xy = distort_normalized(cam, xy)
    return normalized_to_pixel(cam, xy)


def projection_matrix(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """P = K [R | t], shape (..., 3, 4) (VO_utility.cpp:9-15)."""
    return K @ torch.cat([R, t[..., None]], dim=-1)


def resize_camera_matrix(K: torch.Tensor, orig_width, desired_width) -> torch.Tensor:
    """K for a resize to ``desired_width``, as the reference (VO_utility.cpp:658-671):
    the whole K divided by the width ratio, then the skew entry and K[2,2] = 1
    restored."""
    K2 = K / (orig_width / desired_width)
    K2[..., 0, 1] = K[..., 0, 1]
    K2[..., 2, 2] = 1.0
    return K2


def resized_height(orig_width: int, orig_height: int, desired_width: int) -> int:
    """Height of a width-preserving resize, truncated as the reference."""
    return int(orig_height / (orig_width / desired_width))
