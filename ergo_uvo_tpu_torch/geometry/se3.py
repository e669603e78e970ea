"""SE(3) rigid transforms with exp/log maps — counterpart of ``ergo_uvo_tpu/geometry/se3.py``.

The reference carries (R, t) pairs as loose ``cv::Mat`` variables
(``visual_odometry.h:209-215``, ``transform_coordinates``
math_utility.cpp:376-379); here a transform is a :class:`SE3` tuple of
tensors, batchable on leading dimensions, which the pose graph optimizes on
the manifold.  Twists are ordered xi = (rho, w): translation generator first.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ergo_uvo_tpu_torch.geometry.rotations import skew, so3_exp, so3_log


class SE3(NamedTuple):
    """Rigid transform x_out = R @ x + t."""

    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "SE3":
        R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
        return SE3(R, torch.zeros((*batch_shape, 3), dtype=dtype, device=device))

    def compose(self, other: "SE3") -> "SE3":
        """self ∘ other: apply ``other`` first, then ``self``."""
        return SE3(self.R @ other.R, (self.R @ other.t[..., None])[..., 0] + self.t)

    def inverse(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(Rt, -(Rt @ self.t[..., None])[..., 0])

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Transform points of shape (..., N, 3) or (..., 3)."""
        if points.shape[-1] != 3:
            raise ValueError(f"points must have trailing dim 3, got {tuple(points.shape)}")
        if points.ndim >= 2 and self.R.ndim == points.ndim + 1:
            return points @ self.R.transpose(-1, -2) + self.t[..., None, :]
        return (self.R @ points[..., None])[..., 0] + self.t

    def matrix(self) -> torch.Tensor:
        """(..., 4, 4) homogeneous matrix."""
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=self.R.dtype, device=self.R.device)
        bottom = bottom.expand(*self.R.shape[:-2], 1, 4)
        return torch.cat([torch.cat([self.R, self.t[..., None]], -1), bottom], -2)


def se3_exp(xi: torch.Tensor) -> SE3:
    """Exponential map se(3) -> SE(3) of xi = (rho, w), Taylor-guarded near 0."""
    rho, w = xi[..., :3], xi[..., 3:]
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-12
    R = so3_exp(w)
    K = skew(w)
    a = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    b = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta)
    )
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(R.shape)
    V = eye + a[..., None, None] * K + b[..., None, None] * (K @ K)
    return SE3(R, (V @ rho[..., None])[..., 0])


def se3_log(T: SE3) -> torch.Tensor:
    """Logarithm map SE(3) -> se(3) = (rho, w).

    V^-1 = I - K/2 + c K^2 with c = (1 - (theta/2) cot(theta/2)) / theta^2,
    and its Taylor value 1/12 + theta^2/720 below theta^2 = 1e-12.
    """
    w = so3_log(T.R)
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-12
    K = skew(w)
    half_theta = 0.5 * theta
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_theta * torch.cos(half_theta) / torch.sin(half_theta))
        / torch.clamp(theta2, min=1e-24),
    )
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    Vinv = eye - 0.5 * K + cot_term[..., None, None] * (K @ K)
    return torch.cat([(Vinv @ T.t[..., None])[..., 0], w], -1)
