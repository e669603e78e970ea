"""SO(3) helpers of the main path — counterpart of ``ergo_uvo_tpu/geometry/rotations.py``.

Only the functions the mono slice calls are ported: ``skew``, ``so3_exp`` and
``project_to_so3``.
"""

from __future__ import annotations

import torch

from ergo_uvo_tpu_torch.geometry.linalg import svd_or_nan


def skew(v: torch.Tensor) -> torch.Tensor:
    """3-vector -> skew-symmetric matrix (math_utility.cpp:94-103)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )


def project_to_so3(R: torch.Tensor) -> torch.Tensor:
    """Project an almost-rotation onto SO(3) via SVD: U @ Vt with a det fix."""
    u, _, vt = svd_or_nan(R)
    d = torch.linalg.det(u @ vt)
    one = torch.ones_like(d)
    fix = torch.stack([one, one, d], -1)
    return (u * fix[..., None, :]) @ vt


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map so(3) -> SO(3), Taylor-guarded near 0."""
    # keepdim: under torch.func.jacfwd, scalar arithmetic on a 0-d dual
    # tensor yields a float64 tangent (torch 2.13); a (..., 1) shape does not.
    theta2 = (w * w).sum(-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    K = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None] * K + b[..., None] * (K @ K)
