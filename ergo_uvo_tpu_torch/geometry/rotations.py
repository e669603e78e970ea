"""SO(3) rotations, Euler angles, quaternions — counterpart of ``ergo_uvo_tpu/geometry/rotations.py``.

The reference's rotation helpers (``uvo_libraries/src/math_utility.cpp``:
rotx/roty/rotz :343-368, Euler/quaternion conversions :119-215, skew
:94-111, isRotationMatrix :245-254, wrap2pi :222-228).  Every function works
on the trailing dimensions, so leading dimensions batch.
"""

from __future__ import annotations

import math

import torch

from ergo_uvo_tpu_torch.geometry.linalg import svd_or_nan


def _rows(*rows) -> torch.Tensor:
    """A (..., 3, 3) matrix from three rows of three (...) tensors."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rotx(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about the x axis (math_utility.cpp:343-350)."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _rows((o, z, z), (z, c, -s), (z, s, c))


def roty(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about the y axis (math_utility.cpp:352-359)."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _rows((c, z, s), (z, o, z), (-s, z, c))


def rotz(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about the z axis (math_utility.cpp:361-368)."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _rows((c, -s, z), (s, c, z), (z, z, o))


def euler_to_rotation(rpy: torch.Tensor) -> torch.Tensor:
    """ZYX (roll, pitch, yaw) -> R = Rz(yaw) Ry(pitch) Rx(roll) (math_utility.cpp:119-131)."""
    return rotz(rpy[..., 2]) @ roty(rpy[..., 1]) @ rotx(rpy[..., 0])


def rotation_to_euler(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> ZYX (roll, pitch, yaw) with the reference's
    gimbal-lock branch (math_utility.cpp:181-205): when cos(pitch) ~ 0 the
    yaw is 0 and the roll takes the rest of the rotation."""
    sy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    roll = torch.where(
        singular,
        torch.atan2(-R[..., 1, 2], R[..., 1, 1]),
        torch.atan2(R[..., 2, 1], R[..., 2, 2]),
    )
    pitch = torch.atan2(-R[..., 2, 0], sy)
    yaw = torch.where(singular, torch.zeros_like(sy), torch.atan2(R[..., 1, 0], R[..., 0, 0]))
    return torch.stack([roll, pitch, yaw], -1)


def euler_to_quaternion(rpy: torch.Tensor) -> torch.Tensor:
    """ZYX Euler -> quaternion (w, x, y, z) (math_utility.cpp:207-215)."""
    half = rpy * 0.5
    cr, cp, cy = torch.cos(half[..., 0]), torch.cos(half[..., 1]), torch.cos(half[..., 2])
    sr, sp, sy = torch.sin(half[..., 0]), torch.sin(half[..., 1]), torch.sin(half[..., 2])
    w = cr * cp * cy + sr * sp * sy
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    return torch.stack([w, x, y, z], -1)


def quaternion_to_rotation(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z), normalized first -> rotation matrix."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return _rows(
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )


def rotation_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (w, x, y, z) with w >= 0, Shepperd-style:
    all four candidates, the one with the largest pivot kept by a gather
    (first on ties, as ``jnp.argmax``)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qs = torch.stack([
        torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], -1),
    ], -2)
    best = torch.argmax(torch.stack([tr, m00, m11, m22], -1), dim=-1)
    q = torch.gather(qs, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def skew(v: torch.Tensor) -> torch.Tensor:
    """3-vector -> skew-symmetric matrix (math_utility.cpp:94-103)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return _rows((zero, -z, y), (z, zero, -x), (-y, x, zero))


def is_rotation_matrix(R: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    """||R^T R - I|| < tol (math_utility.cpp:245-254)."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    err = torch.linalg.vector_norm((R.transpose(-1, -2) @ R - eye).flatten(-2), dim=-1)
    return err < tol


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


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map SO(3) -> so(3) (axis-angle vector), guarded at 0 and pi.

    Below 1e-4 rad the Taylor scale 1/2 + theta^2/12; above pi - 1e-3 the
    axis from the diagonal, its signs from the off-diagonal symmetric part
    (a zero counts as +), as the JAX package.
    """
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.acos(cos_theta)
    v = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        -1,
    )
    small = theta < 1e-4
    near_pi = theta > math.pi - 1e-3
    scale = torch.where(
        small, 0.5 + theta**2 / 12.0, theta / torch.clamp(2.0 * torch.sin(theta), min=1e-12)
    )
    w_generic = scale[..., None] * v
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    c = cos_theta[..., None]
    axis = torch.sqrt(torch.clamp((diag - c) / (1.0 - c + 1e-12), min=0.0))

    def sign_or_plus(x):
        return torch.sign(torch.where(x.abs() > 1e-9, x, 1.0))

    s0 = sign_or_plus(v[..., 0])
    sxy = sign_or_plus(R[..., 1, 0] + R[..., 0, 1])
    sxz = sign_or_plus(R[..., 2, 0] + R[..., 0, 2])
    axis = axis * torch.stack([s0, s0 * sxy, s0 * sxz], -1)
    return torch.where(near_pi[..., None], theta[..., None] * axis, w_generic)


def rpy_rate_jacobian(rpy: torch.Tensor) -> torch.Tensor:
    """Body angular velocity -> (roll, pitch, yaw) rates (math_utility.cpp:25-28);
    singular at pitch = +-pi/2, as the reference."""
    r, p = rpy[..., 0], rpy[..., 1]
    sr, cr = torch.sin(r), torch.cos(r)
    tp, cp = torch.tan(p), torch.cos(p)
    zero, one = torch.zeros_like(r), torch.ones_like(r)
    return _rows((one, sr * tp, cr * tp), (zero, cr, -sr), (zero, sr / cp, cr / cp))


def wrap2pi(angle: torch.Tensor) -> torch.Tensor:
    """Wrap into [-pi, pi] with both ends fixed points: the closed form of the
    reference's subtract/add-2pi loops (math_utility.cpp:222-228)."""
    two_pi = 2.0 * math.pi
    over = angle - two_pi * torch.ceil((angle - math.pi) / two_pi)
    under = angle + two_pi * torch.ceil((-angle - math.pi) / two_pi)
    return torch.where(angle > math.pi, over, torch.where(angle < -math.pi, under, angle))
