"""Batched closed-form P3P (Lambda-Twist style) — counterpart of ``ergo_uvo_tpu/estimation/p3p.py``.

Why P3P and not DLT: the reference's scenes are seafloor surveys — the
triangulated 3D point clouds are near-coplanar, which makes the 12-dof
projection-matrix DLT rank-deficient and its hypotheses garbage.  P3P has no
planar degeneracy (only collinear triples fail), so it is the minimal solver
for the ``solvePnPRansac`` replacement (reference call:
visual_odometry.h:647-648).

Persson & Nordberg's Lambda Twist decomposition as batched closed-form steps
(everything vectorizes over hypotheses, no per-hypothesis control flow):

  1. depth constraints  d_i^2 + d_j^2 - 2 b_ij d_i d_j = a_ij  as quadratic
     forms d^T M_ij d = a_ij;
  2. two homogeneous quadrics D1, D2 by eliminating the constants;
  3. real roots of the cubic det(D1 + g D2) = 0 (trig/Cardano closed form,
     polished by Newton steps);
  4. rank-2 pencil member factored into two planes via the batched 3x3
     Jacobi eigendecomposition (geometry/linalg.py), whose eigenvector signs
     and ascending order decide which plane is which;
  5. plane ∩ quadric -> up to 2 depth directions per plane; scale from the
     inhomogeneous constraint; positivity gate;
  6. rotation from exact triad alignment of the two 3-point frames.

All (root, plane, quadratic-branch) combinations are emitted as candidate
poses, 12 per minimal set in that order (many flagged invalid or duplicate);
RANSAC scoring over all correspondences disambiguates, and breaks ties
towards the lowest candidate index.

torch has no ``cbrt``: the Cardano branch takes ``sign(x) * |x|^(1/3)``
(geometry/linalg.py), and the two Newton steps take up the difference.
"""

from __future__ import annotations

import math

import torch

from uvo_bench.reference.geometry.linalg import cbrt, jacobi_eigh

_EPS = 1e-9


def _cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(u, v, dim=-1)


def _quad_form(u: torch.Tensor, M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u^T M v over the last axes, broadcasting the leading ones."""
    return torch.einsum("...i,...ij,...j->...", u, M, v)


def _det3_mixed(c1a, c2a, c3a, c1b, c2b, c3b):
    """Coefficients of det([c1a+g*c1b | c2a+g*c2b | c3a+g*c3b]) in g.

    Columns are (..., 3) vectors; returns (k0, k1, k2, k3) with
    det = k0 + k1 g + k2 g^2 + k3 g^3 via the triple-product expansion.
    """

    def trip(u, v, w):
        return (u * _cross(v, w)).sum(-1)

    k0 = trip(c1a, c2a, c3a)
    k1 = trip(c1b, c2a, c3a) + trip(c1a, c2b, c3a) + trip(c1a, c2a, c3b)
    k2 = trip(c1a, c2b, c3b) + trip(c1b, c2a, c3b) + trip(c1b, c2b, c3a)
    k3 = trip(c1b, c2b, c3b)
    return k0, k1, k2, k3


def _cubic_real_roots(k0, k1, k2, k3):
    """All-real-root candidates of k3 x^3 + k2 x^2 + k1 x + k0 = 0.

    Returns (roots (..., 3), valid (..., 3)).  Uses the trigonometric method
    when three real roots exist, Cardano's single real root otherwise
    (duplicated into slot 0 with slots 1-2 invalid).  Near-degenerate leading
    coefficients fall back to the quadratic/linear root in slot 0.
    """
    k3_ok = k3.abs() > 1e-12
    k3s = torch.where(k3_ok, k3, 1.0)
    a = k2 / k3s
    b = k1 / k3s
    c = k0 / k3s
    # Depressed cubic t^3 + p t + q, x = t - a/3.
    p = b - a * a / 3.0
    q = 2.0 * a * a * a / 27.0 - a * b / 3.0 + c
    shift = -a / 3.0
    disc = 4.0 * p * p * p + 27.0 * q * q  # < 0 => three distinct real roots

    # --- trigonometric branch (three real roots; needs p < 0).
    p_neg = torch.clamp(p, max=-1e-12)
    m = 2.0 * torch.sqrt(-p_neg / 3.0)
    arg = torch.clamp(3.0 * q / (p_neg * m), -1.0, 1.0)
    theta = torch.arccos(arg) / 3.0
    two_pi_3 = 2.0 * math.pi / 3.0
    trig = torch.stack(
        [
            m * torch.cos(theta),
            m * torch.cos(theta - two_pi_3),
            m * torch.cos(theta - 2.0 * two_pi_3),
        ],
        -1,
    ) + shift[..., None]

    # --- Cardano branch (one real root).
    sq = torch.sqrt(torch.clamp(disc / 108.0, min=0.0))
    u3 = -q / 2.0 + sq
    v3 = -q / 2.0 - sq
    single = cbrt(u3) + cbrt(v3) + shift

    three_real = (disc < 0.0) & (p < 0.0)
    roots = torch.where(three_real[..., None], trig, single[..., None])
    valid = torch.stack([torch.ones_like(three_real), three_real, three_real], -1)

    # --- quadratic fallback when k3 ~ 0: k2 x^2 + k1 x + k0 = 0.
    k2_ok = k2.abs() > 1e-12
    qd = k1 * k1 - 4.0 * k2 * k0
    k2s = torch.where(k2_ok, k2, 1.0)
    sqd = torch.sqrt(torch.clamp(qd, min=0.0))
    r_quad0 = (-k1 + sqd) / (2.0 * k2s)
    r_quad1 = (-k1 - sqd) / (2.0 * k2s)
    k1_ok = k1.abs() > 1e-12
    r_lin = -k0 / torch.where(k1_ok, k1, 1.0)
    fb0 = torch.where(k2_ok, r_quad0, r_lin)
    fb1 = torch.where(k2_ok, r_quad1, r_lin)
    fb_valid0 = torch.where(k2_ok, qd >= 0.0, k1_ok)
    fb = torch.stack([fb0, fb1, torch.zeros_like(fb0)], -1)
    fb_valid = torch.stack([fb_valid0, fb_valid0 & k2_ok, torch.zeros_like(k2_ok)], -1)

    roots = torch.where(k3_ok[..., None], roots, fb)
    valid = torch.where(k3_ok[..., None], valid, fb_valid)

    # Newton polish (restores f32 accuracy lost in the closed forms); a step
    # whose derivative is small divides by inf and stays where it is.
    def newton(r):
        f = ((k3[..., None] * r + k2[..., None]) * r + k1[..., None]) * r + k0[..., None]
        df = (3.0 * k3[..., None] * r + 2.0 * k2[..., None]) * r + k1[..., None]
        return r - f / torch.where(df.abs() > _EPS, df, float("inf"))

    return newton(newton(roots)), valid


def _homogeneous_quadratic_pairs(A, B, C):
    """(alpha, beta) solutions of A a^2 + 2 B a b + C b^2 = 0.

    Returns ((..., 2, 2) pairs, (..., 2) valid).  Branchless: uses the
    (-B ± sqrt(B²-AC), A) parameterization, with the A≈0 special case
    ((1, 0) and (-C, 2B)) selected by mask.
    """
    disc = B * B - A * C
    s = torch.sqrt(torch.clamp(disc, min=0.0))
    a_ok = A.abs() > _EPS
    sol0 = torch.stack([-B + s, A], -1)
    sol1 = torch.stack([-B - s, A], -1)
    alt0 = torch.stack([torch.ones_like(A), torch.zeros_like(A)], -1)
    alt1 = torch.stack([-C, 2.0 * B], -1)
    p0 = torch.where(a_ok[..., None], sol0, alt0)
    p1 = torch.where(a_ok[..., None], sol1, alt1)
    v0 = torch.where(a_ok, disc >= 0.0, torch.ones_like(a_ok))
    v1 = torch.where(a_ok, disc >= 0.0, B.abs() > _EPS)
    return torch.stack([p0, p1], -2), torch.stack([v0, v1], -1)


def _triad(P):
    """Orthonormal frame (..., 3, 3) from three points (..., 3, 3) + validity.

    Columns: f1 along P2-P1, f2 the orthogonal part of P3-P1, f3 = f1 x f2.
    """
    e1 = P[..., 1, :] - P[..., 0, :]
    e2 = P[..., 2, :] - P[..., 0, :]
    n1 = torch.linalg.vector_norm(e1, dim=-1, keepdim=True)
    f1 = e1 / torch.clamp(n1, min=_EPS)
    g = e2 - (e2 * f1).sum(-1, keepdim=True) * f1
    n2 = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    f2 = g / torch.clamp(n2, min=_EPS)
    f3 = _cross(f1, f2)
    ok = (n1[..., 0] > _EPS) & (n2[..., 0] > 1e-6)
    return torch.stack([f1, f2, f3], -1), ok


def p3p(X: torch.Tensor, y: torch.Tensor):
    """Batched P3P: world triples + unit bearings -> candidate poses.

    Args:
      X: (..., 3, 3) world points (rows).
      y: (..., 3, 3) unit bearing vectors in the camera frame (rows),
         y_i ∝ (x_n, y_n, 1) normalized.

    Returns (R, t, valid): (..., 12, 3, 3), (..., 12, 3), (..., 12) —
    candidates over 3 cubic roots × 2 planes × 2 quadratic branches, with
    x_cam = R @ X + t (OpenCV rvec/tvec convention).
    """
    b12 = (y[..., 0, :] * y[..., 1, :]).sum(-1)
    b13 = (y[..., 0, :] * y[..., 2, :]).sum(-1)
    b23 = (y[..., 1, :] * y[..., 2, :]).sum(-1)
    a12 = ((X[..., 0, :] - X[..., 1, :]) ** 2).sum(-1)
    a13 = ((X[..., 0, :] - X[..., 2, :]) ** 2).sum(-1)
    a23 = ((X[..., 1, :] - X[..., 2, :]) ** 2).sum(-1)

    z = torch.zeros_like(b12)
    o = torch.ones_like(b12)

    def sym(m11, m22, m33, m12, m13, m23):
        r1 = torch.stack([m11, m12, m13], -1)
        r2 = torch.stack([m12, m22, m23], -1)
        r3 = torch.stack([m13, m23, m33], -1)
        return torch.stack([r1, r2, r3], -2)

    M12 = sym(o, o, z, -b12, z, z)
    M13 = sym(o, z, o, z, -b13, z)
    M23 = sym(z, o, o, z, z, -b23)

    # Homogeneous quadrics: d^T D d = 0.
    D1 = M12 * a13[..., None, None] - M13 * a12[..., None, None]
    D2 = M23 * a13[..., None, None] - M13 * a23[..., None, None]

    k0, k1, k2, k3 = _det3_mixed(
        D1[..., :, 0], D1[..., :, 1], D1[..., :, 2],
        D2[..., :, 0], D2[..., :, 1], D2[..., :, 2],
    )
    roots, roots_valid = _cubic_real_roots(k0, k1, k2, k3)  # (..., 3)

    # Pencil member per root: (..., 3, 3, 3)  [root axis inserted at -3].
    D0 = D1[..., None, :, :] + roots[..., None, None] * D2[..., None, :, :]
    evals, evecs = jacobi_eigh(D0)  # ascending eigenvalues
    lam_min = evals[..., 0]
    lam_mid = evals[..., 1]
    lam_max = evals[..., 2]
    sig_ok = (lam_max > _EPS) & (lam_min < -_EPS)
    # Rank-2 check: the middle eigenvalue must be the small one.
    rank_ok = lam_mid.abs() <= 0.1 * torch.maximum(lam_max, -lam_min)
    e_min = evecs[..., :, 0]
    e_mid = evecs[..., :, 1]
    e_max = evecs[..., :, 2]
    sp = torch.sqrt(torch.clamp(lam_max, min=0.0))[..., None]
    sn = torch.sqrt(torch.clamp(-lam_min, min=0.0))[..., None]
    # Two factor planes through the origin; e_mid lies in both.
    normals = torch.stack([sp * e_max + sn * e_min, sp * e_max - sn * e_min], -2)
    nrm = torch.linalg.vector_norm(normals, dim=-1, keepdim=True)
    n_hat = normals / torch.clamp(nrm, min=_EPS)  # (..., 3, 2, 3)

    u = e_mid[..., None, :].expand(n_hat.shape)  # in-plane basis 1
    w = _cross(n_hat, u)  # in-plane basis 2

    # Intersect each plane with quadric D2 (homogeneous in alpha, beta).
    D2b = D2[..., None, None, :, :]
    A = _quad_form(u, D2b, u)
    Bq = _quad_form(u, D2b, w)
    C = _quad_form(w, D2b, w)
    ab, ab_valid = _homogeneous_quadratic_pairs(A, Bq, C)  # (..., 3, 2, 2, 2)

    v = ab[..., 0:1] * u[..., None, :] + ab[..., 1:2] * w[..., None, :]
    v_nrm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    v = v / torch.clamp(v_nrm, min=_EPS)  # (..., 3, 2, 2, 3) depth directions

    # Scale from d^T M12 d = a12; positivity gate on all depths.
    M12b = M12[..., None, None, None, :, :]
    qf = _quad_form(v, M12b, v)
    q_ok = qf > _EPS
    s = torch.sqrt(a12[..., None, None, None] / torch.where(q_ok, qf, 1.0))
    d = s[..., None] * v
    d = d * torch.sign(d.sum(-1, keepdim=True))  # orient positive; sign(0) = 0
    d_ok = (d > _EPS).all(-1)

    # Flatten candidates: 3 roots × 2 planes × 2 branches -> 12.
    batch = X.shape[:-2]
    d = d.reshape(*batch, 12, 3)
    valid = (
        (roots_valid & sig_ok & rank_ok)[..., :, None, None]
        & ab_valid
        & q_ok
        & d_ok
    ).reshape(*batch, 12)

    # Camera-frame points and exact triad alignment.
    Z = d[..., None] * y[..., None, :, :]  # (..., 12, 3, 3)
    Xb = X[..., None, :, :].expand(Z.shape)
    Fz, okz = _triad(Z)
    Fx, okx = _triad(Xb)
    R = Fz @ Fx.transpose(-1, -2)
    cx = Xb.mean(-2)
    cz = Z.mean(-2)
    t = cz - torch.einsum("...ij,...j->...i", R, cx)
    valid = valid & okz & okx
    return R, t, valid
