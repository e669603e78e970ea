"""Batched small-matrix linear algebra — counterpart of ``ergo_uvo_tpu/geometry/linalg.py``.

:func:`jacobi_eigh` is the JAX package's cyclic Jacobi carried over literally
(7 sweeps, the same (p, q) order, the same rotation formula, a stable
ascending sort): its eigenvector sign feeds the essential matrix and the
homography refit, so ``torch.linalg.eigh`` (whose signs differ) is not a
substitute.  In eager mode each of the 252 rotations of a 9x9 solve is a few
dozen small elementwise launches, whatever the batch size.
"""

from __future__ import annotations

import torch


def jacobi_eigh(A: torch.Tensor, sweeps: int = 7):
    """Eigendecomposition of batched symmetric (..., n, n) matrices.

    Returns (eigvals (..., n) ascending, eigvecs (..., n, n) as columns).
    Works on copies: the input is not modified.
    """
    n = A.shape[-1]
    A = A.clone()
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape).clone()

    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                app = A[..., p, p]
                aqq = A[..., q, q]
                apq = A[..., p, q]
                # Jacobi rotation zeroing A[p, q]; guard the already-zero case.
                small = apq.abs() < 1e-30
                tau = (aqq - app) / torch.where(small, 1.0, 2.0 * apq)
                t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
                t = torch.where(small, 0.0, t)
                c = (1.0 / torch.sqrt(1.0 + t * t))[..., None]
                s = t[..., None] * c

                # Rows p, q of A.
                Ap = A[..., p, :].clone()
                Aq = A[..., q, :].clone()
                A[..., p, :] = c * Ap - s * Aq
                A[..., q, :] = s * Ap + c * Aq
                # Columns p, q of A.
                Ap = A[..., :, p].clone()
                Aq = A[..., :, q].clone()
                A[..., :, p] = c * Ap - s * Aq
                A[..., :, q] = s * Ap + c * Aq
                # Accumulate V (columns).
                Vp = V[..., :, p].clone()
                Vq = V[..., :, q].clone()
                V[..., :, p] = c * Vp - s * Vq
                V[..., :, q] = s * Vp + c * Vq

    eigvals = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(eigvals, dim=-1, stable=True)
    eigvals = torch.gather(eigvals, -1, order)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return eigvals, V


def smallest_eigvec(A: torch.Tensor, sweeps: int = 7) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., n, n)."""
    _, V = jacobi_eigh(A, sweeps)
    v = V[..., :, 0]
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-20)


def svd_or_nan(M: torch.Tensor):
    """``torch.linalg.svd`` that returns NaNs for a non-finite input.

    ``jnp.linalg.svd`` propagates NaN/inf into its outputs; LAPACK under
    ``torch.linalg.svd`` raises on them instead.  Zero the offending matrices,
    decompose, and poison their factors, so degenerate frames flow through the
    same masks as in the JAX package without a host sync.
    """
    finite = torch.isfinite(M).flatten(-2).all(-1)[..., None, None]
    u, s, vt = torch.linalg.svd(torch.where(finite, M, torch.zeros_like(M)))
    nan = torch.tensor(float("nan"), dtype=M.dtype, device=M.device)
    return (
        torch.where(finite, u, nan),
        torch.where(finite[..., 0], s, nan),
        torch.where(finite, vt, nan),
    )
