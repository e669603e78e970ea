"""Batched small-matrix linear algebra — counterpart of ``ergo_uvo_tpu/geometry/linalg.py``.

:func:`jacobi_eigh` is the JAX package's cyclic Jacobi (7 sweeps, the same
(p, q) order, the same rotation formula, a stable ascending sort): its
eigenvector sign feeds the essential matrix and the homography refit, so
``torch.linalg.eigh`` (whose signs differ) is not a substitute.  It dispatches
on the tensor's device:

* a CUDA tensor launches ``csrc/jacobi_eigh.cu``, one launch a solve, at
  n = 3, 9 and 12 in float32 (a group of 16 lanes a 9x9 or 12x12 matrix, a
  thread a 3x3 one); any other CUDA input raises, and nothing falls back;
* a CPU tensor takes :func:`jacobi_eigh_reference`, the plain PyTorch version,
  which the CPU tests hold to JAX and ``chip_smoke.py`` holds the kernel to,
  bit for bit, on the card.  Eager, each of a 9x9 solve's 252 rotations is
  about 50 elementwise launches, whatever the batch size.

The counter ``jacobi_eigh.launches`` of :mod:`ergo_uvo_tpu_torch.utils.profiling`
counts kernel launches, so a run can show that its solves went through the
kernel.

:func:`inv33` and :func:`polar_so3` are the closed-form 3x3 inverse and the
Newton polar projection onto SO(3) that the PnP solver's DLT uses.
"""

from __future__ import annotations

import ctypes

import torch

from ergo_uvo_tpu_torch.cuda_build import load_library
from ergo_uvo_tpu_torch.utils.profiling import count
KERNEL_SIZES = (3, 9, 12)  # the n the kernel is built for


def jacobi_eigh_reference(A: torch.Tensor, sweeps: int = 7):
    """Eigendecomposition of batched symmetric (..., n, n) matrices, plain PyTorch.

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


_C_INT = ctypes.c_int
_C_PTR = ctypes.c_void_p


def _library() -> ctypes.CDLL:
    """The built kernel library; the argument types are set when it is loaded."""
    lib = load_library("jacobi_eigh")
    if lib.jacobi_eigh_launch.argtypes is None:
        lib.jacobi_eigh_launch.argtypes = [_C_PTR] * 3 + [_C_INT] * 3 + [_C_PTR]
        lib.jacobi_eigh_launch.restype = _C_INT
    return lib


def _launch(A: torch.Tensor, sweeps: int):
    """One launch for the whole batch; leading dimensions are flattened."""
    if A.dtype != torch.float32:
        raise TypeError(f"jacobi_eigh: the kernel takes float32, got {A.dtype}")
    if A.ndim < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"jacobi_eigh: expected (..., n, n), got {tuple(A.shape)}")
    n = A.shape[-1]
    if n not in KERNEL_SIZES:
        raise ValueError(f"jacobi_eigh: the kernel is built for n in {KERNEL_SIZES}, got {n}")
    if sweeps < 0:
        raise ValueError(f"jacobi_eigh: sweeps must be >= 0, got {sweeps}")
    a = A.reshape(-1, n, n).contiguous()
    batch = a.shape[0]
    evals = torch.empty(*A.shape[:-1], dtype=A.dtype, device=A.device)
    evecs = torch.empty(A.shape, dtype=A.dtype, device=A.device)
    if batch == 0:
        return evals, evecs
    lib = _library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.jacobi_eigh_launch(a.data_ptr(), evals.data_ptr(), evecs.data_ptr(),
                                     batch, n, sweeps, stream)
    if err != 0:
        raise RuntimeError(f"jacobi_eigh kernel launch failed: cudaError {err}")
    count("jacobi_eigh.launches")
    return evals, evecs


def jacobi_eigh(A: torch.Tensor, sweeps: int = 7):
    """Eigendecomposition of batched symmetric (..., n, n) matrices.

    Returns (eigvals (..., n) ascending, eigvecs (..., n, n) as columns); the
    input is not modified.  See the module doc for the dispatch.
    """
    if A.is_cuda:
        return _launch(A, sweeps)
    if A.device.type == "cpu":
        return jacobi_eigh_reference(A, sweeps)
    raise ValueError(f"jacobi_eigh: no implementation for device {A.device}")


def smallest_eigvec(A: torch.Tensor, sweeps: int = 7) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., n, n)."""
    _, V = jacobi_eigh(A, sweeps)
    v = V[..., :, 0]
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-20)


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root, ``sign(x) * |x|^(1/3)`` (torch has no ``cbrt``)."""
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def inv33(A: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Closed-form batched 3x3 inverse via the adjugate."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    adj = torch.stack(
        [
            torch.stack([c00, c10, c20], -1),
            torch.stack([c01, c11, c21], -1),
            torch.stack([c02, c12, c22], -1),
        ],
        -2,
    )
    safe = torch.where(det.abs() < eps, torch.where(det < 0, -eps, eps), det)
    return adj / safe[..., None, None]


def polar_so3(M: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Project batched near-rotations (..., 3, 3) onto SO(3).

    Newton iteration for the polar factor, X <- (X + X^-T)/2, from a
    Frobenius-normalized start, then a determinant sign fix on the last
    column (exact when M was a reflection of a rotation).  Converges
    quadratically for any nonsingular M.
    """
    scale = torch.sqrt(torch.clamp((M * M).sum(dim=(-2, -1), keepdim=True) / 3.0, min=1e-20))
    X = M / scale
    for _ in range(iters):
        X = 0.5 * (X + inv33(X).transpose(-1, -2))
    d = torch.sign(torch.linalg.det(X))
    fix = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    return X * fix[..., None, :]


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
