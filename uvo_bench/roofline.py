"""Peaks of the card and the least time a kernel's call could take on it.

The peaks are NVIDIA's published figures for one H100 SXM at its full 700 W
(dense, without sparsity); a run prints the card's power limit beside them.
A call's bound is the larger of its operations over the peak rate and its
bytes over the memory bandwidth, each input byte read once and each output
byte written once; the operations are those that these inputs need.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3


def bound_seconds(operations: float, nbytes: float) -> float:
    return max(operations / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def top2_distances_bound(q: int, t: int, d: int, valid: int) -> float:
    """``top2_distances.cu`` on (Q, D) queries against (T, D) train rows of which
    ``valid`` are valid: 2 Q V D operations (a masked row is skipped, not
    scored); the queries, the valid rows and the mask read once, three
    outputs a query written once."""
    return bound_seconds(2.0 * q * valid * d, 4.0 * (q + valid) * d + t + 12.0 * q)


def jacobi_eigh_bound(batch: int, n: int, sweeps: int) -> float:
    """``jacobi_eigh.cu`` on ``batch`` symmetric n x n matrices: per rotation
    18 n + 15 operations (rows, columns and V: 6 n each; the rotation's
    scalars: 15), n (n - 1) / 2 rotations a sweep; each matrix read once, n
    eigenvalues and n^2 eigenvector entries written once."""
    ops = batch * sweeps * n * (n - 1) // 2 * (18 * n + 15)
    return bound_seconds(ops, 4.0 * batch * (2 * n * n + n))
