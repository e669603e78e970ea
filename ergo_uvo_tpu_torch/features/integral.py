"""Integral images — counterpart of ``ergo_uvo_tpu/features/integral.py``.

The sums stay float32, as the reference computes them.  At 640x480 the table
reaches ~7.8e7, where one float32 ulp is 8, so the order of the additions
shows in the last bits, and a near-tie in the detector's 3x3x3 NMS can flip
on them.  The JAX package's ``jnp.cumsum`` runs on the CPU as XLA's blocked
scan: prefix sums inside blocks of 16, the block totals scanned the same way
recursively, then added back.  :func:`_blocked_cumsum` takes that order with
float32 accumulators, so the port's table equals the reference's bit for bit,
on the CPU and on the card alike (elementwise adds round the same way there).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_SCAN_BLOCK = 16


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right float32 prefix sum along the last (short) axis.

    ``torch.cumsum`` on the CPU accumulates float32 in float64, which is not
    the reference's rounding.
    """
    acc = x[..., 0]
    out = [acc]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
        out.append(acc)
    return torch.stack(out, dim=-1)


def _blocked_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sum along ``dim`` in XLA's blocked-scan order."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        out = _sequential_cumsum(x)
    else:
        m = -(-n // _SCAN_BLOCK)
        blocks = F.pad(x, (0, m * _SCAN_BLOCK - n)).reshape(*x.shape[:-1], m, _SCAN_BLOCK)
        local = _sequential_cumsum(blocks)
        carried = _blocked_cumsum(local[..., -1], -1)
        exclusive = F.pad(carried[..., :-1], (1, 0))
        out = (local + exclusive[..., None]).reshape(*x.shape[:-1], m * _SCAN_BLOCK)[..., :n]
    return out.movedim(-1, dim)


def integral_image(img: torch.Tensor) -> torch.Tensor:
    """Summed-area table with a leading zero row/col: (..., H+1, W+1)."""
    ii = _blocked_cumsum(_blocked_cumsum(img, -2), -1)
    return F.pad(ii, (1, 0, 1, 0))


def pad_integral(ii: torch.Tensor, margin: int) -> torch.Tensor:
    """Edge-pad an integral image by ``margin`` on all sides.

    Edge-padding the table clamps out-of-bounds box corners to the border,
    i.e. pixels outside the image count as zero in every box sum.
    """
    return F.pad(ii[None], (margin, margin, margin, margin), mode="replicate")[0]
