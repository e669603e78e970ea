"""Linear resize as two triangle-weight products.

Counterpart of ``resize_bilinear`` in ``ergo_uvo_tpu/features/sampling.py``.
The JAX package computes this product outside any kernel, so here it is two
``torch.matmul`` calls in true float32.  The patch samplers of that module
(``hat_matrix``, ``extract_patches``, ``sample_patch``, ``conv2d_same``) serve
the ORB / SIFT / AKAZE branches and come with them (ROADMAP.md Queue 1,
item 10).
"""

from __future__ import annotations

import torch


def _resize_weights(
    out_n: int, n: int, antialias: bool, dtype: torch.dtype, device: torch.device
) -> torch.Tensor:
    """(out_n, n) row-normalized triangle weights at half-pixel centers."""
    pos = torch.clamp(
        (torch.arange(out_n, dtype=dtype, device=device) + 0.5) * (n / out_n) - 0.5,
        0.0, n - 1.0,
    )
    s = max(n / out_n, 1.0) if antialias else 1.0
    grid = torch.arange(n, dtype=dtype, device=device)
    w = torch.clamp(1.0 - (pos[:, None] - grid[None]).abs() / s, min=0.0)
    return w / w.sum(dim=1, keepdim=True)


def resize_bilinear(
    img: torch.Tensor, out_h: int, out_w: int, antialias: bool = False
) -> torch.Tensor:
    """Linear resize of (..., H, W) to (..., out_h, out_w): ``R @ img @ C^T``.

    ``antialias=False`` is plain 2-tap bilinear at half-pixel source centers
    (OpenCV ``INTER_LINEAR``); ``antialias=True`` widens the triangle by the
    downscale ratio, a close stand-in for ``INTER_AREA`` at non-integer ratios.
    """
    h, w = img.shape[-2:]
    R = _resize_weights(out_h, h, antialias, img.dtype, img.device)  # (out_h, h)
    C = _resize_weights(out_w, w, antialias, img.dtype, img.device)  # (out_w, w)
    return R @ img @ C.T
