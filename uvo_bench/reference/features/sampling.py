"""Resize, patch sampling and a dense SAME correlation.

Counterpart of ``ergo_uvo_tpu/features/sampling.py``.

* :func:`resize_bilinear`: two triangle-weight products, as in the JAX
  package, in true float32.
* :func:`hat_matrix`: the JAX package's dense hat weights, the same bits.
  Nothing in the port calls it: the samplers below take the two taps that
  carry weight.
* :func:`extract_patches` and :func:`sample_patch`: the JAX package samples
  with hat-weight matmuls, ``relu(1 - |pos - i|)`` over the whole grid,
  because gathers are slow on the TPU.  Only the two grid points either side
  of a position carry weight, so here each sample is a four-tap gather with
  those two hat weights per axis, rows combined first and then columns, as
  the two matmuls do.  A tap outside the grid contributes **zero**, not a
  clamped border value: ORB's 23-px margin and SIFT's zero-padded tail at
  octave borders depend on that (the module docstring of the original).
  Sums of two products replace fused products over the grid, so samples
  agree with the JAX package to float32 rounding, not bit for bit.
* :func:`conv2d_same`: ``F.conv2d`` with SAME padding, in float32 (TF32 is
  off for cuDNN, ``ergo_uvo_tpu_torch/__init__.py``).
* :func:`edge_pad` and :func:`separable_taps`: the edge padding and the
  separable blurs of ORB, SIFT and AKAZE (the JAX package writes them out in
  each module).

Every function takes leading frame dimensions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def hat_matrix(pos: torch.Tensor, n: int) -> torch.Tensor:
    """(..., S) float positions -> (..., S, n) bilinear hat weights.

    Row s holds relu(1 - |pos_s - i|) over grid i = 0..n-1: exactly the
    two nonzero bilinear interpolation weights (or all-zero out of range).
    """
    grid = torch.arange(n, dtype=pos.dtype, device=pos.device)
    return torch.clamp(1.0 - (pos[..., None] - grid).abs(), min=0.0)


def _hat_taps(pos: torch.Tensor, n: int):
    """The two grid points around each position on a grid of ``n`` and their
    hat weights ``relu(1 - |pos - i|)``, zero off the grid: (i0, i1, w0, w1),
    the indices clamped into the grid for the gather."""
    i0 = torch.floor(pos)
    i1 = i0 + 1.0
    w0 = torch.clamp(1.0 - (pos - i0).abs(), min=0.0)
    w1 = torch.clamp(1.0 - (pos - i1).abs(), min=0.0)
    w0 = torch.where((i0 >= 0) & (i0 <= n - 1), w0, 0.0)
    w1 = torch.where((i1 >= 0) & (i1 <= n - 1), w1, 0.0)
    i0 = torch.clamp(i0, 0, n - 1).long()
    i1 = torch.clamp(i1, 0, n - 1).long()
    return i0, i1, w0, w1


def _frame_index(n_b: int, ndim: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n_b, device=device).reshape(n_b, *([1] * (ndim - 1)))


def extract_patches(
    img: torch.Tensor,  # (..., H, W)
    cx: torch.Tensor,  # (..., K) subpixel centers, x
    cy: torch.Tensor,  # (..., K)
    spacing: torch.Tensor,  # (..., K) patch-grid step in image pixels
    P: int,
) -> torch.Tensor:
    """(..., K, P, P) patches; patch[k, a, b] = bilinear sample of ``img`` at
    (cy[k] + (a - (P-1)/2) * spacing[k], cx[k] + (b - (P-1)/2) * spacing[k]),
    zero where a tap falls off the image."""
    *batch, h, w = img.shape
    n_k = cx.shape[-1]
    img = img.reshape(-1, h, w)
    cx, cy, spacing = (v.reshape(-1, n_k) for v in (cx, cy, spacing))
    off = torch.arange(P, dtype=img.dtype, device=img.device) - (P - 1) / 2.0
    ys = cy[..., None] + off * spacing[..., None]  # (B, K, P)
    xs = cx[..., None] + off * spacing[..., None]
    y0, y1, wy0, wy1 = _hat_taps(ys, h)
    x0, x1, wx0, wx1 = _hat_taps(xs, w)
    frame = _frame_index(img.shape[0], 4, img.device)
    rows = (y0[..., :, None], y1[..., :, None])
    cols = (x0[..., None, :], x1[..., None, :])
    wy0, wy1 = wy0[..., :, None], wy1[..., :, None]

    def column(xi):  # the rows' combination at one column tap: (B, K, P, P)
        return wy0 * img[frame, rows[0], xi] + wy1 * img[frame, rows[1], xi]

    out = wx0[..., None, :] * column(cols[0]) + wx1[..., None, :] * column(cols[1])
    return out.reshape(*batch, n_k, P, P)


def sample_patch(patches: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear samples inside (..., K, P, P) patches at patch-space float
    coordinates: u (..., K, S) the row, v (..., K, S) the column; zero where a
    tap falls off the patch.  Returns (..., K, S)."""
    *lead, n_k, P, _ = patches.shape
    S = u.shape[-1]
    flat = patches.reshape(-1, P * P)  # one row of P*P per keypoint
    u = u.reshape(-1, S)
    v = v.reshape(-1, S)
    r0, r1, wr0, wr1 = _hat_taps(u, P)
    c0, c1, wc0, wc1 = _hat_taps(v, P)

    def at(ri, ci):
        return torch.gather(flat, 1, ri * P + ci)

    out = wc0 * (wr0 * at(r0, c0) + wr1 * at(r1, c0)) + wc1 * (wr0 * at(r0, c1) + wr1 * at(r1, c1))
    return out.reshape(*lead, n_k, S)


def edge_pad(img: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """(B, h, w) images padded by ``rows`` above and below and ``cols`` left
    and right with their border values (``jnp.pad(mode="edge")``)."""
    return F.pad(img[:, None], (cols, cols, rows, rows), mode="replicate")[:, 0]


def separable_taps(img: torch.Tensor, taps) -> torch.Tensor:
    """Correlation of (B, h, w) images with the odd-length 1-D kernel ``taps``
    (Python floats) along the rows and then along the columns, edge-padded,
    each pass adding its products in tap order, as the JAX package's blurs
    do."""
    r = (len(taps) - 1) // 2
    h, w = img.shape[-2:]
    p = edge_pad(img, r, 0)
    acc = 0.0
    for i, k in enumerate(taps):
        acc = acc + k * p[:, i: i + h]
    p = edge_pad(acc, 0, r)
    out = 0.0
    for i, k in enumerate(taps):
        out = out + k * p[..., i: i + w]
    return out


def conv2d_same(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Dense 2-D SAME correlation of (..., H, W) images with one (kh, kw)
    kernel of odd sizes."""
    *batch, h, w = img.shape
    kh, kw = kernel.shape
    out = F.conv2d(
        img.reshape(-1, 1, h, w),
        kernel.to(img.dtype)[None, None],
        padding=(kh // 2, kw // 2),
    )
    return out.reshape(*batch, h, w)
