"""CLAHE — contrast-limited adaptive histogram equalization.

Counterpart of ``ergo_uvo_tpu/image/clahe.py`` (the reference's
``createCLAHE``, clip limit 3 mono / 8 stereo, 8x8 tiles,
VO_utility.cpp:349-355,368-374), in OpenCV's order:

  * per-tile 256-bin histograms, one ``bincount`` over (tile, level) pairs
    (integer adds, exact in any order);
  * OpenCV's integer excess redistribution (uniform + stepped residual);
  * CDF look-up tables, rounded half to even;
  * bilinear interpolation between the 4 neighbouring tiles' tables, as
    gathers.

The JAX package has two ways through the last stage that give the same
picture, a one-hot product for even tile sizes and a gather for the rest.
Here there is one, a gather.  Its weights are formed as the even-tile path
forms them (``w00 = (1 - wy) * (1 - wx)`` first, then
``v00*w00 + v01*w01 + v10*w10 + v11*w11``), from exact integer arithmetic on
the pixel position, so that at 640x480 (tiles of 60x80) the output rounds as
the JAX package's does.
"""

from __future__ import annotations

import torch

HIST_SIZE = 256


def _pad_reflect101(img: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Extend bottom/right by BORDER_REFLECT_101, as OpenCV's CLAHE does."""
    if pad_h:
        h = img.shape[-2]
        img = torch.cat([img, img[..., h - 1 - pad_h: h - 1, :].flip(-2)], dim=-2)
    if pad_w:
        w = img.shape[-1]
        img = torch.cat([img, img[..., :, w - 1 - pad_w: w - 1].flip(-1)], dim=-1)
    return img


def tile_histograms(ints: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """(B, gh*gw, 256) int64 histograms of a (B, gh*th, gw*tw) integer image."""
    b, ph, pw = ints.shape
    th, tw = ph // gh, pw // gw
    tile_id = (
        torch.arange(b * gh, device=ints.device).reshape(b, gh, 1, 1, 1) * gw
        + torch.arange(gw, device=ints.device).reshape(1, 1, 1, gw, 1)
    )
    keys = tile_id * HIST_SIZE + ints.reshape(b, gh, th, gw, tw)
    n = b * gh * gw
    return torch.bincount(keys.reshape(-1), minlength=n * HIST_SIZE).reshape(b, gh * gw, HIST_SIZE)


def tile_luts(hist: torch.Tensor, clip_limit: float, tile_area: int) -> torch.Tensor:
    """(..., 256) float32 look-up tables from (..., 256) integer histograms:
    clip, redistribute the excess (OpenCV's integer semantics), CDF, scale."""
    clip = max(int(clip_limit * tile_area / HIST_SIZE), 1)
    excess = torch.clamp(hist - clip, min=0).sum(-1, keepdim=True)
    clipped = torch.clamp(hist, max=clip)
    incr = excess // HIST_SIZE
    residual = excess - incr * HIST_SIZE  # in [0, 255]
    clipped = clipped + incr
    # OpenCV: residualStep = max(histSize // residual, 1); bins 0, step, 2*step,
    # ... (residual of them) each get +1.
    step = torch.clamp(HIST_SIZE // torch.clamp(residual, min=1), min=1)
    bin_idx = torch.arange(HIST_SIZE, device=hist.device)
    gets_one = (bin_idx % step == 0) & (bin_idx // step < residual)
    clipped = clipped + gets_one.to(clipped.dtype)

    cdf = torch.cumsum(clipped, dim=-1)
    lut_scale = (HIST_SIZE - 1.0) / tile_area
    return torch.clamp(torch.round(cdf.to(torch.float32) * lut_scale), 0, 255)


def _tile_weights(n: int, t: int, g: int, device: torch.device):
    """Per pixel along one axis: the two neighbouring tile indices (clamped
    after both are formed, OpenCV's order) and the weight of the second.

    The tile coordinate is (p / t - 0.5) = (2p - t) / 2t: its floor and its
    fraction come from integer division, and the fraction is one float32
    quotient.  The divisor is a tensor: by a Python number a CUDA tensor is
    multiplied with the rounded reciprocal, which is not that quotient.
    """
    num = 2 * torch.arange(n, device=device) - t
    t0 = torch.div(num, 2 * t, rounding_mode="floor")
    frac = (num - t0 * 2 * t).to(torch.float32) / torch.full((n,), 2.0 * t, device=device)
    t1 = torch.clamp(t0 + 1, 0, g - 1)
    t0 = torch.clamp(t0, 0, g - 1)
    return t0, t1, frac


def clahe(
    img: torch.Tensor,
    clip_limit: float = 3.0,
    grid: tuple[int, int] = (8, 8),
) -> torch.Tensor:
    """Apply CLAHE to (..., H, W) float32 gray images in [0, 255].

    Returns float32 in [0, 255].  Input intensities are rounded to integers
    for the histogram/LUT (the reference operates on uint8).  Leading
    dimensions are frames; each frame has its own histograms.
    """
    *batch, h, w = img.shape
    gh, gw = grid
    th = -(-h // gh)  # ceil
    tw = -(-w // gw)
    padded = _pad_reflect101(img.reshape(-1, h, w), th * gh - h, tw * gw - w)
    b, ph, pw = padded.shape

    pix = torch.clamp(torch.round(padded), 0, 255).long()
    luts = tile_luts(tile_histograms(pix, gh, gw), clip_limit, th * tw)  # (B, gh*gw, 256)

    ty0, ty1, wy = _tile_weights(ph, th, gh, img.device)
    tx0, tx1, wx = _tile_weights(pw, tw, gw, img.device)
    wy, wx = wy[:, None], wx[None, :]
    w00 = (1 - wy) * (1 - wx)
    w01 = (1 - wy) * wx
    w10 = wy * (1 - wx)
    w11 = wy * wx

    luts_flat = luts.reshape(b, -1)

    def lut_at(ty, tx):
        idx = (ty[:, None] * gw + tx[None, :]) * HIST_SIZE + pix
        return torch.gather(luts_flat, 1, idx.reshape(b, -1)).reshape(b, ph, pw)

    out = (
        lut_at(ty0, tx0) * w00
        + lut_at(ty0, tx1) * w01
        + lut_at(ty1, tx0) * w10
        + lut_at(ty1, tx1) * w11
    )
    return torch.clamp(out[:, :h, :w], 0.0, 255.0).reshape(*batch, h, w)
