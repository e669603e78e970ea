"""SURF-64/128 descriptors, upright and oriented — counterpart of ``ergo_uvo_tpu/features/descriptor.py``.

A (PATCH+1)^2 grid at spacing sigma is sampled around each keypoint, 2x2 Haar
differences are Gaussian weighted and pooled over a 4x4 grid of 5x5 blocks
into (sum dx, sum |dx|, sum dy, sum |dy|), and the vector is L2-normalized.
Oriented SURF (``upright=False``) first takes each keypoint's dominant
orientation (a sliding 60-degree window over the Haar responses, Bay et al.
§4.1) and samples the grid rotated by it.

The JAX package samples the axis-aligned grid with two hat-weight matmuls,
because gathers are slow on the TPU; both compute clamped bilinear sampling,
so here it is four gathers, as the rotated grid is in both packages.
Leading frame dimensions go through: the gathers carry a frame index.
"""

from __future__ import annotations

import math

import torch

from ergo_uvo_tpu_torch.features.detector import Keypoints
from ergo_uvo_tpu_torch.utils.profiling import span

PATCH = 20  # PATCH_SZ, 4x4 subregions of 5x5 samples
_GAUSS_SIGMA = 3.3  # Bay et al.: sigma = 3.3s over the 20s window


def _bilinear_clamped(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    """Clamped bilinear samples of (B, H, W) images at (sx, sy), two (B, ...)
    coordinate tensors that broadcast against each other.

    Coordinates are clamped to [0, size-1] first, like the hat-weight matmul
    form of the JAX package, so a sample on the last row or column takes that
    pixel alone.
    """
    n_b, h, w = img.shape
    sx = torch.clamp(sx, 0, w - 1)
    sy = torch.clamp(sy, 0, h - 1)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = sx - x0
    wy = sy - y0
    x0i = x0.long()
    y0i = y0.long()
    x1i = torch.clamp(x0i + 1, max=w - 1)
    y1i = torch.clamp(y0i + 1, max=h - 1)
    frame = torch.arange(n_b, device=img.device).reshape(n_b, *[1] * (sx.dim() - 1))

    def at(yi, xi):
        return img[frame, yi, xi]

    top = at(y0i, x0i) * (1 - wx) + at(y0i, x1i) * wx
    bot = at(y1i, x0i) * (1 - wx) + at(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


def _sample_patches(img: torch.Tensor, xy: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(B, K, P1, P1) axis-aligned patches at spacing ``scale`` from (B, H, W)
    images, (B, K, 2) centers and (B, K) scales."""
    g = torch.arange(PATCH + 1, dtype=img.dtype, device=img.device) - PATCH / 2.0
    sy = xy[..., 1:2] + g * scale[..., None]  # (B, K, P1)
    sx = xy[..., 0:1] + g * scale[..., None]
    return _bilinear_clamped(img, sx[..., None, :], sy[..., :, None])


def _sample_patches_rotated(
    img: torch.Tensor, xy: torch.Tensor, scale: torch.Tensor,
    cos_t: torch.Tensor, sin_t: torch.Tensor,
) -> torch.Tensor:
    """(B, K, P1, P1) patches of (B, H, W) images on grids rotated by the
    (B, K) angles."""
    g = torch.arange(PATCH + 1, dtype=img.dtype, device=img.device) - PATCH / 2.0
    gy, gx = torch.meshgrid(g, g, indexing="ij")  # (P1, P1)
    cos_t, sin_t, scale = cos_t[..., None, None], sin_t[..., None, None], scale[..., None, None]
    rx = cos_t * gx - sin_t * gy
    ry = sin_t * gx + cos_t * gy
    return _bilinear_clamped(img, xy[..., 0, None, None] + rx * scale,
                             xy[..., 1, None, None] + ry * scale)


def _haar(patch: torch.Tensor):
    """2x2 Haar responses (dx, dy) on sampled patches (OpenCV surf.cpp inner loop)."""
    dx = (
        patch[..., :-1, 1:] - patch[..., :-1, :-1]
        + patch[..., 1:, 1:] - patch[..., 1:, :-1]
    )
    dy = (
        patch[..., 1:, :-1] - patch[..., :-1, :-1]
        + patch[..., 1:, 1:] - patch[..., :-1, 1:]
    )
    return dx, dy


def surf_orientations(img: torch.Tensor, kpts: Keypoints) -> torch.Tensor:
    """(B, K) dominant orientation of (B, H, W) images' keypoints (Bay et al. §4.1).

    Haar responses on the sigma-spaced patch inside a 6-sigma disc, Gaussian
    weighted (sigma = 2.5 s); the angle of the longest summed response over a
    sliding 60-degree window (64 window starts, one masked product).
    """
    n_b, n_k = kpts.mask.shape
    patch = _sample_patches(img, kpts.xy, kpts.scale)
    dx, dy = _haar(patch)
    c = torch.arange(PATCH, dtype=img.dtype, device=img.device) - (PATCH - 1) / 2.0
    yy, xx = torch.meshgrid(c, c, indexing="ij")
    disc = ((xx**2 + yy**2) <= (PATCH / 2.0) ** 2).to(img.dtype)
    gauss = torch.exp(-(xx**2 + yy**2) / (2.0 * 2.5**2)) * disc
    dx = (dx * gauss).reshape(n_b * n_k, -1)  # (N, S)
    dy = (dy * gauss).reshape(n_b * n_k, -1)
    phi = torch.atan2(dy, dx)
    n_win = 64
    # The 64 window starts as jnp.linspace(-pi, pi, 64, endpoint=False)
    # computes them in float32: -pi * (1 - f) + pi * f at f = i / 64.
    frac = torch.arange(n_win, dtype=img.dtype, device=img.device) / n_win
    pi32 = torch.full((), math.pi, dtype=img.dtype, device=img.device)
    starts = -pi32 * (1 - frac) + pi32 * frac
    # in-window mask with wraparound: (N, S, n_win)
    d = torch.remainder(phi[..., None] - starts, 2 * math.pi)
    in_win = (d < math.pi / 3.0).to(img.dtype)
    sx = torch.einsum("ks,ksw->kw", dx, in_win)
    sy = torch.einsum("ks,ksw->kw", dy, in_win)
    best = torch.argmax(sx * sx + sy * sy, dim=-1, keepdim=True)
    angle = torch.atan2(torch.gather(sy, 1, best), torch.gather(sx, 1, best))
    return angle.reshape(n_b, n_k)


def describe_surf(
    img: torch.Tensor, kpts: Keypoints, extended: bool = False, upright: bool = True,
) -> torch.Tensor:
    """(..., K, 64|128) unit descriptors of (..., H, W) images; oriented
    when ``upright=False``."""
    with span("detect.describe"):
        if upright:
            return describe_upright_surf(img, kpts, extended)
        *batch, h, w = img.shape
        n_k = kpts.mask.shape[-1]
        img = img.reshape(-1, h, w)
        kp = Keypoints(*(f.reshape(img.shape[0], n_k, *f.shape[len(batch) + 1:]) for f in kpts))
        theta = surf_orientations(img, kp)
        patch = _sample_patches_rotated(img, kp.xy, kp.scale, torch.cos(theta), torch.sin(theta))
        desc = _descriptor_from_patch(patch.flatten(0, 1), kp.mask.reshape(-1), extended)
        return desc.reshape(*batch, n_k, -1)


def describe_upright_surf(
    img: torch.Tensor, kpts: Keypoints, extended: bool = False
) -> torch.Tensor:
    """(..., K, 64) (or 128 if extended) unit descriptors; invalid rows -> 0."""
    *batch, h, w = img.shape
    n_k = kpts.mask.shape[-1]
    patch = _sample_patches(
        img.reshape(-1, h, w), kpts.xy.reshape(-1, n_k, 2), kpts.scale.reshape(-1, n_k)
    )
    desc = _descriptor_from_patch(patch.flatten(0, 1), kpts.mask.reshape(-1), extended)
    return desc.reshape(*batch, n_k, -1)


def _descriptor_from_patch(
    patch: torch.Tensor, mask: torch.Tensor, extended: bool
) -> torch.Tensor:
    K = patch.shape[0]
    dx, dy = _haar(patch)

    # Gaussian weighting over the 20x20 response grid.
    c = torch.arange(PATCH, dtype=torch.float32, device=patch.device) - (PATCH - 1) / 2.0
    wy_, wx_ = torch.meshgrid(c, c, indexing="ij")
    gauss = torch.exp(-(wx_**2 + wy_**2) / (2.0 * _GAUSS_SIGMA**2))
    dx = dx * gauss[None]
    dy = dy * gauss[None]

    # Aggregate 5x5 blocks into the 4x4 subregion grid.
    def blocks(v):
        return v.reshape(K, 4, 5, 4, 5).permute(0, 1, 3, 2, 4).reshape(K, 16, 25)

    bdx, bdy = blocks(dx), blocks(dy)
    if not extended:
        feats = torch.stack(
            [bdx.sum(-1), bdx.abs().sum(-1), bdy.sum(-1), bdy.abs().sum(-1)], -1
        ).reshape(K, 64)
    else:
        # 128-d: split each sum by the sign of the other gradient component.
        neg_y, pos_y = bdy < 0, bdy >= 0
        neg_x, pos_x = bdx < 0, bdx >= 0
        feats = torch.stack(
            [
                (bdx * neg_y).sum(-1),
                (bdx.abs() * neg_y).sum(-1),
                (bdx * pos_y).sum(-1),
                (bdx.abs() * pos_y).sum(-1),
                (bdy * neg_x).sum(-1),
                (bdy.abs() * neg_x).sum(-1),
                (bdy * pos_x).sum(-1),
                (bdy.abs() * pos_x).sum(-1),
            ],
            -1,
        ).reshape(K, 128)

    norm = torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
    feats = feats / torch.clamp(norm, min=1e-12)
    return torch.where(mask[:, None], feats, 0.0)
