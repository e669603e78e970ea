"""Upright SURF-64/128 descriptors — counterpart of ``ergo_uvo_tpu/features/descriptor.py``.

A (PATCH+1)^2 grid at spacing sigma is sampled around each keypoint, 2x2 Haar
differences are Gaussian weighted and pooled over a 4x4 grid of 5x5 blocks
into (sum dx, sum |dx|, sum dy, sum |dy|), and the vector is L2-normalized.

The JAX package samples the axis-aligned grid with two hat-weight matmuls,
because gathers are slow on the TPU; both compute clamped bilinear sampling,
so here it is four gathers.  Oriented SURF (``upright=False``) is not ported.
Leading frame dimensions go through: the gathers carry a frame index.
"""

from __future__ import annotations

import torch

from ergo_uvo_tpu_torch.features.detector import Keypoints

PATCH = 20  # PATCH_SZ, 4x4 subregions of 5x5 samples
_GAUSS_SIGMA = 3.3  # Bay et al.: sigma = 3.3s over the 20s window


def _sample_patches(img: torch.Tensor, xy: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(B, K, P1, P1) axis-aligned patches at spacing ``scale``, clamped
    bilinear, from (B, H, W) images, (B, K, 2) centers and (B, K) scales.

    Coordinates are clamped to [0, size-1] first, like the hat-weight matmul
    form of the JAX package, so a sample on the last row or column takes that
    pixel alone.
    """
    n_b, h, w = img.shape
    P1 = PATCH + 1
    g = torch.arange(P1, dtype=img.dtype, device=img.device) - PATCH / 2.0
    sy = torch.clamp(xy[..., 1:2] + g * scale[..., None], 0, h - 1)  # (B, K, P1)
    sx = torch.clamp(xy[..., 0:1] + g * scale[..., None], 0, w - 1)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = (sy - y0)[..., :, None]  # (B, K, P1, 1): rows
    wx = (sx - x0)[..., None, :]  # (B, K, 1, P1): columns
    y0i = y0.long()
    x0i = x0.long()
    y1i = torch.clamp(y0i + 1, max=h - 1)
    x1i = torch.clamp(x0i + 1, max=w - 1)
    frame = torch.arange(n_b, device=img.device)[:, None, None, None]

    def at(yi, xi):
        return img[frame, yi[..., :, None], xi[..., None, :]]  # (B, K, P1, P1)

    top = at(y0i, x0i) * (1 - wx) + at(y0i, x1i) * wx
    bot = at(y1i, x0i) * (1 - wx) + at(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


def describe_surf(
    img: torch.Tensor, kpts: Keypoints, extended: bool = False, upright: bool = True,
) -> torch.Tensor:
    """(..., K, 64|128) unit descriptors of (..., H, W) images; only the
    upright branch is ported."""
    if not upright:
        raise NotImplementedError(
            "oriented SURF (upright=False) is not ported yet: ROADMAP.md "
            "Queue 1, item 10 (alternate detectors and descriptor variants)"
        )
    return describe_upright_surf(img, kpts, extended)


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

    # 2x2 Haar responses on the sampled patch (OpenCV surf.cpp inner loop).
    dx = (
        patch[:, :-1, 1:] - patch[:, :-1, :-1]
        + patch[:, 1:, 1:] - patch[:, 1:, :-1]
    )
    dy = (
        patch[:, 1:, :-1] - patch[:, :-1, :-1]
        + patch[:, 1:, 1:] - patch[:, :-1, 1:]
    )

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
