"""ORB: FAST-9 over a 1.2x pyramid and steered BRIEF-256.

Counterpart of ``ergo_uvo_tpu/features/orb.py`` (the reference's
``cv::ORB::create(10000, 1.2, 8)``, VO_utility.cpp:96-99).  The same
computation on the same fixed shapes; what changes in the translation:

* the 9-contiguous segment test, a cascade of 16 x 8 ANDs and 16 ORs per
  polarity in the JAX package, is the same predicate as "some window of 9 of
  the 16 circle taps, read around the circle, is all set": a window sum of
  the wrapped 0/1 taps equal to 9, a handful of tensor ops;
* ``reduce_window`` max with -inf padding is ``max_pool2d``, which pads with
  -inf too;
* ``lax.top_k`` is a stable descending sort (:func:`detector.top_k`);
* the patch samplers are gathers (:mod:`features.sampling`).

The BRIEF test pattern is the JAX package's: numpy's ``default_rng(7)``,
kept here as :data:`_PATTERN`.  Every function takes leading frame
dimensions; nothing is looped over frames.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ergo_uvo_tpu_torch.device import upload
from ergo_uvo_tpu_torch.features.detector import Keypoints, top_k
from ergo_uvo_tpu_torch.features.sampling import (
    conv2d_same,
    edge_pad,
    extract_patches,
    resize_bilinear,
    sample_patch,
)

# FAST Bresenham circle, radius 3, OpenCV tap order (dx, dy).
_CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
PATCH = 31  # orientation/BRIEF patch size
_HALF = PATCH // 2
# Detection gate: the steered-BRIEF grid (_BRIEF_Q = 45, half extent 22
# level pixels) must fit inside the image, since a sample off the image is 0.
_BRIEF_MARGIN = 23  # ceil(_HALF * sqrt(2)) + 1; == _BRIEF_Q // 2 + 1
_BRIEF_Q = 45  # patch grid: covers the rotated pattern (+-HALF*sqrt2 ~ 21.2)


def _contiguous9(m: torch.Tensor) -> torch.Tensor:
    """(B, 16, H, W) taps -> (B, H, W): some 9 consecutive taps, around the
    circle, all set."""
    wrapped = torch.cat([m, m[:, :8]], 1).to(torch.int32)  # (B, 24, H, W)
    csum = F.pad(torch.cumsum(wrapped, 1), (0, 0, 0, 0, 1, 0))  # (B, 25, H, W)
    return ((csum[:, 9:] - csum[:, :-9]) == 9).any(1)


def _sum_taps(x: torch.Tensor) -> torch.Tensor:
    """Sum over the 16 taps in tap order, as the JAX package's reduction."""
    acc = x[:, 0]
    for i in range(1, x.shape[1]):
        acc = acc + x[:, i]
    return acc


def fast_score(img: torch.Tensor, threshold: float = 20.0, margin: int = _HALF) -> torch.Tensor:
    """(B, H, W) FAST-9 corner score maps (0 where not a corner).

    Score: the sum of |intensity difference| - threshold over the brighter
    or darker taps, whichever is larger; ``margin`` gates the border.
    """
    n_b, h, w = img.shape
    pad = edge_pad(img, 3, 3)
    circ = torch.stack([pad[:, 3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w] for dx, dy in _CIRCLE], 1)
    diff = circ - img[:, None]
    bright = diff > threshold
    dark = diff < -threshold
    is_corner = _contiguous9(bright) | _contiguous9(dark)
    score_b = _sum_taps(torch.where(bright, diff - threshold, 0.0))
    score_d = _sum_taps(torch.where(dark, -diff - threshold, 0.0))
    score = torch.maximum(score_b, score_d)
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    interior = (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)
    return torch.where(is_corner & interior, score, 0.0)


def _level_shapes(h: int, w: int, n_levels: int, scale: float):
    out = []
    for lvl in range(n_levels):
        f = scale**lvl
        out.append((max(int(round(h / f)), PATCH + 2), max(int(round(w / f)), PATCH + 2)))
    return out


def _disc_kernels(device: torch.device):
    """The intensity-centroid kernels gx * disc and gy * disc over the 31x31 patch."""
    g = np.arange(PATCH) - _HALF
    gy, gx = np.meshgrid(g, g, indexing="ij")
    disc = ((gx**2 + gy**2) <= _HALF**2).astype(np.float32)
    return upload(gx.astype(np.float32) * disc, device), upload(gy.astype(np.float32) * disc, device)


def _orientations(img: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle at flat pixel indices (Rublee et al. §4.1):
    the disc moments as two whole-image correlations, read at the peaks."""
    kx, ky = _disc_kernels(img.device)
    m10 = conv2d_same(img, kx).flatten(-2)
    m01 = conv2d_same(img, ky).flatten(-2)
    return torch.atan2(torch.gather(m01, -1, flat_idx), torch.gather(m10, -1, flat_idx))


def detect_orb(
    img: torch.Tensor,
    max_keypoints: int = 512,
    threshold: float = 20.0,
    n_levels: int = 8,
    scale_factor: float = 1.2,
) -> Keypoints:
    """FAST-9 keypoints of (..., H, W) images over a 1.2x pyramid; fixed K
    with a validity mask.  ``laplacian`` carries the orientation (radians)."""
    *batch, h, w = img.shape
    img = img.reshape(-1, h, w)
    n_b = img.shape[0]
    frame = torch.arange(n_b, device=img.device)[:, None]
    per_level = []
    level_img = img
    for lvl, (lh, lw) in enumerate(_level_shapes(h, w, n_levels, scale_factor)):
        if (lh, lw) != tuple(level_img.shape[-2:]):
            level_img = resize_bilinear(img, lh, lw)
        score = fast_score(level_img, threshold, margin=_BRIEF_MARGIN)
        nmax = F.max_pool2d(score[:, None], 3, stride=1, padding=1)[:, 0]  # 3x3 NMS
        peak = (score >= nmax) & (score > 0)
        flat = torch.where(peak, score, float("-inf")).reshape(n_b, -1)
        k = min(max_keypoints, flat.shape[-1])
        scores, idx = top_k(flat, k)
        if k < max_keypoints:
            scores = F.pad(scores, (0, max_keypoints - k), value=float("-inf"))
            idx = F.pad(idx, (0, max_keypoints - k))
        yy = (idx // lw).to(torch.float32)
        xx = (idx % lw).to(torch.float32)
        mask = torch.isfinite(scores)
        f = scale_factor**lvl
        xy = torch.stack([xx, yy], -1) * f
        sigma = torch.full((n_b, max_keypoints), f, dtype=img.dtype, device=img.device)
        ang = _orientations(level_img, idx)
        per_level.append((torch.where(mask, scores, float("-inf")), xy, sigma, ang, mask))

    scores = torch.cat([p[0] for p in per_level], -1)
    xy = torch.cat([p[1] for p in per_level], -2)
    sigma = torch.cat([p[2] for p in per_level], -1)
    ang = torch.cat([p[3] for p in per_level], -1)
    mask = torch.cat([p[4] for p in per_level], -1)
    top_scores, top_idx = top_k(torch.where(mask, scores, float("-inf")), max_keypoints)
    top_mask = torch.isfinite(top_scores)
    kpts = Keypoints(
        xy=torch.where(top_mask[..., None], xy[frame, top_idx], 0.0),
        scale=torch.where(top_mask, sigma[frame, top_idx], 0.0),
        score=torch.where(top_mask, top_scores, 0.0),
        laplacian=torch.where(top_mask, ang[frame, top_idx], 0.0),
        mask=top_mask,
    )
    return Keypoints(*(f.reshape(*batch, *f.shape[1:]) for f in kpts))


def _brief_pattern(n_bits: int = 256, seed: int = 7) -> np.ndarray:
    """(n_bits, 4) test pattern (x1, y1, x2, y2), BRIEF G-II: iid Gaussian
    with sigma = PATCH/5, clipped to the patch. Deterministic (fixed seed)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH / 5.0, (n_bits, 4))
    return np.clip(pts, -_HALF + 1, _HALF - 1).astype(np.float32)


_PATTERN = _brief_pattern()


def describe_orb(img: torch.Tensor, kpts: Keypoints, n_bits: int = 256) -> torch.Tensor:
    """(..., K, n_bits) float32 {0,1} steered-BRIEF bits; invalid rows -> 0.

    An axis-aligned 45x45 patch per keypoint at its pyramid scale, then the
    test positions, rotated by the keypoint angle (``laplacian``), sampled
    inside the patch.
    """
    pat = upload(_PATTERN[:n_bits], img.device)  # (n_bits, 4)
    ang = kpts.laplacian
    c, s = torch.cos(ang)[..., None], torch.sin(ang)[..., None]  # (..., K, 1)
    patches = extract_patches(img, kpts.xy[..., 0], kpts.xy[..., 1], kpts.scale, _BRIEF_Q)
    center = (_BRIEF_Q - 1) / 2.0

    def rotate(px, py):  # (..., K, n_bits) rotated offsets in patch units
        return c * px - s * py, s * px + c * py

    x1, y1 = rotate(pat[:, 0], pat[:, 1])
    x2, y2 = rotate(pat[:, 2], pat[:, 3])
    i1 = sample_patch(patches, center + y1, center + x1)
    i2 = sample_patch(patches, center + y2, center + x2)
    bits = (i1 < i2).to(torch.float32)
    return torch.where(kpts.mask[..., None], bits, 0.0)
