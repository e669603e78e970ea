"""Per-frame preprocessing ops: gray, area resize, bilinear remap, full plan.

Counterpart of ``ergo_uvo_tpu/image/preprocess.py``, the device-side half of
the reference's ``get_image`` (VO_utility.cpp:337-379); the init-time half
(grids, camera matrices) is :mod:`ergo_uvo_tpu_torch.image.undistort`.  All
ops take float32 images in [0, 255] with any leading frame dimensions.

The JAX package resamples through the undistortion map in two ways that
agree, a sum over static integer shifts for small displacements and a gather
for large ones.  Here there is one, :func:`remap_bilinear`, a four-tap
gather; it forms each tap's weight as the product ``wy * wx`` and adds the
taps row by row, which is the order in which the shift form meets its four
non-zero terms, so that the result rounds as that form's does.  JAX's
``optimization_barrier`` between remap and CLAHE has no eager meaning and is
dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ergo_uvo_tpu_torch.device import resolve_device
from ergo_uvo_tpu_torch.features.sampling import resize_bilinear
from ergo_uvo_tpu_torch.image import undistort as _und
from ergo_uvo_tpu_torch.image.clahe import clahe
from ergo_uvo_tpu_torch.utils.profiling import span


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) RGB -> (..., H, W) gray with OpenCV's BT.601 weights.

    (ref: ``cvtColor(..., COLOR_RGB2GRAY)`` VO_utility.cpp:345,364.)
    """
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def resize_area(img: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """INTER_AREA resize of (..., H, W) (ref: VO_utility.cpp:361).

    For integer downscale factors this is exact OpenCV INTER_AREA: box-average
    pooling as a reshape and a mean.  Non-integer ratios use the antialiased
    triangle-weight resize (:func:`resize_bilinear`), which differs from area
    weighting only at the margins.
    """
    *batch, h, w = img.shape
    if h % new_h == 0 and w % new_w == 0:
        fh, fw = h // new_h, w // new_w
        return img.reshape(*batch, new_h, fh, new_w, fw).mean(dim=(-3, -1))
    return resize_bilinear(img, new_h, new_w, antialias=True)


def remap_bilinear(
    img: torch.Tensor, grid: torch.Tensor, disp: torch.Tensor | None = None
) -> torch.Tensor:
    """Sample (..., H, W) images at ``grid`` (H', W', 2) (x, y), bilinearly.

    ``disp`` is ``grid`` minus the identity map, for a ``grid`` of the
    image's own size; a plan holds it rounded once from float64, and passing
    it keeps that rounding (it is ``grid - identity`` in float32 otherwise).
    Each output pixel takes the four pixels around its source position, with
    weights ``hat(dy - sy) * hat(dx - sx)``, ``hat(z) = max(0, 1 - |z|)``,
    over the two integer shifts ``sy`` and ``sx`` that bracket the
    displacement.  Out-of-image taps give 0, i.e. cv::undistort's
    BORDER_CONSTANT(0) fill.
    """
    h, w = img.shape[-2:]
    gh, gw = grid.shape[:2]
    ys = torch.arange(gh, device=img.device)[:, None]
    xs = torch.arange(gw, device=img.device)[None, :]
    if disp is None:
        disp = grid - torch.stack(
            [xs.expand(gh, gw), ys.expand(gh, gw)], -1
        ).to(grid.dtype)
    dx, dy = disp[..., 0], disp[..., 1]
    sy0 = torch.floor(dy)
    sx0 = torch.floor(dx)
    flat = img.reshape(*img.shape[:-2], h * w)

    def tap(sy, sx):
        wgt = torch.clamp(1.0 - (dy - sy).abs(), min=0.0) * torch.clamp(
            1.0 - (dx - sx).abs(), min=0.0
        )
        yi = ys + sy.long()
        xi = xs + sx.long()
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)
        vals = flat[..., idx.reshape(-1)].reshape(*img.shape[:-2], gh, gw)
        return wgt * torch.where(valid, vals, 0.0)

    return tap(sy0, sx0) + tap(sy0, sx0 + 1) + tap(sy0 + 1, sx0) + tap(sy0 + 1, sx0 + 1)


class PreprocessPlan(NamedTuple):
    """Init-time state for the per-frame preprocess (finalized from the first
    frame's size, as the reference does — SURVEY.md §3.3)."""

    new_h: int
    new_w: int
    grid: torch.Tensor  # (new_h, new_w, 2) undistortion sampling grid
    disp: torch.Tensor  # (new_h, new_w, 2) grid - identity, float32
    max_shift: int  # ceil(max |disp|)
    K_resized: torch.Tensor  # (3, 3) resized original K
    new_K: torch.Tensor  # (3, 3) alpha=0 optimal camera — the pipeline's K
    clahe_enabled: bool
    clip_limit: float


def build_preprocess_plan(
    K: np.ndarray,
    dist: np.ndarray,
    orig_width: int,
    orig_height: int,
    desired_width: int,
    clahe_enabled: bool,
    clip_limit: float,
    device: torch.device | str | None = None,
) -> PreprocessPlan:
    """Plan construction in numpy float64 (once, from the first frame's size).

    Mirrors mono init (visual_odometry.h:221-222): rescale K by the width
    ratio, derive the alpha=0 optimal new camera, precompute the undistortion
    grid for the resized geometry.  The plan's tensors lie on ``device``:
    ``None`` is the card and raises where there is none; pass
    ``device="cpu"`` for the CPU.
    """
    device = resolve_device(device)
    K = np.asarray(K, np.float64)
    dist = np.asarray(dist, np.float64)
    ratio = orig_width / desired_width
    new_h = int(orig_height / ratio)
    new_w = desired_width
    K_resized = K / ratio
    K_resized[0, 1] = K[0, 1]
    K_resized[2, 2] = 1.0
    new_K = _und.optimal_new_camera(K_resized, dist, new_w, new_h)
    grid = _und.build_undistort_grid(K_resized, dist, new_K, new_w, new_h)
    ys, xs = np.mgrid[0:new_h, 0:new_w].astype(np.float64)
    disp = grid - np.stack([xs, ys], -1)
    max_shift = int(np.ceil(np.abs(disp).max())) if disp.size else 0

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return PreprocessPlan(
        new_h=new_h,
        new_w=new_w,
        grid=put(grid),
        disp=put(disp),
        max_shift=max_shift,
        K_resized=put(K_resized),
        new_K=put(new_K),
        clahe_enabled=bool(clahe_enabled),
        clip_limit=float(clip_limit),
    )


def preprocess_frame(plan: PreprocessPlan, img: torch.Tensor) -> torch.Tensor:
    """Full ``get_image`` path: gray -> resize -> undistort -> CLAHE.

    ``img``: (..., H, W, 3) RGB or (..., H, W) gray, float32 in [0, 255], on
    the plan's device; leading dimensions are frames.  A last dimension of 3
    is read as the colour channels.  Returns (..., new_h, new_w) float32 gray
    in [0, 255].
    """
    with span("preprocess"):
        if img.ndim >= 3 and img.shape[-1] == 3:
            img = rgb_to_gray(img)
        if tuple(img.shape[-2:]) != (plan.new_h, plan.new_w):
            img = resize_area(img, plan.new_h, plan.new_w)
        img = remap_bilinear(img, plan.grid, plan.disp)
        if plan.clahe_enabled:
            img = clahe(img, clip_limit=plan.clip_limit)
        return img
