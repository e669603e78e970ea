"""SURF fast-Hessian keypoint detector — counterpart of ``ergo_uvo_tpu/features/detector.py``.

The same algorithm on the same fixed shapes: box-filter Hessians over a padded
integral image at stride 2^o per octave, 3x3x3 scale-space NMS, a per-octave
top-K with quadratic sub-pixel / sub-scale refinement, then a global top-K
merge.  What changes in the translation:

* ``lax.slice`` with strides becomes tensor slicing with a step;
* ``reduce_window`` max with -inf padding becomes ``max_pool3d`` (3, 1, 1),
  which pads with -inf too;
* ``lax.top_k`` puts the lower index first on ties and ``torch.topk``
  promises no order, so selection is a stable descending sort (:func:`top_k`).

Every stage takes leading frame dimensions, where the JAX package ``vmap``s
the detector: the box sums and the NMS are elementwise or pooled per frame,
the top-K is a sort along the last axis, and the refinement gathers with a
frame index.  Nothing is looped over frames, and a batch gives each frame
the bits it gets alone.

:func:`detect_surf` dispatches on the frames' device, as
``geometry/linalg.py::jacobi_eigh`` does: CUDA frames go through the kernels
of :mod:`ergo_uvo_tpu_torch.features.surf_hessian` (5 launches a call), CPU
frames through :func:`detect_surf_reference`, the plain version, which the
CPU tests hold to the JAX package and the card tests hold the kernels to.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ergo_uvo_tpu_torch import cuda_build
from ergo_uvo_tpu_torch.features import surf_hessian
from ergo_uvo_tpu_torch.features.integral import integral_image, pad_integral
from ergo_uvo_tpu_torch.geometry.triangulation import _solve33
from ergo_uvo_tpu_torch.utils.profiling import span

# SURF 9x9 base patterns: (x0, y0, x1, y1, weight), half-open boxes relative
# to the filter's top-left corner (Bay et al. Fig. 2; OpenCV's dx_s/dy_s/dxy_s).
_DXX = ((0, 2, 3, 7, 1.0), (3, 2, 6, 7, -2.0), (6, 2, 9, 7, 1.0))
_DYY = ((2, 0, 7, 3, 1.0), (2, 3, 7, 6, -2.0), (2, 6, 7, 9, 1.0))
_DXY = (
    (1, 1, 4, 4, 1.0),
    (5, 1, 8, 4, -1.0),
    (1, 5, 4, 8, -1.0),
    (5, 5, 8, 8, 1.0),
)


class Keypoints(NamedTuple):
    """Fixed-budget keypoint set with validity mask."""

    xy: torch.Tensor  # (K, 2) float32 pixel coords (x, y)
    scale: torch.Tensor  # (K,) float32 SURF sigma = 1.2 * size / 9
    score: torch.Tensor  # (K,) float32 det-of-Hessian response
    laplacian: torch.Tensor  # (K,) float32 sign of the trace
    mask: torch.Tensor  # (K,) bool

    @property
    def count(self) -> torch.Tensor:
        return self.mask.sum(-1, dtype=torch.int32)


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index first — ``lax.top_k``'s order."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _scaled_pattern(pattern, size: int):
    """Scale a 9x9 base pattern to ``size``: rounded corners, area-normalized
    weights, offsets centered on the pixel (floor(size/2))."""
    ratio = size / 9.0
    c = size // 2
    out = []
    for x0, y0, x1, y1, w in pattern:
        sx0 = int(round(x0 * ratio))
        sy0 = int(round(y0 * ratio))
        sx1 = int(round(x1 * ratio))
        sy1 = int(round(y1 * ratio))
        area = max((sx1 - sx0) * (sy1 - sy0), 1)
        out.append((sy0 - c, sx0 - c, sy1 - c, sx1 - c, w / area))
    return out


def _strided_box_sum(iip, margin, h, w, step, y0, x0, y1, x1):
    """Box sums of img[y+y0 : y+y1, x+x0 : x+x1] on the stride-``step`` grid;
    shape (ceil(h/step), ceil(w/step))."""

    def corner(dy, dx):
        return iip[..., margin + dy: margin + dy + h: step, margin + dx: margin + dx + w: step]

    return corner(y1, x1) - corner(y0, x1) - corner(y1, x0) + corner(y0, x0)


def _haar_response(iip, margin, h, w, step, boxes):
    acc = None
    for y0, x0, y1, x1, wgt in boxes:
        s = _strided_box_sum(iip, margin, h, w, step, y0, x0, y1, x1) * wgt
        acc = s if acc is None else acc + s
    return acc


def filter_sizes(n_octaves: int, n_layers: int):
    """Filter size table: sizes[o][l] = (9 + 6*l) << o, l in [0, n_layers+2)."""
    return [
        [(9 + 6 * layer) << octave for layer in range(n_layers + 2)]
        for octave in range(n_octaves)
    ]


def hessian_octave(iip, margin: int, h: int, w: int, octave: int, sizes_o):
    """(det, trace) stacks for one octave, each (..., n_layers+2, ceil(h/2^o), ceil(w/2^o))."""
    step = 1 << octave
    dets, traces = [], []
    for s in sizes_o:
        dx = _haar_response(iip, margin, h, w, step, _scaled_pattern(_DXX, s))
        dy = _haar_response(iip, margin, h, w, step, _scaled_pattern(_DYY, s))
        dxy = _haar_response(iip, margin, h, w, step, _scaled_pattern(_DXY, s))
        dets.append(dx * dy - 0.81 * dxy * dxy)
        traces.append(dx + dy)
    return torch.stack(dets, dim=-3), torch.stack(traces, dim=-3)


def octave_scores(dets, octave: int, sizes_o, h: int, w: int, min_hessian: float):
    """(B, n_l * h_o * w_o) flat scores of one octave's (B, n_l, h_o, w_o)
    det stack, in (layer, y, x) order: the det at a valid 3x3x3 peak above
    ``min_hessian``, else -inf."""
    n_b, n_l, h_o, w_o = dets.shape
    step = 1 << octave
    n_middle = n_l - 2
    device = dets.device

    # ---- 3x3x3 NMS over the octave's layer stack.
    neighborhood_max = F.max_pool3d(dets[:, None], 3, stride=1, padding=1)[:, 0]
    is_peak = (dets >= neighborhood_max) & (dets > min_hessian)

    # Validity: middle layers only, filter-fit margins (the layer above's
    # size, as NMS compares against it), interior of the strided grid.
    ys = torch.arange(h_o, device=device)[:, None]
    xs = torch.arange(w_o, device=device)[None, :]
    valid_layers = []
    for layer in range(n_l):
        if 1 <= layer <= n_middle:
            m = sizes_o[layer + 1] // 2 + 1
            lv = (
                (ys * step >= m) & (ys * step < h - m)
                & (xs * step >= m) & (xs * step < w - m)
                & (ys >= 1) & (ys < h_o - 1) & (xs >= 1) & (xs < w_o - 1)
            )
        else:
            lv = torch.zeros((h_o, w_o), dtype=torch.bool, device=device)
        valid_layers.append(lv)
    candidates = is_peak & torch.stack(valid_layers)
    return torch.where(candidates, dets, float("-inf")).reshape(n_b, -1)


def _octave_candidates(
    dets, traces, octave: int, sizes_o, h: int, w: int,
    max_keypoints: int, min_hessian: float,
):
    """Top-K refined candidates of one octave of B frames, from (B, n_l, h_o,
    w_o) stacks: (score (B, K), xy (B, K, 2), sigma, laplacian, mask)."""
    n_b, n_l, h_o, w_o = dets.shape
    step = 1 << octave
    device = dets.device

    # ---- top-K within the octave.
    flat_scores = octave_scores(dets, octave, sizes_o, h, w, min_hessian)
    k = min(max_keypoints, flat_scores.shape[-1])
    scores, idx = top_k(flat_scores, k)
    if k < max_keypoints:
        pad = max_keypoints - k
        scores = F.pad(scores, (0, pad), value=float("-inf"))
        idx = F.pad(idx, (0, pad))
    l_idx = idx // (h_o * w_o)
    rem = idx % (h_o * w_o)
    y_idx = rem // w_o
    x_idx = rem % w_o
    mask = torch.isfinite(scores) & (scores > min_hessian)
    frame = torch.arange(n_b, device=device)[:, None]

    # ---- batched quadratic sub-pixel / sub-scale refinement.
    def nb(dl, dy, dx):
        ll = torch.clamp(l_idx + dl, 0, n_l - 1)
        yy = torch.clamp(y_idx + dy, 1, h_o - 2)
        xx = torch.clamp(x_idx + dx, 1, w_o - 2)
        return dets[frame, ll, yy, xx]

    d_l = 0.5 * (nb(1, 0, 0) - nb(-1, 0, 0))
    d_y = 0.5 * (nb(0, 1, 0) - nb(0, -1, 0))
    d_x = 0.5 * (nb(0, 0, 1) - nb(0, 0, -1))
    c = nb(0, 0, 0)
    d_ll = nb(1, 0, 0) + nb(-1, 0, 0) - 2 * c
    d_yy = nb(0, 1, 0) + nb(0, -1, 0) - 2 * c
    d_xx = nb(0, 0, 1) + nb(0, 0, -1) - 2 * c
    d_ly = 0.25 * (nb(1, 1, 0) - nb(1, -1, 0) - nb(-1, 1, 0) + nb(-1, -1, 0))
    d_lx = 0.25 * (nb(1, 0, 1) - nb(1, 0, -1) - nb(-1, 0, 1) + nb(-1, 0, -1))
    d_yx = 0.25 * (nb(0, 1, 1) - nb(0, 1, -1) - nb(0, -1, 1) + nb(0, -1, -1))
    H3 = torch.stack(
        [
            torch.stack([d_ll, d_ly, d_lx], -1),
            torch.stack([d_ly, d_yy, d_yx], -1),
            torch.stack([d_lx, d_yx, d_xx], -1),
        ],
        -2,
    )
    g = torch.stack([d_l, d_y, d_x], -1)
    offset = torch.clamp(-_solve33(H3, g), -1.0, 1.0)  # (B, K, 3) in (layer, y, x)

    # ---- assemble in image coordinates (strided-grid units * step).
    sizes_arr = torch.tensor(sizes_o, dtype=torch.float32, device=device)
    base_size = sizes_arr[l_idx]
    size_step = float(6 << octave)
    sigma = 1.2 * (base_size + offset[..., 0] * size_step) / 9.0
    xy = torch.stack(
        [
            (x_idx.to(torch.float32) + offset[..., 2]) * step,
            (y_idx.to(torch.float32) + offset[..., 1]) * step,
        ],
        -1,
    )
    lap = torch.sign(traces[frame, l_idx, y_idx, x_idx])
    return scores, xy, sigma, lap, mask


def surf_margin(n_octaves: int, n_layers: int) -> int:
    """The padded table's margin: box corners lie within [-size//2, size -
    size//2] of the pixel, for the largest size; +2 slack."""
    return filter_sizes(n_octaves, n_layers)[-1][-1] // 2 + 2


def detect_surf_reference(
    img: torch.Tensor,
    max_keypoints: int = 512,
    min_hessian: float = 50.0,
    n_octaves: int = 4,
    n_layers: int = 3,
):
    """The plain version of :func:`detect_surf` on (B, H, W) frames: the
    fields of ``Keypoints``, each leading with B."""
    _, h, w = img.shape
    sizes = filter_sizes(n_octaves, n_layers)
    margin = surf_margin(n_octaves, n_layers)
    iip = pad_integral(integral_image(img), margin)

    per_octave = []
    for octave in range(n_octaves):
        dets, traces = hessian_octave(iip, margin, h, w, octave, sizes[octave])
        per_octave.append(
            _octave_candidates(
                dets, traces, octave, sizes[octave], h, w,
                max_keypoints, min_hessian,
            )
        )

    # ---- global top-K merge across octaves.
    scores = torch.cat([p[0] for p in per_octave], dim=-1)
    xy = torch.cat([p[1] for p in per_octave], dim=-2)
    sigma = torch.cat([p[2] for p in per_octave], dim=-1)
    lap = torch.cat([p[3] for p in per_octave], dim=-1)
    mask = torch.cat([p[4] for p in per_octave], dim=-1)

    merged = torch.where(mask, scores, float("-inf"))
    top_scores, top_idx = top_k(merged, max_keypoints)
    top_mask = torch.isfinite(top_scores)
    frame = torch.arange(img.shape[0], device=img.device)[:, None]
    xy = xy[frame, top_idx]
    sigma = sigma[frame, top_idx]
    lap = lap[frame, top_idx]
    zero = torch.zeros_like(sigma)
    return (
        torch.where(top_mask[..., None], xy, 0.0),
        torch.where(top_mask, sigma, zero),
        torch.where(top_mask, top_scores, zero),
        torch.where(top_mask, lap, zero),
        top_mask,
    )


def detect_surf(
    img: torch.Tensor,
    max_keypoints: int = 512,
    min_hessian: float = 50.0,
    n_octaves: int = 4,
    n_layers: int = 3,
) -> Keypoints:
    """Up to ``max_keypoints`` SURF keypoints of each (..., H, W) float32 image.

    Slots beyond the number of detections have mask=False and zero fields.
    Leading dimensions are frames and lead every field of the result.  See
    the module doc for the dispatch.
    """
    with span("detect.hessian"):
        *batch, h, w = img.shape
        frames = img.reshape(-1, h, w)
        if cuda_build.use_kernel(frames.device, "detect_surf"):
            fields = surf_hessian.detect(frames, max_keypoints, min_hessian, n_octaves, n_layers,
                                         surf_margin(n_octaves, n_layers))
        else:
            fields = detect_surf_reference(frames, max_keypoints, min_hessian, n_octaves, n_layers)
        return Keypoints(*(f.reshape(*batch, *f.shape[1:]) for f in fields))
