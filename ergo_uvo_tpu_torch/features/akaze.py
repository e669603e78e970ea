"""AKAZE: nonlinear-diffusion scale space and the M-LDB binary descriptor.

Counterpart of ``ergo_uvo_tpu/features/akaze.py`` (the reference's
``cv::AKAZE::create()`` with its stock defaults, VO_utility.cpp:93-98).
The same computation on the same fixed shapes; what changes in the
translation:

* edge padding is ``F.pad(mode="replicate")``, and the separable blur adds
  its taps in the JAX package's order (:mod:`features.sampling`);
* the contrast factor, ``jnp.nanpercentile(..., 70)`` (linear method), is
  ``torch.nanquantile(q=0.7, interpolation="linear")``;
* the 3x3x3 ``reduce_window`` max is ``max_pool3d``, which pads with -inf;
* ``lax.top_k`` is a stable descending sort (:func:`detector.top_k`).

The step counts of the diffusion come from the static sigma schedule, as in
the JAX package: at 4 octaves x 4 sublevels some 50 explicit steps.  The
M-LDB tables (:data:`_CENTERS`, :data:`_HALVES`, :data:`_SUB`,
:data:`_PAIRS`) are the JAX package's numpy tables.  Every function takes
leading frame dimensions; nothing is looped over frames.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ergo_uvo_tpu_torch.device import upload
from ergo_uvo_tpu_torch.features.detector import Keypoints, top_k
from ergo_uvo_tpu_torch.features.sampling import edge_pad, separable_taps
from ergo_uvo_tpu_torch.geometry.triangulation import _solve33

SIGMA0 = 1.6  # base scale after initial smoothing (paper §3)
TAU_MAX = 0.25  # 2-D explicit-diffusion stability limit
DESCRIPTOR_BITS = 512  # 486 M-LDB bits zero-padded


def _gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian of (B, h, w) images, edge-padded."""
    radius = max(int(math.ceil(3.0 * sigma)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return separable_taps(img, [float(v) for v in (k / k.sum()).astype(np.float32)])


def _grad(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradient with edge-replicated borders."""
    pad = edge_pad(img, 1, 1)
    h, w = img.shape[-2:]
    gx = 0.5 * (pad[:, 1:h + 1, 2:] - pad[:, 1:h + 1, :w])
    gy = 0.5 * (pad[:, 2:, 1:w + 1] - pad[:, :h, 1:w + 1])
    return gx, gy


def _diffusion_step(L: torch.Tensor, g: torch.Tensor, tau: float) -> torch.Tensor:
    """One explicit step of dL/dt = div(g * grad L): conductivities averaged
    onto the half-grid edges, zero flux at the border (edge padding)."""
    h, w = L.shape[-2:]
    Lp = edge_pad(L, 1, 1)
    gp = edge_pad(g, 1, 1)

    def sh(dy, dx, a):
        return a[:, 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]

    c = sh(0, 0, gp)
    flux = (
        (sh(0, 1, gp) + c) * (sh(0, 1, Lp) - L)
        + (sh(0, -1, gp) + c) * (sh(0, -1, Lp) - L)
        + (sh(1, 0, gp) + c) * (sh(1, 0, Lp) - L)
        + (sh(-1, 0, gp) + c) * (sh(-1, 0, Lp) - L)
    )
    return L + (0.5 * tau) * flux


def _contrast_factor(img: torch.Tensor, percentile: float = 70.0) -> torch.Tensor:
    """(B,) k = the ``percentile`` of the gradient magnitude of the smoothed
    images, flat pixels (|grad| <= 1e-8) left out (paper §3.2)."""
    gx, gy = _grad(_gaussian_blur(img, SIGMA0))
    mag = torch.sqrt(gx * gx + gy * gy).flatten(1)
    k = torch.nanquantile(torch.where(mag > 1e-8, mag, float("nan")), percentile / 100.0,
                          dim=-1, interpolation="linear")
    return torch.clamp(torch.nan_to_num(k, nan=0.01), min=1e-3)


def _sigma_schedule(n_octaves: int, n_sublevels: int):
    """Global sigmas sigma0 * 2^(o + s/S) for every evolution level."""
    return [
        [SIGMA0 * 2.0 ** (o + s / n_sublevels) for s in range(n_sublevels)]
        for o in range(n_octaves)
    ]


def build_nonlinear_scale_space(img: torch.Tensor, n_octaves: int = 4, n_sublevels: int = 4):
    """Per octave a (B, S, h_o, w_o) stack of diffused (B, H, W) images.

    The images are normalized to [0, 1].  Between consecutive levels the
    diffusion-time gap is split into ceil(dt / TAU_MAX) explicit steps; each
    octave halves the grid (time / 4, k^2 * 4); the g2 conductivity
    ``1 / (1 + |grad L|^2 / k^2)`` is taken once a level from the current image.
    """
    img = img.to(torch.float32) / 255.0
    L = _gaussian_blur(img, SIGMA0)
    k = _contrast_factor(img)
    k2 = (k * k)[:, None, None]
    sigmas = _sigma_schedule(n_octaves, n_sublevels)

    octave_stacks = []
    t_local = 0.5 * SIGMA0 * SIGMA0  # accumulated time in current-octave units
    for o in range(n_octaves):
        if o > 0:
            L = L[:, ::2, ::2]
            t_local = t_local / 4.0
            k2 = k2 * 4.0
        levels = []
        for s in range(n_sublevels):
            t_target = 0.5 * (sigmas[o][s] / (1 << o)) ** 2
            dt = t_target - t_local
            n_steps = max(int(math.ceil(dt / TAU_MAX)), 0)
            if n_steps:
                tau = dt / n_steps
                gx, gy = _grad(L)
                g = 1.0 / (1.0 + (gx * gx + gy * gy) / k2)
                for _ in range(n_steps):
                    L = _diffusion_step(L, g, tau)
            t_local = t_target
            levels.append(L)
        octave_stacks.append(torch.stack(levels, 1))
    return octave_stacks


def _level_derivatives(L: torch.Tensor, delta: int):
    """First/second differences of (B, h, w) at step ``delta``."""
    h, w = L.shape[-2:]
    p = edge_pad(L, delta, delta)

    def sh(dy, dx):
        return p[:, delta + dy: delta + dy + h, delta + dx: delta + dx + w]

    inv = 1.0 / (2.0 * delta)
    lx = (sh(0, delta) - sh(0, -delta)) * inv
    ly = (sh(delta, 0) - sh(-delta, 0)) * inv
    lxx = (sh(0, delta) + sh(0, -delta) - 2.0 * L) / (delta * delta)
    lyy = (sh(delta, 0) + sh(-delta, 0) - 2.0 * L) / (delta * delta)
    lxy = (
        sh(delta, delta) - sh(delta, -delta)
        - sh(-delta, delta) + sh(-delta, -delta)
    ) / (4.0 * delta * delta)
    return lx, ly, lxx, lyy, lxy


def _octave_response(stack: torch.Tensor, o: int, sigmas_o):
    """(B, S, h_o, w_o) sigma^4-normalized det-Hessian and per-level (Lx, Ly)."""
    dets, lxs, lys = [], [], []
    for s in range(stack.shape[1]):
        sig_local = sigmas_o[s] / (1 << o)
        delta = max(int(round(sig_local)), 1)
        lx, ly, lxx, lyy, lxy = _level_derivatives(stack[:, s], delta)
        norm = sig_local**4
        dets.append(norm * (lxx * lyy - lxy * lxy))
        lxs.append(lx)
        lys.append(ly)
    return torch.stack(dets, 1), torch.stack(lxs, 1), torch.stack(lys, 1)


def _octave_candidates_akaze(dets, o: int, sigmas_o, max_keypoints: int, threshold: float):
    """Fixed top-K 3x3x3 NMS peaks of one octave stack (B, S, h_o, w_o),
    refined by a quadratic fit: (score, xy, sigma, sublevel, mask)."""
    n_b, S, h_o, w_o = dets.shape
    device = dets.device
    step = 1 << o
    nmax = F.max_pool3d(dets[:, None], 3, stride=1, padding=1)[:, 0]
    is_peak = (dets >= nmax) & (dets > threshold)
    ys = torch.arange(h_o, device=device)[:, None]
    xs = torch.arange(w_o, device=device)[None, :]
    border = max(int(round(sigmas_o[-1] / step)) + 1, 2)
    interior = (ys >= border) & (ys < h_o - border) & (xs >= border) & (xs < w_o - border)
    flat = torch.where(is_peak & interior, dets, float("-inf")).reshape(n_b, -1)
    k = min(max_keypoints, flat.shape[-1])
    scores, idx = top_k(flat, k)
    if k < max_keypoints:
        scores = F.pad(scores, (0, max_keypoints - k), value=float("-inf"))
        idx = F.pad(idx, (0, max_keypoints - k))
    s_idx = idx // (h_o * w_o)
    rem = idx % (h_o * w_o)
    y_idx = rem // w_o
    x_idx = rem % w_o
    mask = torch.isfinite(scores)
    frame = torch.arange(n_b, device=device)[:, None]

    def nb(ds, dy, dx):
        ss = torch.clamp(s_idx + ds, 0, S - 1)
        yy = torch.clamp(y_idx + dy, 1, h_o - 2)
        xx = torch.clamp(x_idx + dx, 1, w_o - 2)
        return dets[frame, ss, yy, xx]

    c = nb(0, 0, 0)
    d_s = 0.5 * (nb(1, 0, 0) - nb(-1, 0, 0))
    d_y = 0.5 * (nb(0, 1, 0) - nb(0, -1, 0))
    d_x = 0.5 * (nb(0, 0, 1) - nb(0, 0, -1))
    d_ss = nb(1, 0, 0) + nb(-1, 0, 0) - 2 * c
    d_yy = nb(0, 1, 0) + nb(0, -1, 0) - 2 * c
    d_xx = nb(0, 0, 1) + nb(0, 0, -1) - 2 * c
    d_sy = 0.25 * (nb(1, 1, 0) - nb(1, -1, 0) - nb(-1, 1, 0) + nb(-1, -1, 0))
    d_sx = 0.25 * (nb(1, 0, 1) - nb(1, 0, -1) - nb(-1, 0, 1) + nb(-1, 0, -1))
    d_yx = 0.25 * (nb(0, 1, 1) - nb(0, 1, -1) - nb(0, -1, 1) + nb(0, -1, -1))
    H3 = torch.stack(
        [
            torch.stack([d_ss, d_sy, d_sx], -1),
            torch.stack([d_sy, d_yy, d_yx], -1),
            torch.stack([d_sx, d_yx, d_xx], -1),
        ],
        -2,
    )
    g = torch.stack([d_s, d_y, d_x], -1)
    off = torch.clamp(-_solve33(H3, g), -1.0, 1.0)

    sig_arr = upload(np.asarray(sigmas_o, np.float32), device)
    sub_ratio = 2.0 ** (1.0 / len(sigmas_o))
    sigma = sig_arr[s_idx] * sub_ratio ** off[..., 0]
    xy = torch.stack(
        [(x_idx.to(torch.float32) + off[..., 2]) * step, (y_idx.to(torch.float32) + off[..., 1]) * step],
        -1,
    )
    return scores, xy, sigma, s_idx, mask


def detect_akaze(
    img: torch.Tensor,
    max_keypoints: int = 512,
    threshold: float = 1e-3,
    n_octaves: int = 4,
    n_sublevels: int = 4,
):
    """AKAZE keypoints of (B, H, W) float images (0..255 gray).

    Returns (Keypoints, scale_space): per octave the (L, Lx, Ly) stacks that
    :func:`describe_akaze` samples.  ``laplacian`` carries the keypoint's
    global evolution level (octave * S + sublevel) as a float.
    """
    n_b = img.shape[0]
    stacks = build_nonlinear_scale_space(img, n_octaves, n_sublevels)
    sigmas = _sigma_schedule(n_octaves, n_sublevels)

    per_octave, space = [], []
    for o in range(n_octaves):
        dets, lxs, lys = _octave_response(stacks[o], o, sigmas[o])
        space.append((stacks[o], lxs, lys))
        sc, xy, sg, s_idx, m = _octave_candidates_akaze(dets, o, sigmas[o], max_keypoints, threshold)
        level = (o * n_sublevels + s_idx).to(torch.float32)
        per_octave.append((torch.where(m, sc, float("-inf")), xy, sg, level, m))

    scores = torch.cat([p[0] for p in per_octave], -1)
    xy = torch.cat([p[1] for p in per_octave], -2)
    sigma = torch.cat([p[2] for p in per_octave], -1)
    level = torch.cat([p[3] for p in per_octave], -1)
    mask = torch.cat([p[4] for p in per_octave], -1)
    top_scores, top_idx = top_k(torch.where(mask, scores, float("-inf")), max_keypoints)
    top_mask = torch.isfinite(top_scores)
    frame = torch.arange(n_b, device=img.device)[:, None]
    kpts = Keypoints(
        xy=torch.where(top_mask[..., None], xy[frame, top_idx], 0.0),
        scale=torch.where(top_mask, sigma[frame, top_idx], 0.0),
        score=torch.where(top_mask, top_scores, 0.0),
        laplacian=torch.where(top_mask, level[frame, top_idx], 0.0),
        mask=top_mask,
    )
    return kpts, space


def _bilinear_stack(stack: torch.Tensor, s_idx: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Clamped bilinear samples of a (B, S, h, w) stack at sublevel ``s_idx``
    and (x, y), all (B, N)."""
    n_b, S, h, w = stack.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    flat = stack.reshape(n_b, -1)
    base = s_idx * (h * w)

    def at(yi, xi):
        return torch.gather(flat, 1, base + yi * w + xi)

    top = at(y0i, x0i) * (1 - wx) + at(y0i, x1i) * wx
    bot = at(y1i, x0i) * (1 - wx) + at(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


def _mldb_cells():
    """Static cell-center offsets (unit pattern, extent [-1, 1]) and the
    3x3 intra-cell sample offsets, plus the C(n^2, 2) pair index table."""
    cells = []
    for n in (2, 3, 4):
        edges = np.linspace(-1.0, 1.0, n + 1)
        c = 0.5 * (edges[:-1] + edges[1:])
        half = 1.0 / n  # half cell width
        for cy in c:
            for cx in c:
                cells.append((cx, cy, half))
    centers = np.asarray([(c[0], c[1]) for c in cells], np.float32)  # (29, 2)
    halves = np.asarray([c[2] for c in cells], np.float32)  # (29,)
    # 3x3 sample offsets within a unit half-width cell (interior points).
    g = np.asarray([-0.6, 0.0, 0.6], np.float32)
    sub = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)  # (9,2)
    pairs = []
    off = 0
    for n in (2, 3, 4):
        m = n * n
        for i in range(m):
            for j in range(i + 1, m):
                pairs.append((off + i, off + j))
        off += m
    return centers, halves, sub, np.asarray(pairs, np.int32)  # 162 pairs


_CENTERS, _HALVES, _SUB, _PAIRS = _mldb_cells()
PATTERN_EXTENT = 5.0  # pattern half-width in units of sigma (M-LDB scale 10s)


def _orientation(space, kpts: Keypoints, n_sublevels: int) -> torch.Tensor:
    """(B, K) dominant gradient direction: the Gaussian-weighted mean of
    (Lx, Ly) over a radius-6-sigma disc at the keypoint's evolution level."""
    g = np.linspace(-1.0, 1.0, 7, dtype=np.float32)
    gy, gx = np.meshgrid(g, g, indexing="ij")
    disc = (gx**2 + gy**2) <= 1.0
    device = kpts.xy.device
    wgt = upload((np.exp(-(gx**2 + gy**2) / 0.5) * disc).astype(np.float32), device).reshape(-1)
    gx = upload(gx, device)
    gy = upload(gy, device)

    n_b, n_k = kpts.mask.shape
    level = kpts.laplacian.to(torch.int64)
    sum_x = torch.zeros((n_b, n_k), dtype=torch.float32, device=device)
    sum_y = torch.zeros((n_b, n_k), dtype=torch.float32, device=device)
    for o, (_, lxs, lys) in enumerate(space):
        sel = level // n_sublevels == o
        s_idx = torch.clamp(level - o * n_sublevels, 0, lxs.shape[1] - 1)
        step = float(1 << o)
        r = 6.0 * kpts.scale / step  # disc radius, octave-local pixels
        sx = kpts.xy[..., 0:1, None] / step + r[..., None, None] * gx
        sy = kpts.xy[..., 1:2, None] / step + r[..., None, None] * gy
        sflat = torch.broadcast_to(s_idx[..., None, None], sx.shape).reshape(n_b, -1)
        vx = _bilinear_stack(lxs, sflat, sx.reshape(n_b, -1), sy.reshape(n_b, -1))
        vy = _bilinear_stack(lys, sflat, sx.reshape(n_b, -1), sy.reshape(n_b, -1))
        wx = (vx.reshape(n_b, n_k, -1) * wgt).sum(-1)
        wy = (vy.reshape(n_b, n_k, -1) * wgt).sum(-1)
        sum_x = torch.where(sel, wx, sum_x)
        sum_y = torch.where(sel, wy, sum_y)
    return torch.atan2(sum_y, sum_x)


def describe_akaze(space, kpts: Keypoints, n_sublevels: int = 4, upright: bool = False) -> torch.Tensor:
    """(B, K, 512) float32 {0,1} M-LDB bits; invalid rows -> 0.

    For each keypoint: the means of (L, Lx', Ly'), gradients rotated into
    the keypoint frame, over 29 cells (2x2 + 3x3 + 4x4) of the rotated
    pattern, each from 3x3 bilinear samples at the keypoint's evolution
    level; then 162 pairwise comparisons x 3 channels = 486 bits, zero-padded
    to 512.
    """
    n_b, n_k = kpts.mask.shape
    device = kpts.xy.device
    angle = (torch.zeros((n_b, n_k), dtype=torch.float32, device=device) if upright
             else _orientation(space, kpts, n_sublevels))
    ca, sa = torch.cos(angle), torch.sin(angle)
    level = kpts.laplacian.to(torch.int64)

    centers = upload(_CENTERS, device)  # (C, 2) unit-pattern cell centers
    halves = upload(_HALVES, device)  # (C,)
    sub = upload(_SUB, device)  # (P, 2)
    pts = centers[:, None, :] + halves[:, None, None] * sub[None]  # (C, P, 2)
    C, Pn, _ = pts.shape

    means = torch.zeros((n_b, n_k, C, 3), dtype=torch.float32, device=device)
    for o, (ls, lxs, lys) in enumerate(space):
        sel = level // n_sublevels == o
        s_idx = torch.clamp(level - o * n_sublevels, 0, ls.shape[1] - 1)
        step = float(1 << o)
        ext = PATTERN_EXTENT * kpts.scale  # (B, K) pattern half-width, px
        px = pts[..., 0] * ext[..., None, None]  # (B, K, C, P)
        py = pts[..., 1] * ext[..., None, None]
        rx = ca[..., None, None] * px - sa[..., None, None] * py
        ry = sa[..., None, None] * px + ca[..., None, None] * py
        sx = ((kpts.xy[..., 0, None, None] + rx) / step).reshape(n_b, -1)
        sy = ((kpts.xy[..., 1, None, None] + ry) / step).reshape(n_b, -1)
        sflat = torch.broadcast_to(s_idx[..., None, None], rx.shape).reshape(n_b, -1)
        vL = _bilinear_stack(ls, sflat, sx, sy)
        vx = _bilinear_stack(lxs, sflat, sx, sy)
        vy = _bilinear_stack(lys, sflat, sx, sy)
        mL = vL.reshape(n_b, n_k, C, Pn).mean(-1)
        mx = vx.reshape(n_b, n_k, C, Pn).mean(-1)
        my = vy.reshape(n_b, n_k, C, Pn).mean(-1)
        # Rotate gradients into the keypoint frame (OpenCV M-LDB).
        mxr = ca[..., None] * mx + sa[..., None] * my
        myr = -sa[..., None] * mx + ca[..., None] * my
        m_o = torch.stack([mL, mxr, myr], -1)  # (B, K, C, 3)
        means = torch.where(sel[..., None, None], m_o, means)

    pairs = upload(_PAIRS.astype(np.int64), device)
    diff = means[:, :, pairs[:, 0]] - means[:, :, pairs[:, 1]]  # (B, K, 162, 3)
    bits = (diff > 0).to(torch.float32).reshape(n_b, n_k, -1)  # (B, K, 486)
    bits = F.pad(bits, (0, DESCRIPTOR_BITS - bits.shape[-1]))
    return torch.where(kpts.mask[..., None], bits, 0.0)


def detect_and_describe_akaze(
    img: torch.Tensor,
    max_keypoints: int = 512,
    threshold: float = 1e-3,
    n_octaves: int = 4,
    n_sublevels: int = 4,
    upright: bool = False,
):
    """(Keypoints, (..., K, 512) binary descriptors) of (..., H, W) images."""
    *batch, h, w = img.shape
    kpts, space = detect_akaze(img.reshape(-1, h, w), max_keypoints, threshold, n_octaves,
                               n_sublevels)
    desc = describe_akaze(space, kpts, n_sublevels, upright)
    return (Keypoints(*(f.reshape(*batch, *f.shape[1:]) for f in kpts)),
            desc.reshape(*batch, max_keypoints, DESCRIPTOR_BITS))
