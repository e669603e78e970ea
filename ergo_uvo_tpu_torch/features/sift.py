"""SIFT: DoG pyramid detector and 128-d gradient descriptor.

Counterpart of ``ergo_uvo_tpu/features/sift.py`` (the reference's
``cv::SIFT::create(10000, 3, 0.03, 10, 1.6)``, VO_utility.cpp:101-104).
The same computation on the same fixed shapes; what changes in the
translation:

* the separable blurs add their taps in the JAX package's order
  (:func:`sampling.separable_taps`);
* the 3x3x3 ``reduce_window`` max and min are ``max_pool3d`` of the DoG
  stack and of its negation (both pad with -inf, as the window's init);
* the edge test keeps ``roll`` (it wraps around at the border, as
  ``jnp.roll`` does);
* ``lax.top_k`` is a stable descending sort (:func:`detector.top_k`), and
  ``argmax`` of the orientation histogram takes the first of equal bins, as
  ``jnp.argmax`` does;
* the patch samplers are gathers (:mod:`features.sampling`).

Every function takes leading frame dimensions; nothing is looped over frames.

Spans (:mod:`utils.profiling`), under the frontend's ``detect``:
``detect.sift.scale_space`` (the pyramid), ``detect.sift.extrema`` and
``detect.sift.describe`` (one each an octave), ``detect.sift.select`` (the
merged top-K and its gathers).  The counter ``sift.describe_passes`` adds one
an octave's describe pass: ``n_octaves`` a detection, where the kept
keypoints would need one.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ergo_uvo_tpu_torch.features.detector import Keypoints, top_k
from ergo_uvo_tpu_torch.features.sampling import extract_patches, sample_patch, separable_taps
from ergo_uvo_tpu_torch.geometry.triangulation import _solve33
from ergo_uvo_tpu_torch.utils.profiling import count, span

_N_SPLITS = 8  # orientation bins in the descriptor
_PATCH = 16  # descriptor sample grid (4x4 cells of 4x4 samples)
_DESC_Q = 26  # patch grid around the 16x16 samples, with the gradient margin


def _gauss_kernel(sigma: float):
    r = max(int(math.ceil(3.0 * sigma)), 1)
    x = np.arange(-r, r + 1)
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (B, h, w) images, edge-padded."""
    if sigma <= 0:
        return img
    return separable_taps(img, [float(v) for v in _gauss_kernel(sigma)])


def build_scale_space(img: torch.Tensor, n_octaves: int, n_scales: int, sigma0: float):
    """Per octave (gaussians (B, S+3, h, w), dog (B, S+2, h, w)) of (B, H, W) images."""
    k = 2.0 ** (1.0 / n_scales)
    sig_prev = 0.5  # assumed base-image blur
    base = _blur(img, math.sqrt(max(sigma0**2 - sig_prev**2, 1e-6)))
    octaves = []
    level0 = base
    for _ in range(n_octaves):
        gs = [level0]
        sig = sigma0
        for s in range(1, n_scales + 3):
            sig_next = sigma0 * k**s
            inc = math.sqrt(max(sig_next**2 - sig**2, 1e-6))
            gs.append(_blur(gs[-1], inc))
            sig = sig_next
        g = torch.stack(gs, 1)
        octaves.append((g, g[:, 1:] - g[:, :-1]))
        level0 = gs[n_scales][:, ::2, ::2]  # the 2*sigma0 level
    return octaves


def _octave_keypoints(
    dog, octave: int, n_scales: int, sigma0: float,
    max_keypoints: int, contrast_thresh: float, edge_thresh: float,
):
    """Top-K refined (score, xy, sigma, layer, (y, x), mask) of one octave of
    B frames, each (B, K, ...)."""
    n_b, n_l, h, w = dog.shape
    device = dog.device
    nmax = F.max_pool3d(dog[:, None], 3, stride=1, padding=1)[:, 0]
    nmin = -F.max_pool3d(-dog[:, None], 3, stride=1, padding=1)[:, 0]
    # OpenCV's prefilter: floor(0.5 * contrastThreshold / nOctaveLayers * 255)
    thr = 0.5 * contrast_thresh / n_scales * 255.0  # images are [0, 255]
    is_ext = ((dog >= nmax) & (dog > thr)) | ((dog <= nmin) & (dog < -thr))

    # Edge response: 2x2 spatial Hessian ratio gate (Lowe §4.1).
    def roll(x, sy, sx):
        return torch.roll(x, (sy, sx), (2, 3))

    dxx = roll(dog, 0, -1) + roll(dog, 0, 1) - 2 * dog
    dyy = roll(dog, -1, 0) + roll(dog, 1, 0) - 2 * dog
    dxy = 0.25 * (roll(dog, 1, 1) + roll(dog, -1, -1) - roll(dog, 1, -1) - roll(dog, -1, 1))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_thresh
    edge_ok = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)

    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    border = 8
    interior = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    layers = torch.arange(n_l, device=device)[:, None, None]
    layer_ok = (layers >= 1) & (layers <= n_scales)
    cand = is_ext & edge_ok & interior & layer_ok

    score = torch.where(cand, dog.abs(), float("-inf")).reshape(n_b, -1)
    kk = min(max_keypoints, score.shape[-1])
    scores, idx = top_k(score, kk)
    if kk < max_keypoints:
        scores = F.pad(scores, (0, max_keypoints - kk), value=float("-inf"))
        idx = F.pad(idx, (0, max_keypoints - kk))
    l_i = idx // (h * w)
    rem = idx % (h * w)
    y_i = rem // w
    x_i = rem % w
    mask = torch.isfinite(scores)
    frame = torch.arange(n_b, device=device)[:, None]

    # Quadratic sub-pixel refinement on the |DoG| stationary point.
    def at(dl, dy, dx):
        ll = torch.clamp(l_i + dl, 0, n_l - 1)
        yy = torch.clamp(y_i + dy, 1, h - 2)
        xx = torch.clamp(x_i + dx, 1, w - 2)
        return dog[frame, ll, yy, xx]

    gl = 0.5 * (at(1, 0, 0) - at(-1, 0, 0))
    gy = 0.5 * (at(0, 1, 0) - at(0, -1, 0))
    gx = 0.5 * (at(0, 0, 1) - at(0, 0, -1))
    c = at(0, 0, 0)
    hll = at(1, 0, 0) + at(-1, 0, 0) - 2 * c
    hyy = at(0, 1, 0) + at(0, -1, 0) - 2 * c
    hxx = at(0, 0, 1) + at(0, 0, -1) - 2 * c
    hly = 0.25 * (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0))
    hlx = 0.25 * (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1))
    hyx = 0.25 * (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1))
    H3 = torch.stack(
        [
            torch.stack([hll, hly, hlx], -1),
            torch.stack([hly, hyy, hyx], -1),
            torch.stack([hlx, hyx, hxx], -1),
        ],
        -2,
    )
    g3 = torch.stack([gl, gy, gx], -1)
    off = torch.clamp(-_solve33(H3, g3), -0.5, 0.5)

    step = float(1 << octave)
    xy = torch.stack(
        [(x_i.to(torch.float32) + off[..., 2]) * step, (y_i.to(torch.float32) + off[..., 1]) * step],
        -1,
    )
    sigma = sigma0 * (2.0 ** ((l_i.to(torch.float32) + off[..., 0]) / n_scales)) * step
    return scores, xy, sigma, l_i, (y_i, x_i), mask


def _orientations_and_desc(gauss, l_i, y_i, x_i, sigma_rel, mask, n_scales: int):
    """(angle (B, K), desc (B, K, 128)) from one octave's Gaussian stack
    (B, S+3, h, w); ``sigma_rel`` is the keypoint sigma in this octave's
    pixels.  One axis-aligned patch per keypoint from its layer, gradients
    by central differences in patch space, a 36-bin orientation histogram,
    then the rotated 16x16 grid sampled inside the gradient patches."""
    n_b, n_k = l_i.shape
    device = gauss.device
    spacing = 3.0 * sigma_rel / _PATCH * 2.0  # (B, K) ~radius 3*sigma
    x_f = x_i.to(torch.float32)
    y_f = y_i.to(torch.float32)
    patches = torch.zeros((n_b, n_k, _DESC_Q, _DESC_Q), dtype=gauss.dtype, device=device)
    for layer in range(1, n_scales + 1):  # keypoints only sit on these layers
        p_l = extract_patches(gauss[:, layer], x_f, y_f, spacing, _DESC_Q)
        patches = patches + torch.where((l_i == layer)[..., None, None], p_l, 0.0)
    patches = patches.reshape(-1, _DESC_Q, _DESC_Q)  # (N = B*K, Q, Q)
    n = patches.shape[0]

    # Central-difference gradients at interior patch indices 1.._DESC_Q-2.
    dxc = 0.5 * (patches[:, 1:-1, 2:] - patches[:, 1:-1, :-2])
    dyc = 0.5 * (patches[:, 2:, 1:-1] - patches[:, :-2, 1:-1])

    # ---- orientation: the un-rotated 16x16 grid = patch indices 5..20,
    # i.e. rows/cols 4..19 of the interior gradient patches.
    g1 = torch.arange(_PATCH, dtype=torch.float32, device=device) - (_PATCH - 1) / 2.0
    gy_, gx_ = torch.meshgrid(g1, g1, indexing="ij")
    lo = (_DESC_Q - _PATCH) // 2 - 1  # = 4
    dx0 = dxc[:, lo:lo + _PATCH, lo:lo + _PATCH]
    dy0 = dyc[:, lo:lo + _PATCH, lo:lo + _PATCH]
    mag0 = torch.sqrt(dx0 * dx0 + dy0 * dy0)
    th0 = torch.atan2(dy0, dx0)
    gw = torch.exp(-(gx_**2 + gy_**2) / (2.0 * (_PATCH / 3.0) ** 2))
    # 36-bin histogram, soft-assigned.
    nb = 36
    b = (th0 + math.pi) / (2 * math.pi) * nb
    b0 = torch.floor(b)
    fb = (b - b0).reshape(n, -1)
    b0i = b0.to(torch.int64).reshape(n, -1) % nb
    b1i = (b0i + 1) % nb
    wgt = (mag0 * gw).reshape(n, -1)
    bins = torch.arange(nb, device=device)
    onehot0 = (b0i[..., None] == bins).to(torch.float32)
    onehot1 = (b1i[..., None] == bins).to(torch.float32)
    hist = torch.einsum("ks,ksb->kb", wgt * (1 - fb), onehot0)
    hist = hist + torch.einsum("ks,ksb->kb", wgt * fb, onehot1)
    for _ in range(2):  # circular smooth x2
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    peak = torch.argmax(hist, -1)
    angle = (peak.to(torch.float32) + 0.5) / nb * 2 * math.pi - math.pi

    # ---- descriptor: rotated 16x16 gradient grid, 4x4 cells x 8 bins;
    # patch index p is gradient index p - 1, so the patch center
    # (_DESC_Q-1)/2 sits at (_DESC_Q-3)/2 in dxc/dyc coordinates.
    ca, sa = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    rx = ca * gx_ - sa * gy_
    ry = sa * gx_ + ca * gy_
    c_int = (_DESC_Q - 3) / 2.0
    u = (c_int + ry).reshape(n, -1)
    v = (c_int + rx).reshape(n, -1)
    dx1 = sample_patch(dxc, u, v).reshape(n, _PATCH, _PATCH)
    dy1 = sample_patch(dyc, u, v).reshape(n, _PATCH, _PATCH)
    mag1 = (torch.sqrt(dx1 * dx1 + dy1 * dy1) * gw).reshape(n, -1)
    th1 = torch.atan2(dy1, dx1) - angle[:, None, None]
    bd = torch.remainder((th1 + math.pi) / (2 * math.pi) * _N_SPLITS, _N_SPLITS)
    bd0 = torch.floor(bd)
    fd = (bd - bd0).reshape(n, -1)
    bd0i = bd0.to(torch.int64).reshape(n, -1) % _N_SPLITS
    bd1i = (bd0i + 1) % _N_SPLITS
    obins = torch.arange(_N_SPLITS, device=device)
    w0 = (mag1 * (1 - fd))[..., None] * (bd0i[..., None] == obins)
    w1 = (mag1 * fd)[..., None] * (bd1i[..., None] == obins)
    contrib = (w0 + w1).reshape(n, _PATCH, _PATCH, _N_SPLITS)
    cells = contrib.reshape(n, 4, 4, 4, 4, _N_SPLITS).sum(dim=(2, 4))  # (N, 4, 4, 8)
    desc = cells.reshape(n, 128)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-12)
    desc = torch.clamp(desc, max=0.2)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-12)
    desc = desc.reshape(n_b, n_k, 128)
    return angle.reshape(n_b, n_k), torch.where(mask[..., None], desc, 0.0)


def detect_and_describe_sift(
    img: torch.Tensor,
    max_keypoints: int = 512,
    n_octaves: int = 4,
    n_scales: int = 3,
    sigma0: float = 1.6,
    contrast_thresh: float = 0.03,
    edge_thresh: float = 10.0,
):
    """(Keypoints, (..., K, 128) descriptors) of (..., H, W) images;
    ``laplacian`` carries the angle."""
    *batch, h, w = img.shape
    img = img.reshape(-1, h, w)
    frame = torch.arange(img.shape[0], device=img.device)[:, None]
    per = []
    with span("detect.sift.scale_space"):
        octaves = build_scale_space(img, n_octaves, n_scales, sigma0)
    for o, (gauss, dog) in enumerate(octaves):
        with span("detect.sift.extrema"):
            scores, xy, sigma, l_i, (y_i, x_i), mask = _octave_keypoints(
                dog, o, n_scales, sigma0, max_keypoints, contrast_thresh, edge_thresh
            )
        with span("detect.sift.describe"):
            count("sift.describe_passes")
            sigma_rel = sigma / float(1 << o)
            angle, desc = _orientations_and_desc(gauss, l_i, y_i, x_i, sigma_rel, mask, n_scales)
        per.append((torch.where(mask, scores, float("-inf")), xy, sigma, angle, mask, desc))

    with span("detect.sift.select"):
        scores = torch.cat([p[0] for p in per], -1)
        xy = torch.cat([p[1] for p in per], -2)
        sigma = torch.cat([p[2] for p in per], -1)
        ang = torch.cat([p[3] for p in per], -1)
        mask = torch.cat([p[4] for p in per], -1)
        desc = torch.cat([p[5] for p in per], -2)
        top_s, top_i = top_k(torch.where(mask, scores, float("-inf")), max_keypoints)
        top_m = torch.isfinite(top_s)
        kpts = Keypoints(
            xy=torch.where(top_m[..., None], xy[frame, top_i], 0.0),
            scale=torch.where(top_m, sigma[frame, top_i], 0.0),
            score=torch.where(top_m, top_s, 0.0),
            laplacian=torch.where(top_m, ang[frame, top_i], 0.0),
            mask=top_m,
        )
        d = torch.where(top_m[..., None], desc[frame, top_i], 0.0)
    return (Keypoints(*(f.reshape(*batch, *f.shape[1:]) for f in kpts)),
            d.reshape(*batch, max_keypoints, 128))
