"""SIFT: the plain version of the port's ``features/sift.py``.

The reference node's SIFT is OpenCV's ``cv::SIFT::create(10000, 3, 0.03, 10,
1.6)`` (``VO_utility.cpp:101-104``).  This file follows the port's mathematics
one frame at a time: a Gaussian scale space of 4 octaves x 6 levels, its
difference-of-Gaussians stack, extrema over the 26 neighbours with OpenCV's
contrast prefilter and Lowe's edge test, a quadratic refinement, a 36-bin
orientation and a 4x4x8 descriptor clipped at 0.2.

Where the port's SIFT departs from OpenCV's, and so this file with it:

* a budget of ``max_keypoints`` (512 under the benchmark's configuration, what
  the port's ``load_vo_params`` gives) where OpenCV keeps up to 10,000: each
  octave keeps its 512 strongest extrema, then the 512 strongest of all;
* 4 octaves from the image itself, assumed blurred by 0.5 px, without
  OpenCV's doubled first octave;
* one quadratic step, its offset clamped to +-0.5, with no re-localisation
  and no second contrast test after it; an 8 px border;
* one orientation a keypoint, the first highest bin of the histogram smoothed
  twice by [1, 1, 1] / 3, where OpenCV adds a keypoint for each peak over 80%;
* axis-aligned sample patches: 26 x 26 bilinear samples of the keypoint's
  layer at a spacing of 3 sigma / 8, zero where a tap falls off the image;
  gradients by central differences in patch space; the 16 x 16 descriptor
  grid is rotated inside the gradient patches;
* each sample goes to its cell with its two orientation bins' weights alone
  (no trilinear spreading over cells), and the descriptor stays float.

The histograms are one-hot ``einsum``s, computed in true float32.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from uvo_bench.reference.features.detector import Keypoints, top_k
from uvo_bench.reference.features.sampling import extract_patches, sample_patch, separable_taps
from uvo_bench.reference.geometry.triangulation import _solve33

N_OCTAVES, N_SCALES, SIGMA0 = 4, 3, 1.6  # OpenCV's nOctaveLayers 3 and sigma 1.6
BORDER = 8  # px of every octave where no keypoint is taken
PATCH = 16  # the descriptor's sample grid: 4 x 4 cells of 4 x 4 samples
Q = 26  # the patch around it, with the margin the gradients need
ORI_BINS, DESC_BINS = 36, 8


@contextlib.contextmanager
def _float32():
    """Matmuls and convolutions in true float32 inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def gaussian_taps(sigma: float) -> list[float]:
    """The normalised Gaussian of radius ceil(3 sigma), in float32."""
    r = max(int(math.ceil(3.0 * sigma)), 1)
    x = np.arange(-r, r + 1)
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return [float(v) for v in (k / k.sum()).astype(np.float32)]


def blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """A (h, w) image blurred by ``sigma``, edge-padded."""
    return separable_taps(img[None], gaussian_taps(sigma))[0]


def scale_space(img: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(Gaussians (S+3, h, w), DoG (S+2, h, w)) of each octave of one (H, W) image.
    Each level blurs the one before by the increment to its sigma; an octave
    starts from the 2 sigma0 level of the one before, taken at every second
    pixel."""
    k = 2.0 ** (1.0 / N_SCALES)
    level0 = blur(img, math.sqrt(SIGMA0**2 - 0.5**2))
    octaves = []
    for _ in range(N_OCTAVES):
        levels = [level0]
        for s in range(1, N_SCALES + 3):
            levels.append(blur(levels[-1], math.sqrt((SIGMA0 * k**s) ** 2
                                                     - (SIGMA0 * k ** (s - 1)) ** 2)))
        g = torch.stack(levels)
        octaves.append((g, g[1:] - g[:-1]))
        level0 = levels[N_SCALES][::2, ::2]
    return octaves


def _neighbours(dog: torch.Tensor, fill: float):
    """The 26 neighbours of every DoG sample, ``fill`` beyond the stack."""
    n_l, h, w = dog.shape
    p = F.pad(dog[None, None], (1, 1, 1, 1, 1, 1), value=fill)[0, 0]
    for dl in range(3):
        for dy in range(3):
            for dx in range(3):
                if (dl, dy, dx) != (1, 1, 1):
                    yield p[dl:dl + n_l, dy:dy + h, dx:dx + w]


def octave_keypoints(dog: torch.Tensor, octave: int, max_keypoints: int,
                     contrast_thresh: float, edge_thresh: float):
    """The strongest ``max_keypoints`` extrema of one octave's DoG stack, refined:
    (|DoG|, xy in image px, sigma in image px, layer, row, column, mask),
    each (K,) or (K, 2)."""
    n_l, h, w = dog.shape
    is_max = torch.ones_like(dog, dtype=torch.bool)
    is_min = torch.ones_like(dog, dtype=torch.bool)
    for v in _neighbours(dog, float("-inf")):
        is_max &= dog >= v
    for v in _neighbours(dog, float("inf")):
        is_min &= dog <= v
    thr = 0.5 * contrast_thresh / N_SCALES * 255.0  # OpenCV's prefilter; images are 0-255
    extremum = (is_max & (dog > thr)) | (is_min & (dog < -thr))

    # Lowe's edge test on the 2x2 spatial Hessian (torch.roll: the border
    # rows and columns it wraps lie inside the excluded border).
    def shifted(sy, sx):
        return torch.roll(dog, (sy, sx), (1, 2))

    dxx = shifted(0, -1) + shifted(0, 1) - 2 * dog
    dyy = shifted(-1, 0) + shifted(1, 0) - 2 * dog
    dxy = 0.25 * (shifted(1, 1) + shifted(-1, -1) - shifted(1, -1) - shifted(-1, 1))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_thresh
    not_edge = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)

    ys = torch.arange(h, device=dog.device)[:, None]
    xs = torch.arange(w, device=dog.device)[None, :]
    inside = (ys >= BORDER) & (ys < h - BORDER) & (xs >= BORDER) & (xs < w - BORDER)
    layers = torch.arange(n_l, device=dog.device)[:, None, None]
    scale_layer = (layers >= 1) & (layers <= N_SCALES)
    candidate = extremum & not_edge & inside & scale_layer

    score = torch.where(candidate, dog.abs(), float("-inf")).reshape(-1)
    kk = min(max_keypoints, score.shape[0])
    scores, idx = top_k(score, kk)
    scores = F.pad(scores, (0, max_keypoints - kk), value=float("-inf"))
    idx = F.pad(idx, (0, max_keypoints - kk))
    l_i, y_i, x_i = idx // (h * w), idx % (h * w) // w, idx % w
    mask = torch.isfinite(scores)

    # One Newton step on the DoG around the sample, from central differences.
    def d(dl, dy, dx):
        return dog[torch.clamp(l_i + dl, 0, n_l - 1), torch.clamp(y_i + dy, 1, h - 2),
                   torch.clamp(x_i + dx, 1, w - 2)]

    c = d(0, 0, 0)
    grad = torch.stack([0.5 * (d(1, 0, 0) - d(-1, 0, 0)), 0.5 * (d(0, 1, 0) - d(0, -1, 0)),
                        0.5 * (d(0, 0, 1) - d(0, 0, -1))], -1)
    hll = d(1, 0, 0) + d(-1, 0, 0) - 2 * c
    hyy = d(0, 1, 0) + d(0, -1, 0) - 2 * c
    hxx = d(0, 0, 1) + d(0, 0, -1) - 2 * c
    hly = 0.25 * (d(1, 1, 0) - d(1, -1, 0) - d(-1, 1, 0) + d(-1, -1, 0))
    hlx = 0.25 * (d(1, 0, 1) - d(1, 0, -1) - d(-1, 0, 1) + d(-1, 0, -1))
    hyx = 0.25 * (d(0, 1, 1) - d(0, 1, -1) - d(0, -1, 1) + d(0, -1, -1))
    hessian = torch.stack([torch.stack([hll, hly, hlx], -1),
                           torch.stack([hly, hyy, hyx], -1),
                           torch.stack([hlx, hyx, hxx], -1)], -2)
    offset = torch.clamp(-_solve33(hessian, grad), -0.5, 0.5)  # (layer, y, x)

    step = float(1 << octave)
    xy = torch.stack([(x_i.to(torch.float32) + offset[:, 2]) * step,
                      (y_i.to(torch.float32) + offset[:, 1]) * step], -1)
    sigma = SIGMA0 * (2.0 ** ((l_i.to(torch.float32) + offset[:, 0]) / N_SCALES)) * step
    return scores, xy, sigma, l_i, y_i, x_i, mask


def orientation_and_descriptor(gauss, l_i, y_i, x_i, sigma_rel, mask):
    """(angle (K,), descriptor (K, 128)) of one octave's keypoints, from the
    Gaussian level each lies on (``sigma_rel``: sigma in the octave's px)."""
    n_k = l_i.shape[0]
    spacing = 3.0 * sigma_rel / PATCH * 2.0  # 16 samples across 6 sigma
    x_f, y_f = x_i.to(torch.float32), y_i.to(torch.float32)
    patches = torch.zeros((n_k, Q, Q), dtype=gauss.dtype, device=gauss.device)
    for layer in range(1, N_SCALES + 1):
        on_layer = (l_i == layer)[:, None, None]
        sampled = extract_patches(gauss[layer], x_f, y_f, spacing, Q)
        patches = patches + torch.where(on_layer, sampled, 0.0)
    gx = 0.5 * (patches[:, 1:-1, 2:] - patches[:, 1:-1, :-2])  # (K, Q-2, Q-2)
    gy = 0.5 * (patches[:, 2:, 1:-1] - patches[:, :-2, 1:-1])

    g1 = torch.arange(PATCH, dtype=torch.float32, device=gauss.device) - (PATCH - 1) / 2.0
    grid_y, grid_x = torch.meshgrid(g1, g1, indexing="ij")
    window = torch.exp(-(grid_x**2 + grid_y**2) / (2.0 * (PATCH / 3.0) ** 2))

    # Orientation: a 36-bin histogram of the unrotated 16 x 16 grid, gradient
    # rows and columns 4-19, smoothed; its first highest bin.
    lo = (Q - PATCH) // 2 - 1
    ux = gx[:, lo:lo + PATCH, lo:lo + PATCH]
    uy = gy[:, lo:lo + PATCH, lo:lo + PATCH]
    magnitude = torch.sqrt(ux * ux + uy * uy)
    theta = torch.atan2(uy, ux)
    # Each sample's weight split between the two bins either side of its
    # angle, summed as one-hot products.
    weight = (magnitude * window).reshape(n_k, -1)
    position = ((theta + math.pi) / (2 * math.pi) * ORI_BINS).reshape(n_k, -1)
    b0 = torch.floor(position)
    frac = position - b0
    lo_bin = b0.to(torch.int64) % ORI_BINS
    hi_bin = (lo_bin + 1) % ORI_BINS
    bins = torch.arange(ORI_BINS, device=gauss.device)
    with _float32():
        hist = torch.einsum("ks,ksb->kb", weight * (1 - frac), (lo_bin[..., None] == bins).float())
        hist = hist + torch.einsum("ks,ksb->kb", weight * frac,
                                   (hi_bin[..., None] == bins).float())
    for _ in range(2):
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    angle = (torch.argmax(hist, -1).to(torch.float32) + 0.5) / ORI_BINS * 2 * math.pi - math.pi

    # Descriptor: the grid rotated by the angle about the patch's centre,
    # (Q - 3) / 2 in gradient coordinates.
    cos, sin = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    rot_x = cos * grid_x - sin * grid_y
    rot_y = sin * grid_x + cos * grid_y
    centre = (Q - 3) / 2.0
    rows = (centre + rot_y).reshape(n_k, -1)
    cols = (centre + rot_x).reshape(n_k, -1)
    sx = sample_patch(gx, rows, cols).reshape(n_k, PATCH, PATCH)
    sy = sample_patch(gy, rows, cols).reshape(n_k, PATCH, PATCH)
    magnitude = (torch.sqrt(sx * sx + sy * sy) * window).reshape(n_k, -1)
    theta = torch.atan2(sy, sx) - angle[:, None, None]
    position = torch.remainder((theta + math.pi) / (2 * math.pi) * DESC_BINS, DESC_BINS)
    b0 = torch.floor(position)
    frac = (position - b0).reshape(n_k, -1)
    lo_bin = b0.to(torch.int64).reshape(n_k, -1) % DESC_BINS
    hi_bin = (lo_bin + 1) % DESC_BINS
    bins = torch.arange(DESC_BINS, device=gauss.device)
    per_sample = ((magnitude * (1 - frac))[..., None] * (lo_bin[..., None] == bins)
                  + (magnitude * frac)[..., None] * (hi_bin[..., None] == bins))
    cells = per_sample.reshape(n_k, 4, 4, 4, 4, DESC_BINS).sum(dim=(2, 4))  # (K, 4, 4, 8)
    desc = cells.reshape(n_k, 128)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-12)
    desc = torch.clamp(desc, max=0.2)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-12)
    return angle, torch.where(mask[:, None], desc, 0.0)


def detect_and_describe(img: torch.Tensor, max_keypoints: int, contrast_thresh: float,
                        edge_thresh: float) -> tuple[Keypoints, torch.Tensor]:
    """(Keypoints, (K, 128) descriptors) of one (H, W) image; ``laplacian``
    carries the angle.  Each octave gives its ``max_keypoints`` candidates
    with their descriptors, and the strongest of all are kept."""
    found = []
    for o, (gauss, dog) in enumerate(scale_space(img)):
        score, xy, sigma, l_i, y_i, x_i, mask = octave_keypoints(
            dog, o, max_keypoints, contrast_thresh, edge_thresh)
        angle, desc = orientation_and_descriptor(gauss, l_i, y_i, x_i, sigma / float(1 << o),
                                                 mask)
        found.append((score, xy, sigma, angle, mask, desc))
    score, xy, sigma, angle, mask, desc = (torch.cat(parts) for parts in zip(*found))
    best, pick = top_k(torch.where(mask, score, float("-inf")), max_keypoints)
    kept = torch.isfinite(best)
    kpts = Keypoints(xy=torch.where(kept[:, None], xy[pick], 0.0),
                     scale=torch.where(kept, sigma[pick], 0.0),
                     score=torch.where(kept, best, 0.0),
                     laplacian=torch.where(kept, angle[pick], 0.0),
                     mask=kept)
    return kpts, torch.where(kept[:, None], desc[pick], 0.0)


def detect_and_describe_cfg(img: torch.Tensor, cfg) -> tuple[Keypoints, torch.Tensor]:
    """(Keypoints, descriptors) of (..., H, W) preprocessed frames under a
    config's ``max_keypoints`` and SIFT thresholds, one frame at a time."""
    *lead, h, w = img.shape
    frames = [detect_and_describe(f, cfg.max_keypoints, cfg.sift_contrast_threshold,
                                  cfg.sift_edge_threshold) for f in img.reshape(-1, h, w)]
    kpts = Keypoints(*(torch.stack(field).reshape(*lead, *field[0].shape)
                       for field in zip(*(k for k, _ in frames))))
    desc = torch.stack([d for _, d in frames]).reshape(*lead, cfg.max_keypoints, 128)
    return kpts, desc
