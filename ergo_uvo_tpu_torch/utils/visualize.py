"""Host-side match visualization (debug dumps, not on the device path).

A numpy copy of ``ergo_uvo_tpu/utils/visualize.py`` (whose package imports
JAX), held equal to it by ``tests/test_torch_host_modules.py``.  It replaces
the reference's ``show_matches`` (VO_utility.cpp:756-763) and the
SHOW_MATCHES windows the node opens at every pipeline stage
(visual_odometry.h:291-296, :325-333, :493-498, :560-565, :594-599,
:658-663).  There is no GUI: frames come back from the device as arrays,
matches are rendered into a side-by-side image with lines, and the result is
written to disk (PNG when pillow is importable, PPM otherwise).  It costs
nothing unless a caller asks for it.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["draw_matches", "save_image", "dump_matches"]

_GREEN = np.array([0, 255, 0], dtype=np.uint8)
_RED = np.array([255, 64, 64], dtype=np.uint8)


def _to_u8_rgb(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        lo, hi = float(img.min()), float(img.max())
        img = ((img - lo) / max(hi - lo, 1e-9) * 255.0).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img


def _draw_line(canvas: np.ndarray, p0, p1, color) -> None:
    """Rasterize a line segment by dense sampling (host-side debug only)."""
    h, w = canvas.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) + 1
    xs = np.clip(np.linspace(p0[0], p1[0], n).round().astype(int), 0, w - 1)
    ys = np.clip(np.linspace(p0[1], p1[1], n).round().astype(int), 0, h - 1)
    canvas[ys, xs] = color


def _draw_marker(canvas: np.ndarray, p, color, radius: int = 2) -> None:
    h, w = canvas.shape[:2]
    x, y = int(round(p[0])), int(round(p[1]))
    y0, y1 = max(y - radius, 0), min(y + radius + 1, h)
    x0, x1 = max(x - radius, 0), min(x + radius + 1, w)
    canvas[y0:y1, x0:x1] = color


def draw_matches(
    img_prev: np.ndarray,
    kpts_prev: np.ndarray,
    img_curr: np.ndarray,
    kpts_curr: np.ndarray,
    mask: np.ndarray | None = None,
    inliers: np.ndarray | None = None,
    max_draw: int = 256,
) -> np.ndarray:
    """Side-by-side match image: green = match (or inlier), red = outlier.

    ``kpts_*`` are (N, 2) pixel coordinates, matched row-for-row; ``mask``
    marks valid rows (fixed-shape convention); ``inliers`` optionally colors
    RANSAC outliers red, mirroring the reference's two drawMatches calls on
    the full and inlier match sets (visual_odometry.h:291-296, :325-333).
    """
    a = _to_u8_rgb(img_prev)
    b = _to_u8_rgb(img_curr)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), dtype=np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1] :] = b

    kp = np.asarray(kpts_prev, dtype=np.float64)
    kc = np.asarray(kpts_curr, dtype=np.float64)
    n = min(len(kp), len(kc))
    valid = np.ones(n, dtype=bool) if mask is None else np.asarray(mask[:n], bool)
    good = valid if inliers is None else valid & np.asarray(inliers[:n], bool)

    drawn = 0
    off = a.shape[1]
    for i in range(n):
        if not valid[i] or drawn >= max_draw:
            continue
        drawn += 1
        color = _GREEN if good[i] else _RED
        p0 = (kp[i, 0], kp[i, 1])
        p1 = (kc[i, 0] + off, kc[i, 1])
        _draw_line(canvas, p0, p1, color)
        _draw_marker(canvas, p0, color)
        _draw_marker(canvas, p1, color)
    return canvas


def save_image(img: np.ndarray, path: str) -> str:
    """Write an RGB uint8 image; PNG via pillow when available, else PPM."""
    img = _to_u8_rgb(img)
    try:
        from PIL import Image

        Image.fromarray(img).save(path)
        return path
    except ImportError:
        base, _ = os.path.splitext(path)
        path = base + ".ppm"
        with open(path, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
            f.write(np.ascontiguousarray(img).tobytes())
        return path


def dump_matches(out_dir: str, frame_idx: int, stage: str, *args, **kwargs) -> str:
    """Render + save one stage's matches as ``{out_dir}/f{idx}_{stage}.png``."""
    os.makedirs(out_dir, exist_ok=True)
    canvas = draw_matches(*args, **kwargs)
    return save_image(canvas, os.path.join(out_dir, f"f{frame_idx:06d}_{stage}.png"))
