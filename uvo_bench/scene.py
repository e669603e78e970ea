"""The benchmark's camera stream: a seafloor survey rendered on the device from a seed.

A PyTorch rewrite of the port's ``io/synthetic.py`` scene: a multi-octave
value-noise texture on the plane z = 0, a camera flying over it at a set
altitude, speed, yaw rate and sway, with a pitch and roll jitter a frame
that the traffic mix sets.  Each frame is taken through the configuration's
lens: every pixel of the distorted image casts the ray of its undistorted
normalized position (the inverse of the distortion by fixed-point iteration,
as ``cv::undistortPoints``), so that the port's undistortion is
geometrically true on these frames.  The frames are rounded to 8-bit gray
and copied to pinned host memory, as a camera would deliver them.

The texture is drawn on the device by a ``torch.Generator`` seeded from the
run's seed.  The trajectory, a few numbers a frame, is the mix's own: numpy
draws it from the mix's ``trajectory_seed``, so that every run's seed meets
the same parallax from frame to frame, and so the same work, over another
seafloor.  The same seed gives the same frames.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from uvo_bench.reference.image.undistort import _undistort_points_np

RENDER_BATCH = 64  # frames rendered in one call


class Stream(NamedTuple):
    """One pass of the camera, in pinned host memory."""

    left: torch.Tensor  # (T, H, W) uint8
    right: torch.Tensor | None  # (T, H, W) uint8, stereo only
    timestamps: torch.Tensor  # (T,) float32 seconds
    ranges: torch.Tensor  # (T,) float32 optical-axis distance to the plane
    K: np.ndarray  # (3, 3) float64, the distorted camera
    dist: np.ndarray  # (4,) k1, k2, p1, p2


def camera_matrix(camera: dict) -> np.ndarray:
    w, h = camera["width"], camera["height"]
    f = camera["focal_over_width"] * w
    return np.array([[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]])


def texture(size: int, octaves: int, gen: torch.Generator, device) -> torch.Tensor:
    """Multi-octave value noise in [20, 235] (the port's ``make_seafloor_texture``)."""
    tex = torch.zeros((size, size), dtype=torch.float32, device=device)
    for o in range(octaves):
        n = 8 << o
        coarse = torch.randn((n, n), generator=gen, device=device)
        idx = torch.linspace(0, n - 1, size, dtype=torch.float64, device=device)
        x0 = idx.floor().long()
        x1 = torch.clamp(x0 + 1, max=n - 1)
        w = (idx - x0).float()
        up = (
            coarse[x0][:, x0] * torch.outer(1 - w, 1 - w)
            + coarse[x0][:, x1] * torch.outer(1 - w, w)
            + coarse[x1][:, x0] * torch.outer(w, 1 - w)
            + coarse[x1][:, x1] * torch.outer(w, w)
        )
        tex += up / (1.6**o)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    return 20.0 + 215.0 * tex


def trajectory(n: int, traffic: dict, rng: np.random.Generator):
    """(timestamps, camera centres (n, 3), world-to-camera rotations (n, 3, 3)),
    float64: the port's ``_trajectory`` with the mix's parameters."""
    dt = traffic["dt"]
    ts = np.arange(n) * dt
    yaw = traffic["yaw_rate"] * ts + traffic["yaw_walk"] * np.cumsum(rng.standard_normal(n)) * dt
    x = np.cumsum(traffic["speed"] * np.cos(yaw)) * dt
    y = np.cumsum(traffic["speed"] * np.sin(yaw)) * dt
    z = traffic["altitude"] + traffic["sway"] * np.sin(traffic["sway_rate"] * ts)
    C = np.stack([x, y, z], -1)
    jitter = traffic["jitter"] * rng.standard_normal((n, 2))
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(jitter[:, 0]), np.sin(jitter[:, 0])
    cr, sr = np.cos(jitter[:, 1]), np.sin(jitter[:, 1])
    zero, one = np.zeros(n), np.ones(n)
    R_yaw = np.stack([cy, -sy, zero, sy, cy, zero, zero, zero, one], -1).reshape(n, 3, 3)
    R_down = np.diag([1.0, -1.0, -1.0])  # look down: cam z toward the plane
    R_pitch = np.stack([cp, zero, sp, zero, one, zero, -sp, zero, cp], -1).reshape(n, 3, 3)
    R_roll = np.stack([one, zero, zero, zero, cr, -sr, zero, sr, cr], -1).reshape(n, 3, 3)
    R_cw = R_yaw @ R_down @ R_pitch @ R_roll  # camera -> world
    return ts, C, np.transpose(R_cw, (0, 2, 1))


def lens_rays(K: np.ndarray, dist: np.ndarray, h: int, w: int) -> np.ndarray:
    """(h, w, 3) camera rays of the distorted image's pixels."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    xn = _undistort_points_np(np.stack([xs.ravel(), ys.ravel()], -1), K, dist)
    return np.concatenate([xn, np.ones((xn.shape[0], 1))], -1).reshape(h, w, 3)


def render(tex, rays, R_wc, C, tex_scale):
    """(B, H, W) float32 views of the textured plane z = 0 from cameras
    (R_wc (B, 3, 3), C (B, 3)) along ``rays`` (H, W, 3); all on one device."""
    rays_world = torch.einsum("hwi,bij->bhwj", rays, R_wc)  # R_wc^T applied row-wise
    denom = rays_world[..., 2]
    denom = torch.where(denom.abs() < 1e-9, 1e-9, denom)
    s = -C[:, 2, None, None] / denom
    u = (C[:, 0, None, None] + s * rays_world[..., 0]) * tex_scale
    v = (C[:, 1, None, None] + s * rays_world[..., 1]) * tex_scale
    th, tw = tex.shape
    u = torch.remainder(u, tw - 1)
    v = torch.remainder(v, th - 1)
    x0, y0 = u.floor().long(), v.floor().long()
    wx, wy = (u - x0).float(), (v - y0).float()
    x1, y1 = torch.clamp(x0 + 1, max=tw - 1), torch.clamp(y0 + 1, max=th - 1)
    img = (
        tex[y0, x0] * (1 - wx) * (1 - wy)
        + tex[y0, x1] * wx * (1 - wy)
        + tex[y1, x0] * (1 - wx) * wy
        + tex[y1, x1] * wx * wy
    )
    return torch.where(s > 0, img, 0.0)


def median_parallax(K, R_wc, C, grid: int = 24) -> np.ndarray:
    """The median pixel displacement, from the previous frame, of plane points
    seen on a ``grid`` x ``grid`` lattice of the previous frame's pixels
    (pinhole, from the ground truth); 0 for the first frame."""
    w, h = 2 * K[0, 2], 2 * K[1, 2]
    xs, ys = np.meshgrid(np.linspace(0, w, grid), np.linspace(0, h, grid))
    pix = np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)], -1)
    rays = pix @ np.linalg.inv(K).T
    out = np.zeros(len(C))
    for i in range(1, len(C)):
        rw = rays @ R_wc[i - 1]
        X = C[i - 1] + (-C[i - 1, 2] / rw[:, 2])[:, None] * rw
        pc = (X - C[i]) @ R_wc[i].T
        q = pc @ K.T
        out[i] = np.median(np.linalg.norm(q[:, :2] / q[:, 2:] - pix[:, :2], axis=-1))
    return out


def make_stream(camera: dict, traffic: dict, stereo_baseline: float | None, seed: int,
                device, frames: int | None = None) -> Stream:
    """One pass of ``frames`` (default: the mix's ``frames_per_pass``) frames."""
    n = traffic["frames_per_pass"] if frames is None else frames
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h, w = camera["height"], camera["width"]
    K = camera_matrix(camera)
    dist = np.asarray(camera["distortion"], np.float64)
    tex = texture(traffic["texture_size"], traffic["texture_octaves"], gen, device)
    ts, C, R_wc = trajectory(n, traffic, np.random.default_rng(traffic["trajectory_seed"]))
    rays = torch.as_tensor(lens_rays(K, dist, h, w), device=device)
    R_t = torch.as_tensor(R_wc, device=device)
    C_t = torch.as_tensor(C, device=device)
    pin = device.type == "cuda"

    def frames_from(centres):
        out = torch.empty((n, h, w), dtype=torch.uint8, pin_memory=pin)
        for b in range(0, n, RENDER_BATCH):
            img = render(tex, rays, R_t[b:b + RENDER_BATCH], centres[b:b + RENDER_BATCH],
                         traffic["tex_scale"])
            out[b:b + RENDER_BATCH].copy_(torch.clamp(img, 0, 255).round().to(torch.uint8))
        return out

    left = frames_from(C_t)
    right = None
    if stereo_baseline is not None:
        # The right camera sits `baseline` along the camera's +x axis.
        offset = torch.einsum("bji,j->bi", R_t,
                              torch.tensor([stereo_baseline, 0.0, 0.0], dtype=R_t.dtype,
                                           device=device))
        right = frames_from(C_t + offset)
    axis_world = R_wc[:, 2, :]  # R_wc^T e_z
    ranges = C[:, 2] / np.maximum(-axis_world[:, 2], 1e-6)

    def host(a):
        t = torch.as_tensor(np.asarray(a, np.float32))
        return t.pin_memory() if pin else t

    return Stream(left=left, right=right, timestamps=host(ts), ranges=host(ranges), K=K,
                  dist=dist)
