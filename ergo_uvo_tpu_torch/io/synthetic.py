"""Synthetic underwater scene renderer with exact ground truth.

A verbatim copy of ``ergo_uvo_tpu/io/synthetic.py`` (numpy only), carried so
that the port never imports the JAX package; ``tests/test_torch_pipeline.py``
holds the sequences of both copies equal.

Renders a textured seafloor plane (z = 0 in world) viewed by a downward-ish
camera — the monocular UVO operating regime (downward camera + range sensor,
README.md:17-18) — and stereo pairs for the stereo pipeline.  Pure NumPy,
host-side, used by tests and by `bench.py` to synthesize arbitrarily long
sequences with known trajectories (the reference's bag is unavailable,
SURVEY.md §6).

Ground truth conventions match the pipelines:
  * world -> camera: x_cam = R_wc @ (X - C)  with camera center C;
  * per-frame relative pose (R_rel, t_rel): x_curr = R_rel x_prev + t_rel;
  * mono "range" = distance along the optical axis to the plane (the
    sensor_msgs/Range input);
  * per-frame ground-truth velocity = camera displacement in the previous
    camera frame / dt  (what mono_output_computation estimates).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def make_seafloor_texture(size: int = 1024, seed: int = 0, octaves: int = 5):
    """Multi-octave value-noise texture in [20, 235] — seafloor-like mottling."""
    rng = np.random.default_rng(seed)
    tex = np.zeros((size, size), np.float32)
    for o in range(octaves):
        n = 8 << o
        coarse = rng.standard_normal((n, n)).astype(np.float32)
        # bilinear upsample to full size (wrap-friendly enough for our use)
        idx = np.linspace(0, n - 1, size)
        x0 = np.floor(idx).astype(int)
        x1 = np.minimum(x0 + 1, n - 1)
        w = (idx - x0).astype(np.float32)
        up = (
            coarse[np.ix_(x0, x0)] * np.outer(1 - w, 1 - w)
            + coarse[np.ix_(x0, x1)] * np.outer(1 - w, w)
            + coarse[np.ix_(x1, x0)] * np.outer(w, 1 - w)
            + coarse[np.ix_(x1, x1)] * np.outer(w, w)
        )
        tex += up / (1.6**o)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    return (20.0 + 215.0 * tex).astype(np.float32)


def _sample_bilinear(tex: np.ndarray, u: np.ndarray, v: np.ndarray):
    h, w = tex.shape
    u = np.mod(u, w - 1)
    v = np.mod(v, h - 1)
    x0 = np.floor(u).astype(int)
    y0 = np.floor(v).astype(int)
    wx = (u - x0).astype(np.float32)
    wy = (v - y0).astype(np.float32)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    return (
        tex[y0, x0] * (1 - wx) * (1 - wy)
        + tex[y0, x1] * wx * (1 - wy)
        + tex[y1, x0] * (1 - wx) * wy
        + tex[y1, x1] * wx * wy
    )


def render_frame(
    tex: np.ndarray,
    K: np.ndarray,
    R_wc: np.ndarray,
    C: np.ndarray,
    height: int,
    width: int,
    tex_scale: float = 60.0,
):
    """Render the z=0 plane seen by camera (R_wc, C); returns (H, W) float32.

    `tex_scale`: texture pixels per world meter.
    """
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    rays_cam = np.stack(
        [(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], np.ones_like(xs)], -1
    )
    rays_world = rays_cam @ R_wc  # R_wc^T applied row-wise
    denom = rays_world[..., 2]
    denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
    s = (0.0 - C[2]) / denom
    px = C[0] + s * rays_world[..., 0]
    py = C[1] + s * rays_world[..., 1]
    img = _sample_bilinear(tex, px * tex_scale, py * tex_scale)
    return np.where(s > 0, img, 0.0).astype(np.float32)


class SyntheticSequence(NamedTuple):
    imgs_left: np.ndarray  # (T, H, W) float32 gray
    imgs_right: np.ndarray | None  # stereo only
    timestamps: np.ndarray  # (T,)
    ranges: np.ndarray  # (T,) optical-axis distance to plane
    positions: np.ndarray  # (T, 3) camera centers (world)
    rotations: np.ndarray  # (T, 3, 3) R_wc (world -> camera)
    velocities_prevcam: np.ndarray  # (T, 3) GT of the mono/stereo velocity output
    K: np.ndarray  # (3, 3)


def _trajectory(n_frames, dt, depth, speed, seed, yaw_rate=0.03, sway=0.15):
    rng = np.random.default_rng(seed)
    ts = np.arange(n_frames) * dt
    yaw = yaw_rate * ts + 0.02 * np.cumsum(rng.standard_normal(n_frames)) * dt
    x = np.cumsum(speed * np.cos(yaw)) * dt
    y = np.cumsum(speed * np.sin(yaw)) * dt
    z = depth + sway * np.sin(0.5 * ts)
    C = np.stack([x, y, z], -1)
    # Downward camera: camera z-axis points to -world-z (toward the plane),
    # rotated about the vertical by yaw plus small pitch/roll jitter.
    Rs = []
    for i in range(n_frames):
        cy, sy = np.cos(yaw[i]), np.sin(yaw[i])
        R_yaw = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
        # look down: cam x ~ world x, cam y ~ -world y, cam z ~ -world z
        R_down = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])
        jitter = 0.01 * rng.standard_normal(2)
        cp, sp = np.cos(jitter[0]), np.sin(jitter[0])
        cr, sr = np.cos(jitter[1]), np.sin(jitter[1])
        R_pitch = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        R_roll = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        R_cw = R_yaw @ R_down @ R_pitch @ R_roll  # camera -> world
        Rs.append(R_cw.T)
    return ts, C, np.stack(Rs)


def _gt_velocities(C, Rs, dt):
    """GT of the published velocity: camera displacement in prev-cam frame/dt."""
    v = np.zeros_like(C)
    v[1:] = np.einsum("tij,tj->ti", Rs[:-1], C[1:] - C[:-1]) / dt
    return v


def make_mono_sequence(
    n_frames: int = 30,
    height: int = 240,
    width: int = 320,
    dt: float = 0.25,
    depth: float = 5.0,
    speed: float = 0.35,
    seed: int = 0,
    tex_scale: float = 60.0,
) -> SyntheticSequence:
    K = np.array(
        [[0.9 * width, 0, width / 2], [0, 0.9 * width, height / 2], [0, 0, 1.0]]
    )
    tex = make_seafloor_texture(1024, seed)
    ts, C, Rs = _trajectory(n_frames, dt, depth, speed, seed)
    imgs = np.stack(
        [render_frame(tex, K, Rs[i], C[i], height, width, tex_scale) for i in range(n_frames)]
    )
    # Range sensor: distance along the optical axis (cam z) to the plane.
    axis_world = np.einsum("tji,j->ti", Rs, np.array([0.0, 0, 1.0]))  # R_wc^T e_z
    ranges = C[:, 2] / np.maximum(-axis_world[:, 2], 1e-6)
    return SyntheticSequence(
        imgs_left=imgs.astype(np.float32),
        imgs_right=None,
        timestamps=ts.astype(np.float32),
        ranges=ranges.astype(np.float32),
        positions=C.astype(np.float32),
        rotations=Rs.astype(np.float32),
        velocities_prevcam=_gt_velocities(C, Rs, dt).astype(np.float32),
        K=K.astype(np.float32),
    )


def make_loop_sequence(
    n_frames: int = 24,
    height: int = 240,
    width: int = 320,
    dt: float = 0.5,
    depth: float = 5.0,
    radius: float = 3.0,
    closure_gap: float = 0.8,
    seed: int = 0,
    tex_scale: float = 60.0,
    baseline: float | None = None,
) -> SyntheticSequence:
    """Closed-loop survey: the camera translates along a circle (constant
    downward orientation) and the last frame returns to within `closure_gap`
    meters of the first — the loop-closure fixture for the pose-graph layer
    (BASELINE configs[3]; the reference has no loop closure, SURVEY.md §0).

    Constant orientation keeps retrieval appearance-stable for upright SURF.
    With `baseline` set, right-eye frames are rendered too (camera offset
    along camera +x, identity rig rotation) — the stereo loop fixture.
    """
    K = np.array(
        [[0.9 * width, 0, width / 2], [0, 0.9 * width, height / 2], [0, 0, 1.0]]
    )
    tex = make_seafloor_texture(1024, seed)
    ts = np.arange(n_frames) * dt
    # Angle sweep that stops `closure_gap` short of a full revolution.
    end = 2 * np.pi - closure_gap / radius
    th = np.linspace(0.0, end, n_frames)
    C = np.stack(
        [radius * np.cos(th), radius * np.sin(th), np.full(n_frames, depth)], -1
    )
    R_down = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])  # cam->world
    Rs = np.tile(R_down.T, (n_frames, 1, 1))
    imgs = np.stack(
        [render_frame(tex, K, Rs[i], C[i], height, width, tex_scale) for i in range(n_frames)]
    )
    imgs_right = None
    if baseline is not None:
        imgs_right = np.stack([
            render_frame(
                tex, K, Rs[i],
                C[i] + Rs[i].T @ np.array([baseline, 0.0, 0.0]),
                height, width, tex_scale,
            )
            for i in range(n_frames)
        ]).astype(np.float32)
    ranges = np.full(n_frames, depth, np.float32)
    return SyntheticSequence(
        imgs_left=imgs.astype(np.float32),
        imgs_right=imgs_right,
        timestamps=ts.astype(np.float32),
        ranges=ranges,
        positions=C.astype(np.float32),
        rotations=Rs.astype(np.float32),
        velocities_prevcam=_gt_velocities(C, Rs, dt).astype(np.float32),
        K=K.astype(np.float32),
    )


def make_stereo_sequence(
    n_frames: int = 30,
    height: int = 240,
    width: int = 320,
    dt: float = 0.25,
    depth: float = 5.0,
    speed: float = 0.35,
    baseline: float = 0.33,
    seed: int = 0,
    tex_scale: float = 60.0,
) -> SyntheticSequence:
    """Stereo pairs; right camera offset by `baseline` along camera +x
    (identity rig rotation, as the reference's shipped extrinsics)."""
    K = np.array(
        [[0.9 * width, 0, width / 2], [0, 0.9 * width, height / 2], [0, 0, 1.0]]
    )
    tex = make_seafloor_texture(1024, seed)
    ts, C, Rs = _trajectory(n_frames, dt, depth, speed, seed)
    imgs_l, imgs_r = [], []
    for i in range(n_frames):
        C_r = C[i] + Rs[i].T @ np.array([baseline, 0.0, 0.0])
        imgs_l.append(render_frame(tex, K, Rs[i], C[i], height, width, tex_scale))
        imgs_r.append(render_frame(tex, K, Rs[i], C_r, height, width, tex_scale))
    axis_world = np.einsum("tji,j->ti", Rs, np.array([0.0, 0, 1.0]))
    ranges = C[:, 2] / np.maximum(-axis_world[:, 2], 1e-6)
    return SyntheticSequence(
        imgs_left=np.stack(imgs_l).astype(np.float32),
        imgs_right=np.stack(imgs_r).astype(np.float32),
        timestamps=ts.astype(np.float32),
        ranges=ranges.astype(np.float32),
        positions=C.astype(np.float32),
        rotations=Rs.astype(np.float32),
        velocities_prevcam=_gt_velocities(C, Rs, dt).astype(np.float32),
        K=K.astype(np.float32),
    )
