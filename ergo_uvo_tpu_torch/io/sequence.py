"""Frame sources: the ingestion boundary between host IO and device compute.

A numpy copy of ``ergo_uvo_tpu/io/sequence.py`` (whose package imports JAX).
The reference consumes ``sensor_msgs/CompressedImage`` + ``sensor_msgs/Range``
topics through ROS callbacks with queue-size-1 drop semantics
(visual_odometry.h:67-95, :766-785).  Here ingestion is an explicit host-side
iterator of fixed-shape frame batches; decode (JPEG) happens on the host,
through the native loader in ``io/native/`` (libjpeg) or else PIL, and
preprocessing and everything after runs on the device.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

import numpy as np


class FrameBatch(NamedTuple):
    imgs: np.ndarray  # (B, H, W) or (B, H, W, 3)
    imgs_right: Optional[np.ndarray]  # stereo
    timestamps: np.ndarray  # (B,)
    ranges: Optional[np.ndarray]  # (B,) mono range sensor


class FrameSource:
    """Interface: iterate fixed-size frame batches."""

    def batches(self, batch_size: int) -> Iterator[FrameBatch]:
        raise NotImplementedError


class JpegDirectorySource(FrameSource):
    """Streaming JPEG-directory source: frames are decoded on demand by the
    native threaded prefetch ring (io/native, libjpeg) — or PIL when the
    toolchain is unavailable — so arbitrarily long sequences never fully
    materialize in host memory (the streaming analogue of the reference's
    queue-size-1 subscriber, visual_odometry.h:766-785).

    `timestamps`/`ranges`: optional full-length arrays (they are tiny).
    """

    def __init__(self, paths, timestamps=None, ranges=None, gray=True,
                 threads: int = 4):
        self.paths = list(paths)
        self.timestamps = (
            np.arange(len(self.paths), dtype=np.float32)
            if timestamps is None else np.asarray(timestamps, np.float32)
        )
        self.ranges = None if ranges is None else np.asarray(ranges, np.float32)
        self.gray = gray
        self.threads = threads

    def __len__(self):
        return len(self.paths)

    def _frames(self) -> Iterator[np.ndarray]:
        from ergo_uvo_tpu_torch.io import native

        if native.available():
            # The ring yields frames out of order; re-order with a small
            # hold-back buffer (bounded by the ring capacity).
            loader = native.JpegLoader(self.paths, threads=self.threads,
                                       gray=self.gray)
            try:
                pending: dict[int, np.ndarray] = {}
                next_idx = 0
                for idx, img in loader:
                    pending[idx] = img
                    while next_idx in pending:
                        yield pending.pop(next_idx)
                        next_idx += 1
                while next_idx in pending:
                    yield pending.pop(next_idx)
                    next_idx += 1
            finally:
                loader.close()
        else:
            try:
                from PIL import Image
            except ImportError:
                raise RuntimeError(
                    "decoding JPEG frames needs libjpeg (for the native loader, "
                    f"whose build failed: {native.build_error()}) or PIL; "
                    "this host has neither"
                ) from None

            for p in self.paths:
                with Image.open(p) as img:
                    yield np.asarray(img.convert("L" if self.gray else "RGB"))

    def batches(self, batch_size: int) -> Iterator[FrameBatch]:
        buf, t0 = [], 0
        for img in self._frames():
            buf.append(np.asarray(img, np.float32))
            if len(buf) == batch_size:
                sl = slice(t0, t0 + batch_size)
                yield FrameBatch(
                    imgs=np.stack(buf),
                    imgs_right=None,
                    timestamps=self.timestamps[sl],
                    ranges=None if self.ranges is None else self.ranges[sl],
                )
                t0 += batch_size
                buf = []
        # Trailing partial batch is dropped (fixed shapes; callers pad the
        # path list if every frame matters).


class JpegPairSource(FrameSource):
    """Synced left/right JPEG streaming source for the stereo pipeline.

    The streaming analogue of the reference's ApproximateTime-synced stereo
    subscriber pair (visual_odometry.h:766-774): two path lists of equal
    length decode side by side (each through its own native prefetch ring /
    PIL fallback) and emit paired fixed-size batches.
    """

    def __init__(self, paths_left, paths_right, timestamps=None, gray=True,
                 threads: int = 4):
        if len(paths_left) != len(paths_right):
            raise ValueError(
                f"unsynced stereo streams: {len(paths_left)} left vs "
                f"{len(paths_right)} right frames"
            )
        self._left = JpegDirectorySource(paths_left, timestamps=timestamps,
                                         gray=gray, threads=threads)
        self._right = JpegDirectorySource(paths_right, timestamps=timestamps,
                                          gray=gray, threads=threads)

    def __len__(self):
        return len(self._left)

    def batches(self, batch_size: int) -> Iterator[FrameBatch]:
        for bl, br in zip(self._left.batches(batch_size),
                          self._right.batches(batch_size)):
            yield FrameBatch(
                imgs=bl.imgs,
                imgs_right=br.imgs,
                timestamps=bl.timestamps,
                ranges=None,
            )


class ArraySource(FrameSource):
    """In-memory source over preloaded arrays (tests, benchmarks, replays)."""

    def __init__(self, imgs, timestamps, ranges=None, imgs_right=None):
        self.imgs = np.asarray(imgs)
        self.timestamps = np.asarray(timestamps)
        self.ranges = None if ranges is None else np.asarray(ranges)
        self.imgs_right = None if imgs_right is None else np.asarray(imgs_right)

    def __len__(self):
        return len(self.imgs)

    def batches(self, batch_size: int) -> Iterator[FrameBatch]:
        n = len(self.imgs)
        for i in range(0, n - n % batch_size, batch_size):
            sl = slice(i, i + batch_size)
            yield FrameBatch(
                imgs=self.imgs[sl],
                imgs_right=None if self.imgs_right is None else self.imgs_right[sl],
                timestamps=self.timestamps[sl],
                ranges=None if self.ranges is None else self.ranges[sl],
            )
