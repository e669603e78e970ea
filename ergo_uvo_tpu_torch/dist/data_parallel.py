"""Data parallelism for the VO front end: independent streams over the ranks.

Counterpart of ``ergo_uvo_tpu/dist/data_parallel.py``.  VO is sequential in
time, so the parallel axis is over independent streams (cameras, dive
segments, replays): the batch of B streams is split into contiguous blocks
over the mesh, each rank runs its streams through :func:`run_mono_vo`
(the top-2 kernel once a frame), and the results are all-gathered so that
every rank returns all B.  Stream ``b`` draws its minimal sets from
``torch.Generator(device).manual_seed(seed + b)``, so a stream's result does
not depend on the world size; JAX splits one key B ways instead.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh

from ergo_uvo_tpu_torch.config import MonoVOConfig
from ergo_uvo_tpu_torch.device import resolve_device, upload
from ergo_uvo_tpu_torch.dist.mesh import all_gather_rows, axis_size, local_rows, mesh_device
from ergo_uvo_tpu_torch.pipeline.mono import (
    FrameSampler,
    MonoFrameOutput,
    MonoVOState,
    run_mono_vo,
)


def shard_frame_batches(source, mesh: DeviceMesh, batch_size: int, axis_name: str = "data"):
    """Sharded ingestion: for each global batch of ``source``
    (a :class:`~ergo_uvo_tpu_torch.io.sequence.FrameSource`), this rank's
    contiguous rows on its mesh device, as ``(imgs, timestamps, ranges)``
    (``ranges`` None when the source has none).  Every rank decodes the
    whole batch; see :func:`shard_frame_batches_multiprocess` for a source
    that decodes only the rank's share."""
    dev = mesh_device(mesh)
    for batch in source.batches(batch_size):  # local_rows raises unless the batch divides
        yield _upload_rows((local_rows(a, mesh, axis_name) if a is not None else None
                            for a in (batch.imgs, batch.timestamps, batch.ranges)), dev)


def shard_frame_batches_multiprocess(source, mesh: DeviceMesh, global_batch_size: int,
                                     axis_name: str = "data"):
    """Per-rank ingestion: ``source`` yields only this rank's share of every
    global batch (``global_batch_size / n`` frames, in global order), so no
    rank decodes a frame it does not own.  Yields what
    :func:`shard_frame_batches` yields for the same global batches."""
    n = axis_size(mesh, axis_name)
    if global_batch_size % n:
        raise ValueError(f"a global batch of {global_batch_size} over {n} shards")
    dev = mesh_device(mesh)
    for batch in source.batches(global_batch_size // n):
        yield _upload_rows((batch.imgs, batch.timestamps, batch.ranges), dev)


def _upload_rows(arrays, dev):
    return tuple(None if a is None else upload(a, dev) for a in arrays)


def run_mono_vo_batch(
    mesh: DeviceMesh,
    imgs,  # (B, T, H, W): B independent streams
    timestamps,  # (B, T)
    ranges,  # (B, T)
    K,  # (3, 3) shared intrinsics
    cfg: MonoVOConfig,
    seed: int = 0,
    samplers: Sequence[FrameSampler] | None = None,
    axis_name: str = "data",
    local: bool = False,
    device: torch.device | str | None = None,
):
    """Run B mono streams split over the mesh; returns (state, outputs) on
    every rank, each field stacked over all B streams.

    Every rank calls it.  With ``local=False`` it passes all B streams and
    keeps its contiguous block; with ``local=True`` it passes only its block
    (as :func:`shard_frame_batches` gives it), B being the blocks together.
    ``samplers``, one per global stream, replaces the generators (the
    parity hook of :func:`run_mono_vo`).  ``device=None`` is the card; it
    must be the mesh's device.
    """
    device = resolve_device(device)
    if device != mesh_device(mesh):
        raise ValueError(f"run_mono_vo_batch runs on {device}, the mesh on {mesh_device(mesh)}")
    imgs, timestamps, ranges = (torch.as_tensor(a) for a in (imgs, timestamps, ranges))
    if not local:
        imgs, timestamps, ranges = (local_rows(a, mesh, axis_name)
                                    for a in (imgs, timestamps, ranges))
    first = mesh.get_local_rank(axis_name) * imgs.shape[0]
    states, outs = [], []
    for j in range(imgs.shape[0]):
        b = first + j
        state, out = run_mono_vo(
            imgs[j], timestamps[j], ranges[j], K, cfg,
            torch.Generator(device).manual_seed(seed + b),
            sampler=None if samplers is None else samplers[b], device=device,
        )
        states.append(state)
        outs.append(out)
    group = mesh.get_group(axis_name)

    def gathered(cls, items):
        return cls(*(all_gather_rows(torch.stack(field), group) for field in zip(*items)))

    return gathered(MonoVOState, states), gathered(MonoFrameOutput, outs)
