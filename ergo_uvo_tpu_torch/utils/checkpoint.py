"""Checkpoint / resume for pipeline state and streaming runs.

Counterpart of ``ergo_uvo_tpu/utils/checkpoint.py``.  The reference has none
— a crashed node respawns with all state lost (SURVEY.md §5 "Checkpoint /
resume": respawn=true at UVO_node.launch:24,38).

The streaming checkpoint keeps the JAX package's npz layout: a small head
(``state_NNNN`` leaves in the state's field order, ``frames_done``,
``n_segments``, ``n_real``, ``chunk_size``, ``seq_digest``) and append-only
output segments (``leaf_NNNN`` in the output's field order), each written to
a temporary file and renamed.  Two things differ, because the JAX package's
forms do not exist here:

* the head holds the ``torch.Generator``'s state (``get_state()``, uint8)
  under ``generator_state`` where the JAX head holds its PRNG key under
  ``key``;
* :func:`save_state` / :func:`restore_state` write the NamedTuple's fields as
  CPU tensors with ``torch.save`` (one file), where the JAX package uses
  Orbax (one directory).

Trees are flattened as JAX flattens them: tuples and NamedTuples by
position, dicts by sorted key, ``None`` holds no leaf.
"""

from __future__ import annotations

import os
from typing import Any, Iterator, NamedTuple

import numpy as np
import torch

from ergo_uvo_tpu_torch.device import resolve_device


def _leaves(tree: Any) -> list:
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for child in tree for leaf in _leaves(child)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _unflatten(example: Any, leaves: Iterator) -> Any:
    if example is None:
        return None
    if isinstance(example, tuple) and hasattr(example, "_fields"):
        return type(example)(*(_unflatten(child, leaves) for child in example))
    if isinstance(example, (tuple, list)):
        return type(example)(_unflatten(child, leaves) for child in example)
    if isinstance(example, dict):
        return {k: _unflatten(example[k], leaves) for k in sorted(example)}
    return next(leaves)


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _savez_atomic(path: str, arrays: dict[str, np.ndarray]) -> None:
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def save_state(path: str, state: NamedTuple) -> None:
    """Save a NamedTuple of tensors (a VO state) to the file `path`, overwriting.

    The fields go to ``torch.save`` as CPU tensors, keyed by field name,
    through a temporary file and a rename.
    """
    path = os.path.abspath(path)
    payload = {f: torch.as_tensor(getattr(state, f)).detach().cpu() for f in state._fields}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_state(path: str, example: NamedTuple, device: torch.device | str | None = None):
    """Restore a :func:`save_state` file as ``type(example)`` on `device`.

    `example` gives the type and its fields (``mono_vo_init_from(cfg)``, say);
    shapes and dtypes come from the file.  ``device=None`` is the card and
    raises where there is none.
    """
    device = resolve_device(device)
    data = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if set(data) != set(example._fields):
        raise ValueError(
            f"{path} holds the fields {sorted(data)}, "
            f"{type(example).__name__} has {sorted(example._fields)}"
        )
    return type(example)(*(data[f].to(device) for f in example._fields))


def save_stream_checkpoint(path: str, payload: Any) -> None:
    """Checkpoint a host-side tree (streaming-VO progress) to one .npz.

    Written atomically (tmp + rename) so a crash mid-save leaves the previous
    checkpoint intact.  Tensor leaves are copied to the host.
    """
    path = os.path.abspath(path)
    _savez_atomic(path, {f"leaf_{i:04d}": _host(l) for i, l in enumerate(_leaves(payload))})


def save_stream_head(
    path: str,
    frames_done: int,
    state: NamedTuple,
    generator_state: torch.Tensor | np.ndarray,
    n_segments: int,
    n_real: int,
    chunk_size: int,
    seq_digest: str = "",
) -> None:
    """Write the small streaming-run head file (atomic tmp+rename).

    The head carries resume accounting (`frames_done` counts REAL frames —
    never pad duplicates), the carried VO state, the ``torch.Generator``'s
    state (``get_state()``, uint8) and the number of output segments written
    so far.  Per-frame outputs live in append-only segment files
    (:func:`append_stream_segment`), so each checkpoint writes O(new frames)
    bytes instead of rewriting the whole history.
    """
    path = os.path.abspath(path)
    payload = {f"state_{i:04d}": _host(l) for i, l in enumerate(_leaves(state))}
    payload["generator_state"] = _host(generator_state).astype(np.uint8)
    payload["frames_done"] = np.int64(frames_done)
    payload["n_segments"] = np.int64(n_segments)
    payload["n_real"] = np.int64(n_real)
    payload["chunk_size"] = np.int64(chunk_size)
    # Identity of the frames the head covers: resume refuses a checkpoint
    # whose frames changed (a re-sorted glob would silently misalign the
    # restored prefix otherwise).
    payload["seq_digest"] = np.str_(seq_digest)
    _savez_atomic(path, payload)


def _segment_path(path: str, index: int) -> str:
    return f"{os.path.abspath(path)}.seg{index:04d}.npz"


def append_stream_segment(path: str, index: int, outs: Any) -> None:
    """Write per-frame outputs for one checkpoint interval as segment `index`.

    Written atomically BEFORE the head that references it: a crash between the
    two leaves a head pointing at the previous segment count, and the orphan
    segment is simply overwritten on the next run.
    """
    _savez_atomic(_segment_path(path, index),
                  {f"leaf_{i:04d}": _host(l) for i, l in enumerate(_leaves(outs))})


def load_stream_run(path: str, state_example: NamedTuple, outs_example: Any,
                    device: torch.device | str | None = None):
    """Restore a segmented streaming checkpoint.

    Returns ``(frames_done, state, outs | None, generator_state, meta)``:
    `state` is ``type(state_example)`` with its tensors on `device`
    (``None``: the card, which raises where there is none); `outs` is the
    per-frame output tree as numpy arrays, concatenated across all referenced
    segments (None when no segment was persisted yet); `generator_state` is
    the uint8 CPU tensor that ``torch.Generator.set_state`` takes; and `meta`
    is ``{"n_real", "chunk_size", "n_segments", "seq_digest"}`` for resume
    validation — the caller may stream the remaining frames with ANY chunk
    size since `frames_done` refers to real frames only.
    """
    device = resolve_device(device)
    path = os.path.abspath(path)
    data = np.load(path)
    if "generator_state" not in data:
        raise ValueError(
            f"{path} holds no generator_state: a JAX package checkpoint, whose "
            "PRNG key cannot seed a torch.Generator"
        )
    n_state = len(_leaves(state_example))
    state = _unflatten(state_example, iter(
        torch.from_numpy(data[f"state_{i:04d}"]).to(device) for i in range(n_state)))
    meta = {
        "n_real": int(data["n_real"]),
        "chunk_size": int(data["chunk_size"]),
        "n_segments": int(data["n_segments"]),
        "seq_digest": str(data["seq_digest"]),
    }
    n_outs = len(_leaves(outs_example))
    outs = None
    if meta["n_segments"] > 0:
        segs = []
        for s in range(meta["n_segments"]):
            seg = np.load(_segment_path(path, s))
            segs.append([seg[f"leaf_{i:04d}"] for i in range(n_outs)])
        outs = _unflatten(outs_example, iter(
            np.concatenate([seg[i] for seg in segs]) for i in range(n_outs)))
    generator_state = torch.from_numpy(np.array(data["generator_state"], np.uint8))
    return int(data["frames_done"]), state, outs, generator_state, meta


def load_stream_checkpoint(path: str, example: Any) -> Any:
    """Restore a :func:`save_stream_checkpoint` tree, with numpy leaves.

    `example` supplies only the tree *structure* (leaf shapes/dtypes come
    from the file), so a template with zero-length leading axes works.
    """
    data = np.load(os.path.abspath(path))
    n = len(_leaves(example))
    if len(data.files) != n:
        raise ValueError(
            f"checkpoint has {len(data.files)} leaves, template has "
            f"{n} — config/detector mismatch?"
        )
    return _unflatten(example, iter(data[f"leaf_{i:04d}"] for i in range(n)))
