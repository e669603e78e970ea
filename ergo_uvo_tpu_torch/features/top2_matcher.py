"""Fused descriptor distance + row top-2: the CUDA kernel and its plain versions.

Counterpart of ``ergo_uvo_tpu/features/pallas_matcher.py::top2_distances_pallas``.
For each query row: the smallest squared L2 distance to the valid train rows,
its train index (ties to the lowest index), and the second-smallest distance
over the other columns; d = max(|q|^2 + |t|^2 - 2 q.t, 0), and a row with no
valid column gives (+inf, 0, +inf).

* :func:`top2_distances` dispatches on the tensors' device: a CUDA tensor
  launches ``csrc/top2_distances.cu``, a CPU tensor takes the plain version.
  There is no VMEM plan and no fallback: a CUDA input that the kernel cannot
  take raises.
* :func:`top2_distances_reference` is the plain PyTorch version on the full
  Q x T matrix; the CPU tests use it and ``chip_smoke.py`` checks the kernel
  against it on the card.
* The kernel splits the train set over the blocks of a cluster and merges
  their partial results; the cluster size comes from the shape.
  :func:`launch_forced` launches it under a given size, for the checks that
  every size gives the same bits; nothing on the main path calls it.
* The counter ``top2_distances.launches`` of
  :mod:`ergo_uvo_tpu_torch.utils.profiling` counts kernel launches, so a run
  can show that the main path went through the kernel.
"""

from __future__ import annotations

import torch

from ergo_uvo_tpu_torch import cuda_build
from ergo_uvo_tpu_torch.cuda_build import INT, PTR


def _masked_distances(desc_q: torch.Tensor, desc_t: torch.Tensor, mask_t: torch.Tensor):
    """The (Q, T) matrix of squared distances, +inf in the masked columns."""
    qn = (desc_q * desc_q).sum(-1, keepdim=True)
    tn = (desc_t * desc_t).sum(-1)
    cross = desc_q @ desc_t.T
    d2 = torch.clamp(qn + tn[None, :] - 2.0 * cross, min=0.0)
    return torch.where(mask_t[None, :], d2, float("inf"))


def _row_top2(d2: torch.Tensor):
    """(min1, idx1, min2) of each row of a (Q, T) distance matrix."""
    Q, T = d2.shape
    if T == 0:
        inf = torch.full((Q,), float("inf"), dtype=torch.float32, device=d2.device)
        return inf, torch.zeros(Q, dtype=torch.int32, device=d2.device), inf.clone()
    min1 = d2.min(dim=1).values
    # torch.argmin returns the first minimal index, like jnp.argmin.
    idx1 = torch.argmin(d2, dim=1).to(torch.int32)
    cols = torch.arange(T, device=d2.device)
    d2_wo = torch.where(cols[None, :] == idx1[:, None], float("inf"), d2)
    min2 = d2_wo.min(dim=1).values
    return min1, idx1, min2


def top2_distances_reference(
    desc_q: torch.Tensor, desc_t: torch.Tensor, mask_t: torch.Tensor
):
    """(min1 (Q,) f32, idx1 (Q,) i32, min2 (Q,) f32) on the full distance matrix."""
    return _row_top2(_masked_distances(desc_q, desc_t, mask_t))


SIGNATURES = {
    "top2_distances_plan": ([INT] * 3 + [PTR], None),
    "top2_distances_launch": [PTR] * 6 + [INT] * 3 + [PTR],
    "top2_distances_launch_forced": [PTR] * 6 + [INT] * 4 + [PTR],
}


def launch_plan(Q: int, T: int, D: int) -> dict:
    """The grid the kernel uses at this shape on the current device (for reports)."""
    out = (INT * 5)()
    cuda_build.bind("top2_distances", SIGNATURES).top2_distances_plan(Q, T, D, out)
    keys = ("cluster", "query_tiles", "cols_per_rank", "q_resident", "smem_bytes")
    plan = dict(zip(keys, out))
    plan["blocks"] = plan["query_tiles"] * plan["cluster"]
    return plan


def _launch(
    desc_q: torch.Tensor, desc_t: torch.Tensor, mask_t: torch.Tensor, splits: int | None = None
):
    """Launch the kernel; ``splits`` None lets the C entry point pick the
    cluster size from the shape, as the main path does."""
    for name, x in (("desc_q", desc_q), ("desc_t", desc_t), ("mask_t", mask_t)):
        if x.device != desc_q.device:
            raise ValueError(f"{name} is on {x.device}, desc_q on {desc_q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if desc_q.dtype != torch.float32 or desc_t.dtype != torch.float32:
        raise TypeError(f"descriptors must be float32, got {desc_q.dtype}/{desc_t.dtype}")
    if mask_t.dtype != torch.bool:
        raise TypeError(f"mask_t must be bool, got {mask_t.dtype}")
    if desc_q.ndim != 2 or desc_t.ndim != 2 or desc_q.shape[1] != desc_t.shape[1]:
        raise ValueError(f"shapes {tuple(desc_q.shape)} x {tuple(desc_t.shape)} do not match")
    Q, D = desc_q.shape
    T = desc_t.shape[0]
    if mask_t.shape != (T,):
        raise ValueError(f"mask_t has shape {tuple(mask_t.shape)}, expected ({T},)")

    dev = desc_q.device
    min1 = torch.empty(Q, dtype=torch.float32, device=dev)
    idx1 = torch.empty(Q, dtype=torch.int32, device=dev)
    min2 = torch.empty(Q, dtype=torch.float32, device=dev)
    if Q == 0:
        return min1, idx1, min2

    ptrs = (desc_q.data_ptr(), desc_t.data_ptr(), mask_t.data_ptr(),
            min1.data_ptr(), idx1.data_ptr(), min2.data_ptr())
    with cuda_build.on_card(dev, "top2_distances") as stream:
        lib = cuda_build.bind("top2_distances", SIGNATURES)
        if splits is None:
            err = lib.top2_distances_launch(*ptrs, Q, T, D, stream)
        else:
            err = lib.top2_distances_launch_forced(*ptrs, Q, T, D, splits, stream)
    cuda_build.launched(err, "top2_distances", "top2_distances.launches")
    return min1, idx1, min2


def launch_forced(
    desc_q: torch.Tensor, desc_t: torch.Tensor, mask_t: torch.Tensor, splits: int
):
    """The kernel under a cluster of ``splits`` blocks (1, 2, 4 or 8) instead
    of the size its shape picks; CUDA tensors only."""
    return _launch(desc_q, desc_t, mask_t, splits)


def top2_distances(desc_q: torch.Tensor, desc_t: torch.Tensor, mask_t: torch.Tensor):
    """Row-wise (min1, idx1, min2) squared L2 distances; see the module doc."""
    if cuda_build.use_kernel(desc_q.device, "top2_distances"):
        return _launch(desc_q, desc_t, mask_t)
    return top2_distances_reference(desc_q, desc_t, mask_t)
