"""Descriptor distance + row top-2: the plain version of the port's
``features/top2_matcher.py``.

For each query row: the smallest squared L2 distance to the valid train rows,
its train index (ties to the lowest index), and the second-smallest distance
over the other columns; d = max(|q|^2 + |t|^2 - 2 q.t, 0), and a row with no
valid column gives (+inf, 0, +inf).  The port's ``top2_distances.cu`` kernel
computes the same on the card.
"""

from __future__ import annotations

import torch


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


top2_distances = top2_distances_reference
