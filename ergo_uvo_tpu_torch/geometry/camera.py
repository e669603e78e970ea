"""Camera helpers of the main path — counterpart of ``ergo_uvo_tpu/geometry/camera.py``.

Only ``projection_matrix`` is on the mono slice; the distortion model and K
rescaling belong to preprocessing, which a later slice ports.
"""

from __future__ import annotations

import torch


def projection_matrix(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """P = K [R | t], shape (..., 3, 4) (VO_utility.cpp:9-15)."""
    return K @ torch.cat([R, t[..., None]], dim=-1)
