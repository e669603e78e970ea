"""Numerical-safety hooks — counterpart of ``ergo_uvo_tpu/utils/debug.py``.

The reference has no sanitizers.  The JAX package's ``nan_guard`` turns on
``jax_debug_nans``, which re-runs a compiled function op by op on a NaN; the
port runs eagerly and has no such switch, so its :func:`nan_guard` is a scope
in which the runners check each frame's outputs (:func:`check_frame`) and
raise ``FloatingPointError`` at the first frame that is not finite.  Each
check reads the frame's outputs back from the card, which is the price of
debugging, as in JAX; outside the scope :func:`check_frame` does nothing.
:func:`assert_finite` is the always-on check of a run's outputs.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from typing import NamedTuple

import numpy as np
import torch

_NAN_GUARD = contextvars.ContextVar("ergo_uvo_tpu_torch_nan_guard", default=False)


@contextmanager
def nan_guard():
    """Check every frame the runners compute within the scope (debug only)."""
    token = _NAN_GUARD.set(True)
    try:
        yield
    finally:
        _NAN_GUARD.reset(token)


def _non_finite_fields(tup: NamedTuple) -> list[str]:
    bad = []
    for name, value in tup._asdict().items():
        if isinstance(value, torch.Tensor):
            if value.is_floating_point() and not bool(torch.isfinite(value).all()):
                bad.append(name)
        else:
            arr = np.asarray(value)
            if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
                bad.append(name)
    return bad


def check_frame(out: NamedTuple, frame: int) -> None:
    """Within :func:`nan_guard`, raise if a float field of one frame's output
    is not finite; outside it, nothing (no read-back)."""
    if _NAN_GUARD.get():
        bad = _non_finite_fields(out)
        if bad:
            raise FloatingPointError(f"non-finite values in frame {frame}: {bad}")


def assert_finite(tup: NamedTuple, name: str = "outputs") -> None:
    """Check that every float field of a NamedTuple of tensors or numpy
    arrays is finite."""
    bad = _non_finite_fields(tup)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
