"""Carry mono VO state between the JAX package and the port.

There are no trained weights: the state a run carries is the
:class:`~ergo_uvo_tpu_torch.pipeline.mono.MonoVOState` (plus the config,
which both packages share as a dataclass).  The exchange format is a dict of
numpy arrays keyed by the state's field names, i.e. what
``jax.tree.map(np.asarray, state)._asdict()`` gives for the JAX package's
``MonoVOState``.
"""

from __future__ import annotations

import numpy as np
import torch

from ergo_uvo_tpu_torch.pipeline.mono import MonoVOState


def mono_state_from_numpy(d: dict[str, np.ndarray], device: torch.device | str) -> MonoVOState:
    """The port's state from a dict of numpy arrays with the same fields."""
    missing = set(MonoVOState._fields) - set(d)
    if missing:
        raise KeyError(f"mono state dict lacks {sorted(missing)}")
    return MonoVOState(
        *(torch.as_tensor(np.array(d[f])).to(device) for f in MonoVOState._fields)
    )


def mono_state_to_numpy(state: MonoVOState) -> dict[str, np.ndarray]:
    """A dict of numpy arrays, one per state field, copied to the host."""
    return {f: getattr(state, f).detach().cpu().numpy() for f in MonoVOState._fields}
