"""Carry VO state between the JAX package and the port.

There are no trained weights: the state a run carries is the
:class:`~ergo_uvo_tpu_torch.pipeline.mono.MonoVOState` or the
:class:`~ergo_uvo_tpu_torch.pipeline.stereo.StereoVOState`, plus for stereo
the static :class:`~ergo_uvo_tpu_torch.pipeline.stereo.StereoRig` (and the
config, which both packages share as a dataclass).  The exchange format is a
dict of numpy arrays keyed by the tuple's field names, i.e. what
``jax.tree.map(np.asarray, state)._asdict()`` gives for the JAX package's
tuple of the same name.  Dtypes are kept both ways.
"""

from __future__ import annotations

import numpy as np
import torch

from ergo_uvo_tpu_torch.pipeline.mono import MonoVOState
from ergo_uvo_tpu_torch.pipeline.stereo import StereoRig, StereoVOState


def _from_numpy(cls, d: dict[str, np.ndarray], device: torch.device | str):
    missing = set(cls._fields) - set(d)
    if missing:
        raise KeyError(f"{cls.__name__} dict lacks {sorted(missing)}")
    return cls(*(torch.as_tensor(np.array(d[f])).to(device) for f in cls._fields))


def _to_numpy(tup) -> dict[str, np.ndarray]:
    return {f: getattr(tup, f).detach().cpu().numpy() for f in tup._fields}


def mono_state_from_numpy(d: dict[str, np.ndarray], device: torch.device | str) -> MonoVOState:
    """The port's mono state from a dict of numpy arrays with the same fields."""
    return _from_numpy(MonoVOState, d, device)


def mono_state_to_numpy(state: MonoVOState) -> dict[str, np.ndarray]:
    """A dict of numpy arrays, one per state field, copied to the host."""
    return _to_numpy(state)


def stereo_state_from_numpy(d: dict[str, np.ndarray], device: torch.device | str) -> StereoVOState:
    """The port's stereo state from a dict of numpy arrays with the same fields."""
    return _from_numpy(StereoVOState, d, device)


def stereo_state_to_numpy(state: StereoVOState) -> dict[str, np.ndarray]:
    """A dict of numpy arrays, one per state field, copied to the host."""
    return _to_numpy(state)


def stereo_rig_from_numpy(d: dict[str, np.ndarray], device: torch.device | str) -> StereoRig:
    """The rig (``K_left``, ``K_right``, ``R_right``, ``t_right``) on ``device``."""
    return _from_numpy(StereoRig, d, device)
