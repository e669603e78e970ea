"""Holding a run of the port to the JAX package's own outputs.

A parity fixture (an ``.npz``; ``tests/fixtures/torch_parity_main.npz`` is
written by ``tests/test_torch_parity_main.py --write``) holds, for a mono and
a stereo run of the JAX package:

- ``{kind}/sequence`` and ``{kind}/config``: JSON of the synthetic
  sequence's arguments and of the config's, and ``{kind}/sha256``, the
  digest of the sequence's frames (:func:`frames_digest`);
- ``{kind}_eager/<field>`` and ``{kind}_jit/<field>``: the frame outputs of
  JAX's run under ``jax.disable_jit()`` and jitted, both under key 0;
- ``{kind}_sets/<frame>/<method>/{mask,idx,valid}``: each match mask the
  port presents to its sampler and the minimal sets JAX's
  ``sample_minimal_sets`` draws for it under that frame's and method's key.

The minimal sets are the one input that torch cannot draw as JAX does, so a
run that takes them from :class:`FixtureSampler` is a run of JAX's
decisions on the port's arithmetic; :func:`contract_report` then holds its
outputs to the repo's contract for re-scheduled runs
(``tests/test_pipeline.py:230-241``).  numpy and torch only.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

import numpy as np
import torch

from ergo_uvo_tpu_torch.estimation.sampling import sample_minimal_sets

COUNT_SLACK = 2  # a count may differ from JAX's by this much


@dataclass(frozen=True)
class Contract:
    exact: tuple[str, ...]
    counts: tuple[str, ...]
    atol: dict[str, float] = field(default_factory=dict)
    rtol: dict[str, float] = field(default_factory=dict)


MONO_CONTRACT = Contract(
    exact=("published", "validity", "used_essential", "num_features"),
    counts=("num_matches", "num_inliers", "num_3d_points"),
    atol={"velocity": 5e-3},
    rtol={"scale_factor": 1e-2},
)
STEREO_CONTRACT = Contract(
    exact=("published", "validity", "num_features_l", "num_features_r"),
    counts=("num_stereo_matches", "num_triangular_matches", "num_3d_points", "num_pnp_inliers"),
    atol={"velocity": 5e-3, "t": 2e-3, "R": 1e-3},
)
CONTRACTS = {"mono": MONO_CONTRACT, "stereo": STEREO_CONTRACT}


def frames_digest(*arrays: np.ndarray) -> str:
    """SHA-256 of the arrays' bytes, in order."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def sequence_digest(seq, kind: str) -> str:
    """The digest a fixture stores for a synthetic sequence: every frame,
    the timestamps, the ranges (mono) and the intrinsics."""
    if kind == "mono":
        return frames_digest(seq.imgs_left, seq.timestamps, seq.ranges, seq.K)
    return frames_digest(seq.imgs_left, seq.imgs_right, seq.timestamps, seq.K)


def load_fixture(path) -> dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def fixture_json(fixture: dict, key: str) -> dict:
    return json.loads(str(fixture[key]))


def fixture_sequence(fixture: dict, kind: str):
    """Regenerate the fixture's ``kind`` sequence and check it against the
    stored digest; raises ``ValueError`` when the frames differ."""
    from ergo_uvo_tpu_torch.io import make_mono_sequence, make_stereo_sequence

    make = make_mono_sequence if kind == "mono" else make_stereo_sequence
    seq = make(**fixture_json(fixture, f"{kind}/sequence"))
    digest, want = sequence_digest(seq, kind), str(fixture[f"{kind}/sha256"])
    if digest != want:
        raise ValueError(f"the regenerated {kind} frames hash to {digest}, the fixture's to {want}")
    return seq


def fixture_config(fixture: dict, kind: str, config_module):
    """The fixture's ``kind`` config, built from ``config_module`` (the
    port's ``config`` or the JAX package's)."""
    kw = fixture_json(fixture, f"{kind}/config")
    make = config_module.MonoVOConfig if kind == "mono" else config_module.StereoVOConfig
    return make(surf=config_module.SurfConfig(**kw.pop("surf")), **kw)


def reference_outputs(fixture: dict, kind: str, run: str = "eager") -> dict[str, np.ndarray]:
    """JAX's frame outputs of ``run`` ("eager" or "jit"), by field."""
    prefix = f"{kind}_{run}/"
    return {k[len(prefix):]: v for k, v in fixture.items() if k.startswith(prefix)}


def set_entries(fixture: dict, kind: str) -> list[tuple[int, str]]:
    """The (frame, method) pairs whose minimal sets the fixture holds."""
    prefix = f"{kind}_sets/"
    keys = {tuple(k[len(prefix):].split("/")[:2]) for k in fixture if k.startswith(prefix)}
    return sorted((int(f), m) for f, m in keys)


class FixtureSampler:
    """``sampler(frame, method, mask, H, m)`` for the port's runners that
    returns the fixture's minimal sets for (frame, method).

    Each mask the run presents is first held to the stored one.  A mask that
    differs, or a (frame, method) the fixture has no sets for, is written to
    ``failures`` (the frame, the method and the slots that differ) and the
    run goes on with the stored sets, or with sets drawn from a generator
    seeded 0 where none are stored, so that one run shows every
    disagreement; the caller fails on ``failures``.
    """

    def __init__(self, fixture: dict, kind: str):
        self.fixture = fixture
        self.prefix = f"{kind}_sets"
        self.asked: list[tuple[int, str]] = []
        self.failures: list[str] = []
        self._spare = torch.Generator().manual_seed(0)

    def __call__(self, frame, method, mask, num_hypotheses, set_size):
        self.asked.append((frame, method))
        key = f"{self.prefix}/{frame}/{method}"
        got = mask.cpu().numpy()
        if f"{key}/mask" not in self.fixture:
            self.failures.append(f"frame {frame}, {method}: the fixture holds no sets for it")
            return sample_minimal_sets(mask.cpu(), num_hypotheses, set_size, self._spare)
        want = self.fixture[f"{key}/mask"]
        if not np.array_equal(got, want):
            slots = np.flatnonzero(got != want).tolist()
            self.failures.append(f"frame {frame}, {method}: the mask differs from JAX's at slots "
                                 f"{slots} (port {got[slots].astype(int).tolist()})")
        idx, valid = self.fixture[f"{key}/idx"], self.fixture[f"{key}/valid"]
        if idx.shape != (num_hypotheses, set_size):
            raise ValueError(f"{key}: stored sets {idx.shape}, asked for "
                             f"({num_hypotheses}, {set_size})")
        return torch.from_numpy(idx.astype(np.int64)), torch.tensor(valid)


def contract_report(port: dict, ref: dict, contract: Contract) -> dict:
    """Hold ``port``'s frame outputs to ``ref``'s (the first ``len(port)``
    frames) under ``contract``, frame by frame.

    Returns ``failures`` (one line a field that breaks the contract, with its
    frames), ``max_abs`` (the largest |difference| of each float field),
    ``frames_counts_exact`` (how many frames hold every count exactly) and
    ``frames_differing`` (the frames where a discrete field or a count
    differs at all).
    """
    n = len(port[contract.exact[0]])
    ref = {k: v[:n] for k, v in ref.items()}
    failures, differing = [], np.zeros(n, bool)
    for name in contract.exact:
        bad = port[name].astype(np.int64) != ref[name].astype(np.int64)
        differing |= bad
        if bad.any():
            failures.append(f"{name} differs at frames {np.flatnonzero(bad).tolist()}")
    counts_exact = np.ones(n, bool)
    for name in contract.counts:
        diff = np.abs(port[name].astype(np.int64) - ref[name].astype(np.int64))
        counts_exact &= diff == 0
        if (diff > COUNT_SLACK).any():
            failures.append(f"{name} differs by more than {COUNT_SLACK} at frames "
                            f"{np.flatnonzero(diff > COUNT_SLACK).tolist()}")
    differing |= ~counts_exact
    max_abs = {}
    for name in (*contract.atol, *contract.rtol):
        a, b = port[name].astype(np.float64), ref[name].astype(np.float64)
        d = np.where(np.isnan(a) & np.isnan(b), 0.0, np.abs(a - b))
        max_abs[name] = float(np.max(np.where(np.isnan(d), np.inf, d), initial=0.0))
        ok = np.isclose(a, b, atol=contract.atol.get(name, 0.0), rtol=contract.rtol.get(name, 0.0),
                        equal_nan=True).reshape(n, -1).all(-1)
        if not ok.all():
            failures.append(f"{name} off its tolerance at frames {np.flatnonzero(~ok).tolist()}")
    return {"failures": failures, "max_abs": max_abs,
            "frames_counts_exact": int(counts_exact.sum()),
            "frames_differing": np.flatnonzero(differing).tolist()}
