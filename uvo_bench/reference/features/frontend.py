"""Feature frontend, SURF branch: the plain version of the port's ``features/frontend.py``.

The configurations that the benchmark runs use SURF; another detector raises
here until its plain version is added beside this one.
"""

from __future__ import annotations

import torch

from uvo_bench.reference.features.descriptor import describe_surf
from uvo_bench.reference.features.detector import Keypoints, detect_surf


def detect_and_describe_cfg(img: torch.Tensor, cfg) -> tuple[Keypoints, torch.Tensor]:
    """(Keypoints, descriptors) of a preprocessed gray frame under a mono or
    stereo config's SURF settings."""
    if cfg.feature_detector.upper() != "SURF":
        raise NotImplementedError(
            f"the plain reference implements SURF only, not {cfg.feature_detector!r}"
        )
    surf = cfg.surf
    kpts = detect_surf(
        img,
        max_keypoints=cfg.max_keypoints,
        min_hessian=surf.min_hessian,
        n_octaves=surf.n_octaves,
        n_layers=surf.n_octave_layers,
    )
    desc = describe_surf(img, kpts, extended=surf.extended, upright=surf.upright)
    return kpts, desc


def is_binary(cfg) -> bool:
    """SURF descriptors are floats: matched by L2."""
    return False
