"""Feature frontend: the plain version of the port's ``features/frontend.py``.

SURF is here.  Any other ``feature_detector`` is the plain file
``uvo_bench/reference/features/<name lower>.py`` of its own, found by name,
with a ``detect_and_describe_cfg(img, cfg)`` of the same form; a detector
without one raises, naming the file to add.
"""

from __future__ import annotations

import importlib

import torch

from uvo_bench.reference.features.descriptor import describe_surf
from uvo_bench.reference.features.detector import Keypoints, detect_surf

BINARY = ("ORB", "AKAZE")  # bit-vector descriptors, matched by Hamming distance


def _frontend(name: str):
    module = f"{__package__}.{name.lower()}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise NotImplementedError(
            f"the plain reference has no {name} frontend: add "
            f"uvo_bench/reference/features/{name.lower()}.py with "
            f"detect_and_describe_cfg(img, cfg)"
        ) from None


def detect_and_describe_cfg(img: torch.Tensor, cfg) -> tuple[Keypoints, torch.Tensor]:
    """(Keypoints, descriptors) of a preprocessed gray frame under a mono or
    stereo config's detector and its settings."""
    name = cfg.feature_detector.upper()
    if name != "SURF":
        return _frontend(name).detect_and_describe_cfg(img, cfg)
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
    """The config's detector gives bit vectors (ORB, AKAZE): matched by Hamming,
    the ratio test on the distances themselves, as the port's rule."""
    return cfg.feature_detector.upper() in BINARY
