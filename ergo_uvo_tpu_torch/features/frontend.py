"""Feature frontend: detect + describe — counterpart of ``ergo_uvo_tpu/features/frontend.py``.

Only the SURF branch, the configured default of the reference
(mono_VO_parameters.yaml:15), is ported; ORB, SIFT and AKAZE raise.
"""

from __future__ import annotations

import torch

from ergo_uvo_tpu_torch.config import SurfConfig
from ergo_uvo_tpu_torch.features.descriptor import describe_surf
from ergo_uvo_tpu_torch.features.detector import Keypoints, detect_surf


def detect_and_describe(
    img: torch.Tensor,
    surf: SurfConfig = SurfConfig(),
    max_keypoints: int = 512,
    feature_detector: str = "SURF",
) -> tuple[Keypoints, torch.Tensor]:
    """(Keypoints, descriptors) for a preprocessed gray frame, or for
    (..., H, W) frames at once: leading dimensions lead every output.

    The JAX package's ORB, SIFT and AKAZE knobs come with those branches.
    """
    name = feature_detector.upper()
    if name in ("ORB", "SIFT", "AKAZE"):
        raise NotImplementedError(
            f"feature_detector={feature_detector!r} is not ported yet: "
            "ROADMAP.md Queue 1, item 10 (alternate detectors)"
        )
    if name != "SURF":
        raise NotImplementedError(
            f"feature_detector={feature_detector!r}: the reference dispatch "
            "implements AKAZE, ORB, SIFT and SURF (VO_utility.cpp:91-126)"
        )
    kpts = detect_surf(
        img,
        max_keypoints=max_keypoints,
        min_hessian=surf.min_hessian,
        n_octaves=surf.n_octaves,
        n_layers=surf.n_octave_layers,
    )
    desc = describe_surf(img, kpts, extended=surf.extended, upright=surf.upright)
    return kpts, desc
