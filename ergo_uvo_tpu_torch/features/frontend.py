"""Feature frontend: detect + describe — counterpart of ``ergo_uvo_tpu/features/frontend.py``.

All four branches of the reference's ``detect_features`` dispatch
(VO_utility.cpp:91-126): SURF (the configured default,
mono_VO_parameters.yaml:15), SIFT, ORB and AKAZE.  An unknown name raises, as
the reference's error path does (VO_utility.cpp:120-124).
"""

from __future__ import annotations

import torch

from ergo_uvo_tpu_torch.config import AkazeConfig, SurfConfig
from ergo_uvo_tpu_torch.features.akaze import detect_and_describe_akaze
from ergo_uvo_tpu_torch.features.descriptor import describe_surf
from ergo_uvo_tpu_torch.features.detector import Keypoints, detect_surf
from ergo_uvo_tpu_torch.features.orb import describe_orb, detect_orb
from ergo_uvo_tpu_torch.features.sift import detect_and_describe_sift
from ergo_uvo_tpu_torch.utils.profiling import span


def detect_and_describe(
    img: torch.Tensor,
    surf: SurfConfig = SurfConfig(),
    max_keypoints: int = 512,
    feature_detector: str = "SURF",
    orb_threshold: float = 20.0,
    sift_contrast_threshold: float = 0.03,
    sift_edge_threshold: float = 10.0,
    akaze: AkazeConfig = AkazeConfig(),
) -> tuple[Keypoints, torch.Tensor]:
    """(Keypoints, descriptors) for a preprocessed gray frame, or for
    (..., H, W) frames at once: leading dimensions lead every output.

    SURF gives 64/128-d floats, SIFT 128-d floats, ORB 256 bits and AKAZE
    486 bits padded to 512, the binary two as {0,1} floats: match those with
    ``binary=True``.
    """
    with span("detect"):
        name = feature_detector.upper()
        if name == "ORB":
            kpts = detect_orb(img, max_keypoints=max_keypoints, threshold=orb_threshold)
            return kpts, describe_orb(img, kpts)
        if name == "AKAZE":
            return detect_and_describe_akaze(
                img,
                max_keypoints=max_keypoints,
                threshold=akaze.threshold,
                n_octaves=akaze.n_octaves,
                n_sublevels=akaze.n_sublevels,
                upright=akaze.upright,
            )
        if name == "SIFT":
            return detect_and_describe_sift(
                img,
                max_keypoints=max_keypoints,
                contrast_thresh=sift_contrast_threshold,
                edge_thresh=sift_edge_threshold,
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


def detect_and_describe_cfg(img: torch.Tensor, cfg) -> tuple[Keypoints, torch.Tensor]:
    """:func:`detect_and_describe` under a mono or stereo config's knobs."""
    return detect_and_describe(
        img, cfg.surf, cfg.max_keypoints, cfg.feature_detector, cfg.orb_threshold,
        cfg.sift_contrast_threshold, cfg.sift_edge_threshold, akaze=cfg.akaze,
    )


def is_binary(cfg) -> bool:
    """The config's detector gives bit vectors (ORB, AKAZE): match them by Hamming."""
    return cfg.feature_detector.upper() in ("ORB", "AKAZE")
