"""The configuration tree of the port's ``config.py`` (the reference YAMLs'
keys plus the static budgets), as frozen dataclasses: the plain reference
reads its settings from these.  The benchmark fills them from a
configuration's JSON file (``uvo_bench/spec.py::build_config``).
"""

from __future__ import annotations

from dataclasses import dataclass

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
