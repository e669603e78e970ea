"""Pose estimation of the port: essential / homography (mono) and P3P + PnP RANSAC (stereo)."""

from ergo_uvo_tpu_torch.estimation.essential import (  # noqa: F401
    eight_point_essential,
    find_essential,
    recover_pose_from_essential,
    sampson_error_sq,
)
from ergo_uvo_tpu_torch.estimation.homography import (  # noqa: F401
    decompose_homography,
    find_homography,
    four_point_homography,
    homography_transfer_error_sq,
    recover_pose_homography,
)
from ergo_uvo_tpu_torch.estimation.p3p import p3p  # noqa: F401
from ergo_uvo_tpu_torch.estimation.pnp import (  # noqa: F401
    PnPResult,
    gauss_newton_pnp,
    solve_pnp_ransac,
)
from ergo_uvo_tpu_torch.estimation.relative_pose import (  # noqa: F401
    RelativePoseResult,
    estimate_relative_pose,
    select_estimation_method,
)
from ergo_uvo_tpu_torch.estimation.robust import (  # noqa: F401
    lmeds_inlier_mask,
    score_hypotheses,
)
from ergo_uvo_tpu_torch.estimation.sampling import sample_minimal_sets  # noqa: F401
