"""Geometry primitives of the port (PyTorch)."""

from ergo_uvo_tpu_torch.geometry.camera import projection_matrix  # noqa: F401
from ergo_uvo_tpu_torch.geometry.linalg import (  # noqa: F401
    inv33,
    jacobi_eigh,
    polar_so3,
    smallest_eigvec,
)
from ergo_uvo_tpu_torch.geometry.rotations import (  # noqa: F401
    project_to_so3,
    skew,
    so3_exp,
)
from ergo_uvo_tpu_torch.geometry.stats import (  # noqa: F401
    masked_mean,
    masked_mean_and_variance,
    masked_median,
)
from ergo_uvo_tpu_torch.geometry.triangulation import (  # noqa: F401
    cheirality_mask,
    filter_3d_points,
    reprojection_errors,
    triangulate_points,
)
