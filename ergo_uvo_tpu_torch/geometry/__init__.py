"""Geometry primitives of the port (PyTorch)."""

from ergo_uvo_tpu_torch.geometry.camera import (  # noqa: F401
    PinholeCamera,
    distort_normalized,
    normalized_to_pixel,
    pixel_to_normalized,
    project_points,
    projection_matrix,
    resize_camera_matrix,
    resized_height,
    undistort_normalized,
)
from ergo_uvo_tpu_torch.geometry.linalg import (  # noqa: F401
    inv33,
    jacobi_eigh,
    jacobi_eigh_reference,
    polar_so3,
    smallest_eigvec,
)
from ergo_uvo_tpu_torch.geometry.rotations import (  # noqa: F401
    euler_to_quaternion,
    euler_to_rotation,
    is_rotation_matrix,
    project_to_so3,
    quaternion_to_rotation,
    rotation_to_euler,
    rotation_to_quaternion,
    rotx,
    roty,
    rotz,
    rpy_rate_jacobian,
    skew,
    so3_exp,
    so3_log,
    wrap2pi,
)
from ergo_uvo_tpu_torch.geometry.se3 import SE3, se3_exp, se3_log  # noqa: F401
from ergo_uvo_tpu_torch.geometry.stats import (  # noqa: F401
    masked_mean,
    masked_mean_and_variance,
    masked_median,
)
from ergo_uvo_tpu_torch.geometry.triangulation import (  # noqa: F401
    cheirality_mask,
    filter_3d_points,
    reprojection_errors,
    transform_points,
    triangulate_points,
)
from ergo_uvo_tpu_torch.geometry.geodesy import (  # noqa: F401
    WGS84_A,
    WGS84_F,
    ll_to_ne,
    lld_to_ned,
    ne_to_ll,
    ned_to_lld,
)
