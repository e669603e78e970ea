"""Image preprocessing of the port — ``get_image`` (VO_utility.cpp:337-379).

The reference's order: area resize to the configured width, RGB to gray,
undistort into the alpha=0 optimal new camera, optional CLAHE.  The
undistortion grid and the new camera matrix are computed once in numpy; the
per-frame path is tensor code on the plan's device, over any number of frames.
"""

from ergo_uvo_tpu_torch.image.clahe import clahe  # noqa: F401
from ergo_uvo_tpu_torch.image.preprocess import (  # noqa: F401
    PreprocessPlan,
    build_preprocess_plan,
    preprocess_frame,
    remap_bilinear,
    resize_area,
    rgb_to_gray,
)
from ergo_uvo_tpu_torch.image.undistort import (  # noqa: F401
    build_undistort_grid,
    optimal_new_camera,
)
