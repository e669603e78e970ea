"""Feature detection, description and matching (PyTorch): SURF, SIFT, ORB, AKAZE."""

from ergo_uvo_tpu_torch.features.akaze import (  # noqa: F401
    describe_akaze,
    detect_akaze,
    detect_and_describe_akaze,
)
from ergo_uvo_tpu_torch.features.descriptor import (  # noqa: F401
    describe_surf,
    describe_upright_surf,
    surf_orientations,
)
from ergo_uvo_tpu_torch.features.detector import Keypoints, detect_surf  # noqa: F401
from ergo_uvo_tpu_torch.features.frontend import detect_and_describe  # noqa: F401
from ergo_uvo_tpu_torch.features.integral import integral_image  # noqa: F401
from ergo_uvo_tpu_torch.features.matcher import (  # noqa: F401
    Matches,
    match_and_gather,
    match_descriptors,
)
from ergo_uvo_tpu_torch.features.orb import describe_orb, detect_orb  # noqa: F401
from ergo_uvo_tpu_torch.features.sift import detect_and_describe_sift  # noqa: F401
from ergo_uvo_tpu_torch.features.top2_matcher import (  # noqa: F401
    top2_distances,
    top2_distances_reference,
)
