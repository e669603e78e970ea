"""Windowed optimization layers of the port — counterpart of ``ergo_uvo_tpu/optim/``.

* ``ba``: sliding-window bundle adjustment (LM + Schur complement);
* ``keyframes``: the keyframe window that feeds BA;
* ``pose_graph``: pose-graph optimization and descriptor-retrieval loop closure;
* ``trajectory``: from VO outputs to a refined trajectory.
"""

from ergo_uvo_tpu_torch.optim.ba import (  # noqa: F401
    BAProblem,
    BAState,
    ba_solve,
    ba_step,
    reprojection_residuals,
)
from ergo_uvo_tpu_torch.optim.keyframes import KeyframeWindow, WindowedBA  # noqa: F401
from ergo_uvo_tpu_torch.optim.pose_graph import (  # noqa: F401
    PoseGraph,
    detect_loop_closures,
    optimize_pose_graph,
)
from ergo_uvo_tpu_torch.optim.trajectory import (  # noqa: F401
    BATrajectoryResult,
    PoseGraphResult,
    close_loops_and_optimize,
    close_loops_and_optimize_stereo,
    integrate_mono_poses,
    refine_mono_trajectory,
    verify_loop_candidate,
    verify_loop_candidate_pnp,
)
