"""Trajectory evaluation of the port: ATE / RPE (a numpy copy of ``ergo_uvo_tpu/eval/``'s ``ate.py``).

``reference_oracle`` (numpy + cv2, the OpenCV re-execution of the reference)
is imported by its path, as in the JAX package.
"""

from ergo_uvo_tpu_torch.eval.ate import (  # noqa: F401
    ate_rmse,
    integrate_mono_poses,
    integrate_mono_trajectory,
    rpe_rmse,
    umeyama_alignment,
    velocity_rmse,
)
