"""End-to-end VO pipelines of the port: mono UVO (camera + range scale) and
stereo UVO (metric by baseline)."""

from ergo_uvo_tpu_torch.pipeline.mono import (  # noqa: F401
    MonoFrameOutput,
    MonoVOState,
    mono_vo_init,
    mono_vo_init_from,
    mono_vo_step,
    mono_vo_step_with_features,
    run_mono_vo,
    run_mono_vo_batched_features,
    run_mono_vo_streaming,
)
from ergo_uvo_tpu_torch.pipeline.stereo import (  # noqa: F401
    StereoFrameOutput,
    StereoRig,
    StereoVOState,
    run_stereo_vo,
    run_stereo_vo_streaming,
    stereo_vo_init,
    stereo_vo_init_from,
    stereo_vo_step,
)
