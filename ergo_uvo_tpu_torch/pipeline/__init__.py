"""End-to-end VO pipelines of the port: mono UVO (camera + range scale)."""

from ergo_uvo_tpu_torch.pipeline.mono import (  # noqa: F401
    MonoFrameOutput,
    MonoVOState,
    mono_vo_init,
    mono_vo_init_from,
    mono_vo_step,
    mono_vo_step_with_features,
    run_mono_vo,
)
