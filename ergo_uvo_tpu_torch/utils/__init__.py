"""Auxiliary subsystems of the port (SURVEY.md §5): checkpointing, profiling,
records, numerical checks, match visualization."""

from ergo_uvo_tpu_torch.utils.checkpoint import (  # noqa: F401
    restore_state,
    save_state,
)
from ergo_uvo_tpu_torch.utils.debug import assert_finite, nan_guard  # noqa: F401
from ergo_uvo_tpu_torch.utils.profiling import recording, span  # noqa: F401
from ergo_uvo_tpu_torch.utils.records import RunRecorder  # noqa: F401
from ergo_uvo_tpu_torch.utils.visualize import (  # noqa: F401
    draw_matches,
    dump_matches,
    save_image,
)
