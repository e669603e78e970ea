"""Frame ingestion for the port: the synthetic scene renderer (numpy)."""

from ergo_uvo_tpu_torch.io.synthetic import (  # noqa: F401
    SyntheticSequence,
    make_loop_sequence,
    make_mono_sequence,
    make_seafloor_texture,
    make_stereo_sequence,
    render_frame,
)
