"""``image.preprocess_ms``: ms a frame in ``preprocess_frame`` (both eyes in stereo),
timed by the span around the runners' call, in the traced window."""

SPANS = {"preprocess": ["ergo_uvo_tpu_torch.pipeline.mono:preprocess_frame",
                        "ergo_uvo_tpu_torch.pipeline.stereo:preprocess_frame"]}


def read(run):
    s = run.spans.seconds.get("preprocess")
    return 1e3 * sum(s) / run.frames if s else None
