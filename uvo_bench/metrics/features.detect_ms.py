"""``features.detect_ms``: ms a frame in ``detect_and_describe_cfg`` (both eyes in
stereo), timed by the span around the steps' call, in the traced window."""

SPANS = {"detect": ["ergo_uvo_tpu_torch.pipeline.mono:detect_and_describe_cfg",
                    "ergo_uvo_tpu_torch.pipeline.stereo:detect_and_describe_cfg"]}


def read(run):
    s = run.spans.seconds.get("detect")
    return 1e3 * sum(s) / run.frames if s else None
