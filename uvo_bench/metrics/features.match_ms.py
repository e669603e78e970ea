"""``features.match_ms``: ms a frame in ``match_descriptors`` (one call a mono
frame; two a stereo pair, the stereo and the triangular match), timed by the
span around the steps' calls, in the traced window."""

SPANS = {"match": ["ergo_uvo_tpu_torch.pipeline.mono:match_descriptors",
                   "ergo_uvo_tpu_torch.pipeline.stereo:match_descriptors"]}


def read(run):
    s = run.spans.seconds.get("match")
    return 1e3 * sum(s) / run.frames if s else None
