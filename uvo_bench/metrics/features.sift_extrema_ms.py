"""``features.sift_extrema_ms``: ms a frame in SIFT's ``_octave_keypoints`` (the
DoG extrema, the edge and contrast gates, the top-K and the quadratic
refinement, one call an octave), timed by the span around each call, in the
traced window."""

SPANS = {"sift.extrema": ["ergo_uvo_tpu_torch.features.sift:_octave_keypoints"]}


def read(run):
    s = run.spans.seconds.get("sift.extrema")
    return 1e3 * sum(s) / run.frames if s else None
