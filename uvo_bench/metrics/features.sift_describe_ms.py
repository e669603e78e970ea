"""``features.sift_describe_ms``: ms a frame in SIFT's ``_orientations_and_desc``
(the patches, the 36-bin orientation and the 128-d descriptors of an octave's
candidates, one call an octave), timed by the span around each call, in the
traced window."""

SPANS = {"sift.describe": ["ergo_uvo_tpu_torch.features.sift:_orientations_and_desc"]}


def read(run):
    s = run.spans.seconds.get("sift.describe")
    return 1e3 * sum(s) / run.frames if s else None
