"""``features.sift_scale_space_ms``: ms a frame in SIFT's ``build_scale_space``
(the Gaussian pyramid and its DoG stacks, one call a detection), timed by the
span around the call, in the traced window."""

SPANS = {"sift.scale_space": ["ergo_uvo_tpu_torch.features.sift:build_scale_space"]}


def read(run):
    s = run.spans.seconds.get("sift.scale_space")
    return 1e3 * sum(s) / run.frames if s else None
