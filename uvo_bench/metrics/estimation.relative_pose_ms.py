"""``estimation.relative_pose_ms``: ms a mono frame in ``estimate_relative_pose``
(method choice, the robust fits, the switch), timed by the span around the
step's call, in the traced window."""

SPANS = {"relative_pose": ["ergo_uvo_tpu_torch.pipeline.mono:estimate_relative_pose"]}


def read(run):
    s = run.spans.seconds.get("relative_pose")
    return 1e3 * sum(s) / run.frames if s else None
