"""``estimation.pnp_ms``: ms a stereo pair in ``solve_pnp_ransac`` (P3P minimal
sets, scoring, the Gauss-Newton steps), timed by the span around the step's
call, in the traced window."""

SPANS = {"pnp": ["ergo_uvo_tpu_torch.pipeline.stereo:solve_pnp_ransac"]}


def read(run):
    s = run.spans.seconds.get("pnp")
    return 1e3 * sum(s) / run.frames if s else None
