"""``estimation.essential_refine_ms``: ms a mono frame in ``gn_refine_essential``
(the Sampson Gauss-Newton that ``find_essential`` runs on its best hypothesis),
timed by the span around ``find_essential``'s call, in the traced window; a
frame that runs no essential estimator adds nothing."""

SPANS = {"essential_refine": ["ergo_uvo_tpu_torch.estimation.essential:gn_refine_essential"]}


def read(run):
    s = run.spans.seconds.get("essential_refine")
    return 1e3 * sum(s) / run.frames if s else None
