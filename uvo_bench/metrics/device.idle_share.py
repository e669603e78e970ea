"""``device.idle_share``: % of the profiled stretch in which no operation ran on
the card: 1 - the union of the trace's device intervals / the stretch."""


def read(run):
    if run.trace is None or run.stretch.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.stretch.window_s)
