"""``device.launches_per_frame``: kernel launches (``cudaLaunchKernel*`` and
``cuLaunchKernel*`` calls in the trace) a frame of the profiled stretch."""


def read(run):
    if run.trace is None or run.stretch.frames == 0 or run.trace.launches == 0:
        return None
    return run.trace.launches / run.stretch.frames
