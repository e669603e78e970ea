"""``kernel.jacobi_eigh_roofline``: % of its roofline that ``jacobi_eigh.cu``
reaches over the profiled stretch: the least time its calls could take (the
batch, size and sweeps the span around ``jacobi_eigh`` records: 9x9 and
12x12 and 3x3 batches) over its device time in the trace."""

import math

from uvo_bench.roofline import jacobi_eigh_bound

KERNEL = "jacobi_eigh"
SPANS = {"jacobi": ["ergo_uvo_tpu_torch.geometry.linalg:jacobi_eigh",
                    "ergo_uvo_tpu_torch.estimation.p3p:jacobi_eigh"]}


def _shapes(A, sweeps=7):
    return math.prod(A.shape[:-2]), A.shape[-1], sweeps


SHAPES = {"jacobi": _shapes}


def read(run):
    calls = run.spans.shapes.get("jacobi")
    device_s = sum(s for name, s in run.trace.kernel_s.items() if KERNEL in name)
    if not calls or device_s <= 0:
        return None
    return 100.0 * sum(jacobi_eigh_bound(b, n, s) for b, n, s in calls) / device_s
