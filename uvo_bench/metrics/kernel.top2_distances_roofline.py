"""``kernel.top2_distances_roofline``: % of its roofline that ``top2_distances.cu``
reaches over the profiled stretch: the least time its calls could take (the
shapes the span around ``top2_distances`` records) over its device time in
the trace."""

from uvo_bench.roofline import top2_distances_bound

KERNEL = "top2_kernel"
SPANS = {"top2": ["ergo_uvo_tpu_torch.features.matcher:top2_distances"]}


def _shapes(desc_q, desc_t, mask_t):
    # The mask itself: its valid rows are counted after the stretch, so that
    # the stretch holds only the program's own launches.
    return desc_q.shape[0], desc_t.shape[0], desc_q.shape[1], mask_t


SHAPES = {"top2": _shapes}


def read(run):
    calls = run.spans.shapes.get("top2")
    device_s = sum(s for name, s in run.trace.kernel_s.items() if KERNEL in name)
    if not calls or device_s <= 0:
        return None
    bound_s = sum(top2_distances_bound(q, t, d, int(m.sum())) for q, t, d, m in calls)
    return 100.0 * bound_s / device_s
