"""The cell ``mono_sift_vga.steady_20hz`` on the CPU at a small frame: it is
correct, a descriptor altered where the port produces it is not, and a traced
run reads the three SIFT metrics.  (The TF32 control on the card is
``test_uvo_bench_cell.py``'s, parametrised over every cell.)"""

import math
import time

import pytest
import torch

from uvo_bench import harness, spec

CELL = "mono_sift_vga.steady_20hz"
SEED = 2**31 + 77
SMALL = {"config": {"camera": {"width": 160, "height": 120},
                    "preprocessing": {"desired_width": 160}, "reference_frames": 3},
         "traffic": {"frames_per_pass": 8, "texture_size": 256, "profiled_frames": 2}}
SIFT_METRICS = ("features.sift_scale_space_ms", "features.sift_extrema_ms",
                "features.sift_describe_ms")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cell, trace=False, seconds=4.0):
    return harness.run_cell(cell, SEED, seconds, trace, time.perf_counter(), device="cpu",
                            overrides=SMALL, log_fn=lambda *a, **k: None)


def test_the_sift_cell_runs_and_is_correct():
    result = _run(spec.load_cell(CELL))
    assert result["correct"], result["compared"]
    assert result["failed"] == 0
    assert set(result["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())


def test_a_descriptor_altered_where_it_is_produced_is_not_correct(monkeypatch):
    """Seeded noise on every octave's descriptors, a third of an element's
    typical size (0.088 in a unit 128-d vector): the ratio test then keeps
    other matches."""
    from ergo_uvo_tpu_torch.features import sift

    real = sift._orientations_and_desc
    gen = torch.Generator().manual_seed(5)

    def altered(*args, **kwargs):
        angle, desc = real(*args, **kwargs)
        noise = 0.03 * torch.randn(desc.shape, generator=gen).to(desc.device)
        return angle, torch.where(desc != 0, desc + noise, desc)

    monkeypatch.setattr(sift, "_orientations_and_desc", altered)
    result = _run(spec.load_cell(CELL))
    assert not result["correct"], result["compared"]


def test_a_traced_run_reads_the_sift_metrics():
    cell = spec.load_cell(CELL)
    cell = cell._replace(per_layer=[m for m in cell.per_layer if m["name"] in SIFT_METRICS])
    assert {m["name"] for m in cell.per_layer} == set(SIFT_METRICS)
    result = _run(cell, trace=True)
    assert result["correct"], result["compared"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(metrics) == set(SIFT_METRICS)
    assert all(math.isfinite(v) and v > 0 for v in metrics.values()), metrics
