"""The per-layer metrics of matching, the Sampson Gauss-Newton and the second
attempts: a traced run of a small frame on the CPU reads each finite, and the
second-attempt share from the window's outputs equals the port's own counter
over the same frames."""

import math
import time

import pytest
import torch

from ergo_uvo_tpu_torch.utils import profiling
from uvo_bench import harness, spec

SEED = 2**31 + 57
NEW = ("features.match_ms", "estimation.essential_refine_ms",
       "estimation.second_attempt_share")
SMALL = {"config": {"camera": {"width": 160, "height": 120},
                    "preprocessing": {"desired_width": 160}, "reference_frames": 3},
         "traffic": {"frames_per_pass": 8, "texture_size": 256, "profiled_frames": 2}}
# At the small frame the YAML's gate passes every first attempt; a stricter
# one fails some, so that the share reads neither 0 nor 100.
STRICT = {"config": {**SMALL["config"], "valid_point_fraction": 0.9},
          "traffic": SMALL["traffic"]}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload,overrides", [("mono_surf_vga.survey_20hz", STRICT),
                                                ("stereo_surf_vga.survey_20hz", SMALL)],
                         ids=["mono", "stereo"])
def test_the_new_metrics_read_finite_values_in_a_traced_run(workload, overrides, monkeypatch):
    cell = spec.load_cell(workload)
    cell = cell._replace(per_layer=[m for m in cell.per_layer if m["name"] in NEW])
    assert cell.per_layer
    # The port's own count of second attempts, frame by frame, over the window.
    import ergo_uvo_tpu_torch.pipeline.mono as mono

    steps, in_window = [], []
    real_step, real_window = mono.mono_vo_step, harness._stream_window

    def step(*args, **kwargs):
        before = profiling.COUNTERS["relative_pose.second_attempts"]
        state, out = real_step(*args, **kwargs)
        if in_window:
            steps.append((bool(out.published),
                          profiling.COUNTERS["relative_pose.second_attempts"] - before))
        return state, out

    def window(*args, **kwargs):
        in_window.append(True)
        try:
            return real_window(*args, **kwargs)
        finally:
            in_window.clear()

    monkeypatch.setattr(mono, "mono_vo_step", step)
    monkeypatch.setattr(harness, "_stream_window", window)
    result = harness.run_cell(cell, SEED, 3.0, True, time.perf_counter(), device="cpu",
                              overrides=overrides, log_fn=lambda *a, **k: None)
    assert result["correct"], result["compared"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(metrics) == {m["name"] for m in cell.per_layer}
    assert all(math.isfinite(v) and v >= 0 for v in metrics.values()), metrics
    if "estimation.second_attempt_share" in metrics:
        published = [n for p, n in steps if p]
        share = metrics["estimation.second_attempt_share"]
        assert len(published) >= 3 and 0 < share < 100
        assert share == pytest.approx(100.0 * sum(published) / len(published))
