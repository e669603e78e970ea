"""Whole runs of the harness.

On the CPU at a small frame (the harness's look for a card skipped): a cell
assembled from data files alone runs and is correct, chunked streams too;
with the timed path broken underneath (an answer or a flag altered where it
is produced, in the middle of a chunk too, a step that returns its state
unchanged) ``correct`` comes out false.
Without a card ``run.py`` prints no result and fails.  On the card
(``cuda``): the control, the plain reference in TF32 in the program's place,
comes out not correct in every cell.
"""

import json
import subprocess
import sys
import time

import pytest
import torch

from uvo_bench import harness, spec

SEED = 2**31 + 21
SMALL = {"config": {"camera": {"width": 160, "height": 120},
                    "preprocessing": {"desired_width": 160}, "reference_frames": 3},
         "traffic": {"frames_per_pass": 8, "texture_size": 256}}
# A chunked mix at the CPU's pace: chunks of 4, one of them checked.
CHUNKED = {"config": {**SMALL["config"], "reference_frames": 4},
           "traffic": {**SMALL["traffic"], "chunk_size": 4}}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _data_only_cell(config, traffic, name="test_cell"):
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] = bench["workloads"] + [
        {"name": name, "config": config, "traffic": traffic, "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [name]
    return spec.load_cell(name, bench)


def _run(cell, device="cpu", overrides=SMALL, seconds=2.5, **kw):
    return harness.run_cell(cell, SEED, seconds, False, time.perf_counter(), device=device,
                            overrides=overrides, log_fn=lambda *a, **k: None, **kw)


DATA_ONLY = [("mono_surf_vga", "steady_20hz", SMALL), ("stereo_surf_vga", "steady_20hz", SMALL),
             ("mono_surf_vga", "offline_dive", CHUNKED)]


@pytest.mark.parametrize("config,traffic,overrides",
                         [pytest.param(c, t, o, id=f"{c}-{t}") for c, t, o in DATA_ONLY])
def test_a_cell_made_of_data_files_runs_and_is_correct(config, traffic, overrides):
    result = _run(_data_only_cell(config, traffic), overrides=overrides)
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 3 and result["failed"] == 0
    assert set(result["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("kind,step", [("mono", "mono_vo_step"), ("stereo", "stereo_vo_step")])
def test_an_answer_altered_where_it_is_produced_is_not_correct(kind, step, monkeypatch):
    module = __import__(f"ergo_uvo_tpu_torch.pipeline.{kind}", fromlist=[step])
    real = getattr(module, step)

    def altered(*args, **kwargs):
        state, out = real(*args, **kwargs)
        return state, out._replace(velocity=out.velocity * 1.5)

    monkeypatch.setattr(module, step, altered)
    result = _run(_data_only_cell(f"{kind}_surf_vga", "survey_20hz"))
    assert not result["correct"]
    assert result["compared"]["velocity_gap"]["value"] > result["compared"]["velocity_gap"]["limit"]


def test_an_answer_altered_in_the_middle_of_a_chunk_is_not_correct(monkeypatch):
    """Frame 2 of every chunk of 4 (never a chunk's first, whose generator
    state the window records): the check replays whole chunks and sees it."""
    from ergo_uvo_tpu_torch.pipeline import mono

    real = mono.mono_vo_step
    dt = spec.load_json(spec.BENCH_DIR / "traffic" / "offline_dive.json")["dt"]

    def altered(state, img, timestamp, *args, **kwargs):
        state, out = real(state, img, timestamp, *args, **kwargs)
        middle = round(float(timestamp) / dt) % 4 == 2
        return state, out._replace(velocity=out.velocity * 1.5) if middle else out

    monkeypatch.setattr(mono, "mono_vo_step", altered)
    result = _run(_data_only_cell("mono_surf_vga", "offline_dive"), overrides=CHUNKED)
    assert not result["correct"]
    assert result["compared"]["velocity_gap"]["value"] > result["compared"]["velocity_gap"]["limit"]


@pytest.mark.parametrize("kind,step", [("mono", "mono_vo_step"), ("stereo", "stereo_vo_step")])
def test_a_flag_altered_where_it_is_produced_is_not_correct(kind, step, monkeypatch):
    module = __import__(f"ergo_uvo_tpu_torch.pipeline.{kind}", fromlist=[step])
    real = getattr(module, step)
    calls = []

    def flipped(*args, **kwargs):
        state, out = real(*args, **kwargs)
        calls.append(None)
        return state, out._replace(validity=~out.validity) if len(calls) % 3 == 0 else out

    monkeypatch.setattr(module, step, flipped)
    result = _run(_data_only_cell(f"{kind}_surf_vga", "survey_20hz"))
    assert not result["correct"]
    assert result["compared"]["flags_differ"]["value"] > result["compared"]["flags_differ"]["limit"]


@pytest.mark.parametrize("kind,step", [("mono", "mono_vo_step"), ("stereo", "stereo_vo_step")])
def test_a_step_that_returns_its_state_unchanged_is_not_correct(kind, step, monkeypatch):
    module = __import__(f"ergo_uvo_tpu_torch.pipeline.{kind}", fromlist=[step])
    real = getattr(module, step)

    def stuck(state, *args, **kwargs):
        return state, real(state, *args, **kwargs)[1]

    monkeypatch.setattr(module, step, stuck)
    result = _run(_data_only_cell(f"{kind}_surf_vga", "survey_20hz"))
    assert not result["correct"], result["compared"]


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "uvo_bench/run.py", "--workload",
                           "mono_surf_vga.survey_20hz", "--seed", str(SEED), "--seconds", "1"],
                          cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in spec.load_json(
    spec.ROOT / "BENCHMARK.json")["workloads"]])
def test_the_tf32_control_is_not_correct_on_the_card(workload, card):
    small = {"config": {"reference_frames": 16}, "traffic": {"frames_per_pass": 60}}
    result = _run(spec.load_cell(workload), device="cuda", overrides=small, seconds=6.0,
                  control=True)
    assert not result["correct"], result["compared"]
