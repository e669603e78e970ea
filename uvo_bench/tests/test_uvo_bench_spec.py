"""``BENCHMARK.json`` and the files it names: each configuration, traffic mix,
per-layer metric and pipeline loads by name, and the file keeps the contract's
form."""

import json
import re

import pytest

from uvo_bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["uvo_bench"]
    assert BENCH["command"][1] == "uvo_bench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_loads_from_its_files(workload):
    cell = spec.load_cell(workload)
    assert cell.workload["chips"] == 1
    assert cell.config["pipeline"] in ("mono", "stereo")
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    limits = cell.config["limits"]
    assert "velocity_gap" in limits
    assert set(limits) <= {"velocity_gap", "rotation_gap_deg", "count_gap", "flags_differ"}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_metric_reader_loads_by_name(metric):
    reader = spec.load_module("metrics", metric)
    assert callable(reader.read)
    for targets in getattr(reader, "SPANS", {}).values():
        assert all(t.startswith("ergo_uvo_tpu_torch.") and ":" in t for t in targets)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_each_config_file_is_its_own_and_builds_the_ports_config(entry):
    from ergo_uvo_tpu_torch import config as port_config

    values = spec.load_json(spec.ROOT / entry["file"])
    assert entry["file"].startswith("uvo_bench/configs/") and entry["reduced"] == []
    cls = port_config.MonoVOConfig if values["pipeline"] == "mono" else port_config.StereoVOConfig
    built = spec.build_config(cls, values)
    # Every field of the port's configuration is stated in the file.
    import dataclasses
    assert set(f.name for f in dataclasses.fields(cls)) <= set(values)
    assert dataclasses.asdict(built) == {k: values[k] for k in dataclasses.asdict(built)}


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_each_config_takes_the_budgets_the_ports_loader_derives_from_the_yaml(entry):
    """``load_vo_params`` sizes the minimal sets from the YAML's RANSAC keys
    (mono: essential_confidence / essential_max_iters, 8-point sets against
    OpenCV's 5; stereo: confidence / iterations_count, P3P's 3 against EPnP's
    4) and keeps 512 keypoints; the file states the same."""
    from ergo_uvo_tpu_torch.estimation.sampling import derive_hypothesis_budget

    values = spec.load_json(spec.ROOT / entry["file"])
    if values["pipeline"] == "mono":
        want = derive_hypothesis_budget(values["essential"]["confidence"],
                                        values["essential"]["max_iters"], 8, 5)
    else:
        want = derive_hypothesis_budget(values["confidence"], values["iterations_count"], 3, 4)
    assert values["num_hypotheses"] == want
    assert values["max_keypoints"] == 512


@pytest.mark.parametrize("traffic", sorted({w["traffic"] for w in BENCH["workloads"]}))
def test_each_traffic_file_loads_by_name(traffic):
    values = spec.load_json(spec.BENCH_DIR / "traffic" / f"{traffic}.json")
    assert values["frames_per_pass"] == 1200 and values["dt"] == 0.05


def test_an_unknown_workload_raises():
    with pytest.raises(KeyError):
        spec.load_cell("no_such_cell")


def test_a_metric_that_no_cell_reads_stops_the_run():
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"][0]["workloads"] = ["no_such_cell"]
    with pytest.raises(ValueError, match="no cell"):
        spec.load_cell(bench["workloads"][0]["name"], bench)
