"""The manifest and every configuration, traffic, cell and metric file parse
and agree; a new cell and a new metric are found from new files alone."""

from __future__ import annotations

import json
import re

import pytest

from bench_fixtures import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"] and MANIFEST["command"][1] == "benchmark/run.py"
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in MANIFEST[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in MANIFEST["end_to_end"])
    for w in MANIFEST["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"] and w["chips"] == 1
    assert len({(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}) == len(MANIFEST["workloads"])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_agree_with_the_manifest(cell):
    from harness.manifest import Cell

    c = Cell(cell)
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    for key in ("config", "traffic", "chips", "why"):
        assert c.workload[key] == entry[key], key
    assert c.traffic["kind"] == "serve" and (BENCH / "harness" / "serve.py").exists()
    from harness.judge import numbers

    assert set(c.workload["limits"]) == set(numbers(c.family))
    e2e = {m["name"] for m in c.end_to_end()}
    assert {"setup_s", "serve_ms_p50", "serve_ms_p95"} <= e2e
    assert c.per_layer(), "every cell reports a per-layer metric"
    for m in c.per_layer():
        assert m["moves"] in e2e


@pytest.mark.parametrize("config", [c["name"] for c in MANIFEST["configs"]])
def test_config_files_build_in_port_and_reference(config):
    from reference.config import pipeline_config_from_dict as ref_build
    from sparse_pooling_tpu_torch.configs.config import pipeline_config_from_dict as port_build

    entry = next(c for c in MANIFEST["configs"] if c["name"] == config)
    data = json.loads((ROOT / entry["file"]).read_text())
    assert entry["file"] == f"benchmark/configs/{config}.json" and data["name"] == config
    assert data["reduced"] == entry["reduced"] and data["source"] == entry["source"]
    assert port_build(data["pipeline"]).to_json() == ref_build(data["pipeline"]).to_json()


@pytest.mark.parametrize("cell", sorted(p.stem for p in (BENCH / "workloads").glob("*.json")))
def test_every_cell_file_parses_and_builds(cell):
    """Cell files outside the manifest too: their configuration builds alike
    in the port and the reference, and their limits name the numbers the
    judge reads of their family."""

    from harness.judge import numbers
    from harness.manifest import Cell
    from reference.config import pipeline_config_from_dict as ref_build
    from sparse_pooling_tpu_torch.configs.config import pipeline_config_from_dict as port_build

    c = Cell(cell)
    assert c.workload["config"] == c.config["name"] and c.traffic["kind"] == "serve"
    assert set(c.workload["limits"]) == set(numbers(c.family))
    assert port_build(c.config["pipeline"]).to_json() == ref_build(c.config["pipeline"]).to_json()


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_metric_readers_load_and_return_nothing_without_data(metric):
    from harness.manifest import Cell

    read = Cell("rcnn-serve-b8").reader(metric)
    empty = {"kind": "serve", "profile": {}, "flops_per_frame": 1, "peak_flops": 1,
             "window": {"stage_ms": {}, "seconds": 0.0, "kept_s": 0.0, "frames": 0}}
    assert read(empty) is None


def test_a_new_cell_and_metric_are_found_from_new_files(bench_copy):
    from harness.manifest import Cell

    (bench_copy / "benchmark" / "metrics" / "requests.serve.py").write_text(
        "def read(run):\n    return float(run['window']['requests'])\n")
    manifest = json.loads((bench_copy / "BENCHMARK.json").read_text())
    manifest["per_layer"].append({"name": "requests.serve", "unit": "req", "better": "higher",
                                  "source": "host_clock", "layer": "device", "moves": "serve_ms_p50",
                                  "workloads": ["tiny-serve"]})
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = Cell("tiny-serve", bench_copy / "benchmark")
    assert cell.config["name"] == "tiny_avod" and cell.traffic["batch"] == 2
    assert "requests.serve" in [m["name"] for m in cell.per_layer()]
    assert cell.reader("requests.serve")({"window": {"requests": 7}}) == 7.0
