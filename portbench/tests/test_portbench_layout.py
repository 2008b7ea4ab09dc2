"""BENCHMARK.json against the benchmark's contract, every cell resolved to
its files by name, and a new configuration, traffic mix and per-layer metric
taken up as new files only."""

import json
import math
import re
import shutil
import time

import pytest

from portbench import entries, harness

from conftest import REPO, SEED, SMALL

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (REPO / c["file"]).is_file()
        assert c["reduced"] == [] and c["source"].startswith("https://")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and w["config"] in {c["name"] for c in BENCH["configs"]}
    end_to_end = {m["name"]: m for m in BENCH["end_to_end"]}
    assert end_to_end["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in end_to_end and m["source"] in ("device_trace", "program_span", "program_counter",
                                                             "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for cell in CELLS:  # setup_s, another end-to-end metric and a per-layer metric in every cell
        reported = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", CELLS)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(cell in m.get("workloads", CELLS) for m in BENCH["per_layer"])
        for m in BENCH["per_layer"]:  # a per-layer metric's cells report the end-to-end metric it moves
            if cell in m.get("workloads", CELLS):
                assert m["moves"] in {r["name"] for r in reported}


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = harness.Cell(name)
    assert cell.traffic["entry"] in entries.ENTRIES
    assert set(cell.limits) == {"max_gap", "rms_gap"}
    for attr in ("param_spec", "conv_shapes", "Model"):
        assert hasattr(cell.reference, attr)
    assert hasattr(cell.builder, "build") and hasattr(cell.builder, "float_model")
    assert set(cell.readers) == {m["name"] for m in cell.per_layer} and all(hasattr(r, "read") for r in
                                                                          cell.readers.values())
    # the runs of a cell report its end-to-end metrics under their names: each names a quantity the harness takes
    assert {harness.quantity(m["name"]) for m in cell.end_to_end} <= {"mpix_per_s", "latency_p95_ms", "peak_mem_gib",
                                                                      "setup_s"}


NEW_READER = '''"""h2d_host_ms: host ms per request copying the image in and normalising it."""


def read(ctx):
    return 1e3 * ctx.spans["h2d_normalize"] / ctx.requests if ctx.requests else None
'''


def test_a_new_config_traffic_and_metric_are_taken_by_name(tmp_path):
    """Copy the benchmark, add a UNet-16, a 96x96 traffic mix and a metric as
    new files and entries only, and run the new cell."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    home = root / "portbench"
    cfg = json.loads((home / "configs" / "unet32-int8.json").read_text())
    cfg.update(name="unet16-int8", encoder_channels=16, calibration={"images": 2, "size": 32})
    (home / "configs" / "unet16-int8.json").write_text(json.dumps(cfg))
    shutil.copy(home / "configs" / "unet32-int8.py", home / "configs" / "unet16-int8.py")
    shutil.copy(home / "reference" / "unet32-int8.py", home / "reference" / "unet16-int8.py")
    (home / "traffic" / "d4-96.json").write_text(json.dumps(dict(SMALL["unet32-int8.d4-5000"], entry="tiled_d4",
                                                                 weight="pyramid", mode="distributed")))
    (home / "limits" / "unet16-int8.d4-96.json").write_text(json.dumps({"max_gap": 1e-3, "rms_gap": 1e-4}))
    (home / "metrics" / "h2d_host_ms.py").write_text(NEW_READER)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "unet16-int8.d4-96", "config": "unet16-int8", "traffic": "d4-96", "chips": 1,
                               "why": "a throwaway cell"})
    for m in bench["end_to_end"]:
        if m["name"] in ("mpix_per_s", "latency_p95_ms"):
            m["workloads"].append("unet16-int8.d4-96")
    bench["per_layer"].append({"name": "h2d_host_ms", "unit": "ms", "better": "lower", "source": "program_span",
                               "layer": "inference", "moves": "mpix_per_s", "workloads": ["unet16-int8.d4-96"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    assert all(p.read_bytes() == data for p, data in before.items())  # nothing that was there changed
    result, _ = harness.run("unet16-int8.d4-96", SEED, 1.0, True, time.perf_counter(), device="cpu", root=root)
    assert result["correct"] and result["metrics"]["h2d_host_ms"]["value"] > 0
    result, _ = harness.run("unet16-int8.d4-96", SEED, 1.0, False, time.perf_counter(), device="cpu", root=root)
    assert result["correct"] and result["metrics"]["mpix_per_s"]["value"] > 0
    assert math.isclose(result["checks"]["max_gap"]["limit"], 1e-3)
