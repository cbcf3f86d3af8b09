"""``BENCHMARK.json`` against the benchmark's contract, and every cell,
configuration, traffic mix and per-layer metric found by name; a new
configuration, cell and metric added as files and entries alone."""
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests import tiny

REPO = Path(harness.__file__).resolve().parent.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == TOP_KEYS
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    for path in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and not path.startswith("/") and ".." not in path
        assert not path.endswith("_torch")


def test_names_units_and_entry_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])


def test_four_chip_cells_within_a_quarter():
    four = sum(1 for w in BENCH["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    cells = {w["name"] for w in BENCH["workloads"]}
    for metric in BENCH["per_layer"]:
        assert set(metric.get("workloads", cells)) <= cells
    for name in cells:
        cell = harness.Cell(BENCH, name, REPO)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        # a per-layer metric's cells report the end-to-end metric it moves
        assert all(m["moves"] in e2e for m in cell.per_layer)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(name):
    cell = harness.Cell(BENCH, name, REPO)
    assert Path(REPO / cell.config_entry["file"]).is_relative_to(REPO / "portbench")
    for fn in ("make_sets", "build_collection", "rows_per_pass", "snapshot", "reference", "control", "compare", "kernel_work"):
        assert callable(getattr(cell.code, fn)), fn
    assert set(cell.config["limits"]) and all(v >= 0 for v in cell.config["limits"].values())
    assert cell.traffic["update"] in ("fused", "eager") and cell.traffic["ranks"] == cell.chips
    for metric in cell.per_layer:
        assert callable(cell.reader(metric["name"]))


def test_layer_names_one_per_layer():
    layers = {}
    for m in BENCH["per_layer"]:
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        layers.setdefault(m["layer"], []).append(m["name"])
    assert len(layers) >= 5


def test_config_files_are_distinct_and_state_their_source():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        data = json.loads((REPO / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"] and "assumed" in data


def test_a_new_config_cell_and_metric_are_files_and_entries(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix, a cell and a
    per-layer metric as new files plus new entries, and run the new cell."""
    shutil.copytree(REPO / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "portbench/configs/imagenet1k.json").read_text())
    cfg.update(tiny.IMAGENET, name="imagenet-tiny")
    (tmp_path / "portbench/configs/imagenet-tiny.json").write_text(json.dumps(cfg))
    shutil.copy(REPO / "portbench/configs/imagenet1k.py", tmp_path / "portbench/configs/imagenet-tiny.py")
    traffic = json.loads((REPO / "portbench/traffic/val-eager.json").read_text())
    (tmp_path / "portbench/traffic/val-eager-short.json").write_text(json.dumps(dict(traffic, warmup_passes=1, traced_passes=1)))
    (tmp_path / "portbench/layer_metrics/passes_traced.py").write_text("def read(ctx):\n    return float(ctx.trace.passes)\n")
    bench["configs"].append({"name": "imagenet-tiny", "source": "test", "file": "portbench/configs/imagenet-tiny.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "imagenet-tiny.val-eager-short", "config": "imagenet-tiny", "traffic": "val-eager-short", "chips": 1, "why": "test"})
    bench["per_layer"].append(
        {"name": "passes_traced", "unit": "count", "better": "higher", "source": "program_counter", "layer": "card", "moves": "eval_samples_per_s", "workloads": ["imagenet-tiny.val-eager-short"]}
    )
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.Cell(harness.load_benchmark(tmp_path), "imagenet-tiny.val-eager-short", tmp_path)
    assert cell.config["classes"] == tiny.IMAGENET["classes"] and cell.traffic["traced_passes"] == 1
    assert [m["name"] for m in cell.per_layer][-1] == "passes_traced"
    result = harness.run_cell("imagenet-tiny.val-eager-short", tiny.SEED, 0.2, True, "cpu", root=tmp_path)
    assert result["correct"] is True
    assert result["metrics"]["passes_traced"]["value"] == 1.0
