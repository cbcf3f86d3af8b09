"""A run end to end at tiny sizes on the CPU: the result line's shape, the
refusals of ``run.py``, and no JAX package in the process that reports."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests import tiny

REPO = Path(harness.__file__).resolve().parent.parent
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]

# a tiny run in a fresh interpreter, as run.py would drive it, then the
# loaded modules' top-level names
DRIVER = """
import json, sys
sys.path.insert(0, {repo!r})
from portbench import harness
from portbench.tests import tiny
result = harness.run_cell({cell!r}, tiny.SEED, 0.3, {trace}, "cpu", overrides=tiny.BY_CELL[{cell!r}])
print(json.dumps({{"result": result, "forbidden": harness.forbidden_modules(), "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def _drive(cell, trace):
    env = dict(os.environ, USE_FLAX="0")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c", DRIVER.format(repo=str(REPO), cell=cell, trace=trace)],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(REPO),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["imagenet1k.val-fused", "criteo-kaggle.eval-fused", "imagenet1k.val-eager"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape_and_no_jax(cell, trace):
    got = _drive(cell, trace)
    result = got["result"]
    assert list(result)[: len(RESULT_KEYS)] == RESULT_KEYS and list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    spec = harness.Cell(harness.load_benchmark(), cell)
    if trace:
        assert set(result["metrics"]) <= {m["name"] for m in spec.per_layer}
        assert "update_host_us" in result["metrics"]
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        assert set(result["metrics"]) == {m["name"] for m in spec.end_to_end}
    for metric in result["metrics"].values():
        assert set(metric) == {"value", "unit"} and isinstance(metric["value"], float)
    for number in result["checks"].values():
        assert set(number) == {"value", "limit"}
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    # whole top-level names: metrics_tpu_torch is the program, not metrics_tpu
    assert got["forbidden"] == []
    assert "metrics_tpu_torch" in got["top"] and not {"jax", "jaxlib", "flax", "metrics_tpu"} & set(got["top"])


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    modules = {"metrics_tpu_torch": None, "metrics_tpu_torch.ops": None, "jaxtyping": None, "jax_like": None}
    monkeypatch.setattr(sys, "modules", modules)
    assert harness.forbidden_modules() == []
    modules.update({"metrics_tpu.ops": None, "jax": None})
    assert harness.forbidden_modules() == ["jax", "metrics_tpu.ops"]


def _run_py(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, str(Path(cwd) / "portbench/run.py"), *args], capture_output=True, text=True, timeout=300, env=env, cwd=str(cwd)
    )


def test_run_refuses_without_the_cards_and_prints_no_result():
    out = _run_py(REPO, "--workload", "imagenet1k.val-fused", "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_run_refuses_a_checkout_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copytree(REPO / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run_py(tmp_path, "--workload", "imagenet1k.val-fused", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
    assert not (REPO / "metrics_tpu_torch").is_relative_to(tmp_path)


def test_unknown_workload_is_refused():
    out = _run_py(REPO, "--workload", "no-such.cell", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.card
def test_tiny_cells_on_the_card(card):
    for cell, overrides in tiny.BY_CELL.items():
        if harness.Cell(harness.load_benchmark(), cell).chips > 1:
            continue
        result = harness.run_cell(cell, tiny.SEED, 0.3, True, "cuda", overrides=overrides)
        assert result["correct"] is True, result["checks"]
        assert result["device"]["busy_s"] > 0
