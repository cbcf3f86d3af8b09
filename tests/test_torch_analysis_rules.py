"""The port's static analyzer (``metrics_tpu_torch.analysis``): every rule on
its torch fixtures, the pragmas, the baseline, the reporters held byte for
byte against the JAX package's, the CLI, the package gate and the
interpreter's torch model.

Each rule has positive and negative fixtures, the port's own hazards among
them: ``torch.tensor(<constant>, device=...)`` in an update, the capture
rule's guard (``checks_read_nothing()``) where the JAX package exempts
``_is_concrete``, ``torch.cuda.synchronize`` on the async hot path,
``torch.distributed`` collectives outside ``parallel/``, and a fused
handle's static cache key. Fixtures are parsed as text, never imported.
"""
import ast
import json
import pathlib
import subprocess
import sys

import pytest

import metrics_tpu.analysis as jax_analysis
from metrics_tpu_torch.analysis import (
    RULE_REGISTRY,
    Violation,
    analyze_paths,
    analyze_source,
    default_package_root,
    file_suppressed_rules,
    get_rules,
    load_baseline,
    render_github,
    render_json,
    render_text,
    save_baseline,
    split_by_baseline,
    suppressed_rules,
)
from metrics_tpu_torch.analysis import interp
from metrics_tpu_torch.analysis.cli import DEFAULT_BASELINE, main as cli_main

REPO = pathlib.Path(__file__).resolve().parent.parent
ANALYSIS = REPO / "metrics_tpu_torch" / "analysis"

_PREAMBLE = """
import numpy as np
import torch
import torch.nn.functional as F
import torch.distributed as dist
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.checks import checks_read_nothing, capturing_checks
"""


def _check(source, relpath="classification/fixture.py", rules=None):
    return analyze_source(_PREAMBLE + source, relpath, rules=get_rules(rules) if rules else None)


def _rules_of(violations):
    return {v.rule for v in violations}


def _metric(update, init='self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")', extra=""):
    body = "\n".join("        " + line for line in update.strip("\n").splitlines())
    return f"""
class M(Metric):
{extra}
    def __init__(self):
        super().__init__()
        {init}
    def _update(self, preds, target):
{body}
    def _compute(self):
        return self.total
"""


# ---------------------------------------------------------------------------
# TL-TRACE
# ---------------------------------------------------------------------------

_TRACE_FLAGS = {
    "float_of_tensor": "self.total = self.total + float(torch.sum(preds))",
    "int_of_tensor": "n = int(preds.sum())\nself.total = self.total + n",
    "bool_of_tensor": "if bool(preds.any()):\n    self.total = self.total + 1",
    "item": "self.total = self.total + preds.sum().item()",
    "tolist": "vals = preds.tolist()\nself.total = self.total + len(vals)",
    "cpu": "host = preds.cpu()\nself.total = self.total + host.sum()",
    "numpy": "host = preds.numpy()\nself.total = self.total + 1",
    "np_asarray": "host = np.asarray(preds)\nself.total = self.total + 1",
    "np_array": "host = np.array(target)\nself.total = self.total + 1",
    "cuda_synchronize": "torch.cuda.synchronize()\nself.total = self.total + preds.sum()",
    "stream_synchronize": "torch.cuda.current_stream().synchronize()\nself.total = self.total + preds.sum()",
    "if_on_tensor": "if preds.sum() > 0:\n    self.total = self.total + 1",
    "while_on_tensor": "while preds.max() > 1:\n    preds = preds / 2\nself.total = self.total + preds.sum()",
    "host_constant_copy": "one = torch.tensor(1.0, device=preds.device)\nself.total = self.total + one",
    "host_constant_list_copy": "w = torch.as_tensor([1.0, 2.0], device=preds.device)\nself.total = self.total + (preds * w).sum()",
    "guard_negation_does_not_cover_other_side": (
        "if checks_read_nothing():\n    self.total = self.total + float(preds.sum())"
    ),
}

_TRACE_PASSES = {
    "clean_torch_update": "self.total = self.total + torch.sum(preds * target)",
    "shape_and_dtype_checks": (
        "if preds.shape != target.shape or preds.ndim != 1:\n    raise ValueError('shape')\n"
        "if preds.dtype == torch.float16:\n    preds = preds.float()\nself.total = self.total + preds.sum()"
    ),
    "static_metadata_methods": (
        "if preds.is_floating_point() and preds.dim() == 1 and preds.numel() and preds.size(0):\n"
        "    self.total = self.total + preds.sum()"
    ),
    "finfo_is_static": "if torch.finfo(preds.dtype).bits < 32:\n    preds = preds.float()\nself.total = self.total + preds.sum()",
    "is_floating_point_function_is_static": "if torch.is_floating_point(preds):\n    self.total = self.total + preds.sum()",
    "device_is_static": "if preds.device.type == 'cuda' and preds.is_cuda:\n    self.total = self.total + preds.sum()",
    "dtype_membership_is_static": "if preds.dtype in (torch.float16, torch.bfloat16):\n    preds = preds.float()\nself.total = self.total + preds.sum()",
    "capture_guard_eager_side": (
        "if not checks_read_nothing():\n    if bool(preds.isnan().any()):\n        raise ValueError('nan')\n"
        "self.total = self.total + preds.sum()"
    ),
    "capture_guard_early_return": (
        "self.total = self.total + preds.sum()\nif checks_read_nothing():\n    return\n"
        "if preds.min().item() < 0:\n    raise ValueError('negative')"
    ),
    "capture_guard_short_circuit": (
        "if preds.ndim == 1 and not checks_read_nothing() and int(preds.min()) < 0:\n"
        "    raise ValueError('negative')\nself.total = self.total + preds.sum()"
    ),
    "capture_guard_conditional_expression": (
        "n = None if checks_read_nothing() else int(preds.sum())\nself.total = self.total + preds.sum()"
    ),
    "capturing_checks_block": "with capturing_checks():\n    x = preds.sum()\nself.total = self.total + preds.sum()",
    "torch_full_fills_on_the_card": "one = torch.full((), 1.0, device=preds.device)\nself.total = self.total + one",
    "isinstance_type_dispatch": "if isinstance(preds, list):\n    preds = torch.cat(preds)\nself.total = self.total + preds.sum()",
    "identity_checks": "if target is None:\n    target = preds\nself.total = self.total + target.sum()",
}


class TestTraceRule:
    @pytest.mark.parametrize("name", sorted(_TRACE_FLAGS))
    def test_hazard_flags(self, name):
        kept, _ = _check(_metric(_TRACE_FLAGS[name]), rules=["TL-TRACE"])
        assert "TL-TRACE" in _rules_of(kept), name

    @pytest.mark.parametrize("name", sorted(_TRACE_PASSES))
    def test_capture_safe_update_passes(self, name):
        kept, _ = _check(_metric(_TRACE_PASSES[name]), rules=["TL-TRACE"])
        assert not kept, [v.render() for v in kept]

    def test_compute_is_not_the_capture_surface(self):
        # the port's compute runs eagerly: its one host read is the design
        source = _metric("self.total = self.total + preds.sum()").replace(
            "return self.total", "return self.total if self.total.item() > 0 else self.total"
        )
        kept, _ = _check(source, rules=["TL-TRACE"])
        assert not kept

    def test_jit_unsafe_class_exempt(self):
        kept, _ = _check(_metric("self.total = self.total + preds.sum().item()", extra="    __jit_unsafe__ = True"), rules=["TL-TRACE"])
        assert not kept

    def test_functional_kernel_item_flags(self):
        kept, _ = _check("def _update(preds):\n    return preds.sum().item()\n", relpath="functional/regression/x.py", rules=["TL-TRACE"])
        assert _rules_of(kept) == {"TL-TRACE"}

    def test_functional_kernel_sync_flags_and_clean_passes(self):
        kept, _ = _check("def f(x):\n    torch.cuda.synchronize()\n    return x\n", relpath="functional/x.py", rules=["TL-TRACE"])
        assert _rules_of(kept) == {"TL-TRACE"}
        kept, _ = _check("def f(x):\n    return torch.sum(x)\n", relpath="functional/x.py", rules=["TL-TRACE"])
        assert not kept

    def test_functional_kernel_guarded_read_passes(self):
        src = "def f(x):\n    if not checks_read_nothing():\n        print_value = x.item()\n    return x\n"
        kept, _ = _check(src, relpath="functional/x.py", rules=["TL-TRACE"])
        assert not kept


# ---------------------------------------------------------------------------
# TL-RECOMPILE
# ---------------------------------------------------------------------------

class TestRecompileRule:
    @pytest.mark.parametrize(
        "arg", ["x.shape[0]", "x.ndim", "len(rows)", "int(k)", "x.size(0)", "x.numel()", "bool(flag)"]
    )
    def test_python_int_into_fused_handle_flags(self, arg):
        src = f"handle = collection.compile_update()\nhandle(x, {arg})\n"
        kept, _ = _check(src, relpath="bench/x.py", rules=["TL-RECOMPILE"])
        assert _rules_of(kept) == {"TL-RECOMPILE"}

    def test_self_attribute_handle_and_dispatch_flag(self):
        src = (
            "class Loop:\n    def setup(self, c):\n        self.h = c.compile_update(buckets=(64,))\n"
            "    def step(self, x):\n        self.h.dispatch((x, x.shape[0]), {})\n"
        )
        kept, _ = _check(src, relpath="bench/x.py", rules=["TL-RECOMPILE"])
        assert _rules_of(kept) == {"TL-RECOMPILE"}

    @pytest.mark.parametrize("arg", ["float(k)", "torch.full((), k)", "x", "weights"])
    def test_dynamic_arguments_pass(self, arg):
        src = f"handle = collection.compile_update()\nhandle(x, {arg})\n"
        kept, _ = _check(src, relpath="bench/x.py", rules=["TL-RECOMPILE"])
        assert not kept

    def test_unrelated_callable_passes(self):
        kept, _ = _check("f = make()\nf(x, x.shape[0])\n", relpath="bench/x.py", rules=["TL-RECOMPILE"])
        assert not kept


# ---------------------------------------------------------------------------
# TL-STATE
# ---------------------------------------------------------------------------

class TestStateRule:
    def test_unknown_reducer_flags(self):
        kept, _ = _check(_metric("self.total = self.total + preds.sum()", init='self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="median")'), rules=["TL-STATE"])
        assert _rules_of(kept) == {"TL-STATE"}

    @pytest.mark.parametrize("fx", ['"sum"', '"mean"', '"max"', '"min"', '"cat"', '"merge"', '"ring"', '"decay"', "None", "my_fx"])
    def test_known_reducers_and_callables_pass(self, fx):
        kept, _ = _check(_metric("self.total = self.total + preds.sum()", init=f'self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx={fx})'), rules=["TL-STATE"])
        assert not kept

    def test_state_write_in_compute_flags(self):
        src = _metric("self.total = self.total + preds.sum()").replace("return self.total", "self.total = self.total * 2\n        return self.total")
        kept, _ = _check(src, rules=["TL-STATE"])
        assert _rules_of(kept) == {"TL-STATE"}

    def test_list_state_without_declaration_flags_and_with_passes(self):
        init = 'self.add_state("vals", default=[], dist_reduce_fx="cat")'
        kept, _ = _check(_metric("self.vals.append(preds)", init=init), rules=["TL-STATE"])
        assert _rules_of(kept) == {"TL-STATE"}
        kept, _ = _check(_metric("self.vals.append(preds)", init=init, extra="    __jit_unsafe__ = True"), rules=["TL-STATE"])
        assert not kept

    def test_wrapper_without_declaration_flags(self):
        kept, _ = _check("class W(Metric):\n    def _update(self, x):\n        pass\n", relpath="wrappers/w.py", rules=["TL-STATE"])
        assert _rules_of(kept) == {"TL-STATE"}

    def test_host_counter_and_cache_plane_fields(self):
        src = _metric("self.total = self.total + preds.sum()").replace(
            "return self.total", "self._dirty = None\n        return self.total"
        ) + "    def poke(self):\n        self._write_epoch += 1\n"
        kept, _ = _check(src, rules=["TL-STATE"])
        assert [v.message.split("`")[1] for v in kept] == ["_write_epoch"]


# ---------------------------------------------------------------------------
# TL-COLLECTIVE
# ---------------------------------------------------------------------------

_COLLECTIVE_SPELLINGS = {
    "dist_alias": "dist.all_reduce(x)",
    "torch_chain": "torch.distributed.all_gather(out, x)",
    "broadcast": "dist.broadcast(x, src=0)",
    "barrier": "dist.barrier()",
    "all_to_all": "dist.all_to_all_single(out, x)",
    "reduce_scatter": "dist.reduce_scatter_tensor(out, x)",
    "send": "dist.send(x, dst=1)",
    "gather": "dist.gather(x, out, dst=0)",
}


class TestCollectiveRule:
    @pytest.mark.parametrize("name", sorted(_COLLECTIVE_SPELLINGS))
    def test_collective_outside_transport_flags(self, name):
        kept, _ = _check(f"def f(x, out):\n    {_COLLECTIVE_SPELLINGS[name]}\n", relpath="classification/x.py", rules=["TL-COLLECTIVE"])
        assert _rules_of(kept) == {"TL-COLLECTIVE"}

    def test_planted_all_reduce_in_an_update_flags(self):
        kept, _ = _check(_metric("dist.all_reduce(self.total)\nself.total = self.total + preds.sum()"), rules=["TL-COLLECTIVE"])
        assert _rules_of(kept) == {"TL-COLLECTIVE"}

    def test_from_import_and_rebinding_flag(self):
        src = "from torch.distributed import all_reduce as ar\ndef f(x):\n    ar(x)\n"
        assert _rules_of(_check(src, relpath="x.py", rules=["TL-COLLECTIVE"])[0]) == {"TL-COLLECTIVE"}
        src = "mydist = torch.distributed\ndef f(x):\n    mydist.all_reduce(x)\n"
        assert _rules_of(_check(src, relpath="x.py", rules=["TL-COLLECTIVE"])[0]) == {"TL-COLLECTIVE"}

    @pytest.mark.parametrize("relpath", ["parallel/distributed.py", "parallel/new.py", "observability/aggregate.py"])
    def test_transport_layer_allowed(self, relpath):
        kept, _ = _check("def f(x):\n    dist.all_reduce(x)\n", relpath=relpath, rules=["TL-COLLECTIVE"])
        assert not kept

    def test_non_collective_dist_calls_pass(self):
        kept, _ = _check("def f():\n    return dist.is_initialized() and dist.get_rank()\n", relpath="x.py", rules=["TL-COLLECTIVE"])
        assert not kept


# ---------------------------------------------------------------------------
# TL-PRINT
# ---------------------------------------------------------------------------

class TestPrintRule:
    @pytest.mark.parametrize("src", ["print('x')", "import warnings\nwarnings.warn('x')", "from warnings import warn\nwarn('x')"])
    def test_raw_output_flags(self, src):
        kept, _ = _check(src + "\n", relpath="classification/x.py", rules=["TL-PRINT"])
        assert _rules_of(kept) == {"TL-PRINT"}

    def test_rank_zero_helpers_pass_and_prints_module_allowed(self):
        src = "from metrics_tpu_torch.utils.prints import rank_zero_print, rank_zero_warn\nrank_zero_print('x')\nrank_zero_warn('y')\n"
        assert not _check(src, relpath="x.py", rules=["TL-PRINT"])[0]
        assert not _check("print('x')\n", relpath="utils/prints.py", rules=["TL-PRINT"])[0]

    def test_the_port_has_the_helpers_the_message_names(self):
        from metrics_tpu_torch.utils.exceptions import MetricsUserWarning
        from metrics_tpu_torch.utils.prints import rank_zero_debug, rank_zero_info, rank_zero_print, rank_zero_warn

        assert issubclass(MetricsUserWarning, UserWarning)
        assert all(callable(f) for f in (rank_zero_debug, rank_zero_info, rank_zero_print, rank_zero_warn))


# ---------------------------------------------------------------------------
# TL-BLOCK
# ---------------------------------------------------------------------------

_PIPELINE = "core/pipeline.py"


class TestBlockRule:
    @pytest.mark.parametrize(
        "body",
        ["batch.sum().item()", "batch.tolist()", "torch.cuda.synchronize()", "self._event.synchronize()", "n = int(batch.sum())"],
    )
    def test_host_block_in_worker_flags(self, body):
        src = f"class H:\n    def _worker_loop(self, batch):\n        {body}\n"
        kept, _ = _check(src, relpath=_PIPELINE, rules=["TL-BLOCK"])
        assert _rules_of(kept) == {"TL-BLOCK"}

    def test_async_function_flags_anywhere(self):
        kept, _ = _check("def update_async(x):\n    torch.cuda.synchronize()\n", relpath="collections.py", rules=["TL-BLOCK"])
        assert _rules_of(kept) == {"TL-BLOCK"}

    def test_non_hot_and_host_casts_pass(self):
        src = "class H:\n    def flush(self, x):\n        torch.cuda.synchronize()\n    def _enqueue(self, depth):\n        n = int(5)\n"
        assert not _check(src, relpath=_PIPELINE, rules=["TL-BLOCK"])[0]
        src = "class Exporter:\n    def worker(self, x):\n        x.item()\n"
        assert not _check(src, relpath="observability/exporters.py", rules=["TL-BLOCK"])[0]

    def test_pragma_suppresses_block(self):
        src = "class H:\n    def _drain(self, x):\n        torch.cuda.synchronize()  # tracelint: disable=TL-BLOCK (the drain waits by contract)\n"
        kept, suppressed = _check(src, relpath=_PIPELINE, rules=["TL-BLOCK"])
        assert not kept and len(suppressed) == 1


# ---------------------------------------------------------------------------
# pragmas, baseline, reporters (byte for byte against the JAX package's)
# ---------------------------------------------------------------------------

_VIOLATIONS = [
    Violation("TL-TRACE", "classification/a.py", 3, 4, "msg `a`, with: punctuation", "x = float(y)"),
    Violation("TL-PRINT", "utils/b.py", 10, 0, "raw print()\nsecond line 100%", "print(1)"),
    Violation("TL-TRACE", "classification/a.py", 7, 8, "msg", "x = float(y)"),
]


def _jax_violations():
    return [jax_analysis.Violation(**v.to_dict()) for v in _VIOLATIONS]


class TestPragmasBaselineReporters:
    @pytest.mark.parametrize(
        "line",
        [
            "x = 1  # tracelint: disable=TL-TRACE",
            "x = 1  # tracelint: disable=tl-trace,TL-PRINT (a reason)",
            "x = 1  # tracelint: disable=all",
            "x = 1  # tracelint: disable=TL-TRACE — the JAX package's em-dash form",
            "x = 1",
        ],
    )
    def test_pragma_parse_equals_jax(self, line):
        assert suppressed_rules(line) == jax_analysis.suppressed_rules(line)

    def test_file_pragma_equals_jax(self):
        src = '"""doc\n# tracelint: disable-file=TL-PRINT\n"""\nprint(1)\n# tracelint: disable-file=TL-TRACE\n'
        tree = ast.parse(src)
        assert file_suppressed_rules(src.splitlines(), tree) == jax_analysis.file_suppressed_rules(src.splitlines(), tree) == {"TL-PRINT"}
        kept, _ = analyze_source(src.replace("print(1)\n", "print(1)\nprint(2)\n"), "classification/x.py", rules=get_rules(["TL-PRINT"]))
        assert not kept

    def test_pragma_for_another_rule_does_not_suppress(self):
        kept, suppressed = _check("print(1)  # tracelint: disable=TL-TRACE (not this one)\n", relpath="x.py", rules=["TL-PRINT"])
        assert len(kept) == 1 and not suppressed

    def test_text_report_byte_equal(self):
        for kw in ({}, {"suppressed_count": 2, "n_files": 9, "stale_count": 1}):
            assert render_text(_VIOLATIONS[:2], _VIOLATIONS[2:], **kw) == jax_analysis.render_text(_jax_violations()[:2], _jax_violations()[2:], **kw)

    def test_json_report_byte_equal_but_the_package_prefix(self):
        kw = {"suppressed_count": 1, "n_files": 3, "rules": ["TL-TRACE", "TL-PRINT"], "stale_count": 2}
        ours = render_json(_VIOLATIONS[:2], _VIOLATIONS[2:], **kw)
        theirs = jax_analysis.render_json(_jax_violations()[:2], _jax_violations()[2:], **kw)
        assert ours == theirs.replace('"metrics_tpu/', '"metrics_tpu_torch/')
        doc = json.loads(ours)
        assert doc["version"] == 2 and doc["summary"]["by_rule"] == {"TL-PRINT": 1, "TL-TRACE": 1}
        assert {v["file"] for v in doc["violations"]} == {"metrics_tpu_torch/classification/a.py", "metrics_tpu_torch/utils/b.py"}

    def test_github_report_byte_equal_but_the_package_prefix(self):
        ours = render_github(_VIOLATIONS[:2], _VIOLATIONS[2:])
        theirs = jax_analysis.render_github(_jax_violations()[:2], _jax_violations()[2:])
        assert ours == theirs.replace("file=metrics_tpu%2F", "file=metrics_tpu_torch%2F").replace("file=metrics_tpu/", "file=metrics_tpu_torch/")
        assert ours.count("::error") == 2 and ours.count("::warning") == 1 and "%0A" in ours and render_github([]) == ""

    def test_baseline_round_trip_and_bytes_equal_jax(self, tmp_path):
        ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
        save_baseline(ours, _VIOLATIONS)
        jax_analysis.save_baseline(theirs, _jax_violations())
        assert ours.read_bytes() == theirs.read_bytes()
        counts = load_baseline(ours)
        assert counts[("TL-TRACE", "classification/a.py", "x = float(y)")] == 2
        new, grandfathered, stale = split_by_baseline(_VIOLATIONS[:2], counts)
        assert not new and len(grandfathered) == 2 and sum(stale.values()) == 1

    def test_new_violation_not_masked_and_missing_baseline_empty(self, tmp_path):
        counts = load_baseline(tmp_path / "missing.json")
        assert not counts
        new, _, _ = split_by_baseline(_VIOLATIONS, counts)
        assert len(new) == 3

    def test_version_mismatch_raises(self, tmp_path):
        path = tmp_path / "b.json"
        path.write_text(json.dumps({"version": 99, "entries": []}))
        with pytest.raises(ValueError, match="version"):
            load_baseline(path)


# ---------------------------------------------------------------------------
# the CLI and the package gate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def package_result():
    return analyze_paths()


class TestPackageGate:
    def test_package_has_no_violation_and_the_baseline_is_empty(self, package_result):
        assert package_result.n_files > 200 and not package_result.parse_errors
        assert not package_result.violations, [v.render() for v in package_result.violations]
        assert json.loads((ANALYSIS / DEFAULT_BASELINE).read_text()) == {"version": 1, "tool": "tracelint", "entries": []}

    def test_every_pragma_in_the_package_states_its_reason(self, package_result):
        assert package_result.suppressed
        for v in package_result.suppressed:
            line = (default_package_root() / v.path).read_text().splitlines()[v.line - 1]
            reason = line.split("tracelint: disable=", 1)[1]
            assert "(" in reason and reason.rstrip().endswith(")"), line

    def test_every_rule_registered(self):
        assert sorted(RULE_REGISTRY) == sorted(jax_analysis.RULE_REGISTRY) == [
            "TL-BLOCK", "TL-COLLECTIVE", "TL-DECL", "TL-FLOW", "TL-LOCK", "TL-MERGE",
            "TL-PRINT", "TL-RECOMPILE", "TL-SHARD", "TL-STATE", "TL-TRACE", "TL-WIRE",
        ]

    def test_cli_check_exits_zero_and_lists_rules(self, capsys):
        assert cli_main(["--check", str(default_package_root() / "classification")]) == 0
        assert "0 new" in capsys.readouterr().out
        assert cli_main(["--list-rules"]) == 0
        assert "TL-COLLECTIVE: raw torch.distributed collective" in capsys.readouterr().out

    def test_cli_json_and_github_formats(self, tmp_path, capsys):
        bad = tmp_path / "bad.py"
        bad.write_text("print('x')\n")
        assert cli_main([str(bad), "--format=json", "--no-baseline"]) == 1
        doc = json.loads(capsys.readouterr().out)
        assert doc["summary"]["new"] == 1 and doc["violations"][0]["rule"] == "TL-PRINT"
        assert cli_main([str(bad), "--format=github", "--no-baseline"]) == 1
        assert capsys.readouterr().out.startswith("::error file=metrics_tpu_torch/bad.py,line=1")

    def test_cli_baseline_update_is_scoped_to_the_analyzed_paths(self, tmp_path, capsys):
        baseline = tmp_path / "baseline.json"
        save_baseline(baseline, [Violation("TL-PRINT", "other/file.py", 1, 0, "m", "print(1)")])
        bad = tmp_path / "bad.py"
        bad.write_text("print('x')\n")
        assert cli_main([str(bad), "--baseline", str(baseline), "--baseline-update"]) == 0
        keys = set(load_baseline(baseline))
        assert keys == {("TL-PRINT", "other/file.py", "print(1)"), ("TL-PRINT", "bad.py", "print('x')")}
        assert cli_main([str(bad), "--baseline", str(baseline), "--check"]) == 0
        capsys.readouterr()

    def test_unknown_rule_is_a_usage_error(self, capsys):
        assert cli_main(["--rules", "TL-NOPE"]) == 2

    def test_python_m_entry_point_checks_the_package(self):
        out = subprocess.run(
            [sys.executable, "-m", "metrics_tpu_torch.analysis", "--check"], cwd=REPO, capture_output=True, text=True, timeout=300
        )
        assert out.returncode == 0, out.stdout + out.stderr
        assert "0 new, 0 baselined" in out.stdout


class TestStdlibOnly:
    def test_the_analysis_package_imports_only_the_stdlib(self):
        allowed = set(sys.stdlib_module_names)
        files = sorted(ANALYSIS.glob("*.py"))
        assert len(files) == 12
        for path in files:
            for node in ast.walk(ast.parse(path.read_text())):
                if isinstance(node, ast.Import):
                    roots = [a.name.split(".")[0] for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    roots = [node.module.split(".")[0]]
                else:
                    continue
                assert all(r in allowed for r in roots), (path.name, roots)

    def test_counterparts_of_every_jax_module(self):
        jax_dir = REPO / "metrics_tpu" / "analysis"
        assert {p.name for p in ANALYSIS.glob("*.py")} == {p.name for p in jax_dir.glob("*.py")}


# ---------------------------------------------------------------------------
# alias maps and file pragmas
# ---------------------------------------------------------------------------

class TestAliasMaps:
    def test_torch_rebinding_and_member_imports_track_taint(self):
        src = "th = torch\n" + _metric("self.total = self.total + float(th.sum(preds))")
        assert "TL-TRACE" in _rules_of(_check(src, rules=["TL-TRACE"])[0])
        src = "from torch import sum as tsum\n" + _metric("self.total = self.total + float(tsum(preds))")
        assert "TL-TRACE" in _rules_of(_check(src, rules=["TL-TRACE"])[0])

    def test_member_import_of_a_static_predicate_is_static(self):
        src = "from torch import finfo as fi\n" + _metric("if fi(preds.dtype).bits < 32:\n    preds = preds.float()\nself.total = self.total + preds.sum()")
        assert not _check(src, rules=["TL-TRACE"])[0]

    def test_numpy_member_import_flags_host_pull(self):
        src = "from numpy import asarray\n" + _metric("h = asarray(preds)\nself.total = self.total + 1")
        assert "TL-TRACE" in _rules_of(_check(src, rules=["TL-TRACE"])[0])

    def test_function_local_rebind_does_not_alias_the_module(self):
        src = "def helper():\n    dist = object()\n    return dist\ndef f(x):\n    dist.all_reduce(x)\n"
        assert _rules_of(_check(src, relpath="x.py", rules=["TL-COLLECTIVE"])[0]) == {"TL-COLLECTIVE"}

    def test_file_pragma_region_only(self):
        src = '"""doc"""\nprint(1)  # plain\n# tracelint: disable-file=TL-PRINT\nprint(2)\n'
        kept, _ = _check(src, relpath="x.py", rules=["TL-PRINT"])
        assert len(kept) == 2


# ---------------------------------------------------------------------------
# TL-DECL and TL-FLOW
# ---------------------------------------------------------------------------

class TestDeclRule:
    def test_stale_true_declaration_flags(self):
        kept, _ = _check(_metric("self.total = self.total + preds.sum()", extra="    __jit_unsafe__ = True"), rules=["TL-DECL"])
        assert _rules_of(kept) == {"TL-DECL"}

    @pytest.mark.parametrize("body", ["self.total = self.total + preds.sum().item()", "self.total = self.total + preds[preds > 0].sum()"])
    def test_contradicted_false_declaration_flags(self, body):
        kept, _ = _check(_metric(body, extra="    __jit_unsafe__ = False"), rules=["TL-DECL"])
        assert _rules_of(kept) == {"TL-DECL"}

    @pytest.mark.parametrize(
        "body, extra",
        [
            ("self.total = self.total + preds.sum().item()", "    __jit_unsafe__ = True"),
            ("self.total = self.total + unresolved(preds)", "    __jit_unsafe__ = True"),
            ("self.total = self.total + preds.sum()", ""),
        ],
    )
    def test_consistent_or_undeclared_passes(self, body, extra):
        assert not _check(_metric(body, extra=extra), rules=["TL-DECL"])[0]


_FLOW_FLAGS = {
    "sum_overwrite": ('"sum"', "self.total = preds.sum()"),
    "sum_extremum": ('"sum"', "self.total = torch.maximum(self.total, preds.max())"),
    "sum_imul": ('"sum"', "self.total *= 2"),
    "max_additive": ('"max"', "self.total = self.total + preds.max()"),
    "sum_scatter_amax": ('"sum"', 'self.total = self.total.scatter_reduce(0, target, preds, "amax")'),
    "max_scatter_amin": ('"max"', 'self.total = self.total.scatter_reduce(0, target, preds, "amin")'),
    "decay_plain_add": ('"decay"', "self.total = self.total + preds.sum()"),
    "ring_whole_leaf_add": ('"ring"', "self.total += preds.sum()"),
    "merge_additive": ('"merge"', "self.total = self.total + preds"),
}
_FLOW_PASSES = {
    "sum_additive": ('"sum"', "self.total = self.total + preds.sum()"),
    "sum_index_add": ('"sum"', "self.total = self.total.index_add(0, target, preds)"),
    "sum_two_step": ('"sum"', "new = self.total + preds.sum()\nself.total = new"),
    "max_maximum": ('"max"', "self.total = torch.maximum(self.total, preds.max())"),
    "max_ieee": ('"max"', "self.total = maximum_ieee(self.total, preds.max())"),
    "max_scatter_amax": ('"max"', 'self.total = self.total.scatter_reduce(0, target, preds, "amax")'),
    "decay_scaled": ('"decay"', "self.total = 0.9 * self.total + preds.sum()"),
    "ring_index_copy": ('"ring"', "self.total = self.total.index_copy(0, target, preds)"),
    "merge_insert": ('"merge"', "self.total = qsketch_insert(self.total, preds)"),
}


class TestFlowRule:
    @pytest.mark.parametrize("name", sorted(_FLOW_FLAGS))
    def test_reducer_inconsistent_write_flags(self, name):
        fx, body = _FLOW_FLAGS[name]
        init = f'self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx={fx})'
        assert _rules_of(_check(_metric(body, init=init), rules=["TL-FLOW"])[0]) == {"TL-FLOW"}

    @pytest.mark.parametrize("name", sorted(_FLOW_PASSES))
    def test_reducer_consistent_write_passes(self, name):
        fx, body = _FLOW_PASSES[name]
        init = f'self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx={fx})'
        assert not _check(_metric(body, init=init), rules=["TL-FLOW"])[0]

    def test_reset_missing_leaf_and_dead_leaf_flag(self):
        init = 'self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")\n        self.add_state("count", default=torch.tensor(0), dist_reduce_fx="sum")'
        src = _metric("self.total = self.total + preds.sum()", init=init) + "    def reset(self):\n        self.total = torch.tensor(0.0)\n"
        messages = [v.message for v in _check(src, rules=["TL-FLOW"])[0]]
        assert any("count" in m and "reset" in m for m in messages)


# ---------------------------------------------------------------------------
# the interpreter's torch model
# ---------------------------------------------------------------------------

def _verdict(source, relpath="classification/fixture.py"):
    ctx = interp.FileContext(None, relpath, _PREAMBLE + source)
    node = next(n for n in ctx.tree.body if isinstance(n, ast.ClassDef) and n.name == "M")
    verdict, facts = interp.classify(interp.Project(), ctx, node)
    return verdict, facts


_VERDICTS = {
    "pure": ("self.total = self.total + torch.sum(preds * target)", "fusible", None),
    "static_metadata": ("if preds.is_floating_point() and torch.finfo(preds.dtype).bits < 32 and preds.numel():\n    preds = preds.float()\nself.total = self.total + preds.sum()", "fusible", None),
    "item": ("self.total = self.total + preds.sum().item()", "unsafe", "host-sync"),
    "cpu": ("self.total = self.total + preds.cpu().sum()", "unsafe", "host-sync"),
    "to_cpu": ("self.total = self.total + preds.to('cpu').sum()", "unsafe", "host-sync"),
    "np_asarray": ("x = np.asarray(preds)\nself.total = self.total + 1", "unsafe", "host-sync"),
    "cuda_synchronize": ("torch.cuda.synchronize()\nself.total = self.total + preds.sum()", "unsafe", "host-sync"),
    "host_constant_copy": ("self.total = self.total + torch.tensor(1.0, device=preds.device)", "unsafe", "host-sync"),
    "batched_solve": ("x = torch.linalg.solve(preds, target)\nself.total = self.total + x.sum()", "unsafe", "host-sync"),
    "torch_equal": ("if torch.equal(preds, target):\n    self.total = self.total + 1", "unsafe", "host-sync"),
    "nonzero": ("idx = torch.nonzero(preds)\nself.total = self.total + idx.sum()", "unsafe", "data-dependent-shape"),
    "unique_method": ("u = preds.unique()\nself.total = self.total + u.sum()", "unsafe", "data-dependent-shape"),
    "masked_select": ("v = torch.masked_select(preds, target > 0)\nself.total = self.total + v.sum()", "unsafe", "data-dependent-shape"),
    "boolean_mask": ("self.total = self.total + preds[preds > 0].sum()", "unsafe", "data-dependent-shape"),
    "bincount": ("c = torch.bincount(target, minlength=10)\nself.total = self.total + c.sum()", "unsafe", "data-dependent-shape"),
    "repeat_interleave": ("r = torch.repeat_interleave(preds, target)\nself.total = self.total + r.sum()", "unsafe", "data-dependent-shape"),
    "repeat_interleave_sized": ("r = torch.repeat_interleave(preds, target, output_size=64)\nself.total = self.total + r.sum()", "fusible", None),
    "one_hot_unsized": ("o = F.one_hot(target)\nself.total = self.total + o.sum()", "unsafe", "data-dependent-shape"),
    "one_hot_sized": ("o = F.one_hot(target, num_classes=10)\nself.total = self.total + o.sum()", "fusible", None),
    "cat_growth": ("self.total = torch.cat([self.total, preds])", "unsafe", "cat-growth"),
    "guarded_read": ("if not checks_read_nothing():\n    if bool(preds.isnan().any()):\n        raise ValueError('nan')\nself.total = self.total + preds.sum()", "fusible", None),
    "guard_early_return": ("self.total = self.total + preds.sum()\nif checks_read_nothing():\n    return\nif preds.min().item() < 0:\n    raise ValueError('negative')", "fusible", None),
    "guard_selected_raise": ("if checks_read_nothing():\n    raise ValueError('no capture')\nself.total = self.total + preds.sum()", "unknown", None),
    "isinstance_host_side": ("x = preds if isinstance(preds, torch.Tensor) else torch.full((), float(preds))\nself.total = self.total + x", "fusible", None),
    "container_truthiness": ("parts = [preds, target]\nif parts:\n    self.total = self.total + torch.stack(parts).sum()", "fusible", None),
    "conditional_read": ("if self.flag:\n    self.total = self.total + preds.sum().item()\nelse:\n    self.total = self.total + preds.sum()", "unknown", None),
    "unresolved_call": ("self.total = self.total + some_helper(preds)", "unknown", None),
    "local_helper_closure": ("def inner(x):\n    return x.sum().item()\nself.total = self.total + inner(preds)", "unsafe", "host-sync"),
    "function_alias": ("reduce = torch.amax if self.flag else torch.amin\nself.total = self.total + reduce(preds)", "fusible", None),
}


class TestInterpVerdicts:
    @pytest.mark.parametrize("name", sorted(_VERDICTS))
    def test_torch_op_model(self, name):
        body, status, reason = _VERDICTS[name]
        verdict, _ = _verdict(_metric(body))
        assert (verdict.status, verdict.reason) == (status, reason), verdict

    def test_string_annotation_is_host_sync(self):
        src = "class M(Metric):\n    def _update(self, preds: str, target: str):\n        pass\n"
        assert _verdict(src)[0].reason == "host-sync"

    def test_state_abstractions_of_torch_constructors(self):
        init = (
            'self.add_state("a", default=torch.zeros(num_classes, num_classes, dtype=torch.int32), dist_reduce_fx="sum")\n'
            '        self.add_state("b", default=torch.tensor(0), dist_reduce_fx="sum")\n'
            '        self.add_state("c", default=0.0, dist_reduce_fx="max")\n'
            '        self.add_state("d", default=torch.full((k,), -1, dtype=torch.float64), dist_reduce_fx="min")\n'
            '        for side in ("real", "fake"):\n'
            '            self.add_state(f"{side}_n", default=torch.zeros(()), dist_reduce_fx="sum")\n'
            '        self.add_state("e", default=[], dist_reduce_fx="cat")'
        )
        _, facts = _verdict(_metric("self.a = self.a + 1", init=init))
        got = {e.name: (e.container, e.shape, e.dtype, e.dist_reduce_fx) for e in facts.entries}
        assert got == {
            "a": ("array", ["num_classes", "num_classes"], "int32", "sum"),
            "b": ("array", [], "int64", "sum"),
            "c": ("array", [], "float32", "max"),
            "d": ("array", ["k"], "float64", "min"),
            "real_n": ("array", [], "float32", "sum"),
            "fake_n": ("array", [], "float32", "sum"),
            "e": ("list", None, None, "cat"),
        }

    def test_exact_mode_split_classifies_the_default_mode(self):
        body = "if self._exact:\n    self.vals.append(preds)\n    return\nself.total = self.total + preds.sum()"
        init = 'self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")'
        assert _verdict(_metric(body, init=init, extra='    __exact_mode_attr__ = "_exact"'))[0].status == "fusible"
        assert _verdict(_metric(body, init=init))[0].status != "fusible"

    def test_declared_traced_callable_attr(self):
        body = "f = self.extractor(preds)\nself.total = self.total + f.sum()"
        assert _verdict(_metric(body, extra='    __traced_callable_attrs__ = ("extractor",)'))[0].status == "fusible"
        assert _verdict(_metric(body))[0].status == "unknown"

    def test_calls_into_ops_are_kernels(self):
        body = "from metrics_tpu_torch.ops.segment_sum import segment_sum_dispatch\nself.total = self.total + segment_sum_dispatch(preds, target, 4).sum()"
        assert _verdict(_metric(body))[0].status == "fusible"
