"""One run of one benchmark cell: set-up, the measured window of evaluation
passes, the traced passes, the check against the reference, the result.

Everything particular to a cell is found by name: the cell in
``BENCHMARK.json``, its configuration (``configs/<config>.json`` and the
plain code beside it, ``configs/<config>.py``), its traffic mix
(``traffic/<traffic>.json``) and each per-layer metric's reader
(``layer_metrics/<metric>.py``). Adding a cell, a configuration or a
per-layer metric adds files and entries and edits none.

**The loop.** A cell is a closed loop of evaluation passes. A pass hands
each batch of one prediction set, already on the card, to
``MetricCollection.update`` (through the fused handle of
``compile_update`` when the traffic says ``fused``), then calls
``compute()`` and brings every value to the host, then ``reset()``. The
sets are made at set-up from the seed and rotate, so consecutive passes
never see the same predictions. There is no synchronise before
``compute()``: the update backlog is part of the wait for the result.

**Ranks.** A traffic mix of ``ranks > 1`` runs one process per card, each
evaluating its share of every pass, with one NCCL group (gloo on the CPU)
that the program syncs its states over, and one gloo group for the
harness's own messages (the end of the window, the results). Rank 0
reports.
"""
import contextlib
import gc
import importlib.util
import json
import math
import random
import sys
import time
import types
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
#: module names whose presence in the reporting process fails the run,
#: compared as whole top-level names
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "metrics_tpu")
PHASE_PREFIX = "pb:"
MIB = 1 << 20


class HarnessError(RuntimeError):
    """A run that cannot go on: a missing file or entry, a rank that failed."""


# ---------------------------------------------------------------------------
# finding things by name
# ---------------------------------------------------------------------------


def load_benchmark(root: Path = REPO) -> Dict[str, Any]:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise HarnessError(f"{path} is missing: the benchmark runs from the root of a checkout")
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> Any:
    """Import the Python file ``path`` under the module name ``name``."""
    if not path.is_file():
        raise HarnessError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _module_name(kind: str, name: str) -> str:
    return "portbench_" + kind + "_" + "".join(c if c.isalnum() else "_" for c in name)


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, the code beside
    it, its traffic mix and the metrics it reports."""

    def __init__(self, bench: Dict[str, Any], name: str, root: Path = REPO, overrides: Optional[Dict[str, Any]] = None):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise HarnessError(f"no workload {name!r} in BENCHMARK.json (known: {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        config_file = root / self.config_entry["file"]
        with open(config_file) as f:
            self.config = json.load(f)
        self.config.update(overrides or {})
        self.code = load_module(config_file.with_suffix(".py"), _module_name("config", self.config_entry["name"]))
        self.home = root / HERE.name
        with open(self.home / "traffic" / f"{self.entry['traffic']}.json") as f:
            self.traffic = json.load(f)
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]

    def reader(self, metric: str) -> Callable[["LayerContext"], Optional[float]]:
        module = load_module(self.home / "layer_metrics" / f"{metric}.py", _module_name("metric", metric))
        return module.read


# ---------------------------------------------------------------------------
# the passes
# ---------------------------------------------------------------------------


class Loop:
    """The evaluation loop of one rank: the collection, the prediction sets
    and one pass over them at a time."""

    def __init__(self, torch: Any, cell: Cell, sets: List[Dict[str, Any]], collection: Any):
        self.torch = torch
        self.cell = cell
        self.sets = sets
        self.collection = collection
        if cell.traffic["update"] == "fused":
            collection.compile_update(buckets=(int(cell.config["batch"]),))
        self.index = 0  # passes run so far, warm-up included
        self.update_s: List[float] = []  # host seconds of each update call
        self.spans = False  # mark phases for the profiler
        self.update_guard: Optional[Callable[[], Any]] = None  # a context around each update call

    def _phase(self, name: str) -> Any:
        if self.spans:
            return self.torch.profiler.record_function(PHASE_PREFIX + name)
        return contextlib.nullcontext()

    def run_pass(self) -> Dict[str, Any]:
        """One pass over the next prediction set: ``{"set", "values" (on the
        host), "snapshot", "result_s"}``."""
        which = self.index % len(self.sets)
        self.index += 1
        with self._phase("pass"):
            for batch in self.sets[which]["batches"]:
                with self._phase("data"):
                    args = batch
                with self._phase("update"), (self.update_guard() if self.update_guard else contextlib.nullcontext()):
                    t0 = time.perf_counter()
                    self.collection.update(*args)
                    t_last = time.perf_counter()
                self.update_s.append(t_last - t0)
            with self._phase("compute"):
                values = {k: _to_host(v) for k, v in self.collection.compute().items()}
                t_result = time.perf_counter()
            snapshot = self.cell.code.snapshot(self.collection)
            with self._phase("reset"):
                self.collection.reset()
        return {"set": which, "values": values, "snapshot": snapshot, "result_s": t_result - t_last}


def _to_host(value: Any) -> Any:
    if hasattr(value, "detach"):
        return value.detach().cpu()
    if isinstance(value, (list, tuple)):
        return type(value)(_to_host(v) for v in value)
    return value


# ---------------------------------------------------------------------------
# per-layer metrics
# ---------------------------------------------------------------------------


#: what a per-layer metric's reader is handed (``read(ctx)``): the window's
#: update spans, the traced passes' device trace, the program's counters over
#: those passes, the configuration and the bytes its kernels' work needs
LayerContext = types.SimpleNamespace


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------


def run_rank(
    cell_name: str,
    seed: int,
    seconds: float,
    trace: bool,
    device_kind: str,
    rank: int = 0,
    world: int = 1,
    control: Optional[Any] = None,
    t_start: Optional[float] = None,
    overrides: Optional[Dict[str, Any]] = None,
    root: Path = REPO,
) -> Optional[Dict[str, Any]]:
    """Run one cell on one rank (``device_kind`` "cuda" or "cpu"); rank 0
    returns the result's fields, the other ranks None. ``control`` is the
    gloo group of a multi-rank run."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    bench = load_benchmark(root)
    cell = Cell(bench, cell_name, root, overrides)
    on_card = device_kind == "cuda"
    if on_card:
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    dist = None
    if world > 1:
        import torch.distributed as dist
    cfg = cell.config

    # ---- set-up: inputs, the collection, every shape warmed -------------
    sets = cell.code.make_sets(cfg, seed, int(cell.traffic["prediction_sets"]), device, rank, world)
    collection = cell.code.build_collection(cfg, device)
    loop = Loop(torch, cell, sets, collection)
    for _ in range(int(cell.traffic["warmup_passes"])):
        loop.run_pass()
    if on_card:
        torch.cuda.synchronize(device)
    if dist is not None:
        dist.barrier(group=control)
    setup_s = time.perf_counter() - t_start

    # ---- the measured window --------------------------------------------
    rng = random.Random(int(seed))
    keep_share = float(cell.traffic["checked_share"])
    kept: List[Dict[str, Any]] = []
    last: Optional[Dict[str, Any]] = None
    result_s: List[float] = []
    loop.update_s = []
    passes = 0
    t0 = time.perf_counter()
    while True:
        out = loop.run_pass()
        t_end = time.perf_counter()
        passes += 1
        result_s.append(out["result_s"])
        if passes == 1 or rng.random() < keep_share:
            kept.append(out)
            last = None
        else:
            last = out
        stop = t_end - t0 >= seconds
        if dist is not None:
            flag = torch.tensor([1 if stop else 0])
            dist.broadcast(flag, src=0, group=control)
            stop = bool(flag.item())
        if stop:
            break
    window_s = t_end - t0
    if last is not None:
        kept.append(last)
    window_update_s = list(loop.update_s)
    peak = torch.cuda.max_memory_reserved(device) if on_card else 0
    if dist is not None:
        peaks = [None] * world
        dist.all_gather_object(peaks, peak, group=control)
        peak = max(peaks)

    # ---- traced passes ----------------------------------------------------
    layer: Dict[str, float] = {}
    device_extra: Dict[str, Any] = {}
    breakdown = None
    if trace:
        traced = _traced_passes(torch, loop, cell, on_card)
        kept.extend(traced["outs"])
        ctx = LayerContext(
            torch=torch,
            cell=cell,
            config=cfg,
            world=world,
            on_card=on_card,
            kind=torch.cuda.get_device_name(device) if on_card else "cpu",
            window_update_s=window_update_s,
            trace=traced["trace"],
            traced_updates=traced["updates"],
            sync_warnings=traced["sync_warnings"],
            fused_totals=traced["fused_totals"],
            recorder_events=traced["events"],
            work=cell.code.kernel_work(cfg, [sets[o["set"]] for o in traced["outs"]], world),
        )
        for metric in cell.per_layer:
            value = cell.reader(metric["name"])(ctx)
            if value is not None:
                layer[metric["name"]] = float(value)
        busy, window = traced["trace"].busy_s, traced["trace"].window_s
        if dist is not None:
            pairs = [None] * world
            dist.all_gather_object(pairs, (busy, window), group=control)
            busy = sum(p[0] for p in pairs) / world
        device_extra = {"busy_s": busy, "window_s": window}
        breakdown = {
            "device_ops": [[name[:120], s] for name, s in traced["trace"].top_ops(10)],
            "idle_gaps": [[label, s] for label, s in traced["trace"].idle_gaps()[:10]],
        }

    # ---- the check, once the program's state is gone ----------------------
    del loop, collection
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if dist is not None:
        dist.barrier(group=control)
    if rank != 0:
        return None
    checks = check(cell, sets, kept)

    e2e = {
        "eval_samples_per_s": passes * cell.code.rows_per_pass(cfg) / window_s,
        "result_ms_p95": float(np.percentile(np.array(result_s) * 1e3, 95)),
        "peak_mem_mib": peak / MIB,
        "setup_s": setup_s,
    }
    if trace:
        units = {m["name"]: m["unit"] for m in cell.per_layer}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in layer.items()}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    return {
        "correct": checks["correct"],
        "attempted": passes,
        "failed": checks["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": world,
            "memory_peak_bytes": int(peak),
            **device_extra,
        },
        **({"breakdown": breakdown} if breakdown is not None else {}),
        "passes": passes,
        "window_s": window_s,
        "result_ms_passes": len(result_s),
        "checks": checks["numbers"],
    }


def _traced_passes(torch: Any, loop: Loop, cell: Cell, on_card: bool) -> Dict[str, Any]:
    """The traced passes, after the window: the program's recorder on, the
    card's sync-debug warnings counted over the updates, the profiler over
    whole passes."""
    from metrics_tpu_torch.observability import get_recorder

    from portbench import devtrace

    recorder = get_recorder()
    recorder.reset()
    recorder.enable()
    outs: List[Dict[str, Any]] = []

    def run_passes(n: int) -> None:
        for _ in range(n):
            outs.append(loop.run_pass())

    loop.spans = True
    if on_card:
        loop.update_guard = lambda: _SyncDebug(torch)
    before = len(loop.update_s)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trace = devtrace.profile(torch, run_passes, int(cell.traffic["traced_passes"]), on_card)
    finally:
        loop.spans = False
        loop.update_guard = None
        recorder.disable()
    syncs = sum(1 for w in caught if "synchroniz" in str(w.message))
    return {
        "outs": outs,
        "trace": trace,
        "updates": len(loop.update_s) - before,
        "sync_warnings": syncs if on_card else None,
        "fused_totals": recorder.fused_update_totals(),
        "events": recorder.events(),
    }


class _SyncDebug:
    """Warn at every synchronising CUDA call inside the block."""

    def __init__(self, torch: Any):
        self.torch = torch

    def __enter__(self) -> None:
        self.torch.cuda.set_sync_debug_mode("warn")

    def __exit__(self, *exc: Any) -> None:
        self.torch.cuda.set_sync_debug_mode("default")


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------


def check(cell: Cell, sets: List[Dict[str, Any]], kept: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Compare every kept pass with the reference of its prediction set.
    Each compared number is the largest over the kept passes, beside its
    limit from the configuration; a NaN counts as past every limit."""
    limits = cell.config["limits"]
    expected: Dict[int, Any] = {}
    worst: Dict[str, float] = {}
    failed = 0
    for out in kept:
        s = out["set"]
        if s not in expected:
            expected[s] = cell.code.reference(cell.config, sets[s])
        numbers = cell.code.compare(cell.config, out["values"], out["snapshot"], expected[s])
        bad = False
        for name, value in numbers.items():
            value = math.inf if value is None or math.isnan(value) else float(value)
            worst[name] = max(worst.get(name, -math.inf), value)
            bad |= value > limits[name]
        failed += bad
    missing = sorted(set(limits) - set(worst))
    if missing:
        raise HarnessError(f"the comparison gave no {missing}")
    numbers = {name: {"value": worst[name], "limit": limits[name]} for name in sorted(worst)}
    correct = failed == 0 and all(n["value"] <= n["limit"] for n in numbers.values())
    return {"correct": correct, "failed": failed, "numbers": numbers, "compared": len(kept)}


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN_MODULES``."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN_MODULES})


def _init_group(device_kind: str, rank: int, world: int, port: int) -> Any:
    import torch.distributed as dist

    dist.init_process_group(
        "nccl" if device_kind == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{port}",
        rank=rank,
        world_size=world,
    )
    return dist.new_group(backend="gloo")


def rank_worker(cell_name: str, seed: int, seconds: float, trace: bool, device_kind: str, rank: int, world: int, port: int, overrides: Optional[Dict[str, Any]], root: str) -> None:
    """Entry of ranks 1.. of a multi-rank run (a spawned process)."""
    import torch.distributed as dist

    control = _init_group(device_kind, rank, world, port)
    try:
        run_rank(cell_name, seed, seconds, trace, device_kind, rank, world, control, overrides=overrides, root=Path(root))
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_cell(
    cell_name: str,
    seed: int,
    seconds: float,
    trace: bool,
    device_kind: str,
    t_start: Optional[float] = None,
    overrides: Optional[Dict[str, Any]] = None,
    root: Path = REPO,
    worker: Callable[..., None] = rank_worker,
) -> Dict[str, Any]:
    """Run the cell once, spawning ranks 1.. where its traffic has more than
    one; returns rank 0's result. Every spawned process is waited for."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_benchmark(root)
    cell = Cell(bench, cell_name, root, overrides)
    world = int(cell.traffic["ranks"])
    if world == 1:
        return run_rank(cell_name, seed, seconds, trace, device_kind, t_start=t_start, overrides=overrides, root=root)
    import multiprocessing

    import torch.distributed as dist

    port = free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(target=worker, args=(cell_name, seed, seconds, trace, device_kind, r, world, port, overrides, str(root)))
        for r in range(1, world)
    ]
    for p in procs:
        p.start()
    try:
        control = _init_group(device_kind, 0, world, port)
        try:
            result = run_rank(cell_name, seed, seconds, trace, device_kind, 0, world, control, t_start, overrides, root)
        finally:
            dist.destroy_process_group()
        for p in procs:
            p.join(timeout=120)
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise HarnessError(f"a rank exited with {bad}")
        return result
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
