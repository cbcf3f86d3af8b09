"""Capture-cost profiling: what a captured metric update *costs*.

The port's counterpart of ``metrics_tpu/observability/profiling.py``. The
JAX package prices a compile through its AOT pipeline
(``jit(...).trace().lower().compile()``) and XLA's cost analysis. The
port's compile is the CUDA graph capture of a pure update, so
:func:`compiled_cost` runs ``fn`` once outside any graph (the warm-up,
under ``torch.profiler`` with ``with_flops`` to count its FLOPs), captures
it once as a ``torch.cuda.CUDAGraph`` on a side stream and replays it once,
and reports:

* ``trace_s`` -- the warm-up run's wall time (the JAX package's trace);
* ``compile_s`` -- the capture's wall time;
* ``replay_s`` -- the first replay's wall time, synchronised;
* ``pool_bytes`` -- the bytes the capture reserved in its memory pool
  (``torch.cuda.memory_stats`` before and after; the ``memory_analysis``
  of the report);
* ``flops`` -- the profiler's FLOP count where it has one (it counts
  matrix products, convolutions and some elementwise arithmetic), else
  ``None`` with ``flops_reason``.

On a machine without a card there is no graph: the report carries the
warm-up alone, ``captured: False`` and the reason. When the (resolved)
recorder is enabled, a typed ``compile`` event with the same payload lands
in the event stream. Profiling never breaks the hot path: metrics whose
update cannot be captured (``__jit_unsafe__``, list states, host-side
numerics) decline quietly (``None``), as the JAX package's do.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

from metrics_tpu_torch.observability.recorder import _DEFAULT_RECORDER

__all__ = ["compiled_cost", "metric_compile_cost"]


def _tensor_device(args: Tuple, kwargs: Dict[str, Any]) -> Any:
    """The device of the first tensor among the arguments (None: none)."""
    import torch
    from torch.utils._pytree import tree_flatten

    leaves, _ = tree_flatten((args, kwargs))
    return next((x.device for x in leaves if isinstance(x, torch.Tensor)), None)


def _profiled_flops(fn: Callable, args: Tuple, kwargs: Dict[str, Any]) -> Tuple[Optional[float], str]:
    """Run ``fn`` once under ``torch.profiler`` with ``with_flops`` and sum
    the FLOPs it attributes. ``(None, reason)`` when it counts none."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=activities, with_flops=True) as prof:
        fn(*args, **kwargs)
    total = 0.0
    for evt in prof.key_averages():
        flops = getattr(evt, "flops", 0) or 0
        total += float(flops)
    if total > 0:
        return total, ""
    return None, "torch.profiler attributes no FLOPs to this update's operators"


def _pool_bytes(device: Any) -> int:
    import torch

    return int(torch.cuda.memory_stats(device).get("reserved_bytes.all.current", 0))


def compiled_cost(
    fn: Callable,
    *args: Any,
    entry: Optional[str] = None,
    recorder: Optional[Any] = None,
    **kwargs: Any,
) -> Dict[str, Any]:
    """Warm up, capture and replay ``fn(*args, **kwargs)`` once and return
    what it cost (see the module docstring for the fields). ``fn`` must be
    capturable when its tensors are on a card: no host reads, no
    synchronisation. Returns a JSON-safe dict::

        {
          "entry": "...", "captured": bool,
          "trace_s": ..., "lower_s": 0.0, "compile_s": ..., "replay_s": ...,
          "flops": ... or None, "flops_reason": "...",
          "bytes_accessed": None,
          "cost_analysis": {...}, "memory_analysis": {"pool_bytes": ...},
        }
    """
    import torch

    label = entry or getattr(fn, "__name__", None) or type(fn).__name__
    device = _tensor_device(args, kwargs)
    on_card = device is not None and device.type == "cuda"

    t0 = time.perf_counter()
    flops, reason = _profiled_flops(fn, args, kwargs)
    if on_card:
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    compile_s = replay_s = 0.0
    memory: Dict[str, int] = {}
    captured = False
    why = ""
    if on_card:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        before = _pool_bytes(device)
        graph = torch.cuda.CUDAGraph()
        t2 = time.perf_counter()
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                fn(*args, **kwargs)
            finally:
                graph.capture_end()
        t3 = time.perf_counter()
        torch.cuda.current_stream(device).wait_stream(side)
        memory["pool_bytes"] = max(_pool_bytes(device) - before, 0)
        graph.replay()
        torch.cuda.synchronize(device)
        t4 = time.perf_counter()
        compile_s, replay_s = t3 - t2, t4 - t3
        captured = True
        del graph
    else:
        why = "no CUDA graph off the card: the warm-up run is the whole cost"

    cost: Dict[str, float] = {}
    if flops is not None:
        cost["flops"] = flops
    report: Dict[str, Any] = {
        "entry": label,
        "captured": captured,
        "trace_s": round(t1 - t0, 6),
        "lower_s": 0.0,
        "compile_s": round(compile_s, 6),
        "replay_s": round(replay_s, 6),
        "flops": flops,
        "flops_reason": reason,
        "bytes_accessed": None,
        "cost_analysis": cost,
        "memory_analysis": memory,
    }
    if why:
        report["reason"] = why

    rec = recorder if recorder is not None else _DEFAULT_RECORDER
    if rec.enabled:
        extra: Dict[str, Any] = {"captured": captured, "replay_ms": round(replay_s * 1e3, 4)}
        if flops is None:
            extra["flops_reason"] = reason
        rec.record_compile(
            label,
            trace_s=report["trace_s"],
            lower_s=0.0,
            compile_s=report["compile_s"],
            cost=cost,
            memory=memory,
            **extra,
        )
    return report


def metric_compile_cost(
    metric: Any,
    args: Tuple = (),
    kwargs: Optional[Dict[str, Any]] = None,
    phase: str = "update",
    recorder: Optional[Any] = None,
) -> Optional[Dict[str, Any]]:
    """Bill one metric capture: capture the metric's pure
    ``update_state(state, *batch)`` on copies of its states and the actual
    arguments, and record the ``compile`` event under
    ``"<MetricClass>.<phase>"``.

    This is the ``profile_compiles`` hook ``core/metric.py`` fires when the
    signature tracker reports a NEW signature. Returns the
    :func:`compiled_cost` report, or ``None`` when the metric declines
    (``__jit_unsafe__``, list states, an update that reads the card from
    the host) or profiling itself fails -- telemetry must never take down
    the hot path it observes.
    """
    if getattr(metric, "__jit_unsafe__", False):
        return None
    try:
        import torch

        state = {name: getattr(metric, name) for name in metric._defaults}
        if any(isinstance(v, list) for v in state.values()):
            # list ("cat") states grow per update; their update has no
            # single fixed-shape graph to bill
            return None
        state = {
            k: v.clone() if isinstance(v, torch.Tensor) else torch.tensor(v, dtype=torch.int32, device=metric.device)
            for k, v in state.items()
        }
        entry = f"{type(metric).__name__}.{phase}"

        from metrics_tpu_torch.utils.checks import capturing_checks

        def _step(state: Dict[str, Any], *batch: Any, **batch_kw: Any) -> Dict[str, Any]:
            # the value checks read nothing, as in a fused update's graph
            with capturing_checks():
                return metric.update_state(state, *batch, **batch_kw)

        return compiled_cost(_step, state, *args, entry=entry, recorder=recorder, **(kwargs or {}))
    except Exception:
        return None
