"""Reading a ``torch.profiler`` trace of whole evaluation passes.

The benchmark marks its own host spans with ``record_function`` (``pb:pass``
around each pass; ``pb:data``, ``pb:update``, ``pb:compute`` and
``pb:reset`` inside it). Every device operation (kernel, copy, memset) is
tied to the runtime call that launched it by the trace's correlation id, so
it lands in the span the host was in when it launched it: a kernel replayed
from a CUDA graph belongs to the span of its ``cudaGraphLaunch``. Host and
device times share the trace's clock.
"""
import json
import os
import re
import tempfile
from typing import Any, Dict, List, Optional, Tuple

SPAN_PREFIX = "pb:"
PHASES = ("data", "update", "compute", "reset")
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


class DeviceTrace:
    """Device operations of the traced passes, each with the benchmark span
    it was launched from; the passes' window; the host spans."""

    def __init__(self, events: List[Dict[str, Any]], passes: int):
        self.passes = passes
        spans = [e for e in events if e.get("ph") == "X" and str(e.get("name", "")).startswith(SPAN_PREFIX)]
        self.spans = [(e["name"][len(SPAN_PREFIX) :], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in spans]
        pass_spans = [s for s in self.spans if s[0] == "pass"]
        self.window = (min(s[1] for s in pass_spans), max(s[2] for s in pass_spans)) if pass_spans else (0.0, 0.0)
        launch_ts = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch_ts[corr] = float(e["ts"])
        phase_spans = sorted((s for s in self.spans if s[0] in PHASES), key=lambda s: s[1])
        self.ops: List[Tuple[str, float, float, str]] = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in _DEVICE_CATS:
                continue
            start, dur = float(e["ts"]), float(e.get("dur", 0))
            if not (self.window[0] <= start <= self.window[1]):
                continue
            corr = (e.get("args") or {}).get("correlation")
            self.ops.append((str(e["name"]), start, dur, self._span_at(phase_spans, launch_ts.get(corr))))

    @staticmethod
    def _span_at(spans: List[Tuple[str, float, float]], ts: Optional[float]) -> str:
        if ts is None:
            return "unknown"
        for name, lo, hi in spans:
            if lo <= ts <= hi:
                return name
        return "loop"

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, in trace us."""
        merged: List[List[float]] = []
        for _, start, dur, _ in sorted(self.ops, key=lambda op: op[1]):
            end = start + dur
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def device_s(self, pattern: Optional[str] = None, phase: Optional[str] = None) -> float:
        """Device seconds of the operations whose name matches ``pattern``
        (a regular expression; every operation when None) launched from
        ``phase`` (every phase when None)."""
        rx = re.compile(pattern) if pattern else None
        return sum(d for name, _, d, ph in self.ops if (rx is None or rx.search(name)) and (phase is None or ph == phase)) / 1e6

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Every idle stretch of the device inside the window, longest first,
        named by the benchmark span that covers most of it on the host."""
        busy = self.busy_intervals()
        edges = [self.window[0]] + [x for iv in busy for x in iv] + [self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        named = []
        for lo, hi in gaps:
            overlap: Dict[str, float] = {}
            for name, a, b in self.spans:
                if name in PHASES:
                    cover = min(hi, b) - max(lo, a)
                    if cover > 0:
                        overlap[name] = overlap.get(name, 0.0) + cover
            label = max(overlap, key=overlap.get) if overlap else "loop"
            named.append((label, (hi - lo) / 1e6))
        return sorted(named, key=lambda g: -g[1])

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        totals: Dict[str, float] = {}
        for name, _, dur, _ in self.ops:
            totals[name] = totals.get(name, 0.0) + dur / 1e6
        return sorted(totals.items(), key=lambda kv: -kv[1])[:n]


def profile(torch: Any, run_passes: Any, passes: int, on_card: bool) -> DeviceTrace:
    """Run ``run_passes(passes)`` under ``torch.profiler`` (host and, on the
    card, device activity) and read the trace. The trace goes through one
    file in the temporary directory, removed at once."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with torch_profile(activities=activities) as prof:
        run_passes(passes)
        if on_card:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return DeviceTrace(events, passes)
