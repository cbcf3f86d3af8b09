"""Sketch-backed telemetry time series: fixed-capacity ring-of-buckets
windows over every hot-path signal the recorder emits.

The port's own copy of ``metrics_tpu/observability/timeseries.py``:

* A :class:`TelemetrySeries` is a **ring of time buckets**. Each bucket
  covers ``bucket_seconds`` of wall time, keyed by the absolute bucket
  index ``int(t / bucket_seconds)`` -- so buckets align across processes
  and the ring self-expires. Memory is fixed: ``n_buckets`` buckets.
* A ``"distribution"`` series backs each bucket with the port's quantile
  sketch (:mod:`metrics_tpu_torch.sketches.quantile`) on the registry's
  device -- the card unless the caller passes ``device="cpu"`` -- so
  windowed p50/p95/p99 queries are a fold of :func:`qsketch_merge_into`
  over the window's buckets and one :func:`qsketch_quantile`. On the card
  a flush or merge that overflows ``sketch_capacity`` compacts through
  ``qsketch_sort_bucket`` (K3) and ``segment_sum_f32`` (K1). A
  ``"counter"`` series skips the sketch and tracks windowed sums/rates.
* **Hot-path cost is host-only**: ``record()`` appends to a per-bucket
  pending list and updates count/sum/min/max -- no device work. Pending
  values fold into the bucket's sketch in fixed-shape chunks (padded to
  ``sketch_capacity`` with weight-0 rows, the ``n_valid`` contract, so
  every flush has one shape) at query/export time, or inline when the
  pending list crosses its bound -- except while the calling thread's
  current stream is capturing a CUDA graph (a recorder hook reached from
  inside a fused update's capture): the flush then waits for the next
  query, so nothing is launched into the graph.
* **Device work runs on the device's default stream**, whichever thread
  asks (the exporter's tick, a serving loop's probe, the async worker's
  inline flush): the caller's current stream and the default stream wait
  on each other around it, so sketches written by one thread are read
  safely by another.
* **Cross-host aggregation reuses the merge contract**: a series
  serializes to a JSON-safe payload (occupied sketch rows only) that
  ``aggregate_across_hosts`` ships; same-index buckets merge by summing
  counts and merging sketches.

The registry is wired into the default recorder via
``get_recorder().attach_timeseries()``; the recorder then feeds the
standard series (the ``SERIES_*`` constants in ``recorder.py``) from its
hooks. The health/SLO engine (:mod:`metrics_tpu_torch.observability.
health`) evaluates its alarm rules over these windows.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

__all__ = [
    "TelemetrySeries",
    "TimeSeriesRegistry",
    "merge_registry_payloads",
    "registry_from_payload",
    "series_from_payload",
]

#: accepted series kinds — "distribution" buckets carry a quantile sketch,
#: "counter" buckets only the count/sum/min/max scalars
KINDS = ("distribution", "counter")


def _capturing() -> bool:
    """Whether the calling thread's current CUDA stream is capturing a graph."""
    import torch

    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def _series_stream(device: Any) -> Iterator[None]:
    """Run the block's device work on ``device``'s default stream, ordered
    after the caller's current stream and before its later work (a no-op
    off the card)."""
    if device.type != "cuda":
        yield
        return
    import torch

    caller = torch.cuda.current_stream(device)
    default = torch.cuda.default_stream(device)
    if caller == default:
        yield
        return
    default.wait_stream(caller)
    with torch.cuda.stream(default):
        yield
    caller.wait_stream(default)


def _series_device(device: Any) -> Any:
    from metrics_tpu_torch.utils.data import _resolve_device

    return _resolve_device(device)


class _Bucket:
    """One ring slot: scalar aggregates + (distribution series) a pending
    host-value list and the qsketch leaf it folds into."""

    __slots__ = ("index", "count", "total", "vmin", "vmax", "pending", "sketch")

    def __init__(self, index: int) -> None:
        self.index = index
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.pending: List[float] = []
        self.sketch: Any = None


class TelemetrySeries:
    """Windowed telemetry over one signal.

    ``record(value)`` is the host-only hot path; ``rate``/``mean``/
    ``value_max``/``quantile`` answer windowed queries; ``to_payload`` /
    :func:`merge_series_payloads` / :func:`series_from_payload` carry the
    series across hosts. All methods are thread-safe (worker threads and
    the serving loop record concurrently; exporters query concurrently).

    ``clock`` defaults to wall time (``time.time``) so bucket indexes
    align across processes; tests and simulations may inject their own.
    ``device`` holds the bucket sketches: the card by default (which
    raises without one), ``"cpu"`` when asked.
    """

    def __init__(
        self,
        name: str,
        kind: str = "distribution",
        bucket_seconds: float = 1.0,
        n_buckets: int = 60,
        sketch_capacity: int = 128,
        clock: Optional[Callable[[], float]] = None,
        device: Optional[Any] = None,
    ) -> None:
        if kind not in KINDS:
            raise ValueError(f"series kind must be one of {KINDS}, got {kind!r}")
        if bucket_seconds <= 0:
            raise ValueError(f"bucket_seconds must be positive, got {bucket_seconds}")
        if n_buckets < 2:
            raise ValueError(f"n_buckets must be >= 2, got {n_buckets}")
        if sketch_capacity < 8:
            raise ValueError(f"sketch_capacity must be >= 8, got {sketch_capacity}")
        self.name = name
        self.kind = kind
        self.bucket_seconds = float(bucket_seconds)
        self.n_buckets = int(n_buckets)
        self.sketch_capacity = int(sketch_capacity)
        self.clock = clock if clock is not None else time.time
        self.device = _series_device(device)
        self._lock = threading.Lock()
        self._ring: List[Optional[_Bucket]] = [None] * self.n_buckets
        #: pending-list bound before an inline sketch flush — bounds worst-
        #: case host memory per bucket without a per-record device launch
        self._flush_at = max(4 * self.sketch_capacity, 512)

    # ------------------------------------------------------------------
    # hot path
    # ------------------------------------------------------------------
    def record(self, value: float, t: Optional[float] = None) -> None:
        """Add one observation (distribution) or increment (counter) at
        time ``t`` (default: now). O(1) host work; the only device work
        this can trigger is the bounded inline flush of an overfull
        pending list, which waits for the next query while the caller's
        stream captures a graph."""
        t = self.clock() if t is None else float(t)
        idx = int(t // self.bucket_seconds)
        value = float(value)
        with self._lock:
            b = self._slot(idx)
            b.count += 1
            b.total += value
            if value < b.vmin:
                b.vmin = value
            if value > b.vmax:
                b.vmax = value
            if self.kind == "distribution":
                b.pending.append(value)
                if len(b.pending) >= self._flush_at and not _capturing():
                    self._flush(b)

    def housekeep(self) -> int:
        """Fold every bucket's pending observations into its sketch NOW,
        returning the number of values folded.

        The hot path bounds its own worst case with the inline flush at
        ``_flush_at`` pending values — but that flush (a few ms of sketch
        compaction) then lands inside whichever :meth:`record` crosses
        the threshold, i.e. inside somebody's timed read. A
        latency-sensitive caller (a serving loop between probe reads)
        calls this at a moment of its own choosing so the compaction
        never rides a measured path."""
        folded = 0
        with self._lock:
            for b in self._ring:
                if b is not None and b.pending:
                    folded += len(b.pending)
                    self._flush(b)
        return folded

    def _slot(self, idx: int) -> _Bucket:
        """The live bucket for absolute index ``idx`` — resetting the slot
        if its previous occupant has expired out of the ring's span.
        Caller holds the lock."""
        pos = idx % self.n_buckets
        b = self._ring[pos]
        if b is None or b.index != idx:
            b = _Bucket(idx)
            self._ring[pos] = b
        return b

    # ------------------------------------------------------------------
    # sketch materialization
    # ------------------------------------------------------------------
    def _flush(self, b: _Bucket) -> None:
        """Fold the bucket's pending values into its sketch. Pads each
        chunk to the fixed ``sketch_capacity`` shape with weight-0 rows
        (the ``n_valid`` mask contract), so every flush -- whatever the
        pending length -- absorbs one ``[capacity]`` chunk shape (the
        JAX package's one cached compilation). The chunks' keys reach the
        device in one copy. ``n_valid`` is a host int, so the sketch's
        occupancy bound counts only the valid rows: a flush whose rows
        still fit packs without a compaction. Caller holds the lock."""
        if not b.pending:
            return
        import numpy as np
        import torch

        from metrics_tpu_torch.sketches.quantile import qsketch_init, qsketch_insert

        vals = b.pending
        b.pending = []
        cap = self.sketch_capacity
        n_chunks = -(-len(vals) // cap)
        host = np.zeros((n_chunks * cap,), np.float32)
        host[: len(vals)] = vals
        with _series_stream(self.device):
            keys = torch.from_numpy(host).to(self.device, non_blocking=False)
            if b.sketch is None:
                b.sketch = qsketch_init(cap, device=self.device)
            for c in range(n_chunks):
                n_valid = min(cap, len(vals) - c * cap)
                b.sketch = qsketch_insert(b.sketch, keys[c * cap : (c + 1) * cap], n_valid=n_valid)

    # ------------------------------------------------------------------
    # windowed queries
    # ------------------------------------------------------------------
    def _window(self, window_s: Optional[float], now: Optional[float]) -> List[_Bucket]:
        """Live buckets inside ``[now - window_s, now]`` (whole ring span
        when ``window_s`` is None). Caller holds the lock."""
        now = self.clock() if now is None else float(now)
        hi = int(now // self.bucket_seconds)
        if window_s is None:
            lo = hi - self.n_buckets + 1
        else:
            lo = int((now - float(window_s)) // self.bucket_seconds) + 1
            # a window narrower than one bucket still covers the CURRENT
            # bucket (else sub-bucket windows read empty and a rule over
            # them can never fire)
            lo = min(lo, hi)
            lo = max(lo, hi - self.n_buckets + 1)
        out = []
        for idx in range(lo, hi + 1):
            b = self._ring[idx % self.n_buckets]
            if b is not None and b.index == idx and b.count:
                out.append(b)
        return out

    def count(self, window_s: Optional[float] = None, now: Optional[float] = None) -> int:
        """Observations recorded inside the window."""
        with self._lock:
            return sum(b.count for b in self._window(window_s, now))

    def total(self, window_s: Optional[float] = None, now: Optional[float] = None) -> float:
        """Sum of recorded values inside the window (a counter's windowed
        increment total)."""
        with self._lock:
            return float(sum(b.total for b in self._window(window_s, now)))

    def rate(self, window_s: float, now: Optional[float] = None) -> float:
        """Windowed rate: summed values per second over ``window_s``."""
        return self.total(window_s, now) / float(window_s)

    def mean(self, window_s: Optional[float] = None, now: Optional[float] = None) -> Optional[float]:
        with self._lock:
            buckets = self._window(window_s, now)
            n = sum(b.count for b in buckets)
            if not n:
                return None
            return float(sum(b.total for b in buckets)) / n

    def value_min(self, window_s: Optional[float] = None, now: Optional[float] = None) -> Optional[float]:
        with self._lock:
            buckets = self._window(window_s, now)
            if not buckets:
                return None
            return float(min(b.vmin for b in buckets))

    def value_max(self, window_s: Optional[float] = None, now: Optional[float] = None) -> Optional[float]:
        with self._lock:
            buckets = self._window(window_s, now)
            if not buckets:
                return None
            return float(max(b.vmax for b in buckets))

    def quantile(
        self,
        q: float,
        window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Optional[float]:
        """Windowed quantile from the merged per-bucket sketches
        (``None`` when the window is empty; distribution series only).
        Accuracy follows :func:`metrics_tpu_torch.sketches.quantile.
        rank_error_bound` for the window's observation count — exact
        inside the lossless window, capacity-bounded rank error past it."""
        out = self.quantiles((q,), window_s=window_s, now=now)
        return out[0] if out is not None else None

    def window_sketch(self, window_s: Optional[float] = None, now: Optional[float] = None):
        """The window's per-bucket sketches merged into ONE qsketch leaf
        (``None`` when the window holds no mass) — what the quantile
        queries fold and what the drift comparator
        (:mod:`metrics_tpu_torch.observability.drift`) histograms. Empty buckets
        are skipped rather than folded: an all-zero sketch would poison
        every downstream query with the empty-sketch ``NaN`` sentinel."""
        if self.kind != "distribution":
            raise ValueError(
                f"series `{self.name}` is a counter; sketch queries need a distribution series"
            )
        from metrics_tpu_torch.sketches.quantile import qsketch_merge_into, qsketch_total_weight

        # flush + collect sketch REFS under the lock, but run the merge
        # fold OUTSIDE it -- holding the lock through device work would
        # block every record() feeding this series for the whole tick
        with self._lock:
            buckets = self._window(window_s, now)
            for b in buckets:
                self._flush(b)
            # a bucket with observations always holds mass (unit-weight
            # inserts), but payload-merged buckets can arrive sketchless or
            # weightless — skip them instead of folding an empty leaf
            sketches = [b.sketch for b in buckets if b.sketch is not None and b.count]
        if not sketches:
            return None
        # sketch tensors are never written in place: a concurrent record()
        # swaps the bucket's ref, never mutates ours
        with _series_stream(self.device):
            merged = qsketch_merge_into(sketches[0], *sketches[1:])
            if float(qsketch_total_weight(merged)) <= 0:
                return None
        return merged

    def quantiles(
        self,
        qs: Sequence[float],
        window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Optional[List[float]]:
        """Several windowed quantiles from ONE merged sketch (one merge
        fold + one query, however many quantiles). ``None`` — never the
        empty-sketch ``NaN`` sentinel — when the window holds no mass."""
        merged = self.window_sketch(window_s=window_s, now=now)
        if merged is None:
            return None
        from metrics_tpu_torch.sketches.quantile import qsketch_quantile

        with _series_stream(self.device):
            vals = qsketch_quantile(merged, [float(q) for q in qs]).tolist()
        return [float(v) for v in vals]

    def _live_buckets(self) -> List[_Bucket]:
        """Every non-empty slot in the ring, oldest first — by construction
        within the ring's span of the newest write, with NO clock involved
        (a snapshot must capture whatever was recorded, even when the data
        carried explicit timestamps far from this host's wall clock).
        Caller holds the lock."""
        return sorted(
            (b for b in self._ring if b is not None and b.count), key=lambda b: b.index
        )

    def window_count(self) -> int:
        """Non-empty buckets currently in the ring."""
        with self._lock:
            return len(self._live_buckets())

    # ------------------------------------------------------------------
    # serialization / merge
    # ------------------------------------------------------------------
    def to_payload(self) -> Dict[str, Any]:
        """JSON-safe snapshot of the live ring (the unit the cross-host
        allgather ships). Sketches serialize occupied rows only, so a
        mostly-empty window stays small on the wire."""
        # flush + snapshot scalars/sketch refs under the lock; the host
        # readback (np.asarray syncs the device) runs outside it so the
        # record() hot path never waits on serialization
        with self._lock:
            snap = []
            for b in self._live_buckets():
                self._flush(b)
                snap.append((b.index, b.count, b.total, b.vmin, b.vmax, b.sketch))
        buckets = []
        for index, count, total, vmin, vmax, sketch in snap:
            row: Dict[str, Any] = {"i": index, "c": count, "s": total, "mn": vmin, "mx": vmax}
            if sketch is not None:
                with _series_stream(self.device):
                    arr = sketch.cpu().numpy()
                occ = arr[arr[:, 0] > 0]
                row["sk"] = [[float(x) for x in r] for r in occ]
            buckets.append(row)
        return {
            "name": self.name,
            "kind": self.kind,
            "bucket_seconds": self.bucket_seconds,
            "n_buckets": self.n_buckets,
            "sketch_capacity": self.sketch_capacity,
            "buckets": buckets,
        }

    def load_payload(self, payload: Dict[str, Any]) -> "TelemetrySeries":
        """Install a payload's buckets into this (expected empty) series —
        the read side of :func:`series_from_payload`."""
        from metrics_tpu_torch.sketches.quantile import qsketch_absorb_rows, qsketch_init

        with self._lock, _series_stream(self.device):
            for row in payload.get("buckets", []):
                idx = int(row["i"])
                existing = self._ring[idx % self.n_buckets]
                if existing is not None and existing.index > idx:
                    # the slot holds FRESHER data (a straggler host shipped
                    # buckets older than the ring span) — installing the
                    # stale bucket via _slot would evict the newer one; the
                    # stale bucket is outside every live window anyway
                    continue
                b = self._slot(idx)
                b.count += int(row["c"])
                b.total += float(row["s"])
                b.vmin = min(b.vmin, float(row["mn"]))
                b.vmax = max(b.vmax, float(row["mx"]))
                rows = row.get("sk")
                if rows:
                    self._flush(b)
                    if b.sketch is None:
                        b.sketch = qsketch_init(self.sketch_capacity, device=self.device)
                    # the shared payload-fan-in fold (larger-capacity peers
                    # chunk down inside the merge)
                    b.sketch = qsketch_absorb_rows(b.sketch, rows)
        return self

    def reset(self) -> "TelemetrySeries":
        with self._lock:
            self._ring = [None] * self.n_buckets
        return self


def series_from_payload(
    payload: Dict[str, Any], clock: Optional[Callable[[], float]] = None, device: Optional[Any] = None
) -> TelemetrySeries:
    """Reconstruct a queryable series from one (possibly merged) payload
    (its sketches on ``device``: the card unless ``"cpu"``)."""
    s = TelemetrySeries(
        payload["name"],
        kind=payload.get("kind", "distribution"),
        bucket_seconds=payload.get("bucket_seconds", 1.0),
        n_buckets=payload.get("n_buckets", 60),
        sketch_capacity=payload.get("sketch_capacity", 128),
        clock=clock,
        device=device,
    )
    return s.load_payload(payload)


def merge_series_payloads(payloads: List[Dict[str, Any]], device: Optional[Any] = None) -> Dict[str, Any]:
    """Merge same-series payloads from several hosts into one.

    Buckets align on their absolute index (wall-clock bucketing makes
    same-index buckets the same time interval on every host): counts and
    sums add, min/max fold, and sketches merge through
    :func:`qsketch_merge_into` — so a quantile over the merged payload is
    within the sketch's advertised rank-error bound of the same quantile
    over the pooled raw observations (pinned by test). Payloads may
    disagree on capacity/layout across a mixed-version fleet; the first
    payload's geometry wins and the rest fold into it."""
    if not payloads:
        return {}
    base = series_from_payload(payloads[0], device=device)
    for p in payloads[1:]:
        base.load_payload(p)
    return base.to_payload()


class TimeSeriesRegistry:
    """Named-series registry with one shared geometry (bucket width, ring
    length, sketch capacity) and one clock.

    ``observe(name, value, kind=...)`` is the get-or-create hot path the
    recorder's feed hooks call. ``payload()`` snapshots every series for
    ``aggregate_across_hosts``; :func:`merge_registry_payloads` folds the
    per-host snapshots."""

    def __init__(
        self,
        bucket_seconds: float = 1.0,
        n_buckets: int = 60,
        sketch_capacity: int = 128,
        clock: Optional[Callable[[], float]] = None,
        device: Optional[Any] = None,
    ) -> None:
        self.bucket_seconds = float(bucket_seconds)
        self.n_buckets = int(n_buckets)
        self.sketch_capacity = int(sketch_capacity)
        self.clock = clock if clock is not None else time.time
        #: where every series' sketches live: the card by default (raises
        #: without one), the CPU when asked
        self.device = _series_device(device)
        self._lock = threading.Lock()
        self._series: Dict[str, TelemetrySeries] = {}

    def series(self, name: str, kind: str = "distribution") -> TelemetrySeries:
        """Get-or-create the named series (first caller's ``kind`` wins)."""
        s = self._series.get(name)
        if s is None:
            with self._lock:
                s = self._series.get(name)
                if s is None:
                    s = self._series[name] = TelemetrySeries(
                        name,
                        kind=kind,
                        bucket_seconds=self.bucket_seconds,
                        n_buckets=self.n_buckets,
                        sketch_capacity=self.sketch_capacity,
                        clock=self.clock,
                        device=self.device,
                    )
        return s

    def observe(
        self, name: str, value: float, kind: str = "distribution", t: Optional[float] = None
    ) -> None:
        self.series(name, kind=kind).record(value, t=t)

    def get(self, name: str) -> Optional[TelemetrySeries]:
        return self._series.get(name)

    def housekeep(self) -> int:
        """Run :meth:`TelemetrySeries.housekeep` on every series; returns
        the total number of pending values folded."""
        with self._lock:
            series = list(self._series.values())
        return sum(s.housekeep() for s in series)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def payload(self) -> Dict[str, Any]:
        """``{series name: series payload}`` for every registered series."""
        with self._lock:
            series = list(self._series.values())
        return {s.name: s.to_payload() for s in series}

    def reset(self) -> "TimeSeriesRegistry":
        """Clear every series' data (registrations and geometry stay)."""
        with self._lock:
            series = list(self._series.values())
        for s in series:
            s.reset()
        return self


def merge_registry_payloads(payloads: List[Dict[str, Any]], device: Optional[Any] = None) -> Dict[str, Any]:
    """Merge per-host registry payloads: series align by name, and a host
    missing a series (mixed-version fleet, workload skew) simply
    contributes nothing — absent keys are identity, never an error."""
    names: Dict[str, List[Dict[str, Any]]] = {}
    for p in payloads:
        if not isinstance(p, dict):
            continue
        for name, sp in p.items():
            names.setdefault(name, []).append(sp)
    return {name: merge_series_payloads(sps, device=device) for name, sps in sorted(names.items())}


def registry_from_payload(
    payload: Dict[str, Any], clock: Optional[Callable[[], float]] = None, device: Optional[Any] = None
) -> TimeSeriesRegistry:
    """Reconstruct a queryable registry from a (possibly merged) registry
    payload — how an aggregator queries fleet-wide windowed quantiles."""
    reg = TimeSeriesRegistry(clock=clock, device=device)
    for name, sp in payload.items():
        reg._series[name] = series_from_payload(sp, clock=clock, device=device)
    return reg
