"""Declarative health/SLO engine over the windowed telemetry series.

The port's own copy of ``metrics_tpu/observability/health.py``. The
time-series layer (:mod:`metrics_tpu_torch.observability.timeseries`)
answers "what is the p99 / rate / max over the last N seconds"; this module
turns those answers into an operational verdict: a rule set is evaluated
against the registry and produces a typed :class:`HealthSnapshot` --
``ok``/``warn``/``critical`` plus the exact alarms firing -- exported as
Prometheus families, appended to a JSONL alarm log on every transition,
and renderable as a terminal summary (:func:`render_health`).

Three rule shapes cover the standard serving-loop failure modes:

* :class:`ThresholdRule` -- a windowed statistic (``p50``/``p95``/``p99``/
  ``mean``/``max``/``min``/``rate``/``count``) of one series compared
  against a bound. Backs the queue-saturation, staleness, recompile-storm,
  sketch-fill-ceiling and hot-slice-skew alarms.
* :class:`BurnRateRule` -- multiwindow SLO burn: the ratio of a "bad"
  counter to a "total" counter (e.g. dropped / offered batches) against an
  error budget over a short AND a long window. Backs the drop-rate alarm.
* :class:`DriftRule` -- a reference-vs-live distribution comparison over
  frozen static edges (PSI / KL / JS / TV --
  :mod:`metrics_tpu_torch.observability.drift`; the histograms are
  ``qsketch_histogram`` on the registry's device). Backs the score-drift
  alarm.

:func:`default_rules` wires the thirteen standard alarm classes -- seven
serving-loop classes, the three fleet-collector classes (whose series
the fleet collector, ``observability/collector.py``, feeds), the
read-path freshness class with its ``read_latency`` companion, and the two
memory-observatory classes (:class:`MemoryBudget`/:class:`MemoryLeak`).
Every rule and the monitor take an injected ``now=``, so a caller can
replay a timeline without the wall clock.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from metrics_tpu_torch.observability.recorder import (
    _DEFAULT_RECORDER,
    SERIES_ASYNC_DROPPED,
    SERIES_ASYNC_ENQUEUED,
    SERIES_ASYNC_QUEUE_DEPTH,
    SERIES_ASYNC_STALENESS,
    SERIES_COLLECTOR_BACKLOG,
    SERIES_FOLD_ERRORS,
    SERIES_FRESHNESS_AGE_S,
    SERIES_HOT_SLICE_SHARE,
    SERIES_MEM_BYTES_PER_TENANT,
    SERIES_MEM_UNACCOUNTED,
    SERIES_PUBLISHER_LAG,
    SERIES_READ_MS,
    SERIES_RECOMPILES,
    SERIES_SCORES,
    SERIES_SKETCH_FILL,
)

__all__ = [
    "AlarmState",
    "BurnRateRule",
    "DriftRule",
    "HealthMonitor",
    "HealthSnapshot",
    "MemoryBudget",
    "MemoryLeak",
    "Rule",
    "ThresholdRule",
    "default_rules",
    "render_health",
]

#: snapshot statuses in escalation order
STATUSES = ("ok", "warn", "critical")

#: accepted rule severities (a firing critical rule makes the snapshot
#: critical; warn rules cap at warn)
SEVERITIES = ("warn", "critical")

#: windowed statistics ThresholdRule understands; pNN spellings map onto
#: the sketch quantile query
_STATS = ("p50", "p90", "p95", "p99", "mean", "max", "min", "rate", "count", "total")

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


class Rule:
    """One health rule: a name, a severity, and an ``evaluate`` returning
    ``(firing, observed_value, detail)``. Subclass to add shapes beyond
    threshold/burn-rate; the monitor only needs this interface."""

    def __init__(self, name: str, severity: str = "warn", description: str = "") -> None:
        if severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, got {severity!r}")
        self.name = name
        self.severity = severity
        self.description = description

    def evaluate(self, registry: Any, now: Optional[float] = None) -> Tuple[bool, Optional[float], str]:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r}, severity={self.severity!r})"


class ThresholdRule(Rule):
    """Fire when a windowed statistic of one series crosses a bound.

    ``stat`` is one of ``p50/p90/p95/p99`` (sketch quantiles), ``mean``/
    ``max``/``min`` (scalar aggregates), ``rate`` (summed values per
    second), ``count``, or ``total``. An empty window (or an absent
    series) never fires — silence is not an alarm; pair with a liveness
    rule if silence should page. ``min_count`` suppresses firing until
    the window holds at least that many observations (quantiles of three
    points are noise, not signal)."""

    def __init__(
        self,
        name: str,
        series: str,
        stat: str,
        threshold: float,
        window_s: float = 30.0,
        op: str = ">",
        severity: str = "warn",
        min_count: int = 1,
        description: str = "",
    ) -> None:
        super().__init__(name, severity=severity, description=description)
        if stat not in _STATS:
            raise ValueError(f"stat must be one of {_STATS}, got {stat!r}")
        if op not in _OPS:
            raise ValueError(f"op must be one of {sorted(_OPS)}, got {op!r}")
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        self.series = series
        self.stat = stat
        self.threshold = float(threshold)
        self.window_s = float(window_s)
        self.op = op
        self.min_count = int(min_count)

    def evaluate(self, registry: Any, now: Optional[float] = None) -> Tuple[bool, Optional[float], str]:
        s = registry.get(self.series) if registry is not None else None
        if s is None:
            return False, None, f"series `{self.series}` absent"
        n = s.count(self.window_s, now=now)
        if n < self.min_count:
            return False, None, f"only {n} observation(s) in window"
        if self.stat.startswith("p"):
            value = s.quantile(int(self.stat[1:]) / 100.0, window_s=self.window_s, now=now)
        elif self.stat == "mean":
            value = s.mean(self.window_s, now=now)
        elif self.stat == "max":
            value = s.value_max(self.window_s, now=now)
        elif self.stat == "min":
            value = s.value_min(self.window_s, now=now)
        elif self.stat == "rate":
            value = s.rate(self.window_s, now=now)
        elif self.stat == "total":
            value = s.total(self.window_s, now=now)
        else:  # count
            value = float(n)
        if value is None:
            return False, None, "empty window"
        firing = _OPS[self.op](value, self.threshold)
        return (
            bool(firing),
            float(value),
            f"{self.stat}({self.series}, {self.window_s:g}s) = {value:.4g} {self.op} {self.threshold:g}",
        )


class BurnRateRule(Rule):
    """Multiwindow SLO burn-rate alarm over counter series.

    The error ratio ``sum(bad) / sum(total)`` is measured over a short and
    a long window; each is divided by the error ``budget`` (the SLO's
    allowed ratio) to get a burn rate, and the alarm fires when BOTH
    exceed ``burn_threshold`` — the standard fast-burn condition: the
    short window reacts within seconds, the long window keeps a single
    bad bucket from paging. ``denominator`` may be several series (their
    totals add), e.g. offered batches = accepted + dropped."""

    def __init__(
        self,
        name: str,
        numerator: str,
        denominator: Union[str, Sequence[str]],
        budget: float,
        short_window_s: float = 10.0,
        long_window_s: float = 60.0,
        burn_threshold: float = 1.0,
        severity: str = "critical",
        min_total: int = 1,
        description: str = "",
    ) -> None:
        super().__init__(name, severity=severity, description=description)
        if not (0 < budget < 1):
            raise ValueError(f"budget must be a ratio in (0, 1), got {budget}")
        if short_window_s >= long_window_s:
            raise ValueError("short_window_s must be smaller than long_window_s")
        self.numerator = numerator
        self.denominator = (denominator,) if isinstance(denominator, str) else tuple(denominator)
        self.budget = float(budget)
        self.short_window_s = float(short_window_s)
        self.long_window_s = float(long_window_s)
        self.burn_threshold = float(burn_threshold)
        self.min_total = int(min_total)

    def _burn(self, registry: Any, window_s: float, now: Optional[float]) -> Optional[float]:
        num_series = registry.get(self.numerator)
        bad = num_series.total(window_s, now=now) if num_series is not None else 0.0
        total = bad
        for name in self.denominator:
            s = registry.get(name)
            if s is not None and s is not num_series:
                total += s.total(window_s, now=now)
        if total < self.min_total:
            return None
        return (bad / total) / self.budget

    def evaluate(self, registry: Any, now: Optional[float] = None) -> Tuple[bool, Optional[float], str]:
        if registry is None:
            return False, None, "no registry"
        short = self._burn(registry, self.short_window_s, now)
        long_ = self._burn(registry, self.long_window_s, now)
        if short is None or long_ is None:
            return False, None, "no traffic in window"
        firing = short >= self.burn_threshold and long_ >= self.burn_threshold
        return (
            bool(firing),
            float(short),
            f"burn {self.short_window_s:g}s={short:.2f}x, {self.long_window_s:g}s={long_:.2f}x"
            f" of budget {self.budget:g} (threshold {self.burn_threshold:g}x)",
        )


class DriftRule(Rule):
    """Fire when a distribution series drifts from its frozen reference
    window (the seventh standard alarm class).

    The rule watches a ``"distribution"`` series (by default the sampled
    model scores serving loops feed via ``record_scores``). Evaluation has
    two phases:

    1. **Reference capture** — until the series has accumulated
       ``freeze_after`` observations inside ``reference_window_s``, the
       rule never fires (detail: "collecting reference"). At that point
       the window's merged sketch is FROZEN as the reference: static
       histogram edges are derived from it once
       (:func:`~metrics_tpu_torch.observability.drift.reference_edges`, unless
       explicit ``edges`` were passed) and its binned histogram is kept.
    2. **Live comparison** — every later evaluation histograms the
       trailing ``window_s`` sketch over the SAME edges and scores it
       against the reference with ``stat`` (``psi``/``kl``/``js``/``tv``
       — see :mod:`metrics_tpu_torch.observability.drift`), firing when the
       score crosses ``threshold``. Scores also land on the default
       recorder as ``metrics_tpu_drift_score{metric,stat}`` gauges.

    The reference stays frozen until :meth:`reset_reference` (or a new
    rule) — drift is measured against *then*, not against a sliding
    yesterday that would normalize a slow regression away. An absent
    series never fires, like every other rule.
    """

    def __init__(
        self,
        name: str,
        series: str = SERIES_SCORES,
        stat: str = "psi",
        threshold: float = 0.25,
        window_s: float = 30.0,
        reference_window_s: Optional[float] = None,
        freeze_after: int = 200,
        n_bins: int = 10,
        min_count: int = 20,
        edges: Optional[Any] = None,
        severity: str = "warn",
        description: str = "",
        recorder: Optional[Any] = None,
    ) -> None:
        super().__init__(name, severity=severity, description=description)
        #: recorder the drift-score gauges land on; None = inherit the
        #: monitor's recorder (HealthMonitor injects its override at
        #: construction, like every other health family), falling back to
        #: the process default
        self.recorder = recorder
        from metrics_tpu_torch.observability.drift import DRIFT_STATS

        if stat not in DRIFT_STATS:
            raise ValueError(f"stat must be one of {DRIFT_STATS}, got {stat!r}")
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        if not isinstance(freeze_after, int) or freeze_after < 1:
            raise ValueError(f"freeze_after must be a positive int, got {freeze_after!r}")
        if not isinstance(n_bins, int) or n_bins < 2:
            raise ValueError(f"n_bins must be an int >= 2, got {n_bins!r}")
        self.series = series
        self.stat = stat
        self.threshold = float(threshold)
        self.window_s = float(window_s)
        self.reference_window_s = float(
            reference_window_s if reference_window_s is not None else window_s
        )
        self.freeze_after = int(freeze_after)
        self.n_bins = int(n_bins)
        self.min_count = int(min_count)
        self._edges = edges
        self._ref_hist: Optional[Any] = None
        #: serializes reference mutation: the monitor lock covers evaluate(),
        #: but freeze_reference() is a direct caller API (the serving loop's
        #: phase boundary) racing the exporter tick's auto-freeze — without
        #: this, two concurrent freezes can bin the reference over one
        #: thread's edges and keep the OTHER thread's edges for live
        #: comparisons, a permanently wrong score with no error
        self._freeze_lock = threading.Lock()

    def reset_reference(self) -> None:
        """Drop the frozen reference; the next evaluations re-capture it
        (an intentional re-baseline after a model push)."""
        with self._freeze_lock:
            self._ref_hist = None
            # edges re-derive with the new reference unless explicit
            if getattr(self, "_edges_derived", False):
                self._edges = None

    def freeze_reference(self, registry: Any, now: Optional[float] = None) -> bool:
        """Freeze the reference from the CURRENT reference window,
        bypassing the ``freeze_after`` count gate — for callers that know
        their own phase boundaries (a serving loop freezing at the end of
        a known-healthy warmup) instead of trusting traffic-rate timing:
        the count-gated auto-freeze can land inside a fault window when
        early traffic crawls through cold caches, silently baselining on
        the very distribution the rule exists to catch. Returns True when
        a reference was (already or newly) frozen; no-op on an absent
        series or an empty window (the auto path remains)."""
        if self._ref_hist is not None:
            return True
        s = registry.get(self.series) if registry is not None else None
        if s is None:
            return False
        sketch = s.window_sketch(self.reference_window_s, now=now)
        if sketch is None:
            return False
        self._freeze(sketch)
        return True

    def _freeze(self, sketch: Any) -> None:
        from metrics_tpu_torch.observability.drift import _f32, reference_edges
        from metrics_tpu_torch.sketches.quantile import qsketch_histogram

        with self._freeze_lock:
            if self._ref_hist is not None:
                return  # another thread froze first: first freeze wins whole
            if self._edges is None:
                self._edges = reference_edges(sketch, n_bins=self.n_bins)
                self._edges_derived = True
            self._ref_hist = qsketch_histogram(sketch, _f32(self._edges, sketch.device))

    def evaluate(self, registry: Any, now: Optional[float] = None) -> Tuple[bool, Optional[float], str]:
        s = registry.get(self.series) if registry is not None else None
        if s is None:
            return False, None, f"series `{self.series}` absent"
        with self._freeze_lock:
            ref_hist, edges = self._ref_hist, self._edges
        if ref_hist is None:
            n_ref = s.count(self.reference_window_s, now=now)
            if n_ref < self.freeze_after:
                return False, None, f"collecting reference ({n_ref}/{self.freeze_after})"
            sketch = s.window_sketch(self.reference_window_s, now=now)
            if sketch is None:
                return False, None, "reference window holds no mass yet"
            self._freeze(sketch)
            return False, 0.0, f"reference frozen over {self.reference_window_s:g}s"
        n_live = s.count(self.window_s, now=now)
        if n_live < self.min_count:
            return False, None, f"only {n_live} live observation(s) in window"
        live = s.window_sketch(self.window_s, now=now)
        if live is None:
            return False, None, "empty live window"
        from metrics_tpu_torch.observability.drift import _f32, histogram_drift
        from metrics_tpu_torch.sketches.quantile import qsketch_histogram

        # score against the SNAPSHOT pair read under the lock above — a
        # concurrent re-baseline cannot mix one reference's edges with
        # another's histogram mid-evaluation
        live_hist = qsketch_histogram(live, _f32(edges, live.device))
        score = histogram_drift(ref_hist, live_hist)[self.stat]
        rec = self.recorder if self.recorder is not None else _DEFAULT_RECORDER
        if rec.enabled:
            rec.record_drift_score(self.series, self.stat, score)
        firing = score >= self.threshold
        return (
            bool(firing),
            float(score),
            f"{self.stat}({self.series}: frozen ref vs live {self.window_s:g}s)"
            f" = {score:.4g} >= {self.threshold:g}",
        )


class MemoryBudget(ThresholdRule):
    """Bytes/tenant ceiling on sliced (per-tenant) metric state — the
    twelfth standard alarm class.

    Watches the ``mem_bytes_per_tenant`` series the memory observatory
    (:class:`~metrics_tpu_torch.observability.memory.MemoryObservatory`) feeds:
    the ledger's live SlicedMetric state bytes divided by the total slice
    (tenant) count. Firing means each tenant's state grew past the budget
    the deployment provisioned (the per-tenant state bytes going out of
    bounds), e.g. a window/sketch capacity misconfiguration
    multiplying per-tenant bytes. The threshold is a plain attribute, so
    capacity tooling can tighten it live (``rule.threshold = ...``)."""

    def __init__(
        self,
        limit_bytes_per_tenant: float,
        name: str = "memory_budget",
        window_s: float = 30.0,
        severity: str = "warn",
        min_count: int = 1,
        description: str = "per-tenant sliced state bytes exceeded the provisioned budget",
    ) -> None:
        super().__init__(
            name,
            SERIES_MEM_BYTES_PER_TENANT,
            stat="max",
            threshold=float(limit_bytes_per_tenant),
            window_s=window_s,
            op=">",
            severity=severity,
            min_count=min_count,
            description=description,
        )


class MemoryLeak(Rule):
    """Monotone unaccounted-bytes growth — the thirteenth standard alarm
    class, the "where did my HBM go" page.

    Watches the ``mem_unaccounted_bytes`` residue series
    (``device_in_use − ledger − cache planes``, fed by the memory
    observatory). Bytes the ledger and the cache planes can both explain
    are healthy; a residue that keeps GROWING is memory nobody accounts
    for — a pinned compute cache, a leaked buffer reference, a foreign
    allocation riding the device.

    The monotone test splits the window in half and fires when the
    *minimum* of the recent half exceeds the *maximum* of the prior half
    by more than ``growth_bytes`` — every recent sample above every older
    sample, so a noisy-but-flat residue (host-RSS jitter on CPU, allocator
    fragmentation) never fires, while steady growth of any shape does.
    An absent series (observatory not polling) never fires."""

    def __init__(
        self,
        growth_bytes: float = 128 * 1024 * 1024,
        name: str = "memory_leak",
        series: str = SERIES_MEM_UNACCOUNTED,
        window_s: float = 30.0,
        min_count: int = 4,
        severity: str = "warn",
        description: str = "unaccounted device bytes growing monotonically — likely leak",
    ) -> None:
        super().__init__(name, severity=severity, description=description)
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        self.series = series
        self.growth_bytes = float(growth_bytes)
        self.window_s = float(window_s)
        self.min_count = int(min_count)

    def evaluate(self, registry: Any, now: Optional[float] = None) -> Tuple[bool, Optional[float], str]:
        s = registry.get(self.series) if registry is not None else None
        if s is None:
            return False, None, f"series `{self.series}` absent"
        t = time.time() if now is None else float(now)
        n = s.count(self.window_s, now=t)
        if n < self.min_count:
            return False, None, f"only {n} observation(s) in window"
        half = self.window_s / 2.0
        prior_max = s.value_max(half, now=t - half)
        recent_min = s.value_min(half, now=t)
        if prior_max is None or recent_min is None:
            return False, None, "both window halves not yet populated"
        growth = float(recent_min) - float(prior_max)
        firing = growth > self.growth_bytes
        return (
            bool(firing),
            growth,
            f"min(recent {half:g}s) - max(prior {half:g}s) of {self.series}"
            f" = {growth:.4g} B (threshold {self.growth_bytes:g})",
        )


@dataclass(frozen=True)
class AlarmState:
    """One rule's state inside a snapshot."""

    name: str
    severity: str
    firing: bool
    value: Optional[float]
    detail: str
    fired_at: Optional[float] = None  # wall time the CURRENT firing episode began


@dataclass(frozen=True)
class HealthSnapshot:
    """Typed verdict of one health evaluation: overall status, every
    rule's state, and the exporter-error count (a stale-artifact signal is
    itself a health fact)."""

    status: str
    t: float
    alarms: Tuple[AlarmState, ...] = ()
    export_errors: int = 0

    @property
    def firing(self) -> Tuple[AlarmState, ...]:
        return tuple(a for a in self.alarms if a.firing)

    def to_json(self) -> Dict[str, Any]:
        return {
            "status": self.status,
            "t": self.t,
            "export_errors": self.export_errors,
            "alarms": [
                {
                    "name": a.name,
                    "severity": a.severity,
                    "firing": a.firing,
                    "value": a.value,
                    "detail": a.detail,
                    "fired_at": a.fired_at,
                }
                for a in self.alarms
            ],
        }


class HealthMonitor:
    """Evaluates a rule set against a time-series registry and tracks alarm
    transitions.

    ``evaluate()`` returns a :class:`HealthSnapshot`; each rule's
    fired/cleared transition is appended to the JSONL alarm log (when
    configured) and remembered in :meth:`transitions` — so
    "did every alarm class fire AND clear during this run" is a direct
    query (:meth:`fired_and_cleared`), which is exactly what the
    serving-loop fault-injection smoke asserts. Thread-safe: the
    :class:`~metrics_tpu_torch.observability.exporters.PeriodicExporter` calls
    ``evaluate()`` from its tick thread while the serving loop polls."""

    #: transition-history cap — health evaluation must stay fixed-memory
    #: like everything else in the live layer
    MAX_TRANSITIONS = 10_000

    def __init__(
        self,
        rules: Sequence[Rule],
        registry: Optional[Any] = None,
        recorder: Optional[Any] = None,
        alarm_log_path: Optional[str] = None,
    ) -> None:
        names = [r.name for r in rules]
        dup = {n for n in names if names.count(n) > 1}
        if dup:
            raise ValueError(f"duplicate rule names: {sorted(dup)}")
        self.rules = list(rules)
        self._registry = registry
        self._recorder = recorder
        if recorder is not None:
            # recorder-aware rules (DriftRule's score gauges) inherit the
            # monitor's override unless they carry their own — the same
            # routing every other health family gets via _resolve
            for r in self.rules:
                if getattr(r, "recorder", "__absent__") is None:
                    r.recorder = recorder
        self.alarm_log_path = alarm_log_path
        self._lock = threading.Lock()
        #: serializes alarm-log appends — O_APPEND writes interleave at
        #: line granularity, but the rows of ONE evaluation must land as a
        #: contiguous block so concurrent evaluates (exporter tick thread +
        #: the serving loop's probe) read as coherent transitions
        self._log_lock = threading.Lock()
        self._fired_at: Dict[str, float] = {}
        self._transitions: List[Dict[str, Any]] = []
        self._last: Optional[HealthSnapshot] = None

    def _resolve_registry(self) -> Optional[Any]:
        if self._registry is not None:
            return self._registry
        rec = self._recorder if self._recorder is not None else _DEFAULT_RECORDER
        return rec.timeseries

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> HealthSnapshot:
        registry = self._resolve_registry()
        rec = self._recorder if self._recorder is not None else _DEFAULT_RECORDER
        t = time.time() if now is None else float(now)
        alarms: List[AlarmState] = []
        new_transitions: List[Dict[str, Any]] = []
        with self._lock:
            for rule in self.rules:
                try:
                    firing, value, detail = rule.evaluate(registry, now=now)
                except Exception as err:  # noqa: BLE001 — one bad rule must not kill the sweep
                    firing, value, detail = False, None, f"rule evaluation failed: {err!r}"
                was = rule.name in self._fired_at
                if firing and not was:
                    self._fired_at[rule.name] = t
                    new_transitions.append(
                        {
                            "event": "fired",
                            "alarm": rule.name,
                            "severity": rule.severity,
                            "value": value,
                            "detail": detail,
                            "t": t,
                        }
                    )
                elif not firing and was:
                    fired_at = self._fired_at.pop(rule.name)
                    new_transitions.append(
                        {
                            "event": "cleared",
                            "alarm": rule.name,
                            "severity": rule.severity,
                            "value": value,
                            "duration_s": round(t - fired_at, 3),
                            "t": t,
                        }
                    )
                alarms.append(
                    AlarmState(
                        name=rule.name,
                        severity=rule.severity,
                        firing=firing,
                        value=value,
                        detail=detail,
                        fired_at=self._fired_at.get(rule.name),
                    )
                )
            self._transitions.extend(new_transitions)
            if len(self._transitions) > self.MAX_TRANSITIONS:
                self._transitions = self._transitions[-self.MAX_TRANSITIONS :]
            status = "ok"
            for a in alarms:
                if a.firing:
                    if a.severity == "critical":
                        status = "critical"
                        break
                    status = "warn"
            snap = HealthSnapshot(
                status=status,
                t=t,
                alarms=tuple(alarms),
                export_errors=rec.export_errors(),
            )
            self._last = snap
        if new_transitions and self.alarm_log_path:
            from metrics_tpu_torch.observability.exporters import _atomic_append, _process_index

            if _process_index() == 0:
                try:
                    with self._log_lock:
                        _atomic_append(
                            self.alarm_log_path,
                            "".join(json.dumps(row) + "\n" for row in new_transitions),
                        )
                except Exception:  # noqa: BLE001 — the log is an artifact, not the source of truth
                    pass
        return snap

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def last_snapshot(self) -> Optional[HealthSnapshot]:
        with self._lock:
            return self._last

    def transitions(self) -> List[Dict[str, Any]]:
        """Every fired/cleared transition observed so far (capped)."""
        with self._lock:
            return list(self._transitions)

    def fired_ever(self) -> List[str]:
        with self._lock:
            return sorted({r["alarm"] for r in self._transitions if r["event"] == "fired"})

    def fired_and_cleared(self) -> List[str]:
        """Alarm names that have both fired and subsequently cleared — the
        fault-injection smoke's acceptance query."""
        with self._lock:
            fired = {r["alarm"] for r in self._transitions if r["event"] == "fired"}
            cleared = {r["alarm"] for r in self._transitions if r["event"] == "cleared"}
        return sorted(fired & cleared)

    # ------------------------------------------------------------------
    # exports
    # ------------------------------------------------------------------
    def prometheus_lines(self, snapshot: Optional[HealthSnapshot] = None) -> List[str]:
        """The health families for the Prometheus page (appended by
        ``PeriodicExporter``/``render_prometheus`` when a monitor rides
        along): overall status as 0/1/2, one 0/1 firing gauge and one
        observed-value gauge per alarm."""
        snap = snapshot if snapshot is not None else self.last_snapshot
        if snap is None:
            return []
        from metrics_tpu_torch.observability.exporters import _labels

        lines = [
            "# HELP metrics_tpu_health_status Overall health verdict (0=ok, 1=warn, 2=critical).",
            "# TYPE metrics_tpu_health_status gauge",
            f"metrics_tpu_health_status {STATUSES.index(snap.status)}",
            "# HELP metrics_tpu_alarm_firing Whether the alarm rule is currently firing.",
            "# TYPE metrics_tpu_alarm_firing gauge",
        ]
        for a in snap.alarms:
            lines.append(
                f"metrics_tpu_alarm_firing{_labels(alarm=a.name, severity=a.severity)}"
                f" {1 if a.firing else 0}"
            )
        lines.append("# HELP metrics_tpu_alarm_value Last observed value of the alarm rule's statistic.")
        lines.append("# TYPE metrics_tpu_alarm_value gauge")
        for a in snap.alarms:
            if a.value is not None:
                lines.append(f"metrics_tpu_alarm_value{_labels(alarm=a.name)} {a.value:g}")
        return lines


def render_health(snapshot: HealthSnapshot) -> str:
    """Terminal one-glance rendering of a snapshot: the status line, then
    one row per alarm (firing rows first)."""
    lines = [
        f"health: {snapshot.status.upper()}"
        f" ({len(snapshot.firing)}/{len(snapshot.alarms)} alarms firing,"
        f" {snapshot.export_errors} export errors)"
    ]
    for a in sorted(snapshot.alarms, key=lambda a: (not a.firing, a.name)):
        mark = "FIRING" if a.firing else "ok"
        lines.append(f"  [{mark:>6}] {a.name} ({a.severity}): {a.detail}")
    return "\n".join(lines)


def default_rules(
    queue_depth_limit: float = 4,
    staleness_limit_steps: float = 4,
    drop_budget: float = 0.01,
    drop_burn_threshold: float = 2.0,
    recompiles_per_window: float = 4,
    fill_ceiling: float = 0.9,
    hot_share_limit: float = 0.5,
    window_s: float = 30.0,
    short_window_s: Optional[float] = None,
    critical_queue_factor: float = 2.0,
    drift_threshold: float = 0.25,
    drift_freeze_after: int = 128,
    drift_stat: str = "psi",
    publisher_lag_limit_s: float = 30.0,
    backlog_limit: float = 64,
    fold_errors_per_window: float = 1,
    freshness_bound_s: float = 10.0,
    read_latency_limit_ms: float = 250.0,
    tenant_bytes_limit: float = 16 * 1024,
    unaccounted_growth_bytes: float = 128 * 1024 * 1024,
) -> List[Rule]:
    """The thirteen standard alarm classes — seven serving-loop classes,
    the three fleet-collector classes, the read-path freshness class
    (plus its ``read_latency`` companion), and the two memory-observatory
    classes — over the standard recorder-fed series, every threshold
    tunable:

    * ``queue_saturation`` (warn) / ``queue_saturation_critical`` — p95 /
      max of the async queue depth against the configured limit.
    * ``staleness`` — max compute-snapshot staleness in batches.
    * ``drop_rate`` — multiwindow burn of dropped vs offered batches
      against the ``drop_budget`` SLO.
    * ``recompile_storm`` — new-signature count per window.
    * ``sketch_fill`` — max sketch capacity-fill ratio against the
      ceiling (past it, compactions are imminent/ongoing and accuracy is
      being spent).
    * ``hot_slice_skew`` — p95 of the per-batch hottest-slice row share.
    * ``score_drift`` — PSI (by default) of the live score distribution
      against its frozen reference window (``record_scores`` feeds the
      series; absent when the loop never records scores — the rule then
      never fires, like any absent series).
    * ``publisher_stale`` — worst per-publisher snapshot lag seen at a
      fleet-collector poll against the staleness bound (a silent
      publisher's lag grows every poll; the collector feeds the series).
    * ``snapshot_backlog`` — unfolded snapshots at the collector (queued
      files + in-window pending deltas) against the backlog limit.
    * ``fold_error`` (critical) — ANY fold error in the window: a
      snapshot the collector could not decode, validate, or merge is
      fleet data loss.
    * ``freshness_slo`` — p95 ingest-to-visible staleness (the
      ``freshness_age_s`` series every stamped read feeds: wall-clock age
      of the newest event visible in the answer, see
      :mod:`metrics_tpu_torch.observability.freshness`) against
      ``freshness_bound_s`` — the "is the dashboard showing old data"
      alarm, distinct from ``staleness`` (queued batches) and
      ``score_drift`` (distribution shape).
    * ``read_latency`` — p95 read wall time (``read_ms``, fed by every
      ``compute``/``window_state``/sliced/fleet read) against
      ``read_latency_limit_ms``.
    * ``memory_budget`` — the ledger's sliced state bytes per tenant
      (``mem_bytes_per_tenant``, fed by memory-observatory polls) against
      ``tenant_bytes_limit`` — the per-tenant state capacity as an
      alarm.
    * ``memory_leak`` — monotone growth of the unaccounted residue
      (``mem_unaccounted_bytes`` = device in-use − ledger − cache planes)
      beyond ``unaccounted_growth_bytes`` across the window: memory
      nothing in the inventory explains, and it keeps growing.

    The three fleet classes watch series only a
    :class:`~metrics_tpu_torch.observability.collector.FleetCollector` feeds —
    in a job without a collector they never fire, like any absent series;
    the two read-path classes likewise stay silent until something reads,
    and the two memory classes until a
    :class:`~metrics_tpu_torch.observability.memory.MemoryObservatory` polls.
    """
    short = short_window_s if short_window_s is not None else max(window_s / 3.0, 1.0)
    return [
        ThresholdRule(
            "queue_saturation",
            SERIES_ASYNC_QUEUE_DEPTH,
            stat="p95",
            threshold=queue_depth_limit,
            window_s=window_s,
            op=">=",
            severity="warn",
            min_count=3,
            description="async ingest queue persistently near capacity",
        ),
        ThresholdRule(
            "queue_saturation_critical",
            SERIES_ASYNC_QUEUE_DEPTH,
            stat="p95",
            threshold=queue_depth_limit * critical_queue_factor,
            window_s=window_s,
            op=">=",
            severity="critical",
            min_count=3,
            description="async ingest queue saturated well past its limit",
        ),
        ThresholdRule(
            "staleness",
            SERIES_ASYNC_STALENESS,
            stat="max",
            threshold=staleness_limit_steps,
            window_s=window_s,
            op=">=",
            severity="warn",
            description="compute snapshots are further behind ingest than the bound",
        ),
        BurnRateRule(
            "drop_rate",
            numerator=SERIES_ASYNC_DROPPED,
            denominator=(SERIES_ASYNC_ENQUEUED, SERIES_ASYNC_DROPPED),
            budget=drop_budget,
            short_window_s=short,
            long_window_s=window_s,
            burn_threshold=drop_burn_threshold,
            severity="critical",
            description="batch drop ratio is burning the SLO error budget",
        ),
        ThresholdRule(
            "recompile_storm",
            SERIES_RECOMPILES,
            stat="total",
            threshold=recompiles_per_window,
            window_s=window_s,
            op=">=",
            severity="warn",
            description="new call signatures keep triggering CUDA graph captures",
        ),
        ThresholdRule(
            "sketch_fill",
            SERIES_SKETCH_FILL,
            stat="max",
            threshold=fill_ceiling,
            window_s=window_s,
            op=">=",
            severity="warn",
            description="sketch states near/at capacity — accuracy budget being spent",
        ),
        ThresholdRule(
            "hot_slice_skew",
            SERIES_HOT_SLICE_SHARE,
            stat="p95",
            threshold=hot_share_limit,
            window_s=window_s,
            op=">=",
            severity="warn",
            min_count=3,
            description="one slice is receiving an outsized share of batch rows",
        ),
        DriftRule(
            "score_drift",
            SERIES_SCORES,
            stat=drift_stat,
            threshold=drift_threshold,
            window_s=window_s,
            reference_window_s=window_s,
            freeze_after=drift_freeze_after,
            min_count=16,
            severity="warn",
            description="live score distribution drifted from the frozen reference window",
        ),
        ThresholdRule(
            "publisher_stale",
            SERIES_PUBLISHER_LAG,
            stat="max",
            threshold=publisher_lag_limit_s,
            window_s=window_s,
            op=">=",
            severity="warn",
            description="a fleet publisher has not shipped a snapshot within the staleness bound",
        ),
        ThresholdRule(
            "snapshot_backlog",
            SERIES_COLLECTOR_BACKLOG,
            stat="max",
            threshold=backlog_limit,
            window_s=window_s,
            op=">=",
            severity="warn",
            description="the fleet collector is falling behind the publishers' snapshot rate",
        ),
        ThresholdRule(
            "fold_error",
            SERIES_FOLD_ERRORS,
            stat="total",
            threshold=fold_errors_per_window,
            window_s=window_s,
            op=">=",
            severity="critical",
            description="snapshots failed to decode/validate/fold — fleet data loss",
        ),
        ThresholdRule(
            "freshness_slo",
            SERIES_FRESHNESS_AGE_S,
            stat="p95",
            threshold=freshness_bound_s,
            window_s=window_s,
            op=">",
            severity="warn",
            min_count=3,
            description="ingest-to-visible staleness past the freshness bound — readers are seeing old data",
        ),
        ThresholdRule(
            "read_latency",
            SERIES_READ_MS,
            stat="p95",
            threshold=read_latency_limit_ms,
            window_s=window_s,
            op=">",
            severity="warn",
            min_count=3,
            description="metric reads (compute/window/fleet fold) persistently slow",
        ),
        MemoryBudget(
            tenant_bytes_limit,
            window_s=window_s,
        ),
        MemoryLeak(
            unaccounted_growth_bytes,
            window_s=window_s,
        ),
    ]
