"""Device memory observatory: live state ledger + cache-plane inventory.

The port's own copy of ``metrics_tpu/observability/memory.py``.
``state_footprint()`` (core/metric.py) *predicts* bytes from shapes and
dtypes; this module asks what is resident:

* :class:`MemoryLedger` walks live metric states and reports *committed*
  bytes -- dedup by tensor identity, so the fused update's static state
  buffers (installed into every compute-group member) and shared
  compute-group states are never double-counted -- with a per-device
  breakdown. It reads tensor metadata only (``numel * element_size``),
  never values.
* A **cache-plane registry**: every byte-holding cache registers a
  ``nbytes()`` callback under a stable plane name into one global
  inventory: ``fused_compile`` (the memory pools of the fused update's CUDA
  graphs), ``reader_cache`` (the read plane's graphs), ``sliced_value_cache``
  (kept per-slice values and dirty bitmaps), ``windowed_fold_memo`` (the
  window fold memos) and ``retrieval_layout`` (the memoized table unpacks).
* :class:`MemoryObservatory` polls ``torch.cuda.memory_stats`` for each
  visible card (allocated bytes in use and their peak, reserved bytes,
  the card's total memory; nothing on a machine without a card, where the
  poll falls back to the host's RSS) and derives the **unaccounted-bytes**
  residue ``in_use - ledger - cache planes`` -- the leak signal the
  ``memory_leak`` alarm (observability/health.py) watches for monotone
  growth, while ``memory_budget`` watches the ledger's bytes/tenant.

Everything here is poll-rate code: the metric hot paths only touch the
recorder's one-bool-gated ``record_memory_boundary`` hook.
"""
from __future__ import annotations

import os
import threading
import weakref
from typing import Any, Callable, Dict, Iterable, List, Optional

from metrics_tpu_torch.observability.recorder import _DEFAULT_RECORDER, _nbytes

__all__ = [
    "MemoryLedger",
    "MemoryObservatory",
    "backend_memory_stats",
    "cache_plane_inventory",
    "cache_plane_total",
    "executable_nbytes",
    "host_rss_bytes",
    "live_metrics",
    "register_cache_plane",
    "unregister_cache_plane",
]


# ---------------------------------------------------------------------------
# live-metric registry (fed by Metric.__init__ via _track_metric)
# ---------------------------------------------------------------------------

#: id -> metric, weakly: an entry goes when its metric is collected. Keyed
#: by id, so membership never calls a metric's ``__eq__`` (which builds a
#: composition) or its state-keyed ``__hash__``
_LIVE_METRICS: "weakref.WeakValueDictionary[int, Any]" = weakref.WeakValueDictionary()
_LIVE_LOCK = threading.Lock()


def _track_metric(metric: Any) -> None:
    """Register a live metric for default-ledger walks. Called from
    ``Metric.__init__`` -- one weak dictionary insert, and never allowed to
    fail a metric's construction."""
    try:
        with _LIVE_LOCK:
            _LIVE_METRICS[id(metric)] = metric
    except Exception:  # noqa: BLE001 — a weakref-less foreign subclass
        pass


def live_metrics() -> List[Any]:
    """Every live (not yet garbage-collected) metric instance in the
    process, in construction order -- the default population a
    :class:`MemoryLedger` walks."""
    with _LIVE_LOCK:
        return list(_LIVE_METRICS.values())


# ---------------------------------------------------------------------------
# cache-plane registry
# ---------------------------------------------------------------------------

_PLANES: Dict[str, Callable[[], int]] = {}
_PLANES_LOCK = threading.Lock()


def register_cache_plane(name: str, nbytes_fn: Callable[[], int]) -> str:
    """Register (or replace) a byte-holding cache's ``nbytes()`` callback
    under ``name``. Owning modules register ONE plane per cache kind at
    import (the callback fans out over a WeakSet of live instances), so
    the inventory is a short, stable table, not per-instance churn."""
    with _PLANES_LOCK:
        _PLANES[name] = nbytes_fn
    return name


def unregister_cache_plane(name: str) -> bool:
    with _PLANES_LOCK:
        return _PLANES.pop(name, None) is not None


def cache_plane_inventory() -> Dict[str, int]:
    """Current bytes per registered plane. A callback that raises reports
    0 — the inventory must never take down a poll."""
    with _PLANES_LOCK:
        planes = dict(_PLANES)
    out: Dict[str, int] = {}
    for name, fn in planes.items():
        try:
            out[name] = int(fn())
        except Exception:  # noqa: BLE001
            out[name] = 0
    return out


def cache_plane_total() -> int:
    return sum(cache_plane_inventory().values())


def executable_nbytes(captured: Any) -> int:
    """Bytes a captured CUDA graph holds on the card: the memory its
    capture reserved in its pool plus its static input buffers, as the
    fused update measured them at capture (``pool_nbytes``). An object
    without the measurement (a plain-version entry on the CPU) reports 0:
    the plane then carries entry counts with honest zero bytes."""
    try:
        return int(getattr(captured, "pool_nbytes", 0) or 0)
    except (TypeError, ValueError):
        return 0


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------


def _leaf_devices(value: Any) -> List[Any]:
    """Devices a leaf is resident on (a tensor's ``device``; ``["host"]``
    for numpy and Python scalars)."""
    dev = getattr(value, "device", None)
    if dev is not None and not callable(dev):
        return [dev]
    return ["host"]


def _per_device_bytes(value: Any, nbytes: int) -> Dict[str, int]:
    """Per-device byte attribution of one leaf (a tensor lives on one
    device)."""
    devices = _leaf_devices(value)
    if not devices:
        return {"host": nbytes}
    share, rem = divmod(nbytes, len(devices))
    out = {}
    for i, d in enumerate(devices):
        out[str(d)] = share + (1 if i < rem else 0)
    return out


def _iter_state_leaves(metric: Any):
    """Yield every array-state leaf of a metric (list/'cat' states flatten;
    children recurse — the buffer-identity dedup makes re-visits free)."""
    defaults = getattr(metric, "_defaults", None)
    if isinstance(defaults, dict):
        for name in defaults:
            val = getattr(metric, name, None)
            if isinstance(val, list):
                for item in val:
                    yield item
            elif val is not None and not isinstance(val, (int, float)):
                yield val
    children = getattr(metric, "_children", None)
    if isinstance(children, dict):
        kids = children.values()
    elif isinstance(children, (list, tuple)):
        kids = children
    else:
        kids = ()
    for child in kids:
        # a child entry is a metric, or a list of them (BootStrapper's copies)
        for c in child if isinstance(child, (list, tuple)) else (child,):
            yield from _iter_state_leaves(c)


class MemoryLedger:
    """Walks metric state pytrees and reports *live committed* bytes.

    Dedup is by buffer identity (``id`` of the array object): compute-group
    members literally share the leader's arrays, and fused group
    propagation installs the same objects into every member, so a naive
    per-metric sum double-books them. Donated buffers mid-dispatch are
    deleted arrays and count 0 (the ``_nbytes`` contract), matching the
    async pipeline's separate in-flight accounting.

    ``metrics=None`` (the default) walks every live metric in the process
    — the population ``Metric.__init__`` registers. Passing an explicit
    iterable scopes the ledger (e.g. one serving loop's collection)."""

    def __init__(self, metrics: Optional[Iterable[Any]] = None) -> None:
        self._metrics = None if metrics is None else list(metrics)

    def metrics(self) -> List[Any]:
        return live_metrics() if self._metrics is None else list(self._metrics)

    def measure(self) -> Dict[str, Any]:
        """One ledger walk. Host-only reads (shape × itemsize metadata; no
        device sync). Returns totals, the per-device breakdown, per-metric
        attribution (first-owner wins for shared buffers), and the sliced
        bytes/tenant headline."""
        seen: set = set()
        total = 0
        n_buffers = 0
        n_shared = 0
        n_donated = 0
        per_device: Dict[str, int] = {}
        per_metric: Dict[str, int] = {}
        sliced_bytes = 0
        num_tenants = 0
        counted_metrics: set = set()
        for metric in self.metrics():
            if id(metric) in counted_metrics:
                continue
            counted_metrics.add(id(metric))
            label = type(metric).__name__
            metric_bytes = 0
            try:
                n_slices = getattr(metric, "num_slices", None)
                for leaf in _iter_state_leaves(metric):
                    key = id(leaf)
                    if key in seen:
                        n_shared += 1
                        continue
                    seen.add(key)
                    nb = _nbytes(leaf)
                    if nb == 0 and callable(getattr(leaf, "is_deleted", None)):
                        try:
                            if leaf.is_deleted():
                                n_donated += 1
                                continue
                        except Exception:  # noqa: BLE001
                            pass
                    if nb <= 0:
                        continue
                    n_buffers += 1
                    total += nb
                    metric_bytes += nb
                    for dev, db in _per_device_bytes(leaf, nb).items():
                        per_device[dev] = per_device.get(dev, 0) + db
                if isinstance(n_slices, int) and n_slices > 0:
                    sliced_bytes += metric_bytes
                    num_tenants += n_slices
            except Exception:  # noqa: BLE001 — a mid-mutation metric must not kill the poll
                continue
            if metric_bytes:
                per_metric[label] = per_metric.get(label, 0) + metric_bytes
        return {
            "total_bytes": total,
            "per_device": per_device,
            "per_metric": per_metric,
            "sliced_bytes": sliced_bytes,
            "num_tenants": num_tenants,
            "bytes_per_tenant": (sliced_bytes / num_tenants) if num_tenants else 0.0,
            "n_metrics": len(counted_metrics),
            "n_buffers": n_buffers,
            "n_shared": n_shared,
            "n_donated": n_donated,
        }

    def total_bytes(self) -> int:
        return int(self.measure()["total_bytes"])


# ---------------------------------------------------------------------------
# backend poller + observatory
# ---------------------------------------------------------------------------


def backend_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-card allocator stats from ``torch.cuda.memory_stats(d)`` for
    each visible card: ``bytes_in_use`` (allocated bytes now),
    ``peak_bytes_in_use`` (their peak since the last reset),
    ``reserved_bytes`` (what the caching allocator holds) and
    ``bytes_limit`` (the card's total memory). Without a card the result
    is ``{}`` and callers fall back to the host's RSS."""
    try:
        import torch

        if not torch.cuda.is_available():
            return {}
        n = torch.cuda.device_count()
    except Exception:  # noqa: BLE001 — no backend is a valid observatory state
        return {}
    out: Dict[str, Dict[str, int]] = {}
    for d in range(n):
        try:
            stats = torch.cuda.memory_stats(d)
            total = int(torch.cuda.get_device_properties(d).total_memory)
        except Exception:  # noqa: BLE001
            continue
        entry = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "reserved_bytes": int(stats.get("reserved_bytes.all.current", 0)),
            "bytes_limit": total,
        }
        out[f"cuda:{d}"] = entry
    return out


def host_rss_bytes() -> Optional[int]:
    """Current resident set size of this process (``/proc/self/statm``;
    ``None`` off Linux) — the in-use fallback when the backend reports no
    memory stats, so the unaccounted-bytes leak signal still exists on a
    CPU box. The absolute value includes the Python heap; the leak alarm
    only cares about monotone *growth*, which survives the offset."""
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except Exception:  # noqa: BLE001
        return None


class MemoryObservatory:
    """One poll surface over the ledger, the cache planes, and the
    backend: ``observe()`` measures everything, derives the unaccounted
    residue, feeds the recorder's ``mem_*`` series + one typed ``memory``
    event (when telemetry is enabled), and returns the full report dict.

    Serving loops call ``observe()`` at probe rate (alongside
    ``rec.tick()``); benches call it between ingest phases. It is never
    on a metric hot path."""

    def __init__(
        self,
        recorder: Optional[Any] = None,
        ledger: Optional[MemoryLedger] = None,
        use_host_rss: bool = True,
    ) -> None:
        self.recorder = _DEFAULT_RECORDER if recorder is None else recorder
        self.ledger = MemoryLedger() if ledger is None else ledger
        #: whether to fall back to /proc RSS when the backend reports no
        #: memory stats (CPU) — off for strict device-only accounting
        self.use_host_rss = bool(use_host_rss)

    def observe(self, **extra: Any) -> Dict[str, Any]:
        report = self.ledger.measure()
        planes = cache_plane_inventory()
        plane_total = sum(planes.values())
        backend = backend_memory_stats()
        in_use: Optional[int] = None
        peak: Optional[int] = None
        source: Optional[str] = None
        if backend:
            in_use = sum(e.get("bytes_in_use", 0) for e in backend.values())
            peaks = [e["peak_bytes_in_use"] for e in backend.values() if "peak_bytes_in_use" in e]
            peak = sum(peaks) if peaks else None
            source = "backend"
        elif self.use_host_rss:
            rss = host_rss_bytes()
            if rss is not None:
                in_use = rss
                source = "host_rss"
        unaccounted: Optional[int] = None
        if in_use is not None:
            unaccounted = int(in_use) - int(report["total_bytes"]) - int(plane_total)
        out: Dict[str, Any] = dict(report)
        out.update(
            {
                "cache_planes": planes,
                "cache_plane_bytes": plane_total,
                "backend": backend,
                "device_bytes_in_use": in_use,
                "device_peak_bytes": peak,
                "unaccounted_bytes": unaccounted,
                "source": source,
            }
        )
        rec = self.recorder
        if rec is not None and rec.enabled:
            rec.record_memory_observation(
                ledger_bytes=int(report["total_bytes"]),
                cache_plane_bytes=int(plane_total),
                device_bytes_in_use=in_use,
                device_peak_bytes=peak,
                unaccounted_bytes=unaccounted,
                bytes_per_tenant=report["bytes_per_tenant"] or None,
                per_device=report["per_device"] or None,
                planes=planes or None,
                source=source,
                **extra,
            )
        return out
