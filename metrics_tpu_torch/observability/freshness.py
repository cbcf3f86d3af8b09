"""Ingest-to-visible freshness stamps for the read path.

The port's own copy of ``metrics_tpu/observability/freshness.py`` (the
module imports nothing of JAX; the port keeps its copy, as it imports
nothing of ``metrics_tpu``). A :class:`FreshnessStamp` is a tiny immutable
record of the wall-clock span of everything that contributed to a read
(``min_event_t``/``max_event_t``), plus the staleness components a read can
still be missing: data accepted into the async queue but not yet applied
(``async_age_s``), the age span of the ring buckets a windowed fold covered
(``ring_span_s``) and how far a fleet watermark trails the collector's
clock (``watermark_lag_s``). Stamps form a commutative monoid under
:meth:`FreshnessStamp.merge` (min over ``min_event_t``, max over everything
else), with :data:`IDENTITY` as the identity. Stamps are made by the
metrics (``core/metric.py``, ``sliced/metric.py``, ``windowed/metric.py``),
the collection (``collections.py``), the async update handle
(``core/pipeline.py``) and the fleet collector
(``observability/collector.py``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional

__all__ = ["FreshnessStamp", "IDENTITY", "merge_stamps", "stamp_from_payload"]


@dataclass(frozen=True)
class FreshnessStamp:
    """The freshness of one read: when the data it reflects was ingested,
    and what visible-latency components still apply.

    ``min_event_t`` / ``max_event_t`` are wall-clock (``time.time``)
    timestamps of the oldest / newest contribution reflected in the read's
    value; ``None`` means "no contribution observed" (the merge identity).
    ``async_age_s`` is the age of the oldest batch accepted into an async
    update queue but not yet applied — data the read could NOT see yet.
    ``ring_span_s`` is the wall-clock span of the ring buckets a windowed
    fold covered (how far back the window reaches). ``watermark_lag_s``
    is how far the fleet watermark trails the collector clock at a fleet
    read — the late-snapshot horizon.
    """

    min_event_t: Optional[float] = None
    max_event_t: Optional[float] = None
    async_age_s: float = 0.0
    ring_span_s: float = 0.0
    watermark_lag_s: float = 0.0

    def merge(self, other: "FreshnessStamp") -> "FreshnessStamp":
        """Commutative monoid fold: min of the min-times, max of the
        max-times and of every staleness component. Merging with
        :data:`IDENTITY` returns a stamp equal to ``self``."""
        lo_a, lo_b = self.min_event_t, other.min_event_t
        hi_a, hi_b = self.max_event_t, other.max_event_t
        return FreshnessStamp(
            min_event_t=lo_a if lo_b is None else (lo_b if lo_a is None else min(lo_a, lo_b)),
            max_event_t=hi_a if hi_b is None else (hi_b if hi_a is None else max(hi_a, hi_b)),
            async_age_s=max(self.async_age_s, other.async_age_s),
            ring_span_s=max(self.ring_span_s, other.ring_span_s),
            watermark_lag_s=max(self.watermark_lag_s, other.watermark_lag_s),
        )

    # ------------------------------------------------------------------
    # derived staleness
    # ------------------------------------------------------------------
    def visible_age_s(self, now: Optional[float] = None) -> float:
        """Age of the NEWEST data the read reflects — "how old is the
        number on this dashboard". 0.0 for an empty stamp (nothing
        ingested yet means nothing is stale yet)."""
        if self.max_event_t is None:
            return 0.0
        return max(0.0, (time.time() if now is None else now) - self.max_event_t)

    def staleness_s(self, now: Optional[float] = None) -> float:
        """The end-to-end ingest-to-visible staleness bound: the dashboard
        age plus whatever is accepted-but-not-yet-visible (async in-flight
        age) and the fleet late-snapshot horizon. This is the quantity the
        ``freshness_slo`` alarm bounds at p95."""
        return self.visible_age_s(now) + max(self.async_age_s, self.watermark_lag_s)

    @property
    def is_identity(self) -> bool:
        return (
            self.min_event_t is None
            and self.max_event_t is None
            and not (self.async_age_s or self.ring_span_s or self.watermark_lag_s)
        )

    # ------------------------------------------------------------------
    # payload round-trip (fleet aggregation / wire)
    # ------------------------------------------------------------------
    def to_payload(self) -> Dict[str, Any]:
        """JSON-safe dict with the same keys the aggregate layer's
        freshness family uses; ``None`` min/max survive as nulls."""
        return {
            "min_event_t": self.min_event_t,
            "max_event_t": self.max_event_t,
            "async_age_s": self.async_age_s,
            "ring_span_s": self.ring_span_s,
            "watermark_lag_s": self.watermark_lag_s,
        }

    @staticmethod
    def from_payload(payload: Optional[Dict[str, Any]]) -> "FreshnessStamp":
        """Inverse of :meth:`to_payload`; a missing/empty payload is the
        identity stamp (the heterogeneous-fleet convention)."""
        if not payload:
            return IDENTITY
        lo = payload.get("min_event_t")
        hi = payload.get("max_event_t")
        return FreshnessStamp(
            min_event_t=float(lo) if lo is not None else None,
            max_event_t=float(hi) if hi is not None else None,
            async_age_s=float(payload.get("async_age_s") or 0.0),
            ring_span_s=float(payload.get("ring_span_s") or 0.0),
            watermark_lag_s=float(payload.get("watermark_lag_s") or 0.0),
        )


#: the merge identity — what a contribution-free read (or a payload from a
#: publisher predating the freshness family) folds as
IDENTITY = FreshnessStamp()


def merge_stamps(stamps: Iterable[Optional[FreshnessStamp]]) -> FreshnessStamp:
    """Fold any number of stamps (``None`` entries fold as identity)."""
    out = IDENTITY
    for s in stamps:
        if s is not None:
            out = out.merge(s)
    return out


# alias used by `stamp_from_payload` re-export convention
stamp_from_payload = FreshnessStamp.from_payload
