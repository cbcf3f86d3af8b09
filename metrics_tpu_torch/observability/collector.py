"""Fleet observatory: a merge-tree snapshot collector over the wire format.

Counterpart of ``metrics_tpu/observability/collector.py``. Serving
processes publish snapshots of their metric states
(:mod:`metrics_tpu_torch.observability.wire`) into a transport-agnostic
sink, and a collector folds them into the answer one job would have
computed, through each metric's own ``merge_states`` (and
:func:`~metrics_tpu_torch.observability.merge_payloads` for telemetry).

* :class:`SnapshotSink` -- the publisher side of the in-tree transport: a
  directory queue of atomic snapshot files (a temporary file, then
  ``os.replace``). The sink owns the monotonic per-publisher sequence
  number; ``republish_last`` writes the previous snapshot again (fault
  injection for the dedup).
* :class:`SnapshotQueue` -- the collector side: consume-on-read polling of
  the directory, oldest first, with an optional per-poll cap.
* :class:`FleetCollector` -- decode, validate, dedup and fold:

  - **exactly-once**: a snapshot is ``(publisher, seq)``; a duplicate is
    counted and dropped.
  - **a bounded late window with a watermark**: the watermark trails the
    newest snapshot time by ``late_window_s``; ``"delta"`` snapshots wait
    until it passes them, so they fold in sequence order whatever the
    arrival order; stragglers behind it are counted and dropped.
  - **per-publisher liveness and lag** (``stale_after_s``,
    ``retire_publisher``), fed to the ``publisher_lag_s`` /
    ``collector_backlog`` / ``collector_fold_errors`` series that the
    ``publisher_stale`` / ``snapshot_backlog`` / ``fold_error`` alarms
    watch (``record_fleet_poll``).
  - **hierarchical fan-in**: :meth:`FleetCollector.publish_fold`
    re-publishes the fold as one snapshot into a parent tier's sink.

**On the card.** A collector whose template lives on a card moves each
absorbed snapshot's leaves there in ONE host-to-device copy
(:meth:`~metrics_tpu_torch.observability.wire.Snapshot.to_device`). A
decoded quantile-sketch leaf is stamped with its occupancy, counted on the
host from the rows whose weight is above 0
(:func:`~metrics_tpu_torch.sketches.quantile.with_fill_bound`), so a merge
whose union fits the capacity packs and launches no compaction; the bits
are the same either way, since the overflow is decided on the card. The
fold merges publishers in sorted order (what makes the card's fold equal
the CPU's) through ``merge_states``: K3 and K1 where sketches overflow, K4
where retrieval tables do. :meth:`FleetCollector.fold_values` computes on
the template's device and reads the values to the host once. The
collector may run on a thread other than the serving loop: its device
work runs on the device's default stream, ordered both ways with the
caller's current stream, and never on a stream that is capturing a graph.
"""
import contextlib
import dataclasses
import os
import re
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from metrics_tpu_torch.observability.wire import (
    Snapshot,
    WireError,
    _leaf_key,
    decode_snapshot,
    encode_snapshot,
    manifest_fingerprint,
    members_of,
    states_key,
)

__all__ = [
    "FleetCollector",
    "PublisherStatus",
    "SnapshotQueue",
    "SnapshotSink",
]

#: snapshot file suffix in a directory queue
SNAPSHOT_SUFFIX = ".snap"

_SAFE_ID = re.compile(r"[^A-Za-z0-9._-]+")


def _safe_name(publisher: str) -> str:
    """Publisher id -> filesystem-safe file stem."""
    return _SAFE_ID.sub("_", publisher) or "publisher"


class SnapshotSink:
    """Publisher-side directory queue: one atomic snapshot file per
    ``publish()``. Owns the per-publisher sequence number (``seq_start``
    lets a restarted publisher resume above its previous range). Thread-safe."""

    def __init__(
        self,
        directory: str,
        publisher: str,
        host: str = "",
        process: int = 0,
        tier: str = "leaf",
        seq_start: int = 0,
    ) -> None:
        if not publisher:
            raise ValueError("publisher id must be non-empty")
        self.directory = str(directory)
        self.publisher = publisher
        self.host = host
        self.process = int(process)
        self.tier = tier
        os.makedirs(self.directory, exist_ok=True)
        self._seq = int(seq_start)
        self._dups = 0
        self._lock = threading.Lock()
        self.last_path: Optional[str] = None
        self._last_blob: Optional[bytes] = None

    def publish(
        self,
        *,
        states: Optional[Dict[str, Dict[str, Any]]] = None,
        states_template: Optional[Any] = None,
        telemetry: Optional[Any] = None,
        mode: str = "state",
        t: Optional[float] = None,
        span: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Encode and atomically land one snapshot file; returns its path.
        ``span`` defaults to the caller's active trace-span context, so a
        publish inside ``with span("publish_tick"):`` is stitchable from the
        collector side."""
        if span is None:
            from metrics_tpu_torch.observability.trace import current_span_context

            span = current_span_context()
        with self._lock:
            seq = self._seq
            self._seq += 1
            blob = encode_snapshot(
                publisher=self.publisher,
                seq=seq,
                t=t,
                host=self.host,
                process=self.process,
                mode=mode,
                tier=self.tier,
                states=states,
                states_template=states_template,
                telemetry=telemetry,
                span=span,
            )
            path = self._write(blob, seq)
            self.last_path = path
            self._last_blob = blob
            return path

    def republish_last(self) -> Optional[str]:
        """Write the previous snapshot again under a fresh file name (same
        publisher and sequence number inside): fault injection for the
        collector's exactly-once dedup. ``None`` before the first publish."""
        with self._lock:
            if self._last_blob is None:
                return None
            self._dups += 1
            return self._write(self._last_blob, self._seq - 1, dup=self._dups)

    def _write(self, blob: bytes, seq: int, dup: int = 0) -> str:
        stem = f"{_safe_name(self.publisher)}-{seq:012d}{f'-dup{dup}' if dup else ''}"
        path = os.path.join(self.directory, stem + SNAPSHOT_SUFFIX)
        tmp = os.path.join(self.directory, f".{stem}.tmp.{os.getpid()}")
        with open(tmp, "wb") as fh:
            fh.write(blob)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        return path


class SnapshotQueue:
    """Collector-side directory queue: ``poll()`` returns up to
    ``max_files`` ``(path, bytes)`` pairs oldest first and unlinks each file
    after reading it. An unreadable file comes back with ``b""`` so the
    collector counts the loss."""

    def __init__(self, directory: str) -> None:
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)

    def backlog(self) -> int:
        """Snapshot files waiting in the directory."""
        try:
            return sum(1 for n in os.listdir(self.directory) if n.endswith(SNAPSHOT_SUFFIX))
        except OSError:
            return 0

    def poll(self, max_files: Optional[int] = None) -> List[Tuple[str, bytes]]:
        try:
            names = sorted(n for n in os.listdir(self.directory) if n.endswith(SNAPSHOT_SUFFIX))
        except OSError:
            return []
        if max_files is not None:
            names = names[: int(max_files)]
        out: List[Tuple[str, bytes]] = []
        for name in names:
            path = os.path.join(self.directory, name)
            try:
                with open(path, "rb") as fh:
                    blob = fh.read()
            except OSError:
                blob = b""
            try:
                os.unlink(path)
            except OSError:
                pass
            out.append((path, blob))
        return out


@dataclass(frozen=True)
class PublisherStatus:
    """One publisher's liveness and lag at a point in time."""

    publisher: str
    host: str
    process: int
    tier: str
    last_seq: int
    last_t: float
    last_arrival: float
    lag_s: float
    stale: bool
    absorbed: int
    duplicates: int
    late_dropped: int
    pending: int
    retired: bool = False


class _Pub:
    """Per-publisher collector state."""

    __slots__ = (
        "publisher", "host", "process", "tier", "seen", "pending",
        "newest", "delta_states", "delta_frontier", "telemetry",
        "telemetry_seq", "last_seq", "last_t", "last_arrival",
        "absorbed", "duplicates", "late_dropped", "retired", "spans",
    )

    def __init__(self, publisher: str) -> None:
        self.publisher = publisher
        self.host = ""
        self.process = 0
        self.tier = "leaf"
        self.seen: Dict[int, float] = {}  # seq -> snapshot t (pruned at the watermark)
        self.pending: Dict[int, Snapshot] = {}  # delta mode, awaiting the watermark
        self.newest: Optional[Snapshot] = None  # state mode, the newest snapshot
        self.delta_states: Optional[Dict[str, Dict[str, Any]]] = None
        self.delta_frontier = -1
        self.telemetry: List[Dict[str, Any]] = []
        self.telemetry_seq = -1
        self.last_seq = -1
        self.last_t = float("-inf")
        self.last_arrival = float("-inf")
        self.absorbed = 0
        self.duplicates = 0
        self.late_dropped = 0
        self.retired = False
        # span contexts of the snapshot headers (wire v2), newest last
        self.spans: List[Dict[str, Any]] = []


def _template_device(template: Any) -> Optional[torch.device]:
    for m in members_of(template).values():
        device = getattr(m, "device", None)
        if isinstance(device, torch.device):
            return device
    return None


@contextlib.contextmanager
def _device_work(device: Optional[torch.device]) -> Iterator[None]:
    """Run the block's device work on ``device``'s default stream, ordered
    after the caller's current stream and before its later work; refuse a
    capturing stream (a no-op off the card)."""
    if device is None or device.type != "cuda":
        yield
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a FleetCollector cannot fold while the calling stream captures a CUDA graph")
    caller = torch.cuda.current_stream(device)
    default = torch.cuda.default_stream(device)
    if caller == default:
        yield
        return
    default.wait_stream(caller)
    with torch.cuda.stream(default):
        yield
    caller.wait_stream(default)


def _is_quantile_sketch(red: Any) -> bool:
    return getattr(red, "sketch_kind", None) == "quantile"


class FleetCollector:
    """Folds published snapshots into one fleet view (see the module docs).

    ``template`` -- a metric or
    :class:`~metrics_tpu_torch.collections.MetricCollection` structurally
    identical to what publishers snapshot; its ``merge_states`` is the fold,
    and its device is where the decoded leaves go. ``None`` makes a
    telemetry-only collector. ``recorder`` (default: the process default)
    receives the liveness, backlog and fold-error series each poll when
    enabled. ``clock`` is the collector's clock (injectable; ``now=``
    arguments override it per call)."""

    MAX_PUB_SPANS = 256
    MAX_ERROR_DETAILS = 64

    def __init__(
        self,
        directory: Optional[str] = None,
        template: Optional[Any] = None,
        late_window_s: float = 30.0,
        stale_after_s: float = 10.0,
        recorder: Optional[Any] = None,
        clock: Optional[Callable[[], float]] = None,
        name: str = "collector",
        max_skew_s: float = 30.0,
    ) -> None:
        if late_window_s < 0:
            raise ValueError(f"late_window_s must be >= 0, got {late_window_s}")
        if stale_after_s <= 0:
            raise ValueError(f"stale_after_s must be positive, got {stale_after_s}")
        if max_skew_s < 0:
            raise ValueError(f"max_skew_s must be >= 0, got {max_skew_s}")
        self.queue = SnapshotQueue(directory) if directory is not None else None
        self.template = template
        self._template_key = states_key(template) if template is not None else None
        self._template_members = members_of(template) if template is not None else {}
        self._device = _template_device(template) if template is not None else None
        self.late_window_s = float(late_window_s)
        self.stale_after_s = float(stale_after_s)
        #: a publisher clock running ahead of the collector would drag the
        #: watermark forward; snapshot times past ``arrival + max_skew_s``
        #: are clamped (and counted) first
        self.max_skew_s = float(max_skew_s)
        self.name = name
        self.clock = clock if clock is not None else time.time
        self._recorder = recorder
        self._lock = threading.RLock()
        self._pubs: Dict[str, _Pub] = {}
        self._max_t = float("-inf")
        self.fold_errors = 0
        self.fold_error_details: List[str] = []  # bounded ring, newest last
        self.clock_skew_clamps = 0
        self._max_clock_skew_s = 0.0
        self._reported = {"absorbed": 0, "duplicates": 0, "late_dropped": 0, "fold_errors": 0}

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------
    @property
    def watermark(self) -> float:
        """Newest snapshot time seen minus the late window: snapshots at or
        below it are final, and a straggler behind it is dropped."""
        return self._max_t - self.late_window_s

    def poll(self, max_files: Optional[int] = None, now: Optional[float] = None) -> int:
        """Consume queued snapshot files (up to ``max_files``), ingest each,
        advance the watermark fold and feed the telemetry series. Returns
        the number of files consumed."""
        if self.queue is None:
            raise ValueError("this collector was constructed without a queue directory")
        # the backlog gauge is taken BEFORE consuming: the work waiting when
        # the collector woke up is the falling-behind signal
        backlog_pre = self.backlog()
        entries = self.queue.poll(max_files=max_files)
        for path, blob in entries:
            if not blob:
                self._count_fold_error(f"unreadable snapshot file {os.path.basename(path)}")
                continue
            self.ingest(blob, now=now)
        self._advance()
        self._feed_recorder(now=now, backlog=backlog_pre)
        return len(entries)

    def ingest(self, blob: bytes, now: Optional[float] = None) -> bool:
        """Ingest one raw snapshot (the transport-agnostic entry point).
        True when absorbed; False when deduplicated, late-dropped or counted
        as a fold error."""
        try:
            snap = decode_snapshot(blob)
        except WireError as err:
            self._count_fold_error(str(err))
            return False
        return self._ingest_snapshot(snap, now=now)

    def _ingest_snapshot(self, snap: Snapshot, now: Optional[float] = None) -> bool:
        arrival = self.clock() if now is None else float(now)
        with self._lock:
            pub = self._pubs.get(snap.publisher)
            if pub is None:
                pub = self._pubs[snap.publisher] = _Pub(snap.publisher)
            if snap.host:
                pub.host = snap.host
            pub.process = snap.process
            pub.tier = snap.tier
            # liveness first: even a duplicate or late snapshot proves the
            # publisher is alive and shipping
            pub.last_arrival = arrival
            pub.retired = False
            skew = snap.t - arrival
            if skew > 0:
                self._max_clock_skew_s = max(self._max_clock_skew_s, skew)
            t_eff = snap.t
            if skew > self.max_skew_s:
                t_eff = arrival + self.max_skew_s
                self.clock_skew_clamps += 1
            if snap.seq in pub.seen or snap.seq in pub.pending or (
                snap.mode == "delta" and snap.seq <= pub.delta_frontier
            ):
                pub.duplicates += 1
                return False
            if t_eff <= self.watermark:
                pub.late_dropped += 1
                return False
            if snap.states is not None:
                if not self._states_compatible(snap):
                    return False
                snap = self._on_device(snap)
            pub.seen[snap.seq] = t_eff
            pub.last_seq = max(pub.last_seq, snap.seq)
            pub.last_t = max(pub.last_t, t_eff)
            self._max_t = max(self._max_t, t_eff)
            if snap.span is not None:
                pub.spans.append({"t": t_eff, "seq": snap.seq, **snap.span})
                if len(pub.spans) > self.MAX_PUB_SPANS:
                    pub.spans = pub.spans[-self.MAX_PUB_SPANS :]
            if snap.telemetry and snap.seq > pub.telemetry_seq:
                # cumulative counters: newest wins per publisher, each
                # payload labelled with its publisher id
                pub.telemetry = [
                    p if p.get("publisher") else {**p, "publisher": snap.publisher} for p in snap.telemetry
                ]
                pub.telemetry_seq = snap.seq
            if snap.mode == "delta" and snap.states is not None:
                pub.pending[snap.seq] = snap
            elif snap.states is not None:
                if pub.newest is None or snap.seq > pub.newest.seq:
                    pub.newest = snap
            pub.absorbed += 1
            return True

    def _on_device(self, snap: Snapshot) -> Snapshot:
        """The snapshot with its leaves on the template's device (one copy)
        and its quantile-sketch leaves stamped with their occupancy."""
        from metrics_tpu_torch.sketches.quantile import with_fill_bound

        bounds = {}
        for metric, tree in snap.states.items():
            member = self._template_members.get(metric)
            reductions = getattr(member, "_reductions", {})
            for name, leaf in tree.items():
                if _is_quantile_sketch(reductions.get(name)) and isinstance(leaf, torch.Tensor) and leaf.ndim == 2:
                    # the host's count of occupied rows: weight above 0
                    bounds[(metric, name)] = int((leaf[:, 0] > 0).sum())
        if self._device is None:
            states = snap.states
        else:
            with _device_work(self._device):
                states = snap.to_device(self._device)
        for (metric, name), bound in bounds.items():
            # a fresh view carries its own attribute (views share the
            # buffer, not the bound)
            leaf = states[metric][name]
            if leaf is snap.states[metric][name]:
                leaf = states[metric][name] = leaf.view(leaf.shape)
            with_fill_bound(leaf, bound)
        return dataclasses.replace(snap, states=states)

    def _states_compatible(self, snap: Snapshot) -> bool:
        """Validate a states-carrying snapshot against the template before
        any leaf is folded; a mismatch is a fold error. Caller holds the lock."""
        if self.template is None:
            self._count_fold_error_locked(
                f"publisher {snap.publisher!r} shipped metric states but this"
                " collector has no template to fold them with"
            )
            return False
        if snap.states_key is not None and snap.states_key != self._template_key:
            self._count_fold_error_locked(
                f"publisher {snap.publisher!r} states layout disagrees with the collector template (seq {snap.seq})"
            )
            return False
        ours = manifest_fingerprint()
        if snap.manifest_hash and ours and snap.manifest_hash != ours:
            self._count_fold_error_locked(
                f"publisher {snap.publisher!r} manifest fingerprint {snap.manifest_hash} != collector {ours} (version skew)"
            )
            return False
        return True

    # ------------------------------------------------------------------
    # watermark fold
    # ------------------------------------------------------------------
    def _advance(self) -> None:
        """Fold the delta snapshots the watermark has passed (in sequence
        order) and prune resolved sequence numbers."""
        with self._lock:
            wm = self.watermark
            for pub in self._pubs.values():
                ready = sorted(s for s, snap in pub.pending.items() if snap.t <= wm)
                for seq in ready:
                    self._fold_delta_locked(pub, pub.pending.pop(seq))
                # a sequence number at or below the watermark can never fold
                # again (a re-arrival is late-dropped first)
                pub.seen = {s: t for s, t in pub.seen.items() if t > wm}

    def _fold_delta_locked(self, pub: _Pub, snap: Snapshot) -> None:
        try:
            if pub.delta_states is None:
                pub.delta_states = snap.states
            else:
                pub.delta_states = self._merge_states_trees(pub.delta_states, snap.states)
            pub.delta_frontier = max(pub.delta_frontier, snap.seq)
        except Exception as err:  # noqa: BLE001 — one bad snapshot must not kill the tree
            self._count_fold_error_locked(f"delta fold failed for {pub.publisher!r} seq {snap.seq}: {err!r}")

    def _merge_states_trees(self, a: Dict[str, Dict[str, Any]], b: Dict[str, Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
        with _device_work(self._device):
            return {name: metric.merge_states(a[name], b[name]) for name, metric in self._template_members.items()}

    def flush_pending(self) -> None:
        """Fold every pending delta snapshot regardless of the watermark
        (sequence order per publisher): the shutdown and inspection path."""
        with self._lock:
            for pub in self._pubs.values():
                for seq in sorted(pub.pending):
                    self._fold_delta_locked(pub, pub.pending.pop(seq))

    # ------------------------------------------------------------------
    # error accounting
    # ------------------------------------------------------------------
    def _count_fold_error(self, detail: str) -> None:
        with self._lock:
            self._count_fold_error_locked(detail)

    def _count_fold_error_locked(self, detail: str) -> None:
        self.fold_errors += 1
        self.fold_error_details.append(detail)
        if len(self.fold_error_details) > self.MAX_ERROR_DETAILS:
            self.fold_error_details = self.fold_error_details[-self.MAX_ERROR_DETAILS :]

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------
    def totals(self) -> Dict[str, int]:
        with self._lock:
            return {
                "absorbed": sum(p.absorbed for p in self._pubs.values()),
                "duplicates": sum(p.duplicates for p in self._pubs.values()),
                "late_dropped": sum(p.late_dropped for p in self._pubs.values()),
                "fold_errors": self.fold_errors,
                "clock_skew_clamps": self.clock_skew_clamps,
                "publishers": len(self._pubs),
            }

    def publisher_spans(self) -> Dict[str, List[Dict[str, Any]]]:
        """Per-publisher publish-time span contexts (wire v2), newest last:
        what ``export_perfetto(collector=...)`` draws."""
        with self._lock:
            return {name: list(p.spans) for name, p in sorted(self._pubs.items()) if p.spans}

    def backlog(self) -> int:
        """Unfolded work: queued snapshot files plus pending delta snapshots."""
        with self._lock:
            pending = sum(len(p.pending) for p in self._pubs.values())
        return pending + (self.queue.backlog() if self.queue is not None else 0)

    def retire_publisher(self, publisher: str) -> bool:
        """Take a cleanly shut-down publisher out of liveness tracking: its
        contribution stays in the fold, its lag no longer feeds
        ``publisher_stale``. A later snapshot un-retires it. False for an
        unknown publisher."""
        with self._lock:
            p = self._pubs.get(publisher)
            if p is None:
                return False
            p.retired = True
            return True

    def publishers(self, now: Optional[float] = None) -> List[PublisherStatus]:
        """Liveness and lag per publisher, sorted by id: ``lag_s`` is the
        collector's now minus the newest snapshot time, and a publisher
        silent past ``stale_after_s`` (and not retired) is ``stale``."""
        now = self.clock() if now is None else float(now)
        with self._lock:
            out = []
            for name in sorted(self._pubs):
                p = self._pubs[name]
                lag = max(0.0, now - p.last_t) if p.last_t > float("-inf") else float("inf")
                out.append(
                    PublisherStatus(
                        publisher=p.publisher,
                        host=p.host,
                        process=p.process,
                        tier=p.tier,
                        last_seq=p.last_seq,
                        last_t=p.last_t,
                        last_arrival=p.last_arrival,
                        lag_s=lag,
                        stale=(not p.retired) and lag > self.stale_after_s,
                        absorbed=p.absorbed,
                        duplicates=p.duplicates,
                        late_dropped=p.late_dropped,
                        pending=len(p.pending),
                        retired=p.retired,
                    )
                )
            return out

    # ------------------------------------------------------------------
    # the fold
    # ------------------------------------------------------------------
    def fold_states(self) -> Optional[Dict[str, Dict[str, Any]]]:
        """The fleet's state fold: one state per publisher (the newest
        cumulative snapshot in ``"state"`` mode, the folded increments in
        ``"delta"`` mode), merged in sorted publisher order through the
        template's ``merge_states``. ``None`` when no publisher has shipped
        states. A contribution whose leaf structure disagrees with the
        template (or whose merge raises) is counted and evicted; the others
        still fold."""
        with self._lock:
            contributions: List[Tuple[str, str, Dict[str, Dict[str, Any]]]] = []
            for name in sorted(self._pubs):
                p = self._pubs[name]
                if p.newest is not None and p.newest.states is not None:
                    contributions.append((name, "newest", p.newest.states))
                if p.delta_states is not None:
                    contributions.append((name, "delta", p.delta_states))
        folded: Optional[Dict[str, Dict[str, Any]]] = None
        for pub_name, kind, tree in contributions:
            problem = self._structural_mismatch(tree)
            if problem is None:
                try:
                    folded = tree if folded is None else self._merge_states_trees(folded, tree)
                    continue
                except Exception as err:  # noqa: BLE001
                    problem = repr(err)
            self._count_fold_error(f"fold contribution from {pub_name!r} evicted: {problem}")
            with self._lock:
                p = self._pubs.get(pub_name)
                if p is not None:
                    if kind == "newest":
                        p.newest = None
                    else:
                        p.delta_states = None
        return folded

    def _structural_mismatch(self, tree: Dict[str, Dict[str, Any]]) -> Optional[str]:
        """The first difference between a contribution's leaf structure and
        the template's, or ``None`` when the fold is safe."""
        if self._template_key is None:
            return "no collector template"
        if set(tree) != set(self._template_key):
            return f"metric set {sorted(tree)} != template {sorted(self._template_key)}"
        for metric, leaves in tree.items():
            want = self._template_key[metric]["states"]
            if set(leaves) != set(want):
                return f"{metric!r} states {sorted(leaves)} != template {sorted(want)}"
            for name, leaf in leaves.items():
                got = _leaf_key(leaf)
                if got != want[name]:
                    return f"{metric}.{name} layout {got} != template {want[name]}"
        return None

    def fold_values(self) -> Dict[str, Any]:
        """Each template member's ``compute_state`` over the fold: the
        fleet-wide values, on the host (one read of the card). With the
        recorder enabled, a ``fleet_fold`` span linked to each publisher's
        newest publish span, and a fleet-tier ``read`` event with the
        fan-in and a freshness stamp."""
        rec = self._recorder
        if rec is None:
            from metrics_tpu_torch.observability.recorder import _DEFAULT_RECORDER as rec  # noqa: N813
        if not rec.enabled:
            return self._fold_values_impl()
        from metrics_tpu_torch.observability.trace import span as _span

        with self._lock:
            links = [
                {"publisher": name, "span_id": p.spans[-1].get("span_id"), "seq": p.spans[-1].get("seq")}
                for name, p in sorted(self._pubs.items())
                if p.spans
            ]
        t0 = time.perf_counter()
        with _span("fleet_fold", recorder=rec, collector=self.name, links=links):
            out = self._fold_values_impl()
        self._record_fleet_read(rec, time.perf_counter() - t0, leaves=len(out))
        return out

    def _fold_values_impl(self) -> Dict[str, Any]:
        folded = self.fold_states()
        if folded is None:
            return {}
        out: Dict[str, Any] = {}
        with _device_work(self._device):
            for name, metric in self._template_members.items():
                try:
                    out[name] = metric.compute_state(folded[name])
                except Exception as err:  # noqa: BLE001
                    self._count_fold_error(f"compute over fold failed for {name!r}: {err!r}")
        return _to_host(out)

    def _record_fleet_read(self, rec: Any, dur_s: float, leaves: int) -> None:
        """The fleet-tier read event and freshness stamp (best effort:
        telemetry never breaks the fold)."""
        try:
            from metrics_tpu_torch.observability.freshness import FreshnessStamp

            with self._lock:
                contrib = [
                    p.last_t
                    for p in self._pubs.values()
                    if (p.newest is not None or p.delta_states is not None) and p.last_t > float("-inf")
                ]
                wm = self._max_t - self.late_window_s
            lag = max(0.0, self.clock() - wm) if contrib else 0.0
            stamp = FreshnessStamp(
                min_event_t=min(contrib) if contrib else None,
                max_event_t=max(contrib) if contrib else None,
                watermark_lag_s=lag,
            )
            rec.record_read(
                "fleet", None, duration_s=dur_s, leaves=leaves, fanin=len(contrib), freshness=stamp, collector=self.name
            )
        except Exception:  # noqa: BLE001
            pass

    def fold_telemetry(self) -> List[Dict[str, Any]]:
        """Every publisher's newest telemetry payloads, in sorted publisher order."""
        with self._lock:
            out: List[Dict[str, Any]] = []
            for name in sorted(self._pubs):
                out.extend(self._pubs[name].telemetry)
            return out

    def merged_telemetry(self) -> Optional[Dict[str, Any]]:
        """``merge_payloads`` over :meth:`fold_telemetry`, or ``None`` when
        no publisher shipped telemetry."""
        payloads = self.fold_telemetry()
        if not payloads:
            return None
        from metrics_tpu_torch.observability.aggregate import merge_payloads

        return merge_payloads(payloads)

    # ------------------------------------------------------------------
    # hierarchy
    # ------------------------------------------------------------------
    def publish_fold(self, sink: SnapshotSink, t: Optional[float] = None) -> Optional[str]:
        """Re-publish the fold as one ``"state"`` snapshot into a parent
        tier's sink (the merge-tree edge). ``None`` when there is nothing
        to publish."""
        folded = self.fold_states()
        payloads = self.fold_telemetry()
        if folded is None and not payloads:
            return None
        return sink.publish(
            states=folded,
            states_template=self.template if folded is not None else None,
            telemetry=payloads or None,
            mode="state",
            t=t,
        )

    # ------------------------------------------------------------------
    # telemetry feed and Prometheus
    # ------------------------------------------------------------------
    def _feed_recorder(self, now: Optional[float] = None, backlog: Optional[int] = None) -> None:
        rec = self._recorder
        if rec is None:
            from metrics_tpu_torch.observability.recorder import _DEFAULT_RECORDER as rec  # noqa: N813
        if not rec.enabled:
            return
        totals = self.totals()
        deltas = {k: totals[k] - self._reported[k] for k in self._reported}
        self._reported = {k: totals[k] for k in self._reported}
        statuses = self.publishers(now=now)
        lags = [s.lag_s for s in statuses if not s.retired and s.lag_s != float("inf")]
        try:
            rec.record_fleet_poll(
                absorbed=deltas["absorbed"],
                duplicates=deltas["duplicates"],
                late_dropped=deltas["late_dropped"],
                fold_errors=deltas["fold_errors"],
                backlog=self.backlog() if backlog is None else backlog,
                max_lag_s=max(lags) if lags else 0.0,
                publishers=totals["publishers"],
            )
        except Exception:  # noqa: BLE001 — telemetry never breaks the fold
            pass

    def prometheus_lines(self, now: Optional[float] = None) -> List[str]:
        """The collector's own families: per-publisher liveness, lag and
        sequence, the snapshot outcome counters, backlog and watermark age."""
        from metrics_tpu_torch.observability.exporters import _labels

        now_f = self.clock() if now is None else float(now)
        statuses = self.publishers(now=now_f)
        totals = self.totals()
        lines = [
            "# HELP metrics_tpu_fleet_publisher_up Publisher liveness (1 = shipped a snapshot within stale_after_s).",
            "# TYPE metrics_tpu_fleet_publisher_up gauge",
        ]
        for s in statuses:
            lines.append(f"metrics_tpu_fleet_publisher_up{_labels(publisher=s.publisher, host=s.host)} {0 if s.stale else 1}")
        lines.append("# HELP metrics_tpu_fleet_publisher_lag_seconds Now minus the publisher's newest snapshot time.")
        lines.append("# TYPE metrics_tpu_fleet_publisher_lag_seconds gauge")
        for s in statuses:
            if s.lag_s != float("inf"):
                lines.append(f"metrics_tpu_fleet_publisher_lag_seconds{_labels(publisher=s.publisher, host=s.host)} {s.lag_s:g}")
        lines.append("# HELP metrics_tpu_fleet_publisher_last_seq Newest sequence number absorbed per publisher.")
        lines.append("# TYPE metrics_tpu_fleet_publisher_last_seq gauge")
        for s in statuses:
            lines.append(f"metrics_tpu_fleet_publisher_last_seq{_labels(publisher=s.publisher, host=s.host)} {s.last_seq}")
        lines.append(
            "# HELP metrics_tpu_fleet_snapshots_total Snapshots by ingest outcome (absorbed|duplicate|late_dropped|fold_error; disjoint)."
        )
        lines.append("# TYPE metrics_tpu_fleet_snapshots_total counter")
        for outcome, key in (
            ("absorbed", "absorbed"),
            ("duplicate", "duplicates"),
            ("late_dropped", "late_dropped"),
            ("fold_error", "fold_errors"),
        ):
            lines.append(f"metrics_tpu_fleet_snapshots_total{_labels(outcome=outcome)} {totals[key]}")
        lines.append("# HELP metrics_tpu_fleet_clock_skew_seconds Largest ahead-of-collector publisher clock skew observed.")
        lines.append("# TYPE metrics_tpu_fleet_clock_skew_seconds gauge")
        lines.append(f"metrics_tpu_fleet_clock_skew_seconds {self._max_clock_skew_s:g}")
        lines.append(
            "# HELP metrics_tpu_fleet_clock_skew_clamps_total Snapshot times clamped to now + max_skew_s before watermark accounting."
        )
        lines.append("# TYPE metrics_tpu_fleet_clock_skew_clamps_total counter")
        lines.append(f"metrics_tpu_fleet_clock_skew_clamps_total {totals['clock_skew_clamps']}")
        lines.append("# HELP metrics_tpu_fleet_backlog Unfolded snapshots (queued files + in-window pending deltas).")
        lines.append("# TYPE metrics_tpu_fleet_backlog gauge")
        lines.append(f"metrics_tpu_fleet_backlog {self.backlog()}")
        lines.append("# HELP metrics_tpu_fleet_publishers Distinct publishers ever seen.")
        lines.append("# TYPE metrics_tpu_fleet_publishers gauge")
        lines.append(f"metrics_tpu_fleet_publishers {totals['publishers']}")
        if self._max_t > float("-inf"):
            lines.append("# HELP metrics_tpu_fleet_watermark_age_seconds Now minus the event-time watermark.")
            lines.append("# TYPE metrics_tpu_fleet_watermark_age_seconds gauge")
            lines.append(f"metrics_tpu_fleet_watermark_age_seconds {max(0.0, now_f - self.watermark):g}")
        return lines

    def fold_value_lines(self) -> List[str]:
        """Scalar fleet-wide metric values as a Prometheus family (vector
        results are skipped: exposition samples are scalars)."""
        from metrics_tpu_torch.observability.exporters import _labels

        values = self.fold_values()
        lines: List[str] = []
        scalars = []
        for name, value in sorted(values.items()):
            try:
                scalars.append((name, float(value)))
            except (TypeError, ValueError, RuntimeError):
                continue
        if scalars:
            lines.append("# HELP metrics_tpu_fleet_metric_value Fleet-wide metric value computed over the global fold.")
            lines.append("# TYPE metrics_tpu_fleet_metric_value gauge")
            for name, v in scalars:
                lines.append(f"metrics_tpu_fleet_metric_value{_labels(metric=name)} {v:g}")
        return lines

    def render_prometheus(
        self,
        now: Optional[float] = None,
        include_collector_families: bool = True,
        include_fold_values: bool = False,
    ) -> str:
        """The federated page: the merged telemetry through
        :func:`~metrics_tpu_torch.observability.render_prometheus`, the
        collector's fleet families and, optionally, the fleet-wide values.
        ``include_collector_families=False`` gives the page that depends
        only on the absorbed multiset, whatever the arrival order."""
        from metrics_tpu_torch.observability.exporters import render_prometheus

        merged = self.merged_telemetry()
        parts: List[str] = []
        if merged is not None:
            parts.append(render_prometheus(aggregate=merged))
        if include_fold_values:
            lines = self.fold_value_lines()
            if lines:
                parts.append("\n".join(lines) + "\n")
        if include_collector_families:
            parts.append("\n".join(self.prometheus_lines(now=now)) + "\n")
        return "".join(parts)


def _to_host(values: Dict[str, Any]) -> Dict[str, Any]:
    """Every tensor of ``values`` on the host, in one read of each card:
    the card's tensors are packed into one buffer and copied once."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    leaves, spec = tree_flatten(values)
    on_card = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor) and x.device.type != "cpu"]
    if not on_card:
        return values
    by_device: Dict[torch.device, List[int]] = {}
    for i in on_card:
        by_device.setdefault(leaves[i].device, []).append(i)
    for device, idx in by_device.items():
        parts = [leaves[i].detach().contiguous().reshape(-1).view(torch.uint8) for i in idx]
        host = torch.cat(parts).cpu()
        lo = 0
        for i, part in zip(idx, parts):
            n = part.numel()
            leaves[i] = host[lo : lo + n].clone().view(leaves[i].dtype).reshape(leaves[i].shape)
            lo += n
    return tree_unflatten(leaves, spec)
