"""Async update pipeline: bounded, backpressured metric ingest that keeps
the serving loop off the metrics' critical path.

Counterpart of ``metrics_tpu/core/pipeline.py``. The fused update
(``core/fused.py``) makes a batch one graph replay, but the host still
serialises: every ``collection.update(batch)`` pays the fused call's host
work inline. :meth:`MetricCollection.compile_update_async` returns an
:class:`AsyncUpdateHandle` on the same :class:`FusedUpdate`:

* ``update_async(batch)`` puts the batch into a **bounded queue** (depth 2
  by default) and returns; one worker thread drains the queue through the
  fused update.
* **On the card** the worker replays the graphs on the handle's own CUDA
  stream. It waits on an event that ``update_async`` records on the
  producer's current stream, and the batch tensors are marked
  (``record_stream``) as used on the worker's stream, so the producer may
  drop them at once. ``compute``, ``snapshot``, ``flush`` and a blocking
  ``update`` make the caller's stream wait on the worker's stream before
  any read, and the worker's next batch waits on the end of the last read
  (a replay overwrites the states in place; ``compute`` hands out copies
  of any result that shares a state buffer, so a kept value is not raced).
* **Backpressure** is the queue depth with a ``block`` / ``drop`` /
  ``error`` policy: ``block`` waits for a slot (lossless, the default),
  ``drop`` discards the batch and counts it, ``error`` raises
  :class:`AsyncQueueFull`.
* ``compute()`` reads a **bounded-staleness snapshot**: it waits until at
  most ``max_staleness`` accepted batches remain unapplied (default 0:
  drain, then compute). The state lock serialises each batch's update
  against the read, so a snapshot sits between whole batches.
* ``flush()`` / ``close()`` drain deterministically; ``close()`` joins the
  worker.
* **Worker exceptions** are kept with the batch index and raised at the
  next ``update_async``/``flush``/``compute`` as :class:`AsyncWorkerError`
  (chained to the original). The handle is then poisoned: queued batches
  are discarded, never half-applied, until ``reset()``.
* :meth:`AsyncUpdateHandle.freshness` gives the pipeline's
  :class:`~metrics_tpu_torch.observability.freshness.FreshnessStamp`.

With the default recorder enabled the handle records the JAX package's
async events: exactly one ``enqueue`` per accepted batch (before its put,
so the worker's ``dequeue`` never precedes it), one ``dequeue`` per
applied batch (recorded by the worker thread, with its apply time and the
batch's enqueue-to-apply age), one ``flush`` per drain (``flush()`` and a
draining ``close()``), and the counter-only ``drop`` and ``snapshot``
(a bounded-staleness compute); queue depth and in-flight bytes ride along.
The recorder's locks make recording from the worker safe; nothing it does
touches the card. Disabled, each site costs one bool check.

Single-producer contract: ``update_async`` is called from one thread at a
time. The worker is the only thread that changes metric state between
drains.
"""
import contextlib
import queue
import threading
import time
import traceback
import weakref
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten

from metrics_tpu_torch.observability.freshness import FreshnessStamp
from metrics_tpu_torch.observability.recorder import _DEFAULT_RECORDER as _TELEMETRY
from metrics_tpu_torch.utils.exceptions import MetricsUserError

#: queue sentinel: the worker exits (close())
_SHUTDOWN = object()

#: accepted backpressure policies for a full queue
POLICIES = ("block", "drop", "error")


class AsyncQueueFull(MetricsUserError):
    """Raised by ``update_async`` under the ``error`` policy when the
    bounded queue is full."""


class AsyncWorkerError(RuntimeError):
    """A batch failed inside the async worker.

    Raised at the next ``update_async``/``flush``/``compute``, with
    :attr:`batch_index` (the 0-based accepted-batch index that failed) and
    chained to the original exception. The handle stays poisoned:
    ``reset()`` and a fresh ``compile_update_async()`` recover.
    """

    def __init__(self, batch_index: int, original: BaseException) -> None:
        self.batch_index = batch_index
        self.original = original
        super().__init__(
            f"async metric update failed on batch {batch_index}: {original!r}"
            " (the handle is now poisoned; reset() and re-compile to recover)"
        )


def _wake_worker(q: "queue.Queue") -> None:
    """GC fallback for a handle dropped without ``close()``: wake the
    parked worker so it notices and exits."""
    try:
        q.put_nowait(_SHUTDOWN)
    except queue.Full:
        pass


def _worker_main(handle_ref: "weakref.ref", q: "queue.Queue") -> None:
    """The drain loop. It holds the handle only per item, so a handle
    dropped without ``close()`` is not kept alive by its own worker."""
    while True:
        handle = handle_ref()
        if handle is None:
            return
        handle._yield_to_snapshot_waiters()
        del handle
        item = q.get()
        if item is _SHUTDOWN:
            return
        handle = handle_ref()
        if handle is None:
            return
        handle._drain_item(item)
        handle._clear_error_frames()
        del handle


def _tensors(args: Tuple, kwargs: Dict[str, Any]) -> list:
    leaves, _ = tree_flatten((args, kwargs))
    return [x for x in leaves if isinstance(x, torch.Tensor)]


def _payload_nbytes(args: Tuple, kwargs: Dict[str, Any]) -> int:
    """Bytes of a queued batch's tensors (host attributes only)."""
    return sum(t.numel() * t.element_size() for t in _tensors(args, kwargs))


class AsyncUpdateHandle:
    """Handle returned by :meth:`MetricCollection.compile_update_async`.

    ``update_async(batch)`` enqueues and returns; a worker thread drains
    the bounded queue through the fused update (see the module docstring).
    """

    def __init__(
        self,
        collection: Any,
        fused: Any,
        queue_depth: int = 2,
        policy: str = "block",
        max_staleness: int = 0,
    ) -> None:
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
        if int(queue_depth) < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if int(max_staleness) < 0:
            raise ValueError(f"max_staleness must be >= 0, got {max_staleness}")
        # weak, as the fused handle's: the collection holds this handle
        self._collection_ref = weakref.ref(collection)
        self._fused = fused
        self.queue_depth = int(queue_depth)
        self.policy = policy
        self.max_staleness = int(max_staleness)

        self._device = fused._device
        #: the worker's CUDA stream, and the end of the last state read on
        #: the caller's stream (the next replay waits for it)
        self._stream = torch.cuda.Stream(self._device) if self._device.type == "cuda" else None
        self._after_read: Optional[Any] = None

        self._queue: "queue.Queue" = queue.Queue(maxsize=self.queue_depth)
        self._cond = threading.Condition()
        self._state_lock = threading.Lock()
        self._snapshot_waiters = 0
        self._pending = 0  # accepted batches not yet applied
        self._in_flight_bytes = 0
        self._attempts = 0  # batch-index source; a rejected batch consumes one
        self._enqueued = 0
        self._applied = 0
        self._dropped = 0
        self._error: Optional[Tuple[int, BaseException]] = None
        # freshness: accept wall time per unapplied batch, and the accept
        # times of the first and last applied batches
        self._pending_wall: Dict[int, float] = {}
        self._first_apply_wall: Optional[float] = None
        self._last_apply_wall: Optional[float] = None
        self._closed = False
        self._discard = False  # close(drain=False): the worker drops queued items
        self._staleness_override: Optional[int] = None
        self._thread = threading.Thread(
            target=_worker_main,
            args=(weakref.ref(self), self._queue),
            name="metrics-tpu-torch-async-update",
            daemon=True,
        )
        self._thread.start()
        self._finalizer = weakref.finalize(self, _wake_worker, self._queue)

    @property
    def _collection(self) -> Any:
        collection = self._collection_ref()
        if collection is None:
            raise MetricsUserError("this async handle's MetricCollection is gone")
        return collection

    # the worker thread and the graphs cannot be copied: clone() drops the
    # handle and the clone compiles its own
    def __deepcopy__(self, memo: Dict) -> None:
        return None

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def pending(self) -> int:
        """Accepted batches not yet applied."""
        with self._cond:
            return self._pending

    @property
    def dropped(self) -> int:
        """Batches discarded by the ``drop`` policy."""
        with self._cond:
            return self._dropped

    @property
    def enqueued(self) -> int:
        """Batches accepted over the handle's lifetime."""
        with self._cond:
            return self._enqueued

    @property
    def applied(self) -> int:
        """Batches applied to the metric states."""
        with self._cond:
            return self._applied

    @property
    def in_flight_bytes(self) -> int:
        """Bytes held by the queued batches, plus (when the update donates)
        the state buffers of the batch being applied: what the states'
        footprint does not show while batches are in flight."""
        with self._cond:
            return self._in_flight_bytes

    @property
    def state_lock(self) -> "threading.Lock":
        """Serialises a batch's update against state readers; use
        :meth:`snapshot` rather than the bare lock."""
        return self._state_lock

    @contextlib.contextmanager
    def snapshot(self) -> Iterator[None]:
        """Priority window for state readers: the worker yields between
        batches, the state lock is held, and on the card the caller's
        stream waits on the worker's first."""
        with self._cond:
            self._snapshot_waiters += 1
        try:
            with self._state_lock:
                self._join_worker_stream()
                try:
                    yield
                finally:
                    self._mark_read_end()
        finally:
            with self._cond:
                self._snapshot_waiters -= 1
                self._cond.notify_all()

    def freshness(self, now: Optional[float] = None) -> FreshnessStamp:
        """The pipeline's part of a read's freshness: the accept times of
        the first and last applied batches and the age of the oldest batch
        accepted but not yet applied (``async_age_s``)."""
        now = time.time() if now is None else now
        with self._cond:
            oldest = min(self._pending_wall.values()) if self._pending_wall else None
            first = self._first_apply_wall
            last = self._last_apply_wall
        return FreshnessStamp(
            min_event_t=first,
            max_event_t=last,
            async_age_s=max(0.0, now - oldest) if oldest is not None else 0.0,
        )

    # ------------------------------------------------------------------
    # streams
    # ------------------------------------------------------------------
    def _join_worker_stream(self) -> None:
        """The caller's stream waits on everything the worker issued."""
        if self._stream is not None:
            torch.cuda.current_stream(self._device).wait_stream(self._stream)

    def _mark_read_end(self) -> None:
        """The worker's next batch waits on the reads issued so far."""
        if self._stream is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self._device))
            self._after_read = event

    # ------------------------------------------------------------------
    # hot path
    # ------------------------------------------------------------------
    def _accept(self, name: str, args: Tuple, kwargs: Dict[str, Any]) -> Tuple:
        """Error and closed checks, then the batch index and accounting;
        returns the queue item."""
        self._raise_pending_error()
        if self._closed:
            raise MetricsUserError(
                f"{name}() on a closed AsyncUpdateHandle; call compile_update_async() again after reset()/close()"
            )
        ready = None
        nbytes = _payload_nbytes(args, kwargs)
        if self._stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self._device))
            for t in _tensors(args, kwargs):
                if t.is_cuda:
                    t.record_stream(self._stream)
        with self._cond:
            idx = self._attempts
            self._attempts += 1
            self._enqueued += 1
            self._pending += 1
            self._in_flight_bytes += nbytes
            self._pending_wall[idx] = time.time()
        return (idx, args, kwargs, ready, nbytes)

    def _record_enqueue(self, idx: int) -> None:
        """Exactly one ``enqueue`` event per accepted batch."""
        if _TELEMETRY.enabled:
            with self._cond:
                depth = self._pending
                inflight = self._in_flight_bytes
            _TELEMETRY.record_async_event("enqueue", batch_index=idx, queue_depth=depth, in_flight_bytes=inflight)

    def _reject(self, item: Tuple) -> None:
        with self._cond:
            self._enqueued -= 1
            self._pending -= 1
            self._in_flight_bytes -= item[4]
            self._pending_wall.pop(item[0], None)

    def update_async(self, *args: Any, **kwargs: Any) -> bool:
        """Enqueue one batch and return: ``True`` when accepted, ``False``
        when the ``drop`` policy discarded it. Raises a kept worker error
        (:class:`AsyncWorkerError`) first. Reads nothing back."""
        item = self._accept("update_async", args, kwargs)
        # single producer: only the worker changes the queue meanwhile, and
        # it only drains, so not-full cannot turn full before the put
        if self.policy != "block" and self._queue.full():
            self._reject(item)
            if self.policy == "error":
                raise AsyncQueueFull(
                    f"async update queue is full (depth {self.queue_depth}); the producer outran the"
                    " device -- flush(), raise queue_depth, or use the 'block'/'drop' policy"
                )
            with self._cond:
                self._dropped += 1
                inflight = self._in_flight_bytes
            if _TELEMETRY.enabled:
                # counter-only: the one-enqueue-per-accepted-batch count stays exact
                _TELEMETRY.record_async_event("drop", batch_index=item[0], in_flight_bytes=inflight)
            return False
        self._enqueue_lossless(item)
        return True

    def _enqueue_lossless(self, item: Tuple) -> None:
        """Wait for a queue slot, then put. A dead worker (interpreter
        teardown) raises instead of parking the producer forever."""
        with self._cond:
            while self._queue.full():
                if not self._thread.is_alive():
                    self._reject(item)  # the condition's lock is reentrant
                    raise MetricsUserError(
                        "async update worker thread is not running; the queue cannot drain"
                        " (was the interpreter shutting down?)"
                    )
                self._cond.wait(timeout=0.1)
        # recorded before the put: the worker's dequeue event follows it
        self._record_enqueue(item[0])
        self._queue.put(item)

    def update_blocking(self, *args: Any, **kwargs: Any) -> None:
        """Apply one batch in FIFO order with the queued ones: enqueue
        (whatever the policy), then drain. ``collection.update()`` routes
        here while the handle is open."""
        item = self._accept("update_blocking", args, kwargs)
        self._enqueue_lossless(item)
        self._wait_drained()

    # ------------------------------------------------------------------
    # drain / snapshot
    # ------------------------------------------------------------------
    def flush(self, timeout: Optional[float] = None) -> int:
        """Block until every accepted batch is applied. Returns how many
        were pending; raises any worker error, including one raised during
        this flush."""
        if not _TELEMETRY.enabled:
            return self._wait_drained(timeout)
        t0 = time.perf_counter()
        waited = self._wait_drained(timeout)
        _TELEMETRY.record_async_event(
            "flush",
            batches_drained=waited,
            dur_ms=round((time.perf_counter() - t0) * 1e3, 4),
            queue_depth=0,
            in_flight_bytes=self.in_flight_bytes,
        )
        return waited

    def _wait_drained(self, timeout: Optional[float] = None) -> int:
        self._raise_pending_error()
        with self._cond:
            waited = self._pending
            deadline = None if timeout is None else time.monotonic() + timeout
            while self._pending > 0 and self._error is None:
                if not self._thread.is_alive():
                    raise MetricsUserError(
                        "async update worker thread is not running; the handle cannot drain"
                        " (was the interpreter shutting down?)"
                    )
                remaining = 0.1 if deadline is None else min(0.1, deadline - time.monotonic())
                if remaining <= 0:
                    raise MetricsUserError(f"flush() timed out with {self._pending} batches still pending")
                self._cond.wait(timeout=remaining)
        self._raise_pending_error()
        self._join_worker_stream()
        return waited

    def compute(self, max_staleness: Optional[int] = None) -> Dict[str, Any]:
        """Bounded-staleness compute: wait until at most ``max_staleness``
        accepted batches remain unapplied (the handle's default when None;
        0 drains), then the collection's ``compute()``."""
        if max_staleness is not None and int(max_staleness) < 0:
            raise ValueError(f"max_staleness must be >= 0, got {max_staleness}")
        if self._closed or getattr(self._collection, "_async", None) is not self:
            raise MetricsUserError(
                "compute() on a closed or replaced AsyncUpdateHandle; use the collection's current"
                " handle (collection.async_update)"
            )
        self._staleness_override = None if max_staleness is None else int(max_staleness)
        try:
            return self._collection.compute()
        finally:
            self._staleness_override = None

    def _before_compute(self) -> None:
        """The collection's compute hook: enforce the staleness bound."""
        self._raise_pending_error()
        bound = self.max_staleness if self._staleness_override is None else self._staleness_override
        with self._cond:
            while self._pending > bound and self._error is None:
                if not self._thread.is_alive():
                    raise MetricsUserError(
                        "async update worker thread is not running; compute() cannot reach its staleness bound"
                    )
                self._cond.wait(timeout=0.1)
            staleness = self._pending
        self._raise_pending_error()
        if _TELEMETRY.enabled:
            _TELEMETRY.record_async_event("snapshot", staleness_steps=staleness)

    def close(self, drain: bool = True) -> None:
        """Stop the worker. ``drain=True`` applies every queued batch
        first; ``drain=False`` discards them. Idempotent; never raises on a
        poisoned handle. Joins the worker thread."""
        if self._closed:
            return
        self._closed = True
        if not drain:
            # flag first: a batch the worker wins from the queue meanwhile
            # is discarded there
            self._discard = True
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is _SHUTDOWN:
                    continue
                with self._cond:
                    self._pending -= 1
                    self._in_flight_bytes -= item[4]
                    self._pending_wall.pop(item[0], None)
                    self._cond.notify_all()
        while True:
            try:
                self._queue.put(_SHUTDOWN, timeout=0.1)
                break
            except queue.Full:
                if not self._thread.is_alive():
                    break
        waited = 0
        if drain and _TELEMETRY.enabled:
            with self._cond:
                waited = self._pending
        self._thread.join(timeout=60.0)
        self._finalizer.detach()
        self._join_worker_stream()
        # only a draining close is a flush
        if drain and _TELEMETRY.enabled:
            _TELEMETRY.record_async_event("flush", batches_drained=waited, queue_depth=0, in_flight_bytes=0, closed=True)

    # ------------------------------------------------------------------
    # worker
    # ------------------------------------------------------------------
    def _raise_pending_error(self) -> None:
        with self._cond:
            err = self._error
        if err is not None:
            idx, original = err
            raise AsyncWorkerError(idx, original) from original

    def _clear_error_frames(self) -> None:
        """Drop the locals of a kept worker error's finished frames. The
        frame that caught it holds this handle: a cycle that kept the
        handle, its fused update and its graphs until Python's cyclic
        collector ran. The traceback keeps its files and lines."""
        with self._cond:
            err = None if self._error is None else self._error[1]
        seen = set()
        while err is not None and id(err) not in seen:
            seen.add(id(err))
            traceback.clear_frames(err.__traceback__)
            err = err.__cause__ or err.__context__

    def _yield_to_snapshot_waiters(self) -> None:
        """Let a waiting compute() take the lock before the next batch."""
        with self._cond:
            while self._snapshot_waiters and self._error is None:
                self._cond.wait(timeout=0.1)

    def _drain_item(self, item: Tuple) -> None:
        """Apply one dequeued batch. Everything fallible runs inside the
        error capture, so a raise poisons the handle and releases waiters."""
        idx, args, kwargs, ready, nbytes = item
        with self._cond:
            self._cond.notify_all()  # a slot is free: wake a blocked producer
        err: Optional[BaseException] = None
        donated = 0
        recording = False
        t0 = 0.0
        poisoned = self._error is not None or self._discard
        if not poisoned:
            try:
                recording = _TELEMETRY.enabled
                t0 = time.perf_counter() if recording else 0.0
                if self._fused.donating:
                    # the update writes the current state buffers in place
                    # until it ends: they count as in flight meanwhile
                    donated = self._fused.donated_state_bytes()
                    with self._cond:
                        self._in_flight_bytes += donated
                with self._state_lock:
                    if self._stream is None:
                        self._fused.dispatch(args, kwargs)
                    else:
                        with torch.cuda.stream(self._stream):
                            self._stream.wait_event(ready)
                            if self._after_read is not None:
                                self._stream.wait_event(self._after_read)
                            self._fused.dispatch(args, kwargs)
            except BaseException as e:  # noqa: BLE001 -- raised again at the call site
                err = e
        with self._cond:
            self._pending -= 1
            self._in_flight_bytes -= nbytes + donated
            t_wall = self._pending_wall.pop(idx, None)
            if err is not None and self._error is None:
                self._error = (idx, err)
            if err is None and not poisoned:
                self._applied += 1
                if t_wall is not None:
                    if self._first_apply_wall is None:
                        self._first_apply_wall = t_wall
                    self._last_apply_wall = t_wall
            depth = self._pending
            inflight = self._in_flight_bytes
            self._cond.notify_all()
        if recording and err is None and not poisoned:
            # no staleness_steps here: that gauge is the compute snapshot's
            _TELEMETRY.record_async_event(
                "dequeue",
                batch_index=idx,
                queue_depth=depth,
                in_flight_bytes=inflight,
                dur_ms=round((time.perf_counter() - t0) * 1e3, 4),
                # enqueue-to-apply age, from the accept wall time the
                # freshness stamp keeps anyway
                age_ms=round((time.time() - t_wall) * 1e3, 4) if t_wall is not None else None,
            )
