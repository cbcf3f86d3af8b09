"""Readers of the incremental read plane: shape buckets and cached readers.

Counterpart of ``metrics_tpu/core/readers.py``. Read paths whose shapes
vary per call (a subset of slices, a top-k, a window of ring buckets, a
sketch's fill) round their row count up to a small family of buckets
(:func:`round_up_bucket`) and pad their ids to it (:func:`pad_ids`,
repeating the last id: re-reading a row is idempotent, so the pad rows
change nothing and are cut off after).

A :class:`ReaderCache` holds one reader per ``(kind, bucket, leaf
signatures, device)``. The JAX package keeps an ahead-of-time compiled
executable there; the port's counterpart on the card is a **CUDA graph
captured over static input buffers of the bucket's shape**: a caller
gathers its rows into those buffers (:meth:`Reader.gather`,
``index_select(..., out=)``) and replays the graph, one launch of the
host's instead of one per op. The graph's outputs are overwritten by its
next replay, so every consumer that keeps a reader's output (the sliced
value cache, the window memos) keeps a copy. On the CPU a reader is the
plain function, and nothing is captured.

A capture that fails (a host read inside a template's compute, an op that
capture refuses) declines that entry by name with its reason
(:attr:`ReaderCache.declined`, as ``FusedUpdate.declined`` does), and the
read runs eagerly on the card. The warm-up before a capture and the
capture itself happen on a side stream ordered both ways with the
caller's stream, in this thread's capture mode (other threads may run
meanwhile); the launches the graph holds are added to
``ops.launch_counts()`` at each replay. ``nbytes`` is the graphs' pool
bytes (``observability/memory.executable_nbytes``), the ``reader_cache``
memory plane. Deep copies and pickles start cold.
"""
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from metrics_tpu_torch.observability.memory import executable_nbytes, register_cache_plane

Tensor = torch.Tensor

#: every live ReaderCache (weak: caches die with their metric); the
#: ``reader_cache`` memory plane fans out over this set
_LIVE_READER_CACHES: "weakref.WeakSet[ReaderCache]" = weakref.WeakSet()


def _reader_plane_nbytes() -> int:
    return sum(c.nbytes() for c in list(_LIVE_READER_CACHES))


#: the bucket family read shapes round up into; reads larger than the last
#: entry double from there (and every bucket is capped at the axis size)
DEFAULT_ID_BUCKETS: Tuple[int, ...] = (8, 64, 512, 4096)

#: entries per cache before the growth warning: the key space (kinds x
#: buckets) is small, so growth past this means a per-call key
READER_CACHE_WARN_ENTRIES = 64


def round_up_bucket(n: int, cap: Optional[int] = None, buckets: Tuple[int, ...] = DEFAULT_ID_BUCKETS) -> int:
    """Smallest bucket ``>= n`` from the family (doubling past the last
    entry), capped at ``cap`` (the axis size: a full-axis read is its own
    exact bucket)."""
    n = max(int(n), 1)
    if cap is not None and n >= cap:
        return cap
    for b in buckets:
        if b >= n:
            return min(b, cap) if cap is not None else b
    b = buckets[-1]
    while b < n:
        b *= 2
    return min(b, cap) if cap is not None else b


def pad_ids(ids: Any, bucket: int) -> np.ndarray:
    """Pad a 1-D host id vector up to ``bucket`` rows by repeating the last
    id (int32). Re-reading an id is idempotent, so padded rows change
    nothing; callers cut the result back to the real prefix."""
    ids = np.asarray(ids, dtype=np.int32).reshape(-1)
    if ids.size == 0:
        raise ValueError("pad_ids: cannot pad an empty id vector")
    if ids.size >= bucket:
        return ids[:bucket]
    return np.concatenate([ids, np.full(bucket - ids.size, ids[-1], np.int32)])


def _leaf_sig(leaf: Any) -> Any:
    if isinstance(leaf, Tensor):
        return (tuple(leaf.shape), leaf.dtype)
    return ("static", leaf)


def _device_of(leaves: Sequence[Any]) -> torch.device:
    for x in leaves:
        if isinstance(x, Tensor):
            return x.device
    return torch.device("cpu")


class Reader:
    """One cached reader: the plain function, or on the card a CUDA graph
    over static input buffers (``inputs``, the flattened arguments) whose
    outputs (``outputs``) each replay overwrites."""

    __slots__ = ("fn", "graph", "inputs", "spec", "outputs", "launches", "calls", "pool_nbytes", "__weakref__")

    def __init__(self, fn: Callable) -> None:
        self.fn = fn
        self.graph: Any = None
        self.inputs: Optional[List[Any]] = None
        self.spec: Any = None
        self.outputs: Any = None
        self.launches: Dict[str, int] = {}
        self.calls = 0
        self.pool_nbytes = 0

    def __call__(self, *args: Any) -> Any:
        if self.graph is None:
            return self.fn(*args)
        flat, _ = tree_flatten(args)
        for buf, x in zip(self.inputs, flat):
            if isinstance(buf, Tensor) and x is not buf:
                buf.copy_(x)
        return self._replay()

    def gather(self, sources: Sequence[Tensor], index: Tensor) -> Any:
        """The reader over ``sources[i].index_select(0, index)``, the
        arguments being those rows in the flattened order: on a graph the
        rows land in its static buffers (``out=``) and it replays."""
        if self.graph is None:
            flat = [s.index_select(0, index) for s in sources]
            return self.fn(*tree_unflatten(flat, self.spec))
        for buf, src in zip(self.inputs, sources):
            torch.index_select(src, 0, index, out=buf)
        return self._replay()

    def _replay(self) -> Any:
        from metrics_tpu_torch.ops.dispatch import add_launches

        self.graph.replay()
        add_launches(self.launches)
        self.calls += 1
        return self.outputs


class ReaderCache:
    """Per-owner cache of readers (see the module docstring).

    ``get(kind, build, *example_args, bucket=...)`` returns the reader of
    ``build()`` (a zero-arg factory of the pure read function) for the
    arguments' shapes and dtypes, capturing it on the card at its first
    use. One cache lives on each metric that serves incremental reads."""

    def __init__(self) -> None:
        self._cache: Dict[Tuple, Reader] = {}
        self._fast: Dict[Tuple, Reader] = {}
        self._nbytes: Dict[Tuple, int] = {}
        #: kind -> reason, for each entry whose capture failed (it reads
        #: eagerly on the card)
        self.declined: Dict[str, str] = {}
        self._warned = False
        self._lock = threading.RLock()
        self._streams: Dict[torch.device, Any] = {}
        _LIVE_READER_CACHES.add(self)

    def __len__(self) -> int:
        return len(self._cache)

    def nbytes(self) -> int:
        """Card bytes the cached graphs hold (their pools and static
        inputs; 0 for plain readers): this cache's share of the
        ``reader_cache`` memory plane."""
        return sum(self._nbytes.values())

    # graphs are neither copyable nor picklable: a copied or restored
    # metric starts with a cold cache and captures again at its first read
    def __deepcopy__(self, memo: Dict) -> "ReaderCache":
        return ReaderCache()

    def __getstate__(self) -> Dict:
        return {}

    def __setstate__(self, state: Dict) -> None:
        self.__init__()

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()
            self._fast.clear()
            self._nbytes.clear()

    def fast(self, kind: str, bucket: Optional[int]) -> Optional[Reader]:
        """The reader the last :meth:`get` for ``(kind, bucket)`` resolved
        to, without hashing the arguments' signature. Owners whose state
        shapes and dtypes are fixed (and who :meth:`clear` on the changes
        that move them: ``set_dtype``, ``to_device``) probe this first."""
        return self._fast.get((kind, bucket))

    def get(self, kind: str, build: Callable[[], Callable], *example_args: Any, bucket: Optional[int] = None) -> Reader:
        flat, spec = tree_flatten(example_args)
        device = _device_of(flat)
        key = (kind, bucket, tuple(_leaf_sig(x) for x in flat), device)
        with self._lock:
            entry = self._cache.get(key)
            if entry is None:
                entry = Reader(build())
                entry.spec = spec
                if device.type == "cuda":
                    self._capture(kind, entry, flat, spec, device)
                self._cache[key] = entry
                self._nbytes[key] = executable_nbytes(entry)
                if len(self._cache) == READER_CACHE_WARN_ENTRIES and not self._warned:
                    self._warn()
            self._fast[(kind, bucket)] = entry
            return entry

    def _warn(self) -> None:
        from metrics_tpu_torch.observability.recorder import _DEFAULT_RECORDER
        from metrics_tpu_torch.utils.prints import rank_zero_warn

        self._warned = True
        if _DEFAULT_RECORDER.enabled:
            # a typed event with entries and bytes: the fleet alarms on
            # reader-cache bloat instead of losing it to stderr
            _DEFAULT_RECORDER.record_cache_plane(
                "reader_cache", entries=len(self._cache), nbytes=self.nbytes(), reason="growth_warning"
            )
        rank_zero_warn(
            f"ReaderCache: {READER_CACHE_WARN_ENTRIES} readers cached on one metric -- a read path is keying"
            " on a per-call quantity instead of a shape bucket (see metrics_tpu_torch/core/readers.py).",
            UserWarning,
        )

    def _side_stream(self, device: torch.device) -> Any:
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        return stream

    def _capture(self, kind: str, entry: Reader, flat: List[Any], spec: Any, device: torch.device) -> None:
        """Warm up and capture ``entry`` over static copies of ``flat``; a
        failure declines the entry by name (it then reads eagerly)."""
        from metrics_tpu_torch.core.fused import _capturing, _reason
        from metrics_tpu_torch.ops.dispatch import recording_launches
        from metrics_tpu_torch.utils.checks import capturing_checks

        if torch.cuda.is_current_stream_capturing():
            # never capture (or run device work) from inside a capture
            self._decline(kind, "the calling stream is capturing a CUDA graph")
            return
        inputs = [x.clone() if isinstance(x, Tensor) else x for x in flat]
        side = self._side_stream(device)
        caller = torch.cuda.current_stream(device)
        side.wait_stream(caller)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(side), capturing_checks():
                with recording_launches():
                    # lazy library and allocator set-up happens outside the graph
                    entry.fn(*tree_unflatten(inputs, spec))
                side.synchronize()
                reserved = torch.cuda.memory_stats(device).get("reserved_bytes.all.current", 0)
                with recording_launches() as launches:
                    with _capturing(graph, side):
                        outputs = entry.fn(*tree_unflatten(inputs, spec))
        except Exception as err:  # noqa: BLE001 — declined by name, read eagerly
            caller.wait_stream(side)
            self._decline(kind, _reason(err))
            return
        caller.wait_stream(side)
        grown = torch.cuda.memory_stats(device).get("reserved_bytes.all.current", 0) - reserved
        entry.graph = graph
        entry.inputs = inputs
        entry.outputs = outputs
        entry.launches = dict(launches)
        entry.pool_nbytes = max(int(grown), 0) + sum(x.numel() * x.element_size() for x in inputs if isinstance(x, Tensor))

    def _decline(self, kind: str, reason: str) -> None:
        self.declined[kind] = reason


# one plane per cache kind: the callback fans out over the live instances
register_cache_plane("reader_cache", _reader_plane_nbytes)
