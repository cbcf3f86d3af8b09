"""Cross-process state synchronisation on ``torch.distributed``, and the
scalar ``reduce``/``class_reduce`` helpers.

Counterpart of ``metrics_tpu/parallel/distributed.py``. The process group
takes the place of the JAX package's mesh axis:

* :func:`gather_all_arrays` -- one tensor per rank, each with its true
  shape (the reference's ``gather_all_tensors`` contract). Tensors travel
  as **bytes**: each is viewed as ``uint8`` for the collective and viewed
  back, so every dtype (``bool``, ``bfloat16``, ``float16`` included) and
  every NaN bit arrives as it left, whatever dtypes the backend moves.
  Card tensors go to the collective as they are (NCCL moves them on the
  card; gloo stages CUDA tensors itself); nothing is copied to the host to
  be synced. A header exchange (one small int64 tensor, the one host read
  of a gather) gives every rank the others' dtypes, shapes and sketch
  occupancy bounds; the payload is padded to the largest rank's byte count,
  gathered once and trimmed. A 0-d tensor is gathered as it is, with no
  header. A rank with nothing to send (an empty list state) sends zero
  bytes and receives the others' trailing shape and dtype, so every rank
  enters the same collectives in the same order.
* :func:`sync_pytree` -- a whole nested state (``MetricCollection.
  state_reductions()``'s layout) in one collective round per group of
  leaves: sum/mean/max/min leaves grouped by (reduction, dtype), sketch
  (``merge_like``) leaves by dtype, the others one by one. Every group is
  one ``all_gather`` of its flat bytes and a fold on the device in rank
  order, so float sums give every rank the same bits, equal to
  ``(r0 + r1) + r2 ...``; max and min fold with the JAX package's NaN and
  signed-zero semantics.

* **Sharded state** (``sliced/sharding.py``, :meth:`Metric.shard_states
  <metrics_tpu_torch.core.metric.Metric.shard_states>`). The process group
  is the mesh axis: :class:`RankMesh` (a group, this rank, the world size)
  takes the place of ``jax.sharding.Mesh`` and :class:`RankSharding` of
  ``NamedSharding(mesh, PartitionSpec(...))``; :class:`PartitionSpec` is
  the port's own tuple. Rank ``r`` of ``W`` owns the rows
  ``[r*N/W, (r+1)*N/W)`` of a sharded leaf's leading dimension and holds
  them as a tensor of that block's size. :func:`gather_parts` is the
  routing gather of a sharded update: the bytes of fixed-shape parts in
  one round, no header and no host read, so every rank passes the same
  shapes. ``sync_pytree(partition_specs=, axis_name=)`` passes a leaf
  whose spec names the axis through with no round and no bytes (the JAX
  package's ``sliced_passthrough``); under
  ``METRICS_TPU_TORCH_VERIFY_MANIFEST`` each such claim is checked against
  the port's layout manifest (:func:`layout_verify_counters`).

Every collective counts in :func:`collective_counts` (rounds, bytes
received and host reads), as the kernels count their launches. With the
default telemetry recorder enabled, each gather and each ``sync_pytree``
is a span and records one ``sync`` event: the bytes it brought in (its
rounds' ``bytes_received``), the world size and, for an uneven gather, the
pad-to-max bytes that carried no data. A ``sync_pytree`` owns the event of
the gathers it makes.
"""
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.observability.recorder import _DEFAULT_RECORDER as _TELEMETRY
from metrics_tpu_torch.observability.trace import span as _span
from metrics_tpu_torch.sketches.quantile import _FILL_BOUND, fill_bound, with_fill_bound, with_rank_fill_bounds
from metrics_tpu_torch.utils.data import dim_zero_cat, maximum_ieee, minimum_ieee
from metrics_tpu_torch.utils.exceptions import MetricsUserError

Tensor = torch.Tensor

#: the dtypes a gather moves, by their code in the header exchange
_DTYPES = (
    torch.bool,
    torch.uint8,
    torch.int8,
    torch.int16,
    torch.int32,
    torch.int64,
    torch.float16,
    torch.bfloat16,
    torch.float32,
    torch.float64,
    torch.complex64,
    torch.complex128,
)
_DTYPE_CODE = {dt: i for i, dt in enumerate(_DTYPES)}
#: most dimensions a gathered tensor may have (the header's width)
_MAX_DIMS = 8
#: header fields before the shape: dtype code, ndim, occupancy bound (-1: none)
_HEAD = 3

_COUNTS = {"rounds": 0, "bytes_received": 0, "host_reads": 0}

#: set while a sync_pytree runs on this thread: it records the sync event
#: of the gathers it makes
_PYTREE_SYNC = threading.local()


def collective_counts() -> Dict[str, int]:
    """Collectives issued by this process since the last reset: ``rounds``
    (each ``all_gather``), ``bytes_received`` (the bytes every round brought
    in, this rank's own included) and ``host_reads`` (header and bound
    reads)."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    for key in _COUNTS:
        _COUNTS[key] = 0


def distributed_available() -> bool:
    """True when an initialised ``torch.distributed`` group has more than one process."""
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def world_size(group: Optional[Any] = None) -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def process_index() -> int:
    """This process's ``torch.distributed`` rank, 0 when no group is initialised."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


# ---------------------------------------------------------------------------
# the byte transport
# ---------------------------------------------------------------------------


def _as_bytes(x: Tensor) -> Tensor:
    """``x``'s bytes as a flat ``uint8`` tensor (a view where ``x`` is contiguous)."""
    flat = x.contiguous().reshape(-1)
    return flat if flat.dtype == torch.uint8 else flat.view(torch.uint8)


def _from_bytes(raw: Tensor, dtype: torch.dtype, shape: Sequence[int]) -> Tensor:
    """The inverse of :func:`_as_bytes` on a flat ``uint8`` tensor."""
    return (raw if dtype == torch.uint8 else raw.view(dtype)).reshape(tuple(shape))


def _all_gather_even(buf: Tensor, group: Optional[Any]) -> List[Tensor]:
    """One ``all_gather`` of a flat tensor of the same length and dtype on every rank."""
    world = world_size(group)
    if world == 1:
        return [buf]
    out = [torch.empty_like(buf) for _ in range(world)]
    torch.distributed.all_gather(out, buf, group=group)
    _COUNTS["rounds"] += 1
    _COUNTS["bytes_received"] += buf.numel() * buf.element_size() * world
    return out


def _header(x: Tensor, bound: int) -> List[int]:
    if x.ndim > _MAX_DIMS:
        raise ValueError(f"cannot gather a tensor of {x.ndim} dimensions (at most {_MAX_DIMS})")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"cannot gather a tensor of dtype {x.dtype}")
    shape = list(x.shape) + [0] * (_MAX_DIMS - x.ndim)
    return [_DTYPE_CODE[x.dtype], x.ndim, bound] + shape


def gather_all_arrays(result: Tensor, group: Optional[Any] = None) -> List[Tensor]:
    """Gather a tensor from every process, one per rank, each with its true
    shape (ranks may differ in every dimension and in the leading one may
    hold zero rows). With one process: ``[result]``.

    A sketch tensor's occupancy bound (``sketches.quantile.fill_bound``)
    rides in the header, and each rank's tensor comes back stamped with its
    bound, so a merge of sketches whose union fits compacts nothing.
    """
    if not distributed_available():
        return [result]
    if not _TELEMETRY.enabled or getattr(_PYTREE_SYNC, "active", False):
        return _gather_all_arrays(result, group)[0]
    before = _COUNTS["bytes_received"]
    world = world_size(group)
    with _span("gather_all_arrays", world_size=world):
        out, pad_waste = _gather_all_arrays(result, group)
        _TELEMETRY.record_sync(
            "gather_all_arrays",
            gather_bytes=_COUNTS["bytes_received"] - before,
            world_size=world,
            pad_waste_bytes=pad_waste,
        )
    return out


def _gather_all_arrays(result: Tensor, group: Optional[Any]) -> Tuple[List[Tensor], int]:
    """The gather, and the padding bytes it moved (header bytes excluded)."""
    if result.ndim == 0:
        raw = _all_gather_even(_as_bytes(result), group)
        return [_from_bytes(r, result.dtype, ()) for r in raw], 0

    bound = fill_bound(result) if hasattr(result, _FILL_BOUND) else -1
    head = torch.tensor(_header(result, bound), dtype=torch.int64, device=result.device)
    table = torch.stack(_all_gather_even(head, group)).tolist()
    _COUNTS["host_reads"] += 1
    nbytes = []
    for row in table:
        shape = row[_HEAD : _HEAD + row[1]]
        numel = 1
        for d in shape:
            numel *= d
        nbytes.append(numel * _DTYPES[row[0]].itemsize)
    width = max(nbytes)
    if width == 0:
        gathered = [result.new_empty((0,), dtype=torch.uint8) for _ in table]
    else:
        local = _as_bytes(result)
        if local.numel() < width:
            local = torch.cat([local, local.new_zeros(width - local.numel())])
        gathered = _all_gather_even(local, group)
    # a rank that sent nothing takes the trailing shape and dtype of the
    # first rank that sent something (its own when none did)
    ref = next((row for row, n in zip(table, nbytes) if n), table[0])
    out = []
    for row, n, raw in zip(table, nbytes, gathered):
        if n == 0 and row is not ref:
            dtype, shape = _DTYPES[ref[0]], [0] + ref[_HEAD + 1 : _HEAD + ref[1]]
        else:
            dtype, shape = _DTYPES[row[0]], row[_HEAD : _HEAD + row[1]]
        tensor = _from_bytes(raw[:n], dtype, shape)
        if row[2] >= 0:
            with_fill_bound(tensor, row[2])
        out.append(tensor)
    return out, width * len(table) - sum(nbytes) if width else 0


# ---------------------------------------------------------------------------
# one-round sync of a nested state
# ---------------------------------------------------------------------------


def _iter_state_leaves(tree: Dict[str, Any], path: Tuple = ()):
    """Depth-first ``(path, value)`` pairs of a (possibly nested) state dict."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _iter_state_leaves(value, path + (key,))
        else:
            yield path + (key,), value


def _path_get(tree: Any, path: Tuple) -> Any:
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            return None
        tree = tree[key]
    return tree


def _path_set(tree: Dict[str, Any], path: Tuple, value: Any) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


#: reductions that fold elementwise across ranks, grouped by (reduction, dtype)
_ELEMENTWISE = ("sum", "mean", "max", "min")


def _fold(red: str, stack: Tensor) -> Tensor:
    """Fold a ``[world, ...]`` stack across ranks in rank order."""
    if red in ("max", "min"):
        fold = maximum_ieee if red == "max" else minimum_ieee
        out = stack[0]
        for r in range(1, stack.shape[0]):
            out = fold(out, stack[r])
        return out
    work = stack.to(torch.int32) if stack.dtype == torch.bool else stack
    out = work[0]
    for r in range(1, work.shape[0]):
        out = out + work[r]
    if red == "mean":
        out = (out if out.is_floating_point() else out.to(torch.float32)) / stack.shape[0]
    elif stack.dtype == torch.bool:
        out = out.to(torch.bool)
    return out


def _gather_group(parts: List[Tensor], extra: Optional[Tensor], gather: Callable, group: Any) -> Tensor:
    """One gather of the bytes of ``parts`` (and ``extra``) back to back:
    ``[world, total_bytes]``."""
    pieces = [_as_bytes(p) for p in parts] + ([] if extra is None else [_as_bytes(extra)])
    buf = torch.cat(pieces) if len(pieces) > 1 else pieces[0]
    return torch.stack(gather(buf, group=group))


def _split_group(gathered: Tensor, parts: List[Tensor]) -> Tuple[List[Tensor], int]:
    """The ``[world, ...]`` stack of each part of a gathered group, and the
    byte offset past the last part."""
    world, offset, stacks = gathered.shape[0], 0, []
    for part in parts:
        n = part.numel() * part.element_size()
        shape = (world,) + tuple(part.shape)
        raw = gathered[:, offset : offset + n].contiguous()
        stacks.append(raw.view(part.dtype).reshape(shape) if n else part.new_empty(shape))
        offset += n
    return stacks, offset


# ---------------------------------------------------------------------------
# the process group as a mesh axis: specs, shardings, the routing gather
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """The port's ``jax.sharding.PartitionSpec``: one entry per array
    dimension, a mesh axis name or None; an empty spec replicates. It is a
    tuple, and compares as one."""

    def __new__(cls, *entries: Any) -> "PartitionSpec":
        return tuple.__new__(cls, entries)

    def __getnewargs__(self) -> Tuple:
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class RankMesh:
    """The port's one-axis mesh: a process group (None: the default one),
    this process's rank in it and the group's size. Rank and size default
    to the initialised group's (0 and 1 without one); a simulated world
    gives them explicitly. Where the JAX package takes a ``mesh``, the port
    takes a ``RankMesh``, a process group, a
    ``torch.distributed.device_mesh.DeviceMesh`` with the named axis, or
    None (:func:`rank_mesh`)."""

    __slots__ = ("group", "rank", "world_size")

    def __init__(self, group: Optional[Any] = None, rank: Optional[int] = None, world_size: Optional[int] = None) -> None:
        dist = torch.distributed
        live = dist.is_available() and dist.is_initialized()
        self.group = group
        self.rank = int(rank) if rank is not None else (dist.get_rank(group) if live else 0)
        self.world_size = int(world_size) if world_size is not None else (dist.get_world_size(group) if live else 1)
        if not 0 <= self.rank < self.world_size:
            raise MetricsUserError(f"rank {self.rank} is outside a world of {self.world_size}")

    def _key(self) -> Tuple:
        return (id(self.group), self.rank, self.world_size)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, RankMesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    # a process group cannot be copied: a cloned metric shares its mesh
    def __deepcopy__(self, memo: Dict) -> "RankMesh":
        return self

    def __repr__(self) -> str:
        return f"RankMesh(rank={self.rank}, world_size={self.world_size})"


def rank_mesh(mesh: Any = None, axis_name: Optional[str] = None) -> RankMesh:
    """The :class:`RankMesh` of a ``mesh`` argument: a ``RankMesh`` as it
    is, a ``DeviceMesh``'s group of ``axis_name``, or a process group (None:
    the default group)."""
    if isinstance(mesh, RankMesh):
        return mesh
    try:
        from torch.distributed.device_mesh import DeviceMesh
    except ImportError:  # pragma: no cover - torch without distributed
        DeviceMesh = ()
    if isinstance(mesh, DeviceMesh):
        names = tuple(mesh.mesh_dim_names or ())
        if axis_name not in names:
            raise MetricsUserError(f"the device mesh has no axis {axis_name!r} (its axes: {names})")
        return RankMesh(mesh.get_group(axis_name))
    return RankMesh(mesh)


class RankSharding:
    """The port's ``NamedSharding(mesh, spec)``: a :class:`RankMesh` and a
    :class:`PartitionSpec`. A spec that names an axis on the leading
    dimension shards it: rank ``r`` owns rows ``[r*N/W, (r+1)*N/W)``. A
    spec that names none replicates. The process group is the one axis, so
    any name stands for it; a name on another dimension is refused."""

    def __init__(self, mesh: Any, spec: Sequence[Any]) -> None:
        spec = PartitionSpec(*spec)
        axis = _leading_axis(spec)
        self.mesh = rank_mesh(mesh, axis)
        self.spec = spec
        self.axis = axis

    @property
    def group(self) -> Any:
        return self.mesh.group

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def world_size(self) -> int:
        return self.mesh.world_size

    def block(self, n: int) -> Tuple[int, int]:
        """The rows ``[lo, hi)`` of a leading dimension of ``n`` this rank owns."""
        rows = n // self.world_size
        return self.rank * rows, (self.rank + 1) * rows

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, RankSharding) and (self.mesh, self.spec) == (other.mesh, other.spec)

    def __hash__(self) -> int:
        return hash((self.mesh, self.spec))

    def __deepcopy__(self, memo: Dict) -> "RankSharding":
        return self

    def __repr__(self) -> str:
        return f"RankSharding({self.mesh!r}, {self.spec!r})"


def _leading_axis(spec: Sequence[Any]) -> Optional[str]:
    """The axis name a spec puts on the leading dimension, or None; a name
    on any other dimension raises (ownership is by leading rows)."""
    named = [i for i, entry in enumerate(spec) if isinstance(entry, str) or (isinstance(entry, (tuple, list)) and entry)]
    if any(i != 0 for i in named):
        raise MetricsUserError(f"{spec!r} names a mesh axis past the leading dimension; the port shards leading rows only")
    if not named:
        return None
    entry = spec[0]
    return entry if isinstance(entry, str) else entry[0]


def _even_gather(dist_sync_fn: Optional[Callable]) -> Callable:
    """The fixed-shape gather: ``dist_sync_fn`` where one was given (a
    simulated world), else one ``all_gather`` of the group."""
    if dist_sync_fn is None or dist_sync_fn is gather_all_arrays:
        return lambda x, group=None: _all_gather_even(x, group)
    return dist_sync_fn


def gather_parts(parts: List[Tensor], group: Optional[Any] = None, dist_sync_fn: Optional[Callable] = None) -> List[Tensor]:
    """Every rank's ``parts`` in one round: their bytes back to back, one
    ``all_gather``, then a ``[world, *part.shape]`` stack per part, in rank
    order. No header and no host read: every rank must pass parts of the
    same shapes and dtypes, in the same order."""
    return _split_group(_gather_group(parts, None, _even_gather(dist_sync_fn), group), parts)[0]


#: layout-manifest plausibility counters of the sharded claims a sync
#: passes through (populated only under METRICS_TPU_TORCH_VERIFY_MANIFEST)
_LAYOUT_VERIFY_COUNTERS = {"claims_checked": 0, "implausible_claims": 0}


def layout_verify_counters() -> Dict[str, int]:
    """The sync path's layout-manifest cross-check counters:
    ``claims_checked`` (sharded-claimed leaves inspected under
    ``METRICS_TPU_TORCH_VERIFY_MANIFEST``) and ``implausible_claims``
    (claims the port's layout manifest says belong to replicated-only
    leaves: the skipped-reduction fault; the claim is honoured, with a
    warning)."""
    return dict(_LAYOUT_VERIFY_COUNTERS)


def reset_layout_verify_counters() -> None:
    for key in _LAYOUT_VERIFY_COUNTERS:
        _LAYOUT_VERIFY_COUNTERS[key] = 0


def _verify_sharded_claims(sharded: List[Tuple]) -> None:
    """Under ``METRICS_TPU_TORCH_VERIFY_MANIFEST``, check every leaf a sync
    passes through as sharded against the layout manifest's shard-axis
    index, and warn on a claim it refutes. Host-side string work; the spec
    stays authoritative."""
    from metrics_tpu_torch.analysis.layout import leaf_may_shard
    from metrics_tpu_torch.analysis.manifest import ENV_VERIFY_MANIFEST
    from metrics_tpu_torch.utils.prints import rank_zero_warn

    if os.environ.get(ENV_VERIFY_MANIFEST, "").strip().lower() in ("", "0", "false", "no", "off"):
        return
    for path in sharded:
        _LAYOUT_VERIFY_COUNTERS["claims_checked"] += 1
        if leaf_may_shard("/".join(path)) is False:
            _LAYOUT_VERIFY_COUNTERS["implausible_claims"] += 1
            rank_zero_warn(
                f"partition spec claims state leaf {'/'.join(path)!r} sharded, but the "
                "layout manifest knows it only as replicated -- the sync is passing it "
                "through WITHOUT its cross-rank reduction. Audit the spec (or regenerate "
                "the manifest with `python -m metrics_tpu_torch.analysis --manifest`).",
                UserWarning,
            )


def _spec_shards_axis(spec: Any, axis_name: Optional[str]) -> bool:
    """True when a spec places ``axis_name`` on some dimension (with
    ``axis_name`` None: any axis, the process group being the only one):
    the leaf's rows are owned disjointly across the group and a reduction
    would mix unrelated blocks."""
    if spec is None:
        return False
    for entry in tuple(spec):
        if axis_name is None and (isinstance(entry, str) or (isinstance(entry, (tuple, list)) and entry)):
            return True
        if entry == axis_name:
            return True
        if isinstance(entry, (tuple, list)) and axis_name in entry:
            return True
    return False


def sync_pytree(
    state: Dict[str, Any],
    reductions: Dict[str, Any],
    group: Optional[Any] = None,
    dist_sync_fn: Optional[Callable] = None,
    partition_specs: Optional[Dict[str, Any]] = None,
    axis_name: Optional[str] = None,
) -> Dict[str, Any]:
    """Sync a whole (possibly nested) state across the process group in
    one collective round per group of leaves.

    ``state``/``reductions`` are matching flat or nested string-keyed dicts
    (``MetricCollection.state_reductions()`` gives the nested form).
    Tensor leaves reduced by ``"sum"``/``"mean"``/``"max"``/``"min"`` are
    grouped by (reduction, dtype), their bytes laid back to back and
    gathered in one ``all_gather``, then folded in rank order on the device.
    ``merge_like`` (sketch) leaves are grouped by dtype, gathered once with
    their occupancy bounds, and folded by their own reducer in rank order.
    ``"cat"``, None and other callable leaves take a gather each, as the
    JAX package's per-state path does (a tensor leaf has one shape on every
    rank, so it needs no header); a list leaf takes :func:`gather_all_arrays`
    (its ranks may hold any number of rows) and becomes a one-element list
    of every rank's rows.

    ``dist_sync_fn(x, group=...)`` replaces the gather (a simulated world
    returns every rank's ``x``); by default the process group's.

    ``partition_specs``: a tree of specs nested like ``reductions``. A leaf
    whose spec names ``axis_name`` (None: any axis) is owned disjointly by
    the ranks (a block of a sharded leaf, see ``sliced/sharding.py``) and
    passes through as it is: no round, no bytes. The other leaves reduce
    as above. The sync event counts the passed leaves
    (``sliced_passthrough``).
    """
    sharded = []
    if partition_specs is not None:
        sharded = [
            path
            for path, _ in _iter_state_leaves(state)
            if _spec_shards_axis(_path_get(partition_specs, path), axis_name)
        ]
        if sharded:
            _verify_sharded_claims(sharded)
    if not _TELEMETRY.enabled:
        return _sync_pytree(state, reductions, group, dist_sync_fn, sharded=sharded)
    moved = [0]

    def counted(fn: Callable) -> Callable:
        def gather_counted(x: Tensor, group: Optional[Any] = None) -> List[Tensor]:
            out = fn(x, group=group)
            moved[0] += sum(t.numel() * t.element_size() for t in out)
            return out

        return gather_counted

    world = world_size(group)
    _PYTREE_SYNC.active = True
    try:
        with _span("sync_pytree", world_size=world):
            out = _sync_pytree(state, reductions, group, dist_sync_fn, wrap=counted, sharded=sharded)
            n_leaves = sum(1 for _ in _iter_state_leaves(state))
            _TELEMETRY.record_sync(
                "sync_pytree",
                gather_bytes=moved[0],
                world_size=world,
                n_leaves=n_leaves,
                sliced_passthrough=len(sharded),
            )
    finally:
        _PYTREE_SYNC.active = False
    return out


def _sync_pytree(
    state: Dict[str, Any],
    reductions: Dict[str, Any],
    group: Optional[Any],
    dist_sync_fn: Optional[Callable],
    wrap: Callable = lambda fn: fn,
    sharded: Sequence[Tuple] = (),
) -> Dict[str, Any]:
    even = wrap(dist_sync_fn or (lambda x, group=None: _all_gather_even(x, group)))
    gather = wrap(dist_sync_fn or gather_all_arrays)
    groups: Dict[Tuple, List[Tuple]] = {}
    merge_groups: Dict[torch.dtype, List[Tuple]] = {}
    fallback: List[Tuple] = []
    out: Dict[str, Any] = {}
    passed = set(sharded)
    for path, value in _iter_state_leaves(state):
        red = _path_get(reductions, path)
        if path in passed:
            # a block of a sharded leaf: each rank owns its rows
            _path_set(out, path, value)
        elif isinstance(value, Tensor) and red in _ELEMENTWISE:
            groups.setdefault((red, value.dtype), []).append(path)
        elif isinstance(value, Tensor) and getattr(red, "merge_like", False):
            merge_groups.setdefault(value.dtype, []).append(path)
        else:
            fallback.append(path)

    device = next((v.device for _, v in _iter_state_leaves(state) if isinstance(v, Tensor)), torch.device("cpu"))
    for (red, _), paths in groups.items():
        parts = [_path_get(state, p) for p in paths]
        stacks, _ = _split_group(_gather_group(parts, None, even, group), parts)
        for path, stack in zip(paths, stacks):
            _path_set(out, path, _fold(red, stack))
    for _, paths in merge_groups.items():
        parts = [_path_get(state, p) for p in paths]
        bounds = torch.tensor(
            [fill_bound(p) if hasattr(p, _FILL_BOUND) else -1 for p in parts], dtype=torch.int64, device=parts[0].device
        )
        gathered = _gather_group(parts, bounds, even, group)
        stacks, offset = _split_group(gathered, parts)
        rank_bounds = gathered[:, offset:].contiguous().view(torch.int64).tolist()
        _COUNTS["host_reads"] += 1
        for i, (path, stack) in enumerate(zip(paths, stacks)):
            with_rank_fill_bounds(stack, [b[i] if b[i] >= 0 else None for b in rank_bounds])
            _path_set(out, path, _path_get(reductions, path)(stack))
    for path in fallback:
        value, red = _path_get(state, path), _path_get(reductions, path)
        if isinstance(value, list):
            local = dim_zero_cat(value) if value else torch.zeros((0,), device=device)
            rows = [g for g in gather(local, group=group) if g.numel() or g.ndim == 0]
            _path_set(out, path, [torch.cat(rows)] if rows else [])
            continue
        if isinstance(value, int):
            value = torch.tensor(value, dtype=torch.int32, device=device)
        # a tensor leaf has the same shape on every rank: one gather, no header
        (stack,), _ = _split_group(_gather_group([value], None, even, group), [value])
        if red == "cat":
            _path_set(out, path, stack.reshape((-1,) + tuple(value.shape[1:])) if value.ndim else stack)
        elif red is None:
            _path_set(out, path, stack)
        elif callable(red):
            _path_set(out, path, red(stack))
        else:
            raise ValueError(f"Unknown reduction {red!r} for state {'/'.join(path)!r}")
    return out


# ---------------------------------------------------------------------------
# scalar reduction helpers
# ---------------------------------------------------------------------------


def reduce(x: Tensor, reduction: str) -> Tensor:
    """Reduce a tensor: ``"elementwise_mean"`` | ``"sum"`` | ``"none"`` (or ``None``)."""
    if reduction == "elementwise_mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction in ("none", None):
        return x
    raise ValueError("Reduction parameter unknown.")


def class_reduce(num: Tensor, denom: Tensor, weights: Tensor, class_reduction: str = "none") -> Tensor:
    """Per-class fraction reduction: ``"micro"`` | ``"macro"`` | ``"weighted"`` | ``"none"``."""
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    fraction = torch.sum(num) / torch.sum(denom) if class_reduction == "micro" else num / denom
    if class_reduction != "micro":
        fraction = torch.where(torch.isnan(fraction), torch.zeros_like(fraction), fraction)

    if class_reduction == "micro":
        return fraction
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        return torch.sum(fraction * (weights / torch.sum(weights)))
    if class_reduction in ("none", None):
        return fraction
    raise ValueError(f"Reduction parameter {class_reduction} unknown. Choose between one of these: {valid_reduction}")
