"""Quantile-sketch compaction: the sort/bucket kernel, its plain version,
and the device-routed compaction chain.

Counterpart of ``metrics_tpu/ops/qsketch_pallas.py``
(``qsketch_sort_bucket_tiled`` and ``qsketch_compact_dispatch``). The
compaction of ``[n, cols]`` sketch rows (column 0 the weight, column 1 the
key, the rest payload) is three steps, as in the JAX package:

1. :func:`qsketch_sort_bucket` (``csrc/qsketch.cu``, see its header): the
   rows sorted by key, zero-weight rows keyed ``+inf``, ties by row index;
   the prefix sum of the sorted weights; each row's bucket on the
   tail-adaptive scale ``k1(q) = capacity / 2pi * asin(2q - 1)``; and the
   weighted rows ``[w, w * key, w * payload]``;
2. K1's float form (:func:`~metrics_tpu_torch.ops.segment_sum.segment_sum_f32`)
   sums the weighted rows by bucket into ``capacity // 2 + 4`` centroids;
3. :func:`finalize_compact`: weighted means, embedded in a rows-shaped
   buffer and packed occupied-first.

On the card the sort runs across the card: blocks sort tiles of 1024
packed keys in shared memory, then 4-way merge passes place every key by
its rank in the other runs, and the prefix sum and bucket map run over
scan tiles of sorted rows (:func:`qsketch_plan` gives the launch, cached
per shape). Every shape takes the kernel: there is no row or column limit
and no route to the plain version for a CUDA tensor. The plain version,
:func:`qsketch_sort_bucket_reference`, repeats the kernel's arithmetic in
the same order with ``torch.sort`` on the same composite key; CPU tensors
take it. ``asin`` is evaluated in float64 and rounded to float32 on both:
a float32 ``asin`` differs between math libraries by an ulp, which moves a
row across a bucket edge, and this way the card and the CPU give the same
buckets. With integer weights (a sketch's weights are counts, exact in
float32 below 2**24) the kernel and the plain version agree bit for bit.
"""
import ctypes
import functools
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from metrics_tpu_torch.ops.build import load
from metrics_tpu_torch.ops.dispatch import check_cuda, launch, route
from metrics_tpu_torch.ops.segment_sum import segment_sum_f32, segment_sum_reference

Tensor = torch.Tensor

SOURCE = "qsketch.cu"

#: the kernel's plan constants (must match ``csrc/bitonic.cuh`` and
#: ``csrc/qsketch.cu``): keys a block sorts in shared memory, runs a merge
#: pass merges, rows and tiles of the scan, rows weighted by the scan
TILE = 1024
MAX_WAY = 4
SCAN_ROWS = 256
MAX_SCAN_TILES = 1024
NARROW_COLS = 16

#: the CUDA kernels one call may launch (a profiler sums them per call)
CUDA_KERNELS = ("sort_tiles_kernel", "merge_pass_kernel", "tile_sums_kernel", "scan_bucket_kernel", "gather_rows_kernel")

_PTR, _LL, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: rows, n, cols, n_pad, capacity, scale, tile, way, scan tile, scratch,
#: perm, wvals, bucket, stream
_SIGNATURES = {
    "qsketch_sort_bucket_f32": [_PTR, _LL, _I32, _LL, _I32, ctypes.c_float, _I32, _I32, _LL, _PTR, _PTR, _PTR, _PTR, _PTR],
}

#: the ordered (uint32) forms of +inf and of every NaN key
_ORD_PLUS_INF = 0xFF800000
_ORD_NAN = 0xFFFFFFFF


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    return load(SOURCE, _SIGNATURES)


@functools.lru_cache(maxsize=None)
def _launcher() -> Tuple[ctypes.CDLL, Any]:
    """The library and its C launcher, bound at first use."""
    lib = load_library()
    return lib, lib.qsketch_sort_bucket_f32


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def merge_passes(length: int, tile: int) -> Tuple[Tuple[int, int], ...]:
    """``(run, way)`` of each merge-by-rank pass that turns sorted tiles of
    ``tile`` keys into one sorted run of ``length`` keys (both powers of
    two): every ``way`` consecutive runs of ``run`` keys become one, at most
    ``MAX_WAY`` a pass (``bitonic::merge_runs``)."""
    passes = []
    run = tile
    while run < length:
        way = min(MAX_WAY, length // run)
        passes.append((run, way))
        run *= way
    return tuple(passes)


class SortBucketPlan(NamedTuple):
    """A launch of :func:`qsketch_sort_bucket`: ``n_pad`` rows sorted in
    tiles of ``tile`` keys (one block each), merged by ``merges``; the scan
    in ``scan_tiles`` blocks of ``scan_tile`` sorted rows; ``scratch_words``
    int64 of scratch (two key buffers, then the float32 tile sums);
    ``gather`` when the rows are too wide for the scan to weight them."""

    n_pad: int
    tile: int
    merges: Tuple[Tuple[int, int], ...]
    scan_tile: int
    scan_tiles: int
    scratch_words: int
    gather: bool


@functools.lru_cache(maxsize=1024)
def qsketch_plan(n: int, cols: int) -> SortBucketPlan:
    """The plan of ``[n, cols]`` rows (what ``csrc/qsketch.cu`` checks)."""
    n_pad = next_pow2(max(n, 2))
    tile = min(n_pad, TILE)
    scan_tile = n_pad if n_pad < SCAN_ROWS else max(SCAN_ROWS, n_pad // MAX_SCAN_TILES)
    scan_tiles = n_pad // scan_tile
    return SortBucketPlan(
        n_pad, tile, merge_passes(n_pad, tile), scan_tile, scan_tiles, 2 * n_pad + -(-scan_tiles // 2), cols > NARROW_COLS
    )


def num_segments(capacity: int) -> int:
    """Centroids a compaction can produce: ``capacity // 2 + 4``."""
    return capacity // 2 + 4


def _check_args(rows: Tensor, capacity: int) -> None:
    if not (isinstance(capacity, int) and capacity > 0):
        raise ValueError(f"sketch `capacity` must be a positive int, got {capacity}")
    if rows.ndim != 2 or rows.shape[1] < 2:
        raise ValueError(f"sketch rows must be [n, 2 + payload_cols], got shape {tuple(rows.shape)}")


def _scale(capacity: int) -> float:
    # a Python float: torch and ctypes both round it to float32
    return capacity / (2.0 * math.pi)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def qsketch_sort_bucket(rows: Tensor, capacity: int) -> Tuple[Tensor, Tensor, Tensor]:
    """The sort -> prefix sum -> bucket stage on the card: float32
    ``[n, cols]`` rows in; ``(weighted rows [n_pad, cols], bucket ids
    [n_pad] int32, sorted row indices [n_pad] int32)`` out, with ``n_pad``
    the next power of two (at least 2) and pad rows of weight 0."""
    check_cuda("qsketch_sort_bucket", rows)
    if rows.dtype != torch.float32:
        raise TypeError(f"qsketch_sort_bucket takes float32 rows, got {rows.dtype}")
    _check_args(rows, capacity)
    if not rows.is_contiguous():
        rows = rows.contiguous()
    n, cols = rows.shape
    plan = qsketch_plan(n, cols)
    if plan.n_pad > 2**31:
        raise ValueError(f"qsketch_sort_bucket sorts at most 2**31 rows, got {n}")
    device = rows.device
    scratch = torch.empty(plan.scratch_words, dtype=torch.int64, device=device)
    perm = torch.empty(plan.n_pad, dtype=torch.int32, device=device)
    wvals = torch.empty((plan.n_pad, cols), dtype=torch.float32, device=device)
    bucket = torch.empty(plan.n_pad, dtype=torch.int32, device=device)
    lib, fn = _launcher()
    launch(
        "qsketch_sort_bucket",
        lib,
        device,
        fn,
        rows.data_ptr(), n, cols, plan.n_pad, capacity, _scale(capacity), plan.tile, MAX_WAY, plan.scan_tile,
        scratch.data_ptr(), perm.data_ptr(), wvals.data_ptr(), bucket.data_ptr(),
    )
    return wvals, bucket, perm


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _sort_key(key: Tensor, occupied: Tensor) -> Tensor:
    """The kernel's unique int64 sort key: the key's order-preserving
    uint32 (unoccupied rows ``+inf``, ``-0.0`` as ``+0.0``, every NaN last)
    above the row index. Its order is ``jnp.lexsort((arange, key))``'s."""
    key = key.to(torch.float32)
    key = torch.where(key == 0, torch.zeros_like(key), key)
    bits = key.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ordered = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF, bits | 0x80000000)
    ordered = torch.where(torch.isnan(key), _ORD_NAN, ordered)
    ordered = torch.where(occupied, ordered, _ORD_PLUS_INF)
    index = torch.arange(key.shape[0], dtype=torch.int64, device=key.device)
    return (ordered << 31) | index


def qsketch_sort_bucket_reference(rows: Tensor, capacity: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of :func:`qsketch_sort_bucket`, in the rows' dtype, on
    any device: the same outputs from ``torch.sort``, ``torch.cumsum`` and
    the elementwise map, in the kernel's order of operations."""
    _check_args(rows, capacity)
    n, cols = rows.shape
    n_pad = next_pow2(max(n, 2))
    data = rows.new_zeros((n_pad, cols))
    data[:n] = rows
    order = torch.sort(_sort_key(data[:, 1], data[:, 0] > 0), stable=True).indices
    srt = data[order]
    sw = srt[:, 0]
    total = torch.clamp(sw.sum(), min=1e-30)
    cum = torch.cumsum(sw, dim=0)
    q = torch.clamp((cum - sw / 2.0) / total, 0.0, 1.0)
    k = _scale(capacity) * torch.asin((2.0 * q - 1.0).double()).to(sw.dtype)
    bucket = torch.clamp(torch.floor(k).to(torch.int32) + capacity // 4 + 1, 0, num_segments(capacity) - 1)
    wvals = torch.cat([sw[:, None], sw[:, None] * srt[:, 1:]], dim=1)
    return wvals, bucket, order.to(torch.int32)


# ---------------------------------------------------------------------------
# the compaction chain
# ---------------------------------------------------------------------------


def pack_rows(rows: Tensor, keep: Optional[int] = None) -> Tensor:
    """Occupied rows (weight > 0) first, both groups in their own order (a
    stable partition, from prefix sums rather than a sort); the first
    ``keep`` rows of the result when ``keep`` is given."""
    n = rows.shape[0]
    if n == 0:
        return rows.clone()
    occupied = rows[:, 0] > 0
    occ_rank = torch.cumsum(occupied, dim=0)
    index = torch.arange(n, device=rows.device)
    dest = torch.where(occupied, occ_rank - 1, occ_rank[-1] + index - occ_rank)
    order = torch.empty_like(dest).scatter_(0, dest, index)
    return rows.index_select(0, order if keep is None else order[:keep])


def finalize_compact(seg_w: Tensor, seg_vals: Tensor, rows: Tensor) -> Tensor:
    """Compaction epilogue: divide the bucket sums of the WEIGHTED values
    back to centroids, embed them at their (key-ordered) bucket positions in
    a ``rows``-shaped buffer, and pack occupied rows first."""
    n_seg = seg_w.shape[0]
    seg_vals = seg_vals / torch.clamp(seg_w[:, None], min=1e-30)
    merged = torch.cat([seg_w[:, None], seg_vals], dim=1)
    out = torch.zeros_like(rows)
    out[:n_seg] = merged.to(rows.dtype)
    return pack_rows(out)


def compact_rows_reference(rows: Tensor, capacity: int) -> Tensor:
    """The whole compaction in plain PyTorch, on any device."""
    wvals, bucket, _ = qsketch_sort_bucket_reference(rows, capacity)
    seg = segment_sum_reference(wvals, bucket, num_segments(capacity))
    return finalize_compact(seg[:, 0], seg[:, 1:], rows)


def qsketch_compact_dispatch(rows: Tensor, capacity: int) -> Tensor:
    """One merging-t-digest compaction pass of ``[n, cols]`` sketch rows
    (the overflow step of ``qsketch_insert``/``qsketch_merge``), rows-shaped
    out, in the rows' dtype. float32 rows on the card take the kernels
    (:func:`qsketch_sort_bucket`, then ``segment_sum_f32``); on the CPU,
    :func:`compact_rows_reference`. Half-precision rows (the leaves
    ``Metric.set_dtype`` makes) are widened to float32, compacted so, and
    rounded back once: the card and the CPU give the same bits. The JAX
    package compacts them in their own dtype instead, whose running weight
    sum stops growing in bfloat16 (ROADMAP.md, C, "Properties")."""
    dtype = rows.dtype
    if dtype in (torch.float16, torch.bfloat16):
        rows = rows.to(torch.float32)
    if not route("qsketch_compact", rows):
        out = compact_rows_reference(rows, capacity)
    elif rows.dtype != torch.float32:
        raise TypeError(f"the sketch kernels compact float32 or half-precision rows on the card, got {rows.dtype}")
    else:
        wvals, bucket, _ = qsketch_sort_bucket(rows, capacity)
        seg = segment_sum_f32(wvals, bucket, num_segments(capacity))
        out = finalize_compact(seg[:, 0], seg[:, 1:], rows)
    return out.to(dtype)
