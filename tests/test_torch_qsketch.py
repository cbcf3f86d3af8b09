"""The port's quantile sketch and its compaction against the JAX package's.

The JAX side runs as its own tests run it on the CPU: the sort/bucket stage
``qsketch_sort_bucket_tiled`` and the fused compaction
``_qsketch_compact_pallas`` in interpret mode (the real Pallas kernel
bodies), and ``_compact_rows_jnp``, the jnp reference. The port's side is
the plain version its entry points take for CPU tensors; the CUDA kernel
is held against the same plain version on the card by ``chip_smoke.py``.

Tolerances, as in ``tests/ops/test_qsketch_pallas.py``:

* integer-valued weights and keys: every prefix sum and centroid moment is
  exact in float32, so sorted order, bucket ids and merged rows are
  bit-identical, and so are insert and merge streams through several
  compactions;
* float keys: the compacted rows within atol = rtol = 1e-5 with the same
  centroid count, and float-stream quantiles within ``rank_error_bound``.

The bucket map takes ``asin`` of ``2q - 1``. XLA's float32 ``arcsin`` on
the CPU and a correctly rounded one differ by an ulp on about a third of
all inputs, so the port evaluates it in float64 and rounds (as its CUDA
kernel does, which makes the card and the CPU agree). A bucket moves only
where ``capacity / 2pi * asin`` lands within an ulp of an integer: on the
seeded data below that never happens, and the float-stream checks hold the
JAX package's float32 ``arcsin`` and the port's float64 one to identical
sketches (``test_float_stream_matches_jax_bitwise``).
"""
import ctypes
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metrics_tpu.ops.qsketch_pallas import _qsketch_compact_pallas, qsketch_sort_bucket_tiled
from metrics_tpu.sketches import quantile as jq
from metrics_tpu_torch import ops
from metrics_tpu_torch.sketches import quantile as tq

# the module (the package's `qsketch_sort_bucket` attribute is the wrapper)
qsketch_module = importlib.import_module("metrics_tpu_torch.ops.qsketch")

torch.set_num_threads(2)

# the cases of tests/ops/test_qsketch_pallas.py: (capacity, rows, occupied, columns)
CASES = [(16, 33, 33, 2), (64, 128, 128, 3), (64, 777, 500, 4), (256, 512, 512, 2)]


def _int_rows(rng, n, n_occ, cols, weighted=False):
    rows = np.zeros((n, cols), np.float32)
    rows[:n_occ, 0] = rng.integers(1, 5, n_occ) if weighted else 1.0
    rows[:n_occ, 1] = rng.integers(-500, 500, n_occ)
    if cols > 2:
        rows[:n_occ, 2:] = rng.integers(0, 3, (n_occ, cols - 2))
    return rows


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("cap,n,n_occ,cols", CASES)
def test_sort_bucket_matches_the_pallas_kernel_bitwise(cap, n, n_occ, cols):
    rows = _int_rows(np.random.default_rng(cap + n + cols), n, n_occ, cols, weighted=True)
    want_w, want_b = qsketch_sort_bucket_tiled(jnp.asarray(rows), cap, interpret=True)
    got_w, got_b, perm = ops.qsketch_sort_bucket_reference(_t(rows), cap)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    assert got_b.dtype == perm.dtype == torch.int32
    key = np.where(rows[:, 0] > 0, rows[:, 1], np.inf)
    np.testing.assert_array_equal(perm.numpy()[:n], np.lexsort((np.arange(n), key)))


@pytest.mark.parametrize("cap,n,n_occ,cols", CASES)
def test_compaction_matches_pallas_and_jnp_bitwise(cap, n, n_occ, cols):
    rows = _int_rows(np.random.default_rng(cap + n + cols), n, n_occ, cols, weighted=True)
    want = np.asarray(_qsketch_compact_pallas(jnp.asarray(rows), cap, interpret=True))
    np.testing.assert_array_equal(want, np.asarray(jq._compact_rows_jnp(jnp.asarray(rows), cap)))
    np.testing.assert_array_equal(ops.compact_rows_reference(_t(rows), cap).numpy(), want)
    np.testing.assert_array_equal(ops.qsketch_compact_dispatch(_t(rows), cap).numpy(), want)


def test_compaction_float_keys_within_tolerance():
    rng = np.random.default_rng(0)
    cap, n = 128, 256
    rows = np.zeros((n, 3), np.float32)
    rows[:, 0] = 1.0
    rows[:, 1] = rng.standard_normal(n)
    rows[:, 2] = rng.integers(0, 2, n)
    want = np.asarray(jq._compact_rows_jnp(jnp.asarray(rows), cap))
    got = ops.compact_rows_reference(_t(rows), cap).numpy()
    assert (got[:, 0] > 0).sum() == (want[:, 0] > 0).sum()
    np.testing.assert_allclose(got[:, 0].sum(), want[:, 0].sum(), rtol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_signed_zeros_and_nan_keys_sort_as_jnp_lexsort():
    """-0.0 ties +0.0 (index order decides), every NaN key sorts after +inf
    and after the zero-weight rows (which are keyed +inf), as
    ``jnp.lexsort`` orders them; the compaction then matches the jnp path."""
    key = np.array(
        [1.0, -0.0, 0.0, np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 2.0, np.nan, -1.0, 3.0, -0.0, 5.0, 0.5],
        np.float32,
    )
    n = key.shape[0]  # a power of two: no pad rows
    rows = np.zeros((n, 3), np.float32)
    rows[:, 0] = [1, 2, 1, 1, 3, 1, 1, 0, 1, 2, 1, 0, 1, 1, 4, 1]
    rows[:, 1] = key
    rows[:, 2] = np.arange(n) % 3
    occ_key = jnp.where(jnp.asarray(rows[:, 0]) > 0, jnp.asarray(key), jnp.inf)
    want_order = np.asarray(jnp.lexsort((jnp.arange(n), occ_key)))
    _, _, perm = ops.qsketch_sort_bucket_reference(_t(rows), 8)
    np.testing.assert_array_equal(perm.numpy(), want_order)
    want = np.asarray(jq._compact_rows_jnp(jnp.asarray(rows), 8))
    np.testing.assert_array_equal(ops.compact_rows_reference(_t(rows), 8).numpy(), want)


def test_sort_bucket_pads_to_a_power_of_two_with_weightless_rows():
    rows = _int_rows(np.random.default_rng(2), 96, 80, 2)
    wvals, bucket, perm = ops.qsketch_sort_bucket_reference(_t(rows), 64)
    assert wvals.shape == (128, 2) and bucket.shape == perm.shape == (128,)
    assert torch.all(wvals[80:, 0] == 0)  # zero-weight and pad rows come last
    assert torch.all(perm[96:] >= 96)  # pad rows keep their indices past n
    assert torch.all(torch.diff(bucket[:80]) >= 0)  # k1 buckets non-decreasing in key order


def test_kernel_wrapper_refuses_cpu_tensors_and_card_sketches_must_be_float32():
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA kernel"):
        ops.qsketch_sort_bucket(torch.ones(4, 3), 8)
    rows64 = torch.from_numpy(_int_rows(np.random.default_rng(3), 40, 40, 3)).double()
    out = ops.qsketch_compact_dispatch(rows64, 16)  # the CPU keeps the rows' dtype
    assert out.dtype == torch.float64 and out.shape == rows64.shape
    assert all(n == 0 for n in ops.launch_counts().values())
    with pytest.raises(ValueError, match="capacity"):
        ops.qsketch_compact_dispatch(torch.ones(4, 3), 0)


def _stream_pair(cap, batches, payload_cols=0):
    j, t = jq.qsketch_init(cap, payload_cols), tq.qsketch_init(cap, payload_cols, device="cpu")
    for keys, payload in batches:
        j = jq.qsketch_insert(j, jnp.asarray(keys), None if payload is None else jnp.asarray(payload))
        t = tq.qsketch_insert(t, _t(keys), None if payload is None else _t(payload))
    return j, t


def test_insert_stream_through_several_compactions_is_bitwise_jax():
    rng = np.random.default_rng(4)
    batches = [(rng.integers(0, 1000, 40).astype(np.float32), None) for _ in range(8)]
    j, t = _stream_pair(64, batches)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert float(tq.qsketch_total_weight(t)) == 8 * 40


def test_insert_with_payload_weights_and_n_valid_is_bitwise_jax():
    rng = np.random.default_rng(9)
    j, t = jq.qsketch_init(32, 2), tq.qsketch_init(32, 2, device="cpu")
    for i in range(6):
        keys = rng.integers(-50, 50, 24).astype(np.float32)
        payload = rng.integers(0, 2, (24, 2)).astype(np.float32)
        weights = rng.integers(1, 4, 24).astype(np.float32)
        j = jq.qsketch_insert(j, jnp.asarray(keys), jnp.asarray(payload), jnp.asarray(weights), n_valid=20 - i)
        t = tq.qsketch_insert(t, _t(keys), _t(payload), _t(weights), n_valid=20 - i)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_oversized_batch_is_chunked_like_jax():
    keys = np.random.default_rng(5).integers(0, 500, 300).astype(np.float32)
    j, t = _stream_pair(64, [(keys, None)])
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_merges_are_bitwise_jax():
    rng = np.random.default_rng(5)
    a_keys, b_keys, c_keys = (rng.integers(0, 99, 32).astype(np.float32) for _ in range(3))
    ja, ta = _stream_pair(32, [(a_keys, None)])
    jb, tb = _stream_pair(32, [(b_keys, None)])
    jc, tc = _stream_pair(32, [(c_keys[:10], None)])
    np.testing.assert_array_equal(tq.qsketch_merge(ta, tb).numpy(), np.asarray(jq.qsketch_merge(ja, jb)))
    # a merge that fits: no compaction on either side
    np.testing.assert_array_equal(tq.qsketch_merge(tc, tc).numpy(), np.asarray(jq.qsketch_merge(jc, jc)))
    np.testing.assert_array_equal(
        tq.qsketch_merge_into(ta, tb, tc).numpy(), np.asarray(jq.qsketch_merge_into(ja, jb, jc))
    )
    stacked = np.stack([np.asarray(ja), np.asarray(jb), np.asarray(jc)])
    np.testing.assert_array_equal(
        tq.sketch_merge_fx()(_t(stacked)).numpy(), np.asarray(jq.sketch_merge_fx()(jnp.asarray(stacked)))
    )
    host_rows = np.asarray(jb)[:20]
    np.testing.assert_array_equal(
        tq.qsketch_absorb_rows(ta, host_rows).numpy(), np.asarray(jq.qsketch_absorb_rows(ja, host_rows))
    )


def test_fill_bound_skips_only_absorbs_that_cannot_overflow():
    """The host bound decides whether an absorb may compact; a sketch
    without one (carried over from elsewhere) takes the device-side select,
    which gives the same rows as the JAX package's ``lax.cond``."""
    keys = np.arange(20, dtype=np.float32)
    t = tq.qsketch_init(32, device="cpu")
    assert tq.fill_bound(t) == 0
    t = tq.qsketch_insert(t, _t(keys))
    assert tq.fill_bound(t) == 20
    t2 = tq.qsketch_insert(t, _t(keys[:12]))
    assert tq.fill_bound(t2) == 32 and int(tq.qsketch_fill(t2)) == 32
    t3 = tq.qsketch_insert(t2, _t(keys[:1]))  # overflows: compacts
    assert tq.fill_bound(t3) == 32 and int(tq.qsketch_fill(t3)) < 32
    j = jq.qsketch_insert(jq.qsketch_insert(jq.qsketch_insert(jq.qsketch_init(32), keys), keys[:12]), keys[:1])
    np.testing.assert_array_equal(t3.numpy(), np.asarray(j))
    carried = torch.from_numpy(np.asarray(jq.qsketch_insert(jq.qsketch_init(32), keys[:5])).copy())
    assert tq.fill_bound(carried) == 32  # nothing known: may overflow
    got = tq.qsketch_insert(carried, _t(keys[:3]))  # selects the packed rows
    want = jq.qsketch_insert(jq.qsketch_insert(jq.qsketch_init(32), keys[:5]), keys[:3])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_in_place_writes_and_inference_tensors_void_the_fill_bound():
    """A bound is kept with the tensor's write counter: a caller's in-place
    write (or an inference tensor, which has no counter) makes the absorb
    take the device-side select, so no row is dropped."""
    keys = np.arange(20, dtype=np.float32)
    t = tq.qsketch_insert(tq.qsketch_init(32, device="cpu"), _t(keys))
    assert tq.fill_bound(t) == 20
    t[20:30, 0] = 1.0  # ten more occupied rows, written in place
    assert tq.fill_bound(t) == 32
    got = tq.qsketch_insert(t, _t(keys))
    want = jq.qsketch_insert(jnp.asarray(t.numpy()), keys)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(tq.qsketch_total_weight(got)) == 50
    with torch.inference_mode():
        u = tq.qsketch_insert(tq.qsketch_init(32, device="cpu"), _t(keys))
        assert tq.fill_bound(u) == 32
        u = tq.qsketch_insert(u, _t(keys))
    want = jq.qsketch_insert(jq.qsketch_insert(jq.qsketch_init(32), keys), keys)
    np.testing.assert_array_equal(u.numpy(), np.asarray(want))


def test_float_stream_matches_jax_bitwise():
    """Float keys through many compactions: on this seeded stream no bucket
    edge falls within an ulp, so the float64-rounded asin of the port and
    XLA's float32 arcsin give identical sketches."""
    x = np.random.default_rng(4).standard_normal(20000).astype(np.float32)
    j, t = _stream_pair(512, [(x[lo : lo + 500], None) for lo in range(0, 20000, 500)])
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_float_stream_quantiles_within_the_advertised_bound():
    rng = np.random.default_rng(6)
    cap, total = 64, 640
    stream = rng.standard_normal(total).astype(np.float32)
    _, t = _stream_pair(cap, [(stream[lo : lo + 40], None) for lo in range(0, total, 40)])
    qs = [0.05, 0.25, 0.5, 0.75, 0.95]
    got = tq.qsketch_quantile(t, qs).numpy()
    srt = np.sort(stream)
    bound = tq.rank_error_bound(total, cap)
    for q, v in zip(qs, got):
        assert abs(np.searchsorted(srt, v) - q * total) <= bound + 1


def test_queries_match_jax():
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 200, 150).astype(np.float32)
    j, t = _stream_pair(64, [(keys[lo : lo + 50], None) for lo in range(0, 150, 50)])
    xs = np.array([-1.0, 10.0, 99.5, 150.0, 300.0], np.float32)
    edges = np.linspace(0, 200, 9).astype(np.float32)
    assert int(tq.qsketch_fill(t)) == int(jq.qsketch_fill(j))
    assert float(tq.qsketch_total_weight(t)) == float(jq.qsketch_total_weight(j))
    np.testing.assert_array_equal(tq.qsketch_rank(t, xs).numpy(), np.asarray(jq.qsketch_rank(j, xs)))
    np.testing.assert_allclose(tq.qsketch_cdf(t, xs).numpy(), np.asarray(jq.qsketch_cdf(j, xs)), rtol=1e-6)
    qs = [0.0, 0.1, 0.5, 0.9, 1.0]
    np.testing.assert_array_equal(tq.qsketch_quantile(t, qs).numpy(), np.asarray(jq.qsketch_quantile(j, jnp.asarray(qs))))
    np.testing.assert_array_equal(
        tq.qsketch_histogram(t, edges).numpy(), np.asarray(jq.qsketch_histogram(j, jnp.asarray(edges)))
    )
    empty = tq.qsketch_init(8, device="cpu")
    assert torch.isnan(tq.qsketch_cdf(empty, [0.0])).all() and torch.isnan(tq.qsketch_quantile(empty, [0.5])).all()
    assert tq.rank_error_bound(64, 64) == jq.rank_error_bound(64, 64) == 0.0
    assert tq.rank_error_bound(6400, 64) == jq.rank_error_bound(6400, 64)


@pytest.mark.parametrize(
    "call, match",
    [
        (lambda: tq.qsketch_init(0, device="cpu"), "capacity"),
        (lambda: tq.qsketch_init(8, -1, device="cpu"), "payload_cols"),
        (lambda: tq.qsketch_insert(tq.qsketch_init(4, device="cpu"), torch.ones(2)), "at least 8"),
        (lambda: tq.qsketch_insert(tq.qsketch_init(8, 1, device="cpu"), torch.ones(2)), "payload has 0"),
        (lambda: tq.qsketch_merge(tq.qsketch_init(8, device="cpu"), tq.qsketch_init(8, 1, device="cpu")), "layouts"),
        (lambda: tq.qsketch_absorb_rows(tq.qsketch_init(8, device="cpu"), np.ones((3, 5))), "layout"),
    ],
)
def test_misuse_raises_like_jax(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_xla_float32_arcsin_is_not_correctly_rounded():
    """Why the bucket map takes asin in float64: XLA's float32 arcsin on the
    CPU differs from the correctly rounded value on a large share of inputs
    (about a third of uniform draws), so two float32 asins cannot be relied
    on to agree at a bucket edge."""
    x = np.random.default_rng(0).uniform(-1, 1, 200_000).astype(np.float32)
    xla = np.asarray(jnp.arcsin(jnp.asarray(x)))
    rounded = torch.asin(torch.from_numpy(x).double()).float().numpy()
    share = float(np.mean(xla.view(np.int32) != rounded.view(np.int32)))
    assert 0.2 < share < 0.5
    np.testing.assert_allclose(xla, rounded, rtol=2.4e-7, atol=0)  # one ulp at most


# ---------------------------------------------------------------------------
# the kernel's launch plan and its sorting arithmetic, emulated in numpy
# ---------------------------------------------------------------------------

_QSKETCH_C_TYPES = {
    "const void*": ctypes.c_void_p,
    "void*": ctypes.c_void_p,
    "long long": ctypes.c_longlong,
    "int": ctypes.c_int,
    "float": ctypes.c_float,
}


def test_ctypes_signature_matches_the_c_launcher():
    """The launcher's parameters (the stream last) match the ctypes argtypes
    its wrapper declares, the plan's constants are the kernel's, and every
    kernel the wrapper names for profilers is a kernel of its sources."""
    csrc = Path(qsketch_module.__file__).parent.parent / "csrc"
    source = (csrc / qsketch_module.SOURCE).read_text()
    header = (csrc / "bitonic.cuh").read_text()
    extern = source[source.index('extern "C" {') :]
    for name, argtypes in qsketch_module._SIGNATURES.items():
        params = re.search(rf"int {name}\(([^)]*)\)", extern).group(1)
        c_types = [re.sub(r"\s*\w+$", "", p.strip()) for p in params.split(",")]
        assert [_QSKETCH_C_TYPES[t] for t in c_types] == list(argtypes), name
        assert c_types[-1] == "void*"  # the stream
    assert '#include "bitonic.cuh"' in source
    assert f"kTile = {qsketch_module.TILE};" in header and f"kMaxWay = {qsketch_module.MAX_WAY};" in header
    assert f"kScanThreads = {qsketch_module.SCAN_ROWS};" in source
    assert f"kMaxScanTiles = {qsketch_module.MAX_SCAN_TILES};" in source
    assert f"kNarrowCols = {qsketch_module.NARROW_COLS};" in source
    for kernel in qsketch_module.CUDA_KERNELS:
        assert re.search(rf"__global__ void(\s+__launch_bounds__\(\w+\))?\s+{kernel}\(", source + header), kernel


@pytest.mark.parametrize("n", [0, 1, 2, 3, 33, 255, 256, 1000, 1024, 1025, 5001, 16384, 131072, 2**20, 2**22])
@pytest.mark.parametrize("cols", [3, 2002])
def test_sort_plan_covers_every_key_once(n, cols):
    """Tiles, merge groups and scan tiles of the plan each cover the n_pad
    sorted keys exactly once; the merges end in one run; at most 1024 scan
    tiles (one block sums their sums); scratch holds both key buffers and
    the tile sums; rows past 16 columns take the gather."""
    plan = qsketch_module.qsketch_plan(n, cols)
    assert plan.n_pad == qsketch_module.next_pow2(max(n, 2)) and plan.n_pad >= max(n, 2)
    assert plan.tile == min(plan.n_pad, qsketch_module.TILE) and plan.n_pad % plan.tile == 0
    covered = np.zeros(plan.n_pad, np.int64)
    for start in range(0, plan.n_pad, plan.tile):
        covered[start : start + plan.tile] += 1
    assert (covered == 1).all()
    run = plan.tile
    for pass_run, way in plan.merges:
        assert pass_run == run and 2 <= way <= qsketch_module.MAX_WAY and plan.n_pad % (run * way) == 0
        groups = np.arange(plan.n_pad) // (run * way)
        assert np.bincount(groups).tolist() == [run * way] * (plan.n_pad // (run * way))
        run *= way
    assert run == plan.n_pad
    assert plan.scan_tile * plan.scan_tiles == plan.n_pad and 1 <= plan.scan_tiles <= qsketch_module.MAX_SCAN_TILES
    assert plan.scan_tile == plan.n_pad or plan.scan_tile % qsketch_module.SCAN_ROWS == 0
    assert plan.scratch_words * 8 >= 2 * plan.n_pad * 8 + plan.scan_tiles * 4
    assert plan.gather == (cols > qsketch_module.NARROW_COLS)
    if plan.n_pad == 16384:
        assert plan.merges == ((1024, 4), (4096, 4))  # the binary default: 16 tiles, two 4-way passes
    if plan.n_pad == 131072:
        assert plan.merges == ((1024, 4), (4096, 4), (16384, 4), (65536, 2))


def _order_pairs(a, b, up):
    swap = (a > b) == up
    return np.where(swap, b, a), np.where(swap, a, b)


def sort_shared_emulated(keys):
    """``bitonic::sort_shared`` step for step: strides >= 32 as shared passes
    of two strides (one when 32 is left alone), strides < 32 as warp passes
    over 32-key chunks (all of stages 2 .. 32 in the first, a chunk past a
    short sequence padded with keys above every key)."""
    s = np.array(keys, np.uint64)
    n = s.size

    def warp_pass(first, k):
        width = max(n, 32)
        v = np.concatenate([s, np.full(width - n, np.uint64(2**64 - 1))])
        i = np.arange(width)
        steps = [(kk, j) for kk in (2, 4, 8, 16, 32) for j in (16, 8, 4, 2, 1) if j < kk] if first else [(k, j) for j in (16, 8, 4, 2, 1)]
        for kk, j in steps:
            other = v[i ^ j]
            keep_min = ((i & j) == 0) == ((i & kk) == 0)
            v = np.where((other < v) == keep_min, other, v)
        s[:] = v[:n]

    def pass2(k, j):
        h = j // 2
        t = np.arange(n // 4)
        i = ((t & ~(h - 1)) << 2) | (t & (h - 1))
        up = (i & k) == 0
        a, b, c, d = s[i], s[i + h], s[i + j], s[i + j + h]
        a, c = _order_pairs(a, c, up)
        b, d = _order_pairs(b, d, up)
        a, b = _order_pairs(a, b, up)
        c, d = _order_pairs(c, d, up)
        s[i], s[i + h], s[i + j], s[i + j + h] = a, b, c, d

    def pass1(k, j):
        t = np.arange(n // 2)
        i = ((t & ~(j - 1)) << 1) | (t & (j - 1))
        a, b = _order_pairs(s[i], s[i + j], (i & k) == 0)
        s[i], s[i + j] = a, b

    warp_pass(True, 0)
    k = 64
    while k <= n:
        j = k // 2
        while j >= 64:
            pass2(k, j)
            j //= 4
        if j == 32:
            pass1(k, 32)
        warp_pass(False, k)
        k *= 2
    return s


def merge_pass_emulated(keys, run, way):
    """``bitonic::merge_pass_kernel`` over one row: each key's place is its
    index in its run plus its rank in every other run of its group, found by
    the kernel's lockstep binary search (equal keys of earlier runs count)."""
    n = keys.size
    i = np.arange(n)
    r = i // run
    first = r - r % way
    own = r - first
    place = first * run + (i - r * run)
    for u in range(way):
        other = (first + u) * run
        earlier = u < own
        at = np.zeros(n, np.int64)
        step = run // 2
        while step > 0:
            probe = keys[other + at + step - 1]
            at += step * ((probe < keys) | (earlier & (probe == keys)))
            step //= 2
        probe = keys[other + at]
        at += (probe < keys) | (earlier & (probe == keys))
        place += np.where(u == own, 0, at)
    out = np.empty_like(keys)
    out[place] = keys
    assert np.array_equal(np.sort(place), i)  # a permutation
    return out


@pytest.mark.parametrize("n", [1, 2, 4, 16, 32, 64, 128, 1024, 4096, 8192])
@pytest.mark.parametrize("dups", [False, True])
def test_shared_sort_schedule_sorts(n, dups):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 7 if dups else 2**63, n, dtype=np.uint64)
    assert np.array_equal(sort_shared_emulated(keys), np.sort(keys))


@pytest.mark.parametrize("n", [1, 64, 5001, 16384, 131072])
def test_tiles_and_rank_merges_sort_the_kernel_keys(n):
    """The plan's tile sorts and merge passes, emulated on the plain
    version's packed keys (NaN of both signs, signed zeros, ties, zero
    weights), give exactly the plain version's order."""
    rng = np.random.default_rng(n)
    rows = np.zeros((n, 3), np.float32)
    rows[:, 0] = rng.integers(0, 3, n)
    rows[:, 1] = rng.integers(-20, 20, n) / 4
    pick = rng.random(n)
    rows[pick < 0.05, 1] = np.nan
    rows[(pick >= 0.05) & (pick < 0.08), 1] = -np.nan
    rows[(pick >= 0.1) & (pick < 0.2), 1] = -0.0
    plan = qsketch_module.qsketch_plan(n, 3)
    data = np.zeros((plan.n_pad, 3), np.float32)
    data[:n] = rows
    keys = qsketch_module._sort_key(_t(data[:, 1]), _t(data[:, 0] > 0)).numpy().astype(np.uint64)
    tiles = [sort_shared_emulated(keys[lo : lo + plan.tile]) for lo in range(0, plan.n_pad, plan.tile)]
    merged = np.concatenate(tiles)
    for run, way in plan.merges:
        merged = merge_pass_emulated(merged, run, way)
    _, _, perm = ops.qsketch_sort_bucket_reference(_t(rows), 64)
    np.testing.assert_array_equal((merged & np.uint64(2**31 - 1)).astype(np.int64), perm.numpy())


def test_rank_merge_is_stable_on_repeated_keys():
    keys = np.sort(np.random.default_rng(0).integers(0, 5, (16, 64)), axis=1).astype(np.uint64).reshape(-1)
    for way in (2, 4, 8, 16):
        np.testing.assert_array_equal(merge_pass_emulated(keys, 64, way)[: 64 * way], np.sort(keys[: 64 * way]))


def test_launch_counter_and_plan(monkeypatch):
    """With the card faked (the launch recorded instead of made), one call
    counts one launch under ``qsketch_sort_bucket`` however many kernels it
    issues, and passes the plan: n_pad, the tile, the merge's way and the
    scan tile, with scratch for both key buffers and the tile sums."""
    calls = []

    def fake_launch(kernel, lib, device, fn, *args):
        calls.append((kernel, args[1:9]))
        ops.count_launch(kernel)

    monkeypatch.setattr(qsketch_module, "check_cuda", lambda *args: None)
    monkeypatch.setattr(qsketch_module, "_launcher", lambda: (None, "qsketch_sort_bucket_f32"))
    monkeypatch.setattr(qsketch_module, "launch", fake_launch)
    ops.reset_launch_counts()
    for n, cols in ((16384, 3), (12288, 2002), (1, 3)):
        wvals, bucket, perm = ops.qsketch_sort_bucket(torch.zeros(n, cols), 8192)
        plan = qsketch_module.qsketch_plan(n, cols)
        assert wvals.shape == (plan.n_pad, cols) and bucket.shape == perm.shape == (plan.n_pad,)
    assert ops.launch_counts()["qsketch_sort_bucket"] == 3
    scale = 8192 / (2 * np.pi)
    assert [c[0] for c in calls] == ["qsketch_sort_bucket"] * 3
    # (n, cols, n_pad, capacity, tile, way, scan tile), the scale apart
    assert [c[1][:4] + c[1][5:] for c in calls] == [
        (16384, 3, 16384, 8192, 1024, 4, 256),
        (12288, 2002, 16384, 8192, 1024, 4, 256),
        (1, 3, 2, 8192, 2, 4, 2),
    ]
    assert all(abs(c[1][4] - scale) < 1e-9 for c in calls)
