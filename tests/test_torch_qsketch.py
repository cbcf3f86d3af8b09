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
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metrics_tpu.ops.qsketch_pallas import _qsketch_compact_pallas, qsketch_sort_bucket_tiled
from metrics_tpu.sketches import quantile as jq
from metrics_tpu_torch import ops
from metrics_tpu_torch.sketches import quantile as tq

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
