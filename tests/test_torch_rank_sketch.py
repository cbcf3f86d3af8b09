"""The Gumbel reservoir, its random stream and the rank sketch: the port
against the JAX package.

* The Threefry bits, ``fold_in`` and the float32 uniforms equal
  ``jax.random``'s bit for bit.
* The Gumbel priorities take each log correctly rounded (float64, rounded
  once); XLA's float32 ``log`` on the CPU is an ulp off that on about 14%
  of the inner logs, so about a fifth of the priorities differ from
  ``jax.random.gumbel``'s, all within 2 ulp counted at ``max(|g|, 1)``
  (pinned here: ROADMAP.md, C, "Properties").
* ``reservoir_insert`` and ``SpearmanCorrCoef``'s sketch hold the JAX
  package's rows bit for bit in payload and order (priorities within the
  2 ulp) inside the lossless window and, at these seeds, past it; the
  port's one stable top ``k`` over ``k + B`` rows gives the JAX package's
  chunked fold bit for bit (keyed inserts and merges with ties across
  chunks); a bucketed (padded, masked) insert equals the unpadded one.
* ``ranksketch_spearman`` and the weighted midranks on the same leaf equal
  the JAX package's within 1e-6 (midranks exactly); Spearman past the
  window within 1e-5; a windowed Spearman's ring and reads likewise.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metrics_tpu import SpearmanCorrCoef as JaxSpearman
from metrics_tpu.sketches import rank as jax_rank
from metrics_tpu.sketches import reservoir as jax_reservoir
from metrics_tpu.windowed import WindowedMetric as JaxWindowed
from metrics_tpu_torch import MetricCollection, SpearmanCorrCoef, WindowedMetric
from metrics_tpu_torch.sketches import rank, reservoir
from metrics_tpu_torch.functional import spearman_corrcoef
from metrics_tpu_torch.utils import prng
from tests.test_torch_regression import assert_priorities_close

torch.set_num_threads(2)

TINY = np.finfo(np.float32).tiny


def _jax_key(seed, seen):
    return jax.random.fold_in(jax.random.PRNGKey(seed), jnp.asarray(seen, jnp.int32))


@pytest.mark.parametrize("seed, seen, n", [(0, 0, 4097), (3, 123456, 1000), (0, 2**31 - 5, 257), (7, 1, 1)])
def test_threefry_bits_and_uniforms_are_jax_bits(seed, seen, n):
    key = prng.fold_in(prng.prng_key(seed), torch.tensor(seen, dtype=torch.int32))
    jk = _jax_key(seed, seen)
    assert [int(x) for x in key] == np.asarray(jax.random.key_data(jk)).astype(np.int64).tolist()
    np.testing.assert_array_equal(prng.random_bits(key, n).numpy(), np.asarray(jax.random.bits(jk, (n,), jnp.uint32)).astype(np.int64))
    want = np.asarray(jax.random.uniform(jk, (n,), jnp.float32, minval=TINY, maxval=1.0))
    np.testing.assert_array_equal(prng.uniform(key, n).numpy().view(np.int32), want.view(np.int32))
    assert prng.prng_key(seed) == tuple(np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))).astype(int).tolist())


def test_gumbel_log_difference_is_pinned():
    """The port's priorities against ``jax.random.gumbel`` over 2**16 draws:
    within 2 ulp of ``max(|g|, 1)`` everywhere, bit-equal where XLA's inner
    and outer logs round correctly. The share that differs is a property
    of XLA's float32 ``log`` on the CPU; if it ever reaches 0, the port
    could be held bit for bit."""
    n = 1 << 16
    key, jk = prng.fold_in(prng.prng_key(0), 0), _jax_key(0, 0)
    got = prng.gumbel(key, n).numpy()
    want = np.asarray(jax.random.gumbel(jk, (n,), jnp.float32))
    assert_priorities_close(got, want)
    differ = float(np.mean(got != want))
    assert 0.15 < differ < 0.30, differ
    u = prng.uniform(key, n).numpy()
    xla_inner = np.asarray(jnp.log(jnp.asarray(u)))
    inner = np.log(u.astype(np.float64)).astype(np.float32)
    assert 0.10 < float(np.mean(xla_inner != inner)) < 0.18
    # a log taken in float64 and rounded once is what the port computes
    np.testing.assert_array_equal(got, (-np.log(-inner.astype(np.float64))).astype(np.float32))


def _pairs(seed, b):
    rng = np.random.RandomState(seed)
    x = rng.rand(b).astype(np.float32)
    return x, (x + rng.rand(b)).astype(np.float32)


def _jax_reservoir_rows(k, batches, seed=0, weights=None):
    leaf = jax_reservoir.reservoir_init(k, 2)
    seen = 0
    for i, (p, t) in enumerate(batches):
        w = None if weights is None else jnp.asarray(weights[i])
        leaf = jax_reservoir.reservoir_insert(leaf, jnp.stack([jnp.asarray(p), jnp.asarray(t)], 1), jnp.asarray(seen), seed=seed, weights=w)
        seen += p.shape[0]
    return np.array(leaf)


def _port_reservoir_rows(k, batches, seed=0, weights=None):
    leaf = reservoir.reservoir_init(k, 2, device="cpu")
    seen = torch.zeros((), dtype=torch.int32)
    for i, (p, t) in enumerate(batches):
        w = None if weights is None else torch.from_numpy(weights[i])
        leaf = reservoir.reservoir_insert(leaf, torch.stack([torch.from_numpy(p), torch.from_numpy(t)], 1), seen, seed=seed, weights=w)
        seen = seen + p.shape[0]
    return leaf.numpy()


def _assert_same_rows(got, want):
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
    assert_priorities_close(got[:, 0], want[:, 0])


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("sizes", [(20, 30, 14), (48, 48, 48, 48), (300,), (5, 200, 7, 64)])
def test_reservoir_insert_matches_jax(seed, sizes):
    """k = 64: inside the lossless window (rows in arrival order) and past it
    (the top 64 by priority), one batch at a time and batches of several k."""
    batches = [_pairs(seed * 100 + i, b) for i, b in enumerate(sizes)]
    _assert_same_rows(_port_reservoir_rows(64, batches, seed), _jax_reservoir_rows(64, batches, seed))


def test_weighted_reservoir_insert_matches_jax():
    batches = [_pairs(40 + i, 48) for i in range(3)]
    rng = np.random.RandomState(3)
    weights = [np.where(rng.rand(48) < 0.2, 0.0, rng.rand(48) * 3).astype(np.float32) for _ in range(3)]
    got, want = _port_reservoir_rows(32, batches, weights=weights), _jax_reservoir_rows(32, batches, weights=weights)
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
    # the weight's log is correctly rounded too: an ulp of log(w) more
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=1e-6)


def test_one_top_k_equals_the_chunked_fold():
    """The port selects once over the k + B rows; the JAX package folds
    chunks of k rows, one top k each (its keyed insert and its merge). With
    the same keys, ties across chunks included, the rows and their order
    are the same bits."""
    rng = np.random.RandomState(9)
    k = 16
    keys = [rng.rand(n).astype(np.float32) for n in (10, 200, 40)]
    keys[1][::7] = keys[1][3]  # ties across chunks
    keys[2][:5] = keys[1][3]
    payloads = [rng.rand(len(x), 2).astype(np.float32) for x in keys]
    leaf, jax_leaf = reservoir.reservoir_init(k, 2, device="cpu"), jax_reservoir.reservoir_init(k, 2)
    for key, payload in zip(keys[:2], payloads[:2]):
        leaf = reservoir.reservoir_insert_keyed(leaf, torch.from_numpy(payload), torch.from_numpy(key))
        jax_leaf = jax_reservoir.reservoir_insert_keyed(jax_leaf, jnp.asarray(payload), jnp.asarray(key))
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jax_leaf))
    # a merge with more rows than k: 40 rows against k = 16
    other = torch.from_numpy(np.concatenate([keys[2][:, None], payloads[2]], 1))
    merged = reservoir.reservoir_merge(leaf, other)
    np.testing.assert_array_equal(merged.numpy(), np.asarray(jax_reservoir.reservoir_merge(jax_leaf, jnp.asarray(other.numpy()))))


def test_bucketed_insert_draws_match_the_eager_draw():
    """A padded batch masked by ``n_valid`` draws the unpadded batch's
    priorities for its first rows, so the reservoir is bit-identical."""
    k = 32
    p, t = _pairs(77, 100)
    for n_valid in (100, 40, 1):
        leaf = reservoir.reservoir_init(k, 2, device="cpu")
        rows = torch.stack([torch.from_numpy(p), torch.from_numpy(t)], 1)
        eager = reservoir.reservoir_insert(leaf, rows[:n_valid], 5)
        padded = torch.cat([rows[:n_valid], rows[n_valid - 1 : n_valid].expand(128 - n_valid, 2)])
        bucketed = reservoir.reservoir_insert(leaf, padded, torch.tensor(5), n_valid=torch.tensor(n_valid))
        assert torch.equal(eager, bucketed)
    draws = prng.gumbel(prng.fold_in(prng.prng_key(0), 5), 128)
    assert torch.equal(draws[:100], prng.gumbel(prng.fold_in(prng.prng_key(0), 5), 100))


def test_weighted_midranks_and_sketch_spearman_match_jax():
    rng = np.random.RandomState(4)
    values = rng.randint(0, 6, 40).astype(np.float32)
    values[::9] = np.nan
    weights = (rng.rand(40) < 0.7).astype(np.float32)
    got = rank._weighted_midranks(torch.from_numpy(values), torch.from_numpy(weights))
    want = jax_rank._weighted_midranks(jnp.asarray(values), jnp.asarray(weights))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a leaf past the window (k = 64 of 240 pairs), the same on both sides
    leaf = _jax_reservoir_rows(64, [_pairs(i, 48) for i in range(5)])
    got = rank.ranksketch_spearman(torch.from_numpy(leaf))
    np.testing.assert_allclose(float(got), float(jax_rank.ranksketch_spearman(jnp.asarray(leaf))), atol=1e-6)
    empty = rank.ranksketch_init(8, device="cpu")
    assert float(rank.ranksketch_spearman(empty)) == float(jax_rank.ranksketch_spearman(jax_rank.ranksketch_init(8)))


@pytest.mark.parametrize("capacity, sizes", [(512, (32, 32, 32)), (64, (48, 48, 48, 48)), (128, (100, 300))])
def test_spearman_sketch_matches_jax(capacity, sizes):
    """Inside the window (512) the compute is the exact kernel on the
    stream; past it (64, 128) the estimator on the sampled pairs."""
    jax_metric, metric = JaxSpearman(sketch_capacity=capacity), SpearmanCorrCoef(sketch_capacity=capacity, device="cpu")
    for i, b in enumerate(sizes):
        p, t = _pairs(200 + i, b)
        jax_metric.update(jnp.asarray(p), jnp.asarray(t))
        metric.update(torch.from_numpy(p), torch.from_numpy(t))
    _assert_same_rows(metric.rsketch.numpy(), np.asarray(jax_metric.rsketch))
    assert int(metric.n_seen) == int(jax_metric.n_seen) == sum(sizes)
    np.testing.assert_allclose(float(metric.compute()), float(jax_metric.compute()), atol=1e-5)
    if sum(sizes) <= capacity:
        p = np.concatenate([_pairs(200 + i, b)[0] for i, b in enumerate(sizes)])
        t = np.concatenate([_pairs(200 + i, b)[1] for i, b in enumerate(sizes)])
        assert torch.equal(metric.compute(), spearman_corrcoef(torch.from_numpy(p), torch.from_numpy(t)))


def test_fused_bucketed_spearman_equals_eager():
    """The fused update (the plain version on the CPU) with pad-and-mask
    buckets: the masked pads draw nothing and ``n_seen`` is corrected, so
    the states equal the eager update's bit for bit, inside and past the
    window."""
    def make():
        return MetricCollection([SpearmanCorrCoef(sketch_capacity=64, device="cpu")])

    eager, fused = make(), make()
    handle = fused.compile_update(buckets=(64,))
    for i, b in enumerate((48, 64, 37, 60)):
        p, t = (torch.from_numpy(x) for x in _pairs(300 + i, b))
        eager.update(p, t)
        fused.update(p, t)
    assert handle.n_compiles == 1 and not handle.declined
    for name in ("rsketch", "n_seen"):
        assert torch.equal(getattr(fused["SpearmanCorrCoef"], name), getattr(eager["SpearmanCorrCoef"], name))
    assert torch.equal(fused.compute()["SpearmanCorrCoef"], eager.compute()["SpearmanCorrCoef"])


def test_windowed_spearman_matches_jax():
    """The ring of reservoirs: each bucket inserts with its own count, and
    a read merges the window's reservoirs oldest first."""
    jax_metric = JaxWindowed(JaxSpearman(sketch_capacity=64), window=3)
    metric = WindowedMetric(SpearmanCorrCoef(sketch_capacity=64, device="cpu"), window=3)
    for i in range(5):
        p, t = _pairs(400 + i, 40)
        jax_metric.update(jnp.asarray(p), jnp.asarray(t))
        metric.update(torch.from_numpy(p), torch.from_numpy(t))
    ring, want = metric.rsketch.numpy(), np.asarray(jax_metric.rsketch)
    for slot in range(3):
        _assert_same_rows(ring[slot], want[slot])
    for window in (1, 2, 3):
        np.testing.assert_allclose(float(metric.compute(window=window)), float(jax_metric.compute(window=window)), atol=1e-5)
    # window 1 is inside the window: a fresh metric fed the last batch
    fresh = SpearmanCorrCoef(sketch_capacity=64, device="cpu")
    fresh.update(*(torch.from_numpy(x) for x in _pairs(404, 40)))
    assert torch.equal(metric.compute(window=1), fresh.compute())
