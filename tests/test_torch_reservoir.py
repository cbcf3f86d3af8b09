"""The port's reservoir, moments and exact-mode helpers against the JAX package's, on the CPU.

Everything here is held bit for bit: the hash priorities are integer
arithmetic, the reservoir only moves rows, and the moment leaves are fed
integer-valued features, whose float32 sums are exact in any order.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.detection import MeanAveragePrecision as JaxMAP
from metrics_tpu.sketches import moments as jmom
from metrics_tpu.sketches import reservoir as jres
from metrics_tpu_torch import MeanAveragePrecision
from metrics_tpu_torch.sketches import (
    fill_bound,
    mean_cov_from_moments,
    moments_init,
    moments_merge_fx,
    moments_update,
    register_exact_list_states,
    reservoir_fill,
    reservoir_init,
    reservoir_insert_keyed,
    reservoir_key,
    reservoir_merge,
    reservoir_merge_fx,
    reservoir_rows,
    warn_exact_buffer,
)

torch.set_num_threads(2)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x)).view(np.int32)


def _same(jax_leaf, torch_leaf):
    np.testing.assert_array_equal(_bits(jax_leaf), _bits(torch_leaf.numpy()))


EDGE_IDS = [0, 1, 2**16 - 1, 2**16, 2**24 - 1, 2**24, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1, 0xDEADBEEF]


@pytest.mark.parametrize("kind", ["edge", "arange", "random"])
def test_reservoir_key_matches_jax_bitwise(kind):
    if kind == "edge":
        ids = np.array(EDGE_IDS, np.int64)
    elif kind == "arange":
        ids = np.arange(5000, dtype=np.int64)
    else:
        ids = np.random.default_rng(7).integers(0, 2**32, 20000, dtype=np.int64)
    want = np.asarray(jres.reservoir_key(jnp.asarray(ids.astype(np.uint32))))
    got = reservoir_key(torch.from_numpy(ids), device="cpu")
    assert got.dtype == torch.float32
    _same(want, got)
    assert float(got.min()) > 0 and float(got.max()) <= 1


def test_reservoir_key_wraps_like_uint32():
    """Negative and past-2**32 ids hash as their uint32 wrap, as the JAX
    package's ``asarray(ids, uint32)`` of an int32 index does."""
    wrapped = np.array([2**32 - 1, 2**32 - 5, 3], np.int64)
    got = reservoir_key(torch.tensor([-1, -5, 2**32 + 3]), device="cpu")
    _same(np.asarray(jres.reservoir_key(jnp.asarray(wrapped.astype(np.uint32)))), got)


def _stream(rng, n, cols=3, start=0):
    payload = rng.integers(0, 9, (n, cols)).astype(np.float32)
    keys = np.array(jres.reservoir_key(jnp.arange(start, start + n, dtype=jnp.uint32)))
    return payload, keys


# (k, batch, batches, n_valid of the second batch): inside the window
# (pack branch), crossing it, far past it (top-k branch), batches larger
# than k (chunked inserts)
INSERT_CASES = [(16, 6, 4, 4), (8, 5, 6, 0), (8, 20, 3, 17)]


@pytest.mark.parametrize("k,batch,batches,n_valid", INSERT_CASES)
def test_insert_keyed_matches_jax_bitwise(k, batch, batches, n_valid):
    rng = np.random.default_rng(k * 100 + batch)
    want, got = jres.reservoir_init(k, 3), reservoir_init(k, 3, device="cpu")
    seen = 0
    for i in range(batches):
        payload, keys = _stream(rng, batch, start=seen)
        nv = n_valid if i == 1 else None
        want = jres.reservoir_insert_keyed(want, payload, keys, n_valid=nv)
        got = reservoir_insert_keyed(got, torch.from_numpy(payload), torch.from_numpy(keys), n_valid=nv)
        _same(want, got)
        seen += batch
    assert int(got[:, 0].gt(-np.inf).sum()) == int(reservoir_fill(got))
    assert fill_bound(got) >= int(reservoir_fill(got))
    np.testing.assert_array_equal(reservoir_rows(got).numpy(), np.asarray(jres.reservoir_rows(want)))


def test_insert_without_a_bound_selects_the_same_rows():
    """A reservoir carried in without its host bound (a checkpoint, a state
    from JAX) takes both branches and the device's select; the rows equal
    those of the bounded path."""
    rng = np.random.default_rng(3)
    payload, keys = _stream(rng, 6)
    bounded = reservoir_insert_keyed(reservoir_init(16, 3, device="cpu"), torch.from_numpy(payload), torch.from_numpy(keys))
    carried = torch.from_numpy(np.asarray(jres.reservoir_init(16, 3)).copy())
    assert fill_bound(carried) == 16
    unbounded = reservoir_insert_keyed(carried, torch.from_numpy(payload), torch.from_numpy(keys))
    assert torch.equal(bounded, unbounded)
    assert fill_bound(bounded) == 6


@pytest.mark.parametrize("k,na,nb", [(16, 6, 6), (8, 5, 5)])
def test_merge_matches_jax_bitwise(k, na, nb):
    rng = np.random.default_rng(k + na + nb)
    pa, ka = _stream(rng, na)
    pb, kb = _stream(rng, nb, start=na)
    ja = jres.reservoir_insert_keyed(jres.reservoir_init(k, 3), pa, ka)
    jb = jres.reservoir_insert_keyed(jres.reservoir_init(k, 3), pb, kb)
    ta = reservoir_insert_keyed(reservoir_init(k, 3, device="cpu"), torch.from_numpy(pa), torch.from_numpy(ka))
    tb = reservoir_insert_keyed(reservoir_init(k, 3, device="cpu"), torch.from_numpy(pb), torch.from_numpy(kb))
    _same(jres.reservoir_merge(ja, jb), reservoir_merge(ta, tb))
    _same(jres.reservoir_merge_fx()(jnp.stack([ja, jb])), reservoir_merge_fx()(torch.stack([ta, tb])))


def test_reservoir_arguments_are_checked():
    with pytest.raises(ValueError, match="positive int"):
        reservoir_init(0, 3, device="cpu")
    with pytest.raises(ValueError, match="payload_cols"):
        reservoir_init(4, 0, device="cpu")
    r = reservoir_init(4, 3, device="cpu")
    with pytest.raises(ValueError, match="column"):
        reservoir_insert_keyed(r, torch.zeros(2, 2), torch.ones(2))
    with pytest.raises(ValueError, match="key"):
        reservoir_insert_keyed(r, torch.zeros(2, 3), torch.ones(3))
    with pytest.raises(ValueError, match="merge"):
        reservoir_merge(r, reservoir_init(4, 2, device="cpu"))
    assert reservoir_insert_keyed(r, torch.zeros(0, 3), torch.ones(0)) is r


def test_moments_match_jax_bitwise():
    rng = np.random.default_rng(11)
    want = jmom.moments_init(6)
    got = moments_init(6, device="cpu")
    for _ in range(3):
        feats = rng.integers(-4, 5, (10, 6)).astype(np.float32)
        want = jmom.moments_update(*want, feats)
        got = moments_update(*got, torch.from_numpy(feats))
        for w, g in zip(want, got):
            _same(w, g)
    for w, g in zip(jmom.mean_cov_from_moments(*want), mean_cov_from_moments(*got)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="positive int"):
        moments_init(0, device="cpu")


def test_moments_reducer_keeps_the_dtype():
    stacked = torch.tensor([3, 4], dtype=torch.int32)
    assert moments_merge_fx()(stacked).dtype == torch.int32
    assert int(moments_merge_fx()(stacked)) == int(jmom.moments_merge_fx()(jnp.asarray([3, 4], jnp.int32)))
    assert moments_merge_fx().merge_like and reservoir_merge_fx().merge_like


def _images(rng, n):
    out = []
    for _ in range(n):
        nd, ng = int(rng.integers(0, 4)), int(rng.integers(1, 4))
        boxes = lambda k: np.concatenate([xy := rng.uniform(0, 20, (k, 2)), xy + rng.uniform(2, 8, (k, 2))], 1).astype(np.float32)
        out.append(
            (
                dict(boxes=boxes(nd), scores=rng.random(nd).astype(np.float32), labels=rng.integers(0, 3, nd).astype(np.int32)),
                dict(boxes=boxes(ng), labels=rng.integers(0, 3, ng).astype(np.int32)),
            )
        )
    return out


def _feed(metric, images, as_tensor):
    preds = [{k: as_tensor(v) for k, v in p.items()} for p, _ in images]
    target = [{k: as_tensor(v) for k, v in t.items()} for _, t in images]
    metric.update(preds, target)


@pytest.mark.parametrize("max_images", [64, 6])
def test_merge_states_with_reservoir_and_moments_reducers(max_images):
    """``merge_states`` folds the mAP table through the reservoir reducer and
    ``images_seen`` through the moments reducer, as the JAX package does."""
    rng = np.random.default_rng(max_images)
    first, second = _images(rng, 5), _images(rng, 4)
    kw = dict(max_images=max_images, det_slots=4, gt_slots=4, max_detection_thresholds=[1, 4])
    jm, tm = JaxMAP(**kw), MeanAveragePrecision(device="cpu", **kw)
    states = []
    for batch in (first, second):
        jm.reset()
        tm.reset()
        _feed(jm, batch, jnp.asarray)
        _feed(tm, batch, torch.from_numpy)
        states.append((jm.state_dict(), tm.state_dict()))
    merged_j = jm.merge_states(states[0][0], states[1][0])
    merged_t = tm.merge_states(states[0][1], states[1][1])
    assert merged_t["images_seen"].dtype == torch.int32 and int(merged_t["images_seen"]) == 9
    for name in ("table", "images_seen"):
        _same(merged_j[name], merged_t[name])


def test_exact_helpers():
    class Holder:
        def __init__(self):
            self.registered = []

        def add_state(self, name, default, dist_reduce_fx):
            self.registered.append((name, default, dist_reduce_fx))

    holder = Holder()
    register_exact_list_states(holder, ("a", "b"), dist_reduce_fx=None)
    assert holder.registered == [("a", [], None), ("b", [], None)]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        warn_exact_buffer("Thing", "rows")
    assert "Metric `Thing` with `exact=True` will save all rows in buffer." in str(caught[0].message)
