"""The port's retrieval metrics against the JAX package's, on the CPU.

* The eight single-query functionals, within 1e-6 (their doctest values
  are checked by ``tests/test_torch_doctests.py``).
* The eight metric classes in their table default and in ``exact=True``,
  under every ``empty_target_action``: the table state bit for bit, the
  results within 1e-6 (the JAX suite's tolerance: per-query values go
  through division, ``log2`` and sums whose rounding differs between XLA
  and torch), and bit for bit where every per-query value is dyadic
  (hit rate, precision at a power of two), as the JAX suite pins it.
* The NDCG + MAP collection (its compute groups, one pack and one row sort
  per shared state), ``state_from_jax`` of a ``qtable``, ``merge_states``.
* The slice as a whole: the MSLR-shaped stream of ``bench.py``'s config 4
  (seed 7, 40-199 documents per query, 8% relevant), cut to 300 queries,
  through both packages in the window and past ``max_docs``.
"""
import gc
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional.retrieval as jfun
import metrics_tpu.retrieval as jret
from metrics_tpu import MetricCollection as JaxCollection
from metrics_tpu_torch import MetricCollection
from metrics_tpu_torch import functional as tfun
from metrics_tpu_torch import retrieval as tret
from metrics_tpu_torch.convert import state_from_jax
from metrics_tpu_torch.functional.retrieval import padded
from metrics_tpu_torch.retrieval import base as tbase

torch.set_num_threads(2)

ATOL = 1e-6

CLASSES = [
    ("RetrievalMAP", {}),
    ("RetrievalMRR", {}),
    ("RetrievalPrecision", {"k": 2}),
    ("RetrievalRecall", {"k": 3}),
    ("RetrievalHitRate", {"k": 2}),
    ("RetrievalFallOut", {"k": 2}),
    ("RetrievalRPrecision", {}),
    ("RetrievalNormalizedDCG", {}),
    ("RetrievalNormalizedDCG", {"k": 3}),
]
DYADIC = [("RetrievalHitRate", {"k": 2}), ("RetrievalPrecision", {"k": 2}), ("RetrievalPrecision", {"k": 4})]


def _stream(seed=0, n_q=19, lo=1, hi=9, all_pos_every=7, all_neg_every=5, graded=False):
    """Sparse query ids, quantized scores (ties), queries with no positive
    and with no negative target."""
    rng = np.random.RandomState(seed)
    idx_l, p_l, t_l = [], [], []
    for q in range(n_q):
        n = int(rng.randint(lo, hi))
        idx_l.append(np.full(n, q * 13 + 5))
        p_l.append((rng.randint(0, 64, n) / 64.0).astype(np.float32))
        if q % all_neg_every == 0:
            t = np.zeros(n)
        elif q % all_pos_every == 0:
            t = np.ones(n)
        else:
            t = rng.randint(0, 4 if graded else 2, n)
        t_l.append(t.astype(np.int32))
    return np.concatenate(idx_l), np.concatenate(p_l), np.concatenate(t_l)


def _make(pkg, name, kw, **extra):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if pkg == "jax":
            return getattr(jret, name)(**kw, **extra)
        return getattr(tret, name)(**kw, **extra, device="cpu")


def _feed(metric, pkg, idx, preds, target, cuts=(0, 17, 18, 60)):
    cuts = [*cuts, len(idx)]
    conv = jnp.asarray if pkg == "jax" else torch.from_numpy
    for lo, hi in zip(cuts, cuts[1:]):
        if hi > lo:
            metric.update(conv(preds[lo:hi]), conv(target[lo:hi]), indexes=conv(idx[lo:hi]))


def _value(x):
    return np.float32(np.asarray(x))


def _same_bits(a, b):
    return np.asarray(a, np.float32).view(np.int32).tolist() == np.asarray(b, np.float32).view(np.int32).tolist()


# ---------------------------------------------------------------------------
# functionals
# ---------------------------------------------------------------------------

FUNCTIONALS = [
    ("retrieval_average_precision", {}),
    ("retrieval_reciprocal_rank", {}),
    ("retrieval_r_precision", {}),
    ("retrieval_precision", {}),
    ("retrieval_precision", {"k": 3}),
    ("retrieval_recall", {"k": 4}),
    ("retrieval_hit_rate", {"k": 2}),
    ("retrieval_fall_out", {"k": 5}),
    ("retrieval_normalized_dcg", {}),
    ("retrieval_normalized_dcg", {"k": 4}),
]


@pytest.mark.parametrize("name,kw", FUNCTIONALS, ids=[f"{n}{kw}" for n, kw in FUNCTIONALS])
def test_functionals_match_jax(name, kw):
    rng = np.random.default_rng(len(name) + sum(kw.values()))
    graded = name == "retrieval_normalized_dcg"
    for case in range(4):
        n = int(rng.integers(1, 30))
        preds = (rng.integers(0, 16, n) / 16.0).astype(np.float32)
        target = rng.integers(0, 5 if graded else 2, n).astype(np.int32)
        if case == 0:
            target[:] = 0  # no relevant document
        if case == 1:
            target[:] = 1  # no irrelevant document
        want = getattr(jfun, name)(jnp.asarray(preds), jnp.asarray(target), **kw)
        got = getattr(tfun, name)(torch.from_numpy(preds), torch.from_numpy(target), **kw)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=f"case {case}")


def test_functional_input_checks():
    p = torch.tensor([0.2, 0.3])
    with pytest.raises(ValueError, match="same shape"):
        tfun.retrieval_precision(p, torch.tensor([1]))
    with pytest.raises(ValueError, match="binary"):
        tfun.retrieval_precision(p, torch.tensor([0, 2]))
    with pytest.raises(ValueError, match="floats"):
        tfun.retrieval_precision(torch.tensor([1, 2]), torch.tensor([0, 1]))
    with pytest.raises(ValueError, match="positive integer"):
        tfun.retrieval_recall(p, torch.tensor([0, 1]), k=0)
    assert float(tfun.retrieval_normalized_dcg(p, torch.tensor([0, 3]))) == 1.0


# ---------------------------------------------------------------------------
# metric classes: table default and exact mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("action", ["neg", "pos", "skip"])
@pytest.mark.parametrize("name,kw", CLASSES, ids=[f"{n}{kw}" for n, kw in CLASSES])
def test_metrics_match_jax(name, kw, action):
    idx, preds, target = _stream(1, graded=name == "RetrievalNormalizedDCG")
    values = {}
    for pkg in ("jax", "torch"):
        for exact in (False, True):
            geometry = {} if exact else {"max_queries": 64, "max_docs": 16}
            m = _make(pkg, name, kw, empty_target_action=action, exact=exact, **geometry)
            _feed(m, pkg, idx, preds, target)
            values[pkg, exact] = _value(m.compute())
            if not exact:
                tables = values.setdefault("tables", [])
                tables.append(np.asarray(m.qtable))
    np.testing.assert_array_equal(*(t.view(np.int32) for t in values["tables"]))
    np.testing.assert_allclose(values["torch", False], values["jax", False], atol=ATOL)
    np.testing.assert_allclose(values["torch", True], values["jax", True], atol=ATOL)
    np.testing.assert_allclose(values["torch", False], values["torch", True], atol=ATOL)


@pytest.mark.parametrize("name,kw", DYADIC, ids=[f"{n}{kw}" for n, kw in DYADIC])
def test_dyadic_values_are_bit_identical(name, kw):
    """Per-query values that are dyadic rationals sum exactly in any order:
    table, exact mode and the JAX package agree bit for bit."""
    idx, preds, target = _stream(2)
    got = []
    for pkg in ("jax", "torch"):
        for exact in (False, True):
            geometry = {} if exact else {"max_queries": 64, "max_docs": 16}
            m = _make(pkg, name, kw, exact=exact, **geometry)
            _feed(m, pkg, idx, preds, target, cuts=(0,))
            got.append(_value(m.compute()))
    assert all(_same_bits(g, got[0]) for g in got), got


@pytest.mark.parametrize("exact", [False, True])
def test_ignore_index_matches_jax(exact):
    rng = np.random.RandomState(3)
    idx, preds, target = _stream(3)
    target = target.copy()
    target[rng.rand(len(target)) < 0.25] = -100
    got = []
    for pkg in ("jax", "torch"):
        m = _make(pkg, "RetrievalMAP", {}, ignore_index=-100, exact=exact, max_queries=64, max_docs=16)
        _feed(m, pkg, idx, preds, target)
        got.append(_value(m.compute()))
        if not exact:
            got.append(np.asarray(m.qtable))
    np.testing.assert_allclose(got[-1 if exact else -2], got[0], atol=ATOL)
    if not exact:
        np.testing.assert_array_equal(got[1].view(np.int32), got[3].view(np.int32))


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize(
    "name,target,message",
    [("RetrievalMAP", 0, "no positive"), ("RetrievalFallOut", 1, "no negative")],
)
def test_error_action(name, target, message, exact):
    """``empty_target_action="error"`` raises for a query with no positive
    target (no negative one for FallOut, read from the table's exact
    negative counter); a batch that ignore_index erases raises too."""
    m = _make("torch", name, {}, empty_target_action="error", exact=exact, max_queries=8, max_docs=4)
    m.update(torch.tensor([0.1, 0.2, 0.3, 0.4]), torch.full((4,), target), indexes=torch.tensor([0, 0, 1, 1]))
    with pytest.raises(ValueError, match=message):
        m.compute()
    m = _make("torch", name, {}, ignore_index=-1, exact=exact, max_queries=8, max_docs=4)
    with pytest.raises(ValueError, match="non-empty"):
        m.update(torch.tensor([0.1, 0.2]), torch.tensor([-1, -1]), indexes=torch.tensor([0, 1]))


def test_update_checks():
    m = _make("torch", "RetrievalMAP", {}, max_queries=8, max_docs=4)
    p, t, i = torch.tensor([0.1, 0.2]), torch.tensor([0, 1]), torch.tensor([0, 1])
    with pytest.raises(ValueError, match="cannot be None"):
        m.update(p, t, indexes=None)
    with pytest.raises(ValueError, match="same shape"):
        m.update(p, t, indexes=torch.tensor([0]))
    with pytest.raises(ValueError, match="long integers"):
        m.update(p, t, indexes=torch.tensor([0.0, 1.0]))
    with pytest.raises(ValueError, match="binary"):
        m.update(p, torch.tensor([0, 2]), indexes=i)
    with pytest.raises(ValueError, match="floats"):
        m.update(t, t, indexes=i)
    with pytest.raises(ValueError, match="empty_target_action"):
        tret.RetrievalMAP(empty_target_action="maybe", device="cpu")
    with pytest.raises(ValueError, match="ignore_index"):
        tret.RetrievalMAP(ignore_index=0.5, device="cpu")
    with pytest.raises(ValueError, match="positive integer"):
        tret.RetrievalPrecision(k=-1, device="cpu")
    m._update_called = True
    with pytest.raises(ValueError, match="no accumulated samples"):
        m.compute()
    assert tret.RetrievalFallOut.higher_is_better is False and tret.RetrievalMAP.higher_is_better is True


def test_update_reads_the_host_once(monkeypatch):
    """A table update's value checks (binary target, ignore_index) are one
    stacked host read."""
    reads = []
    original = torch.Tensor.tolist

    def counting(self):
        reads.append(tuple(self.shape))
        return original(self)

    m = _make("torch", "RetrievalMAP", {}, ignore_index=-1, max_queries=8, max_docs=4)
    monkeypatch.setattr(torch.Tensor, "tolist", counting)
    m.update(torch.tensor([0.1, 0.2, 0.3]), torch.tensor([0, 1, -1]), indexes=torch.tensor([0, 1, 1]))
    assert reads == [(3,)]


def test_table_rows_layout_is_the_row_gather():
    idx, preds, target = _stream(4)
    m = _make("torch", "RetrievalMAP", {}, max_queries=32, max_docs=8)
    _feed(m, "torch", idx, preds, target)
    rows = [5, 0, 31, 5]
    got = m.table_rows_layout(rows)
    want = tret.retrieval_table_layout_rows(m.qtable, torch.tensor(rows))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].shape == (4, 8)
    with pytest.raises(ValueError, match="exact=True"):
        _make("torch", "RetrievalMAP", {}, exact=True).table_rows_layout(rows)


def test_layout_memo_is_bounded_and_freed():
    tbase._LAYOUT_CACHE.clear()
    idx, preds, target = _stream(3, n_q=4)
    m = _make("torch", "RetrievalMAP", {}, max_queries=32, max_docs=8)
    for _ in range(3 * tbase._LAYOUT_CACHE_MAX):
        _feed(m, "torch", idx, preds, target, cuts=(0,))
        m.compute()
        m._computed = None
        m.compute()  # the same epoch: a hit, no new entry
    assert 1 <= len(tbase._LAYOUT_CACHE) <= tbase._LAYOUT_CACHE_MAX
    del m
    gc.collect()
    assert len(tbase._LAYOUT_CACHE) == 0


def test_host_loop_subclass_without_padded_kernel():
    """A subclass with only ``_metric`` computes through the host loops in
    both modes, equal to the padded kernels."""

    class LoopMAP(tret.RetrievalMAP):
        _padded_metric = None

    idx, preds, target = _stream(5)
    for exact in (False, True):
        loop = LoopMAP(exact=exact, max_queries=64, max_docs=16, device="cpu")
        ref = _make("torch", "RetrievalMAP", {}, exact=exact, max_queries=64, max_docs=16)
        for m in (loop, ref):
            _feed(m, "torch", idx, preds, target)
        np.testing.assert_allclose(loop.compute().numpy(), ref.compute().numpy(), atol=ATOL)


# ---------------------------------------------------------------------------
# collections, conversion, merging
# ---------------------------------------------------------------------------


def test_ndcg_map_collection_groups_like_jax():
    """NDCG allows graded targets and MAP does not, so the two form two
    compute groups in both packages, each with its own table."""
    idx, preds, target = _stream(6)
    kw = dict(max_queries=64, max_docs=16)
    jc = JaxCollection([jret.RetrievalNormalizedDCG(**kw), jret.RetrievalMAP(**kw)])
    tc = MetricCollection([tret.RetrievalNormalizedDCG(**kw, device="cpu"), tret.RetrievalMAP(**kw, device="cpu")])
    _feed(jc, "jax", idx, preds, target)
    _feed(tc, "torch", idx, preds, target)
    assert tc.compute_groups == jc.compute_groups == {0: ["RetrievalNormalizedDCG"], 1: ["RetrievalMAP"]}
    jv, tv = jc.compute(), tc.compute()
    for name in jv:
        np.testing.assert_allclose(tv[name].numpy(), np.asarray(jv[name]), atol=ATOL)
        np.testing.assert_array_equal(np.asarray(jc[name].qtable).view(np.int32), tc[name].qtable.numpy().view(np.int32))


def test_explicit_compute_group_shares_one_table_and_one_sort(monkeypatch):
    """With NDCG and MAP in one compute group, each update inserts into the
    leader's table only; compute borrows that table, unpacks it once and
    sorts its rows once for both metrics."""
    sorts = []
    original = padded._sorted_layout
    monkeypatch.setattr(padded, "_sorted_layout", lambda *a: sorts.append(1) or original(*a))
    idx, preds, target = _stream(7)
    kw = dict(max_queries=64, max_docs=16)
    tc = MetricCollection(
        [tret.RetrievalNormalizedDCG(**kw, device="cpu"), tret.RetrievalMAP(**kw, device="cpu")],
        compute_groups=[["RetrievalNormalizedDCG", "RetrievalMAP"]],
    )
    _feed(tc, "torch", idx, preds, target)
    fresh = tret.RetrievalMAP(**kw, device="cpu").qtable
    assert torch.equal(tc["RetrievalMAP"].qtable, fresh)  # the member was never updated
    values = tc.compute()
    assert tc["RetrievalMAP"].qtable is tc["RetrievalNormalizedDCG"].qtable
    assert len(sorts) == 1
    for name, cls in (("RetrievalNormalizedDCG", tret.RetrievalNormalizedDCG), ("RetrievalMAP", tret.RetrievalMAP)):
        solo = cls(**kw, device="cpu")
        _feed(solo, "torch", idx, preds, target)
        assert torch.equal(values[name], solo.compute())


def test_exact_collection_packs_once(monkeypatch):
    """Exact-mode members fed the same int32 ids, float32 scores and int32
    targets hold the same tensors, so the pack memo packs once for both."""
    calls = []
    original = padded.pack_queries
    monkeypatch.setattr(padded, "pack_queries", lambda *a, **k: calls.append(1) or original(*a, **k))
    rng = np.random.default_rng(9)
    idx = np.repeat(np.arange(40, dtype=np.int32), 10)
    preds = rng.random(400).astype(np.float32)
    target = rng.integers(0, 2, 400).astype(np.int32)
    tc = MetricCollection([_make("torch", "RetrievalNormalizedDCG", {}, exact=True), _make("torch", "RetrievalMAP", {}, exact=True)])
    _feed(tc, "torch", idx, preds, target, cuts=(0,))
    tc.compute()
    assert len(calls) == 1


def test_pack_memo_freed_with_its_tensors():
    """The pack memo keeps no state alive: the entry goes with the metric."""
    padded._PACK_CACHE.clear()
    m = _make("torch", "RetrievalMAP", {}, exact=True)
    m.update(torch.tensor([0.3, 0.7, 0.2, 0.9]), torch.tensor([0, 1, 1, 0]), indexes=torch.tensor([0, 0, 1, 1]))
    m.compute()
    m._computed = None
    m.compute()  # the same states: a hit
    assert len(padded._PACK_CACHE) == 1
    del m
    gc.collect()
    assert len(padded._PACK_CACHE) == 0


@pytest.mark.parametrize("name,kw", CLASSES[:2] + CLASSES[-1:], ids=["MAP", "MRR", "NDCG@3"])
def test_state_from_jax_carries_the_table(name, kw):
    idx, preds, target = _stream(8)
    jm = _make("jax", name, kw, max_queries=32, max_docs=8)
    _feed(jm, "jax", idx, preds, target)
    tm = _make("torch", name, kw, max_queries=32, max_docs=8)
    state = state_from_jax({k: np.asarray(v) for k, v in jm.state_dict().items()}, tm)
    assert list(state) == ["qtable"] and state["qtable"].dtype == torch.float32
    np.testing.assert_array_equal(state["qtable"].numpy().view(np.int32), np.asarray(jm.qtable).view(np.int32))
    np.testing.assert_allclose(tm.compute_state(state).numpy(), np.asarray(jm.compute()), atol=ATOL)
    # and the epoch continues in the port
    more = _stream(9)
    state = tm.update_state(state, torch.from_numpy(more[1]), torch.from_numpy(more[2]), indexes=torch.from_numpy(more[0]))
    jm.update(jnp.asarray(more[1]), jnp.asarray(more[2]), indexes=jnp.asarray(more[0]))
    np.testing.assert_array_equal(state["qtable"].numpy().view(np.int32), np.asarray(jm.qtable).view(np.int32))


def test_merge_states_equals_single_stream():
    idx, preds, target = _stream(9)
    half = len(idx) // 2
    parts = []
    for lo, hi in ((0, half), (half, len(idx))):
        m = _make("torch", "RetrievalMAP", {}, max_queries=64, max_docs=16)
        _feed(m, "torch", idx[lo:hi], preds[lo:hi], target[lo:hi], cuts=(0,))
        parts.append(m.init_state() | {"qtable": m.qtable})
    full = _make("torch", "RetrievalMAP", {}, max_queries=64, max_docs=16)
    _feed(full, "torch", idx, preds, target, cuts=(0,))
    merged = full.merge_states(*parts)
    assert torch.equal(full.compute_state(merged), full.compute())


# ---------------------------------------------------------------------------
# the slice as a whole: bench.py's config-4 stream, cut to 300 queries
# ---------------------------------------------------------------------------


def _mslr_stream(n_queries=300):
    rng = np.random.RandomState(7)
    counts = rng.randint(40, 200, n_queries)
    idx = np.repeat(np.arange(n_queries), counts)
    preds = rng.rand(len(idx)).astype(np.float32)
    target = (rng.rand(len(idx)) < 0.08).astype(np.int32)
    return idx, preds, target


@pytest.mark.parametrize("max_docs", [256, 128], ids=["window", "compacting"])
def test_mslr_slice_matches_jax(max_docs):
    idx, preds, target = _mslr_stream()
    kw = dict(max_queries=512, max_docs=max_docs)
    jc = JaxCollection([jret.RetrievalNormalizedDCG(**kw), jret.RetrievalMAP(**kw)])
    tc = MetricCollection([tret.RetrievalNormalizedDCG(**kw, device="cpu"), tret.RetrievalMAP(**kw, device="cpu")])
    cuts = tuple(range(0, len(idx), 16384))
    _feed(jc, "jax", idx, preds, target, cuts=cuts)
    _feed(tc, "torch", idx, preds, target, cuts=cuts)
    jv, tv = jc.compute(), tc.compute()
    for name in ("RetrievalNormalizedDCG", "RetrievalMAP"):
        np.testing.assert_array_equal(np.asarray(jc[name].qtable).view(np.int32), tc[name].qtable.numpy().view(np.int32))
        np.testing.assert_allclose(tv[name].numpy(), np.asarray(jv[name]), atol=ATOL)
    if max_docs == 256:  # inside the window: equal to the exact mode's
        for name in ("RetrievalNormalizedDCG", "RetrievalMAP"):
            exact = _make("torch", name, {}, exact=True)
            _feed(exact, "torch", idx, preds, target, cuts=(0,))
            np.testing.assert_allclose(tv[name].numpy(), exact.compute().numpy(), atol=ATOL)
    else:  # queries past 128 documents were compacted to 64..128
        fill = tc["RetrievalMAP"].qtable[:, tret.table.COL_FILL]
        nseen = tc["RetrievalMAP"].qtable[:, tret.table.COL_NSEEN]
        over = nseen > 128
        assert int(over.sum()) == int((np.bincount(idx) > 128).sum()) > 0
        assert bool(((fill[over] >= 64) & (fill[over] <= 128)).all())


# ---------------------------------------------------------------------------
# the padded kernels and helpers
# ---------------------------------------------------------------------------

ROW_KERNELS = [
    ("average_precision_row", None),
    ("reciprocal_rank_row", None),
    ("precision_row", None),
    ("precision_row", 3),
    ("recall_row", 4),
    ("r_precision_row", None),
    ("hit_rate_row", 2),
    ("fall_out_row", 3),
    ("ndcg_row", None),
    ("ndcg_row", 5),
]


@pytest.mark.parametrize("name,k", ROW_KERNELS, ids=[f"{n}@{k}" for n, k in ROW_KERNELS])
def test_row_kernels_match_jax_per_row(name, k):
    """Each padded row kernel over a [Q, D] batch against the JAX package's
    kernel applied row by row (its vmap), on padded rows with ties, empty
    rows and graded targets for NDCG."""
    import jax

    from metrics_tpu.functional.retrieval import padded as jpadded

    rng = np.random.default_rng(len(name) + (k or 0))
    q, d = 12, 10
    fill = rng.integers(0, d + 1, q)
    fill[0] = d
    mask = np.arange(d)[None, :] < fill[:, None]
    preds = np.where(mask, rng.integers(0, 8, (q, d)) / 8.0, -np.inf).astype(np.float32)
    graded = name == "ndcg_row"
    target = np.where(mask, rng.integers(0, 4 if graded else 2, (q, d)), 0).astype(np.float32)
    want = jax.vmap(lambda p, t, m: getattr(jpadded, name)(p, t, m, k))(preds, target, mask)
    got = getattr(padded, name)(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(mask), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_pack_queries_matches_jax_bitwise():
    from metrics_tpu.functional.retrieval import padded as jpadded

    idx, preds, target = _stream(10)
    order = np.random.default_rng(10).permutation(len(idx))
    idx, preds, target = idx[order].astype(np.int32), preds[order], target[order]
    want = jpadded.pack_queries(jnp.asarray(idx), jnp.asarray(preds), jnp.asarray(target))
    got = padded.pack_queries(torch.from_numpy(idx), torch.from_numpy(preds), torch.from_numpy(target))
    for w, g in zip(want, got):
        w, g = np.asarray(w), g.numpy()
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(w.view(np.int8) if w.dtype == bool else w.view(np.int32), g.view(np.int8) if g.dtype == bool else g.view(np.int32))
    assert padded.pack_queries(torch.from_numpy(idx), torch.from_numpy(preds), torch.from_numpy(target), max_expand=1) is None
    with pytest.raises(ValueError, match="no accumulated samples"):
        padded.pack_queries(torch.zeros(0, dtype=torch.int32), torch.zeros(0), torch.zeros(0))


def test_get_group_indexes_matches_jax():
    from metrics_tpu.utils.data import get_group_indexes as jax_groups
    from metrics_tpu_torch.utils.data import get_group_indexes

    idx = np.random.default_rng(11).integers(-5, 20, 300)
    want = jax_groups(jnp.asarray(idx.astype(np.int32)))
    got = get_group_indexes(torch.from_numpy(idx))
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_tree_sum_is_a_fixed_pairwise_order():
    """The fixed-order sum: equal to float64's on exactly representable data,
    and on other data to the pairwise tree written out by hand (the order
    every device follows)."""
    x = torch.from_numpy(np.random.default_rng(12).integers(-50, 50, (7, 13)).astype(np.float32) / 8)
    assert torch.equal(padded._tree_sum(x), x.double().sum(-1).float())
    y = torch.rand(5, dtype=torch.float32)
    want = ((y[0] + y[1]) + (y[2] + y[3])) + (y[4] + 0.0)
    assert torch.equal(padded._tree_sum(y), want)
    assert torch.equal(padded._tree_sum(torch.zeros(3, 0)), torch.zeros(3))


def test_ndcg_discount_is_correctly_rounded():
    got = padded._discount(4096, torch.device("cpu")).numpy()
    want = np.log2(np.arange(2, 4098, dtype=np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
