"""The port's retrieval table against the JAX package's, on the CPU.

Every table, layout and mask is held bit for bit: the counters are sums of
integers (or of the same float targets in the same order), stored scores
and targets are copies, and every ordering is a stable sort of exact keys.
The JAX side runs ``metrics_tpu.retrieval.table`` eagerly on the CPU (its
``_row_topk_jnp`` route); the port's side takes the plain top-k and
segment-sum versions, as CPU tensors do.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.retrieval import table as jtable
from metrics_tpu_torch.retrieval import table as ttable

torch.set_num_threads(2)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x)).view(np.int32)


def _same(jax_x, torch_x):
    j = np.asarray(jax_x)
    t = torch_x.numpy()
    assert j.shape == t.shape and j.dtype == t.dtype, (j.shape, j.dtype, t.shape, t.dtype)
    if j.dtype == np.bool_:
        np.testing.assert_array_equal(j, t)
    else:
        np.testing.assert_array_equal(_bits(j), _bits(t))


def _stream(seed, n_docs, n_queries, graded=False, id_scale=13, id_offset=5):
    """Sparse query ids, quantized scores (ties), binary or graded targets."""
    rng = np.random.default_rng(seed)
    idx = (rng.integers(0, n_queries, n_docs) * id_scale + id_offset).astype(np.int32)
    preds = (rng.integers(0, 64, n_docs) / 64.0).astype(np.float32)
    target = rng.integers(0, 4 if graded else 2, n_docs).astype(np.float32)
    return idx, preds, target


def _insert_both(max_queries, max_docs, batches, valid=None, n_valid=None):
    jt = jtable.retrieval_table_init(max_queries, max_docs)
    tt = ttable.retrieval_table_init(max_queries, max_docs, device="cpu")
    for i, (idx, preds, target) in enumerate(batches):
        v = None if valid is None else valid[i]
        nv = None if n_valid is None else n_valid[i]
        jt = jtable.retrieval_table_insert(
            jt, jnp.asarray(idx), jnp.asarray(preds), jnp.asarray(target),
            valid=None if v is None else jnp.asarray(v), n_valid=nv,
        )
        tt = ttable.retrieval_table_insert(
            tt, torch.from_numpy(idx), torch.from_numpy(preds), torch.from_numpy(target),
            valid=None if v is None else torch.from_numpy(v), n_valid=nv,
        )
    return jt, tt


def _split(arrays, cuts):
    bounds = [0, *cuts, len(arrays[0])]
    return [tuple(a[lo:hi] for a in arrays) for lo, hi in zip(bounds[:-1], bounds[1:])]


def _same_layouts(jt, tt):
    for j, t in zip(jtable.retrieval_table_layout(jt), ttable.retrieval_table_layout(tt)):
        _same(j, t)
    rows = np.array([3, 0, 7, 3, 1], np.int32) % jt.shape[0]
    for j, t in zip(
        jtable.retrieval_table_layout_rows(jt, jnp.asarray(rows)),
        ttable.retrieval_table_layout_rows(tt, torch.from_numpy(rows)),
    ):
        _same(j, t)
    assert int(jtable.retrieval_table_fill(jt)) == int(ttable.retrieval_table_fill(tt))


# (case, max_queries, max_docs, stream kwargs, batch cuts): in the window,
# doc overflow (compactions within and across chunks), query eviction, and
# both at once, with a batch past one chunk of 2048 documents
CASES = [
    ("window", 64, 32, dict(seed=0, n_docs=600, n_queries=40), [200, 450]),
    ("doc_overflow", 64, 8, dict(seed=1, n_docs=900, n_queries=30), [300]),
    ("eviction", 16, 32, dict(seed=2, n_docs=700, n_queries=60), [100, 101, 400]),
    ("both_graded", 12, 6, dict(seed=3, n_docs=2600, n_queries=50, graded=True), [2300]),
    ("negative_ids", 32, 16, dict(seed=4, n_docs=500, n_queries=40, id_scale=-(2**25) - 1, id_offset=-7), [250]),
]


@pytest.mark.parametrize("case,max_queries,max_docs,kw,cuts", CASES, ids=[c[0] for c in CASES])
def test_insert_and_layout_bitwise(case, max_queries, max_docs, kw, cuts):
    arrays = _stream(**kw)
    jt, tt = _insert_both(max_queries, max_docs, _split(arrays, cuts))
    _same(jt, tt)
    _same_layouts(jt, tt)


def test_overflow_rows_hold_retained_docs_and_exact_counters():
    """Past max_docs a row holds between max_docs/2 and max_docs documents,
    while NSEEN/POS/NEG count every document (checked against numpy)."""
    idx, preds, target = _stream(seed=5, n_docs=1500, n_queries=20)
    _, tt = _insert_both(32, 16, [(idx, preds, target)])
    q = tt.numpy()
    occ = q[:, ttable.COL_KEY] > 0
    qid = ttable._join_qid(tt[:, ttable.COL_QHI], tt[:, ttable.COL_QLO]).numpy()
    for row in np.nonzero(occ)[0]:
        docs = idx == qid[row]
        assert q[row, ttable.COL_NSEEN] == docs.sum()
        assert q[row, ttable.COL_POS] == target[docs].sum()
        assert q[row, ttable.COL_NEG] == (target[docs] == 0).sum()
        assert 8 <= q[row, ttable.COL_FILL] <= 16


def _insert_port(max_queries, max_docs, batches):
    table = ttable.retrieval_table_init(max_queries, max_docs, device="cpu")
    for idx, preds, target in batches:
        table = ttable.retrieval_table_insert(table, *(torch.from_numpy(a) for a in (idx, preds, target)))
    return table


#: batches of 40 documents (fewer than the 64 rows: the card widens 40 rows)
#: and one of 500 (more: it widens all 64)
_WIDEN_CUTS = [*range(40, 640, 40), 1100]


def test_widening_every_row_as_on_the_card(monkeypatch):
    """The card widens a fixed list of candidate rows and masks the kernel;
    the CPU widens only the overflowing rows. Both give the same table."""
    batches = _split(_stream(seed=13, n_docs=1200, n_queries=25), _WIDEN_CUTS)
    cpu_way = _insert_port(64, 8, batches)
    monkeypatch.setattr(ttable, "_rows_to_widen", ttable._overflow_candidates)
    card_way = _insert_port(64, 8, batches)
    assert torch.equal(cpu_way.view(torch.int32), card_way.view(torch.int32))


def test_widening_all_rows_gives_the_same_table(monkeypatch):
    """Any superset of the overflowing rows compacts to the same table."""
    batches = _split(_stream(seed=14, n_docs=1200, n_queries=25), _WIDEN_CUTS)
    cpu_way = _insert_port(64, 8, batches)
    monkeypatch.setattr(ttable, "_rows_to_widen", lambda over, n_docs: torch.arange(over.shape[0]))
    every_row = _insert_port(64, 8, batches)
    assert torch.equal(cpu_way.view(torch.int32), every_row.view(torch.int32))


@pytest.mark.parametrize("num_q,n_docs,n_over", [(8192, 2048, 7), (8192, 2048, 2048), (64, 40, 0), (16, 2048, 16), (50, 3, 3)])
def test_overflow_candidates_hold_every_overflowing_row(num_q, n_docs, n_over):
    gen = torch.Generator().manual_seed(num_q + n_docs + n_over)
    over = torch.zeros(num_q, dtype=torch.bool)
    over[torch.randperm(num_q, generator=gen)[:n_over]] = True
    cand = ttable._overflow_candidates(over, n_docs)
    assert cand.shape == (min(num_q, n_docs),) and cand.unique().numel() == cand.numel()
    assert torch.equal(cand[:n_over], over.nonzero()[:, 0])
    assert not bool(over[cand[n_over:]].any())


def test_ignore_index_mask_and_n_valid():
    idx, preds, target = _stream(seed=6, n_docs=800, n_queries=25)
    rng = np.random.default_rng(6)
    valid = [rng.random(400) < 0.8, rng.random(400) < 0.8]
    batches = _split((idx, preds, target), [400])
    jt, tt = _insert_both(32, 16, batches, valid=valid, n_valid=[400, 317])
    _same(jt, tt)
    _same_layouts(jt, tt)


def test_chunking_invariance_in_the_window():
    """Inside the window the table's layout does not depend on how the
    stream was cut into updates (nor on the chunk boundaries); only which
    row holds which query does."""
    arrays = _stream(seed=7, n_docs=3000, n_queries=100)
    one = ttable.retrieval_table_insert(
        ttable.retrieval_table_init(128, 64, device="cpu"), *(torch.from_numpy(a) for a in arrays)
    )
    _, many = _insert_both(128, 64, _split(arrays, [1, 777, 2100, 2101]))
    for a, b in zip(ttable.retrieval_table_layout(one), ttable.retrieval_table_layout(many)):
        assert torch.equal(a, b)


@pytest.mark.parametrize(
    "max_queries,max_docs,seed",
    [(64, 32, 8), (16, 8, 9), (24, 4, 10)],
    ids=["window", "doc_overflow", "both"],
)
def test_merge_bitwise(max_queries, max_docs, seed):
    """Two sides sharing queries: the same-query fold (top-cap by score past
    capacity) and the reservoir over the union, against the JAX merge and
    through the merge_like reducer that merge_states folds."""
    a_arr = _stream(seed=seed, n_docs=400, n_queries=30)
    b_arr = _stream(seed=seed + 100, n_docs=500, n_queries=30)
    ja, ta = _insert_both(max_queries, max_docs, [a_arr])
    jb, tb = _insert_both(max_queries, max_docs, [b_arr])
    jm = jtable.retrieval_table_merge(ja, jb)
    tm = ttable.retrieval_table_merge(ta, tb)
    _same(jm, tm)
    _same_layouts(jm, tm)
    _same(jtable.retrieval_table_merge_fx()(jnp.stack([ja, jb, ja])), ttable.retrieval_table_merge_fx()(torch.stack([ta, tb, ta])))
    fx = ttable.retrieval_table_merge_fx()
    assert fx.merge_like and fx.sketch_kind == "retrieval_table"
    assert torch.equal(fx(ta), ta)


def test_merge_in_window_equals_single_stream():
    arrays = _stream(seed=11, n_docs=600, n_queries=40)
    a, b = _split(arrays, [300])
    _, ta = _insert_both(64, 32, [a])
    _, tb = _insert_both(64, 32, [b])
    _, whole = _insert_both(64, 32, [arrays])
    merged = ttable.retrieval_table_merge(ta, tb)
    for m, w in zip(ttable.retrieval_table_layout(merged), ttable.retrieval_table_layout(whole)):
        assert torch.equal(m, w)


EDGE_IDS = [
    0, 1, -1, 2, -2, 255, 256, 2**16 - 1, 2**16, 2**24 - 1, 2**24, 2**24 + 1,
    2**31 - 1, -(2**31), -(2**31) + 1, -(2**24), 0x7EADBEEF, -0x12345678,
]


@pytest.mark.parametrize("kind", ["edge", "random"])
def test_qid_hash_and_split_bitwise(kind):
    if kind == "edge":
        ids = np.array(EDGE_IDS, np.int32)
    else:
        ids = np.random.default_rng(12).integers(-(2**31), 2**31, 20000, dtype=np.int64).astype(np.int32)
    t = torch.from_numpy(ids)
    _same(jtable._qid_key(jnp.asarray(ids)), ttable._qid_key(t))
    jhi, jlo = jtable._split_qid(jnp.asarray(ids))
    thi, tlo = ttable._split_qid(t)
    _same(jhi, thi)
    _same(jlo, tlo)
    _same(jtable._join_qid(jhi, jlo), ttable._join_qid(thi, tlo))
    assert torch.equal(ttable._join_qid(thi, tlo), t)


def test_int64_ids_past_2_31_wrap_as_in_jax():
    """int64 ids become int32 (two's complement), as the JAX package's
    ``jnp.asarray(..., jnp.int32)`` makes them."""
    ids64 = np.array([2**31, 2**32 + 5, 2**33 - 1, -(2**31) - 1, 7], np.int64)
    preds = np.linspace(0, 1, 5).astype(np.float32)
    target = np.array([1, 0, 1, 0, 1], np.float32)
    jt = jtable.retrieval_table_insert(jtable.retrieval_table_init(8, 4), jnp.asarray(ids64), preds, target)
    tt = ttable.retrieval_table_insert(
        ttable.retrieval_table_init(8, 4, device="cpu"), torch.from_numpy(ids64), torch.from_numpy(preds), torch.from_numpy(target)
    )
    _same(jt, tt)
    got = ttable.retrieval_table_layout_rows(tt, torch.arange(8))[-1]
    assert sorted(got[tt[:, 0] > 0].tolist()) == sorted(ids64.astype(np.int32).tolist())


def test_geometry_checks():
    with pytest.raises(ValueError, match="max_queries"):
        ttable.retrieval_table_init(0, 4, device="cpu")
    with pytest.raises(ValueError, match="max_docs"):
        ttable.retrieval_table_init(4, 1, device="cpu")
    with pytest.raises(ValueError, match="not a retrieval table"):
        ttable.table_capacity(torch.zeros(4, 8))
    with pytest.raises(ValueError, match="cannot merge"):
        ttable.retrieval_table_merge(torch.zeros(4, 11), torch.zeros(4, 13))
    assert ttable.table_capacity(ttable.retrieval_table_init(5, 6, device="cpu")) == (5, 6)
