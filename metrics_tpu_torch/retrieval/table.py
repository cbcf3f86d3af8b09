"""Fixed-capacity per-query retrieval state table (one packed leaf).

Counterpart of ``metrics_tpu/retrieval/table.py``. The retrieval metrics'
default state is one

    ``[max_queries, 7 + 2 * max_docs]`` float32

tensor in which each ROW holds one query's documents and exact per-query
counters:

    0: KEY   deterministic reservoir key in (0, 1] hashed from the query
             id (0 = empty row)
    1: QHI   query id bits 24..31   (uint32 split, exact in float32)
    2: QLO   query id bits 0..23
    3: NSEEN total documents seen for this query (exact counter)
    4: POS   sum of target over ALL seen documents
    5: NEG   count of ``target == 0`` documents seen (FallOut's empty policy)
    6: FILL  documents currently stored in the slot region
    7            .. 7+max_docs-1:   stored preds
    7+max_docs   .. 7+2*max_docs-1: stored targets

**Row policy.** Every query id hashes to a fixed KEY; the rows are always
the ``max_queries`` largest ``(KEY, -qid)`` priorities among every query
seen, so the sampled query set is a pure function of the ids, whatever the
order and batching of the stream. **Doc policy.** Documents append into
free slots in arrival order; when a row would overflow, its stored and
incoming documents compact to the top ``max_docs // 2`` by score through
the per-row top-k kernel (:func:`metrics_tpu_torch.ops.row_topk`), while
NSEEN/POS/NEG stay exact. Inside the lossless window (distinct queries <=
``max_queries``, documents per query <= ``max_docs``) the table holds the
exact stream and unpacks to ``pack_queries``'s layout.

The arithmetic is the JAX package's, bit for bit: counters, stored scores
and targets are integers or copies, and every sort is a stable sort of
exact keys. Where JAX branches with ``lax.cond(any(over), ...)`` and then
keeps the compacted rows with ``where(over, ...)``, the port launches the
top-k kernel on every chunk over a fixed ``min(max_queries, 2048)`` rows
that hold every overflowing one, with ``over`` as its row mask, so only the
overflowing rows sort and no insert reads the card (on the CPU, where the
read is free, only the overflowing rows are widened at all). The counters go
through the segment-sum kernel (three launches per chunk). Scatters whose
JAX form drops out-of-range indices write into one extra slot that is then
cut off; their live indices are unique, so they are deterministic.
"""
from typing import Any, Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.ops.row_topk import row_topk
from metrics_tpu_torch.ops.segment_sum import segment_sum_dispatch
from metrics_tpu_torch.sketches.reservoir import _U32, reservoir_key
from metrics_tpu_torch.utils.checks import checks_read_nothing
from metrics_tpu_torch.utils.data import _resolve_device

Tensor = torch.Tensor

#: column layout (see module docstring)
COL_KEY, COL_QHI, COL_QLO, COL_NSEEN, COL_POS, COL_NEG, COL_FILL = range(7)
#: number of metadata columns before the preds/targets slot regions
META_COLS = 7

#: finite stand-in for +/-inf so stored scores always beat the -inf empty
#: sentinel in top-k selection (float32(3.4e38), as in the JAX package)
_FMAX = 3.4e38
_I32_MAX = 2**31 - 1

#: docs absorbed per fixed-shape chunk, counted from each insert's start
#: (the chunk boundaries decide nothing inside the window, and only which
#: documents compete in a compaction past it)
_INSERT_CHUNK = 2048


def table_capacity(table: Tensor) -> Tuple[int, int]:
    """``(max_queries, max_docs)`` encoded in the leaf's shape."""
    q, c = table.shape
    if c < META_COLS + 2 or (c - META_COLS) % 2:
        raise ValueError(f"not a retrieval table leaf: shape {tuple(table.shape)}")
    return q, (c - META_COLS) // 2


def retrieval_table_init(max_queries: int, max_docs: int, device: Optional[Any] = None) -> Tensor:
    """Fresh empty table leaf ``[max_queries, 7 + 2 * max_docs]`` on
    ``device`` (the card unless ``device="cpu"``)."""
    if not (isinstance(max_queries, int) and max_queries > 0):
        raise ValueError(f"`max_queries` must be a positive int, got {max_queries!r}")
    if not (isinstance(max_docs, int) and max_docs >= 2):
        raise ValueError(f"`max_docs` must be an int >= 2, got {max_docs!r}")
    return torch.zeros((max_queries, META_COLS + 2 * max_docs), dtype=torch.float32, device=_resolve_device(device))


def _retain(max_docs: int) -> int:
    """Docs kept per row by an overflow compaction (top-k by score)."""
    return max(1, max_docs // 2)


def _qid_key(qid: Tensor) -> Tensor:
    """Deterministic per-query reservoir key in ``(0, 1]`` (24-bit
    granularity, exact in float32; hash collisions tie-break on the id):
    the reservoir's hash of the id taken as uint32."""
    return reservoir_key(qid)


def _split_qid(qid: Tensor) -> Tuple[Tensor, Tensor]:
    """int32 id -> (hi, lo) float32 lanes, each exact below 2**24."""
    u = qid.to(torch.int64) & _U32
    return (u >> 24).to(torch.float32), (u & 0xFFFFFF).to(torch.float32)


def _join_qid(qhi: Tensor, qlo: Tensor) -> Tensor:
    """(hi, lo) float32 lanes -> the original int32 id (two's complement)."""
    u = ((qhi.to(torch.int64) << 24) | qlo.to(torch.int64)) & _U32
    return torch.where(u > _I32_MAX, u - (1 << 32), u).to(torch.int32)


def _lexsort(keys: Sequence[Tensor]) -> Tensor:
    """``jnp.lexsort``: the indices that sort by the LAST key, then the one
    before it, ..., ties kept in index order. Successive stable sorts,
    last key last; float keys have ``-0.0`` made ``+0.0`` first so that the
    two zeros tie on every device."""
    order = None
    for key in keys:
        if key.is_floating_point():
            key = key + 0.0
        k = key if order is None else key[order]
        step = torch.sort(k, stable=True).indices
        order = step if order is None else order[step]
    return order


def _scatter_drop(dst: Tensor, index: Tensor, src: Tensor) -> Tensor:
    """``dst.at[index].set(src, mode="drop")`` along dim 0 for indices in
    ``[0, len(dst)]`` (``len(dst)`` drops); a new tensor."""
    n = dst.shape[0]
    ext = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))])
    ext.index_copy_(0, index.to(torch.int64), src.to(dst.dtype))
    return ext[:n]


def _unpack(table: Tensor):
    q, cap = table_capacity(table)
    return (
        table[:, COL_KEY],
        _join_qid(table[:, COL_QHI], table[:, COL_QLO]),
        table[:, COL_NSEEN],
        table[:, COL_POS],
        table[:, COL_NEG],
        table[:, COL_FILL],
        table[:, META_COLS : META_COLS + cap],
        table[:, META_COLS + cap :],
    )


def _pack(key, qid, nseen, pos, neg, fill, preds, target) -> Tensor:
    qhi, qlo = _split_qid(qid)
    meta = torch.stack([key, qhi, qlo, nseen, pos, neg, fill], dim=1)
    return torch.cat([meta, preds, target], dim=1).to(torch.float32)


# ---------------------------------------------------------------------------
# insert
# ---------------------------------------------------------------------------


def _overflow_candidates(over: Tensor, n_docs: int) -> Tensor:
    """``min(num_q, n_docs)`` distinct rows that hold every overflowing one,
    found with no host read. A row's fill never passes ``cap``, so a row
    overflows only where a document of the chunk lands, and ``n_docs``
    documents land in at most ``n_docs`` rows: a stable sort of ``~over``
    puts them first, in row order (a one-byte key: one radix pass)."""
    return torch.argsort((~over).to(torch.uint8), stable=True)[: min(over.shape[0], n_docs)]


def _rows_to_widen(over: Tensor, n_docs: int) -> Tensor:
    """The rows an insert chunk widens for its compaction, a superset of the
    overflowing ones: on the card a fixed :func:`_overflow_candidates` list,
    of which the top-k kernel's row mask sorts only the overflowing rows; on
    the CPU, where reading ``over`` is free, only those (but the fixed list
    under the capture rule of ``utils/checks.py``, as a fused update on the
    card takes it)."""
    if over.is_cuda or checks_read_nothing():
        return _overflow_candidates(over, n_docs)
    return over.nonzero()[:, 0]


def _chunk_insert(table: Tensor, qid: Tensor, preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
    """One chunk (``<= _INSERT_CHUNK`` docs) into the table: a searchsorted
    join of the chunk's query ids against the resident rows, a greedy
    sorted pairing for reservoir admission and eviction, a flat scatter of
    documents into free slots, and the top-k compaction of the rows that
    would overflow."""
    num_q, cap = table_capacity(table)
    keep = _retain(cap)
    b = qid.shape[0]
    device = table.device
    key_t, qid_t, nseen, pos_m, neg_c, fill, pt, tt = _unpack(table)
    occ = key_t > 0

    # ---- chunk segment layout: stable sort by query id, invalid rows last
    pos_i = torch.arange(b, dtype=torch.int64, device=device)
    skey = torch.where(valid, qid, _I32_MAX)
    order = _lexsort((pos_i, skey))
    sq = skey[order]
    sv = valid[order]
    sp = torch.clamp(preds[order].to(torch.float32), -_FMAX, _FMAX)
    st = target[order].to(torch.float32)
    change = torch.cat([torch.ones(1, dtype=torch.bool, device=device), sq[1:] != sq[:-1]])
    seg_start = torch.cummax(torch.where(change, pos_i, 0), dim=0).values
    col = pos_i - seg_start

    # ---- join: which resident row owns each chunk doc's query?
    qkey_t = torch.where(occ, qid_t, _I32_MAX)
    torder = _lexsort(((~occ).to(torch.int32), qkey_t))
    tq_sorted = qkey_t[torder].contiguous()
    occ_sorted = occ[torder]
    loc = torch.clamp(torch.searchsorted(tq_sorted, sq.contiguous(), side="left"), 0, num_q - 1)
    matched = (tq_sorted[loc] == sq) & occ_sorted[loc] & sv
    match_row = torch.where(matched, torder[loc], -1)

    # ---- reservoir admission: distinct unmatched queries vs resident rows
    is_cand = change & sv & ~matched
    ckey = torch.where(is_cand, _qid_key(sq), 0.0)
    cand_order = _lexsort((sq, -ckey))  # priority desc: key desc, qid asc
    cq = sq[cand_order]
    ck = ckey[cand_order]
    # resident rows ascending by priority (KEY, -qid): free rows first, then
    # occupied rows from the smallest key up; the larger id loses a key tie
    neg_qid = torch.bitwise_not(qid_t)
    row_order = _lexsort((neg_qid, key_t))
    n_pair = min(b, num_q)
    rslots = row_order[:n_pair]
    rkey = key_t[rslots]
    rqid = qid_t[rslots]
    ckp, cqp = ck[:n_pair], cq[:n_pair]
    beats = (ckp > rkey) | ((ckp == rkey) & (cqp < rqid))
    accept = (ckp > 0) & ((rkey <= 0) | beats)
    target_row = torch.where(accept, rslots, num_q)  # num_q: a dropped scatter

    # evicted/admitted rows restart fresh with the new query's identity
    key_t = _scatter_drop(key_t, target_row, ckp)
    qhi_new, qlo_new = _split_qid(cqp)
    qhi_t, qlo_t = _split_qid(qid_t)
    qid_t = _join_qid(_scatter_drop(qhi_t, target_row, qhi_new), _scatter_drop(qlo_t, target_row, qlo_new))
    zeros_pair = torch.zeros(n_pair, dtype=torch.float32, device=device)
    nseen = _scatter_drop(nseen, target_row, zeros_pair)
    pos_m = _scatter_drop(pos_m, target_row, zeros_pair)
    neg_c = _scatter_drop(neg_c, target_row, zeros_pair)
    fill = _scatter_drop(fill, target_row, zeros_pair)

    # the accepted candidate at sorted position p carries its row to every
    # doc of its group
    admit_row = torch.full((b,), -1, dtype=torch.int64, device=device)
    admit_row[cand_order[:n_pair]] = torch.where(accept, rslots, -1)
    # a row evicted in this chunk belongs to its new query now: docs of the
    # evicted query must drop, not land in the new owner's slots
    evicted = _scatter_drop(torch.zeros(num_q, dtype=torch.int32, device=device), target_row, accept) > 0
    still_owned = matched & ~evicted[torch.clamp(match_row, 0, num_q - 1)]
    row_doc = torch.where(still_owned, match_row, admit_row[seg_start])
    row_doc = torch.where(sv & (row_doc >= 0), row_doc, num_q)  # num_q drops

    # ---- exact per-query counters (K1's float form, out-of-range ids drop)
    live = row_doc < num_q
    ones = live.to(torch.float32)
    n_inc = segment_sum_dispatch(ones, row_doc, num_q)
    nseen = nseen + n_inc
    pos_m = pos_m + segment_sum_dispatch(torch.where(live, st, 0.0), row_doc, num_q)
    neg_c = neg_c + segment_sum_dispatch((live & (st == 0)).to(torch.float32), row_doc, num_q)

    # ---- document append: flat scatter into each row's free slots
    row_c = torch.clamp(row_doc, 0, num_q - 1)
    slot = fill[row_c].to(torch.int64) + col
    flat = torch.where(live & (slot < cap), row_c * cap + slot, num_q * cap)
    p_app = _scatter_drop(pt.reshape(-1), flat, sp).reshape(num_q, cap)
    t_app = _scatter_drop(tt.reshape(-1), flat, st).reshape(num_q, cap)
    fill_app = torch.clamp(fill + n_inc, max=float(cap))

    # ---- overflow: a row's stored slots followed by this chunk's docs in
    # scratch columns (col < chunk size), the best `keep` of it kept
    over = fill + n_inc > cap
    rows = _rows_to_widen(over, b)
    n_rows, width = rows.shape[0], cap + b
    place = torch.full((num_q,), n_rows, dtype=torch.int64, device=device)
    place[rows] = torch.arange(n_rows, device=device)
    dest = place[row_c]
    wflat = torch.where(live & (dest < n_rows), dest * width + cap + col, n_rows * width)
    iota = torch.arange(cap, dtype=torch.float32, device=device)[None, :]
    wide = []
    for stored, docs in ((pt, sp), (tt, st), ((iota < fill[:, None]).to(torch.float32), ones)):
        flat_rows = torch.zeros(n_rows * width + 1, dtype=torch.float32, device=device)
        flat_rows[:-1].view(n_rows, width)[:, :cap] = stored[rows]
        flat_rows.index_copy_(0, wflat, docs)
        wide.append(flat_rows[:-1].view(n_rows, width))
    top_p, top_t, _ = row_topk(*wide, keep, rows=over[rows])
    p_k = torch.zeros((num_q, cap), dtype=torch.float32, device=device)
    t_k = torch.zeros((num_q, cap), dtype=torch.float32, device=device)
    p_k[rows, :keep] = top_p
    t_k[rows, :keep] = top_t
    f_k = torch.clamp(fill + n_inc, max=float(keep))
    sel = over[:, None]
    p_new = torch.where(sel, p_k, p_app)
    t_new = torch.where(sel, t_k, t_app)
    fill_new = torch.where(over, f_k, fill_app)
    return _pack(key_t, qid_t, nseen, pos_m, neg_c, fill_new, p_new, t_new)


def retrieval_table_insert(
    table: Tensor,
    indexes: Tensor,
    preds: Tensor,
    target: Tensor,
    valid: Optional[Tensor] = None,
    n_valid: Optional[Any] = None,
) -> Tensor:
    """Insert a batch of ``(query id, pred, target)`` documents; pure (the
    table is not modified). ``valid`` masks rows out entirely (the
    ``ignore_index`` contract); ``n_valid`` masks trailing pad rows. Batches
    larger than one chunk are absorbed in chunks of ``_INSERT_CHUNK``."""
    device = table.device
    indexes = torch.as_tensor(indexes, device=device).reshape(-1).to(torch.int32)
    preds = torch.as_tensor(preds, device=device).reshape(-1).to(torch.float32)
    target = torch.as_tensor(target, device=device).reshape(-1).to(torch.float32)
    b = indexes.shape[0]
    v = (
        torch.ones(b, dtype=torch.bool, device=device)
        if valid is None
        else torch.as_tensor(valid, device=device).reshape(-1).to(torch.bool)
    )
    if n_valid is not None:
        v = v & (torch.arange(b, device=device) < torch.as_tensor(n_valid, device=device))
    for lo in range(0, b, _INSERT_CHUNK):
        hi = lo + _INSERT_CHUNK
        table = _chunk_insert(table, indexes[lo:hi], preds[lo:hi], target[lo:hi], v[lo:hi])
    return table


# ---------------------------------------------------------------------------
# merge (dist_reduce_fx)
# ---------------------------------------------------------------------------


def _merge_impl(a: Tensor, b: Tensor) -> Tensor:
    num_q, cap = table_capacity(a)
    device = a.device
    rows = torch.cat([a, b], dim=0)  # rank order: a's rows first
    key, qid, nseen, pos_m, neg_c, fill, pt, tt = _unpack(rows)
    occ = key > 0
    n2 = 2 * num_q

    # sort by query id (occupied first, original order as tiebreak) so
    # duplicate queries -- one on each side -- become adjacent pairs, the
    # a-side row first
    qkey = torch.where(occ, qid, _I32_MAX)
    order = _lexsort((torch.arange(n2, dtype=torch.int32, device=device), qkey, (~occ).to(torch.int32)))
    key, qid, nseen, pos_m, neg_c, fill = (x[order] for x in (key, qid, nseen, pos_m, neg_c, fill))
    pt, tt = pt[order], tt[order]
    occ = key > 0
    no = torch.zeros(1, dtype=torch.bool, device=device)
    dup_next = torch.cat([occ[1:] & occ[:-1] & (qid[1:] == qid[:-1]), no])
    is_dup = torch.cat([no, dup_next[:-1]])

    # fold the duplicate partner into its primary: docs concatenate in rank
    # (a-then-b) order, the gather-concat order of the exact mode
    nxt = torch.clamp(torch.arange(n2, device=device) + 1, max=n2 - 1)
    part_fill = torch.where(dup_next, fill[nxt], 0.0)
    dn = dup_next[:, None]
    wide_p = torch.cat([pt, torch.where(dn, pt[nxt], 0.0)], dim=1)
    wide_t = torch.cat([tt, torch.where(dn, tt[nxt], 0.0)], dim=1)
    iota = torch.arange(cap, dtype=torch.float32, device=device)[None, :]
    wide_v = torch.cat(
        [
            (iota < fill[:, None]).to(torch.float32),
            torch.where(dn, (iota < part_fill[:, None]).to(torch.float32), 0.0),
        ],
        dim=1,
    )
    f_comb = fill + part_fill

    # arrival-order repack (valid slots first, a-side columns before b-side):
    # exact while the combined docs fit
    slots = torch.arange(2 * cap, dtype=torch.float32, device=device)[None, :]
    arr_key = torch.where(wide_v > 0, slots, float(4 * cap))
    arr_order = torch.sort(arr_key, dim=1, stable=True).indices[:, :cap]
    packed_p = wide_p.gather(1, arr_order)
    packed_t = wide_t.gather(1, arr_order)

    # past capacity: the top `cap` by score of each overflowing row
    over = f_comb > cap
    top_p, top_t, _ = row_topk(wide_p, wide_t, wide_v, cap, rows=over)
    packed_p = torch.where(over[:, None], top_p, packed_p)
    packed_t = torch.where(over[:, None], top_t, packed_t)
    fill = torch.clamp(f_comb, max=float(cap))
    nseen = nseen + torch.where(dup_next, nseen[nxt], 0.0)
    pos_m = pos_m + torch.where(dup_next, pos_m[nxt], 0.0)
    neg_c = neg_c + torch.where(dup_next, neg_c[nxt], 0.0)
    # absorbed partners leave the row set
    key = torch.where(is_dup, 0.0, key)

    # reservoir: the top-num_q (KEY, -qid) priorities of the union (key
    # descending, qid ascending on ties: the insert's order)
    keep_order = _lexsort((qid, -key))[:num_q]
    return _pack(
        key[keep_order],
        qid[keep_order],
        nseen[keep_order],
        pos_m[keep_order],
        neg_c[keep_order],
        fill[keep_order],
        packed_p[keep_order],
        packed_t[keep_order],
    )


def retrieval_table_merge(a: Tensor, b: Tensor) -> Tensor:
    """Merge two tables of one geometry (``dist_reduce_fx`` material):
    same-query rows fold doc-wise in rank order (top-``cap`` by score past
    capacity), distinct queries compete through the key reservoir. Exact,
    and equal to the exact mode's gather, while the union fits."""
    if a.shape != b.shape:
        raise ValueError(f"cannot merge retrieval tables with layouts {tuple(a.shape)} and {tuple(b.shape)}")
    return _merge_impl(a, b)


class _RetrievalTableReduce:
    """``dist_reduce_fx`` for retrieval-table leaves: folds
    :func:`retrieval_table_merge` over the stacked per-rank leaves
    ``[world, Q, C]`` in rank order. A module-level class (so metrics
    holding it pickle), tagged ``merge_like`` for ``Metric.merge_states``."""

    merge_like = True
    sketch_kind = "retrieval_table"
    __name__ = "retrieval_table_reduce"

    def __call__(self, stacked: Tensor) -> Tensor:
        if stacked.ndim == 2:  # a single rank passes through
            return stacked
        out = stacked[0]
        for i in range(1, stacked.shape[0]):
            out = retrieval_table_merge(out, stacked[i])
        return out


_TABLE_REDUCE = _RetrievalTableReduce()


def retrieval_table_merge_fx() -> _RetrievalTableReduce:
    """The shared retrieval-table ``dist_reduce_fx``."""
    return _TABLE_REDUCE


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------


def retrieval_table_fill(table: Tensor) -> Tensor:
    """Occupied query rows (int32 scalar)."""
    return (table[:, COL_KEY] > 0).sum().to(torch.int32)


def _layout_of(table_rows: Tensor):
    key, qid, nseen, pos_m, neg_c, fill, pt, tt = _unpack(table_rows)
    occ = key > 0
    slots = torch.arange(pt.shape[1], dtype=torch.float32, device=pt.device)[None, :]
    mask = (slots < fill[:, None]) & occ[:, None]
    padded_preds = torch.where(mask, pt, -torch.inf)
    padded_target = torch.where(mask, tt, 0.0)
    return padded_preds, padded_target, mask, occ, pos_m, neg_c, nseen, qid


def retrieval_table_layout(table: Tensor):
    """Unpack to the padded compute layout, rows ordered by ascending query
    id (the ``pack_queries`` order):

    ``(padded_preds [Q, cap], padded_target [Q, cap], mask [Q, cap],
    row_valid [Q], pos_mass [Q], neg_count [Q], n_seen [Q])``

    Padding slots carry ``preds=-inf``, ``target=0``, ``mask=False``."""
    occ = table[:, COL_KEY] > 0
    qid = _join_qid(table[:, COL_QHI], table[:, COL_QLO])
    order = _lexsort((qid, (~occ).to(torch.int32)))
    return _layout_of(table[order])[:7]


def retrieval_table_layout_rows(table: Tensor, rows: Any):
    """Subset unpack: the padded layout of just ``table[rows]``, in the
    caller's order (row ``i`` of every output is table row ``rows[i]``,
    each equal to its row in :func:`retrieval_table_layout`), plus a
    trailing ``qid [n]``:

    ``(padded_preds, padded_target, mask, row_valid, pos_mass, neg_count,
    n_seen, qid)``"""
    rows = torch.as_tensor(rows, device=table.device).to(torch.int64).reshape(-1)
    return _layout_of(table[rows])
