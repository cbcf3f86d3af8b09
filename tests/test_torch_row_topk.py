"""The port's per-row top-k (K4) against the JAX package's, on the CPU.

* The plain version (what CPU tensors take, and what the CUDA kernel is
  held to on the card) against ``_row_topk_jnp``, the JAX package's CPU
  route: bit for bit, keys, payload and validity, on ties, NaN of either
  sign, signed zeros, infinities, invalid slots, rows with fewer than k
  valid slots and k above N.
* The ``rows`` mask against what the retrieval table makes of the JAX
  route: the selected rows' top-k, ``(-inf, 0, 0)`` elsewhere.
* Against the interpret-mode Pallas kernel ``row_topk_tiled`` on NaN-free
  rows, bit for bit; on a NaN row that kernel's network breaks, which
  ``test_interpret_kernel_breaks_on_nan`` pins.
* The routing, the launch geometry and the launcher's C signature.
"""
import ctypes
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.ops.topk_pallas import _row_topk_jnp, row_topk_tiled
from metrics_tpu_torch import ops
from metrics_tpu_torch.ops import build as kernel_build
from tests.test_torch_qsketch import sort_shared_emulated

# the module (the package's `row_topk` attribute is the entry-point function)
row_topk_module = importlib.import_module("metrics_tpu_torch.ops.row_topk")

torch.set_num_threads(2)

NAN = float("nan")
INF = float("inf")


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _assert_same(want, got):
    for w, g, name in zip(want, got, ("keys", "payload", "valid")):
        np.testing.assert_array_equal(_bits(w), _bits(g.numpy()), err_msg=name)


def _hard_rows(rng, r, n, nan_share=0.1):
    """Quantized scores (ties), NaN of both signs, signed zeros, +-inf,
    about 30% invalid slots, some rows with fewer valid slots than k."""
    preds = (rng.integers(-3, 4, (r, n)) / 2.0).astype(np.float32)
    pick = rng.random((r, n))
    preds[pick < nan_share] = np.float32(NAN)
    preds[(pick >= nan_share) & (pick < nan_share + 0.03)] = -np.float32(NAN)
    preds[(pick >= 0.2) & (pick < 0.25)] = -0.0
    preds[(pick >= 0.25) & (pick < 0.27)] = INF
    preds[(pick >= 0.27) & (pick < 0.29)] = -INF
    valid = (rng.random((r, n)) < 0.7).astype(np.float32)
    valid[0, 2:] = 0  # a row with two valid slots
    payload = rng.integers(0, 100, (r, n)).astype(np.float32)
    return preds, payload, valid


def _port(preds, payload, valid, k, rows=None):
    args = [torch.from_numpy(x) for x in (preds, payload, valid)]
    return ops.row_topk(*args, k, rows=None if rows is None else torch.from_numpy(rows))


@pytest.mark.parametrize("r,n,k", [(1, 2, 1), (8, 100, 5), (20, 300, 7), (65, 257, 32), (3, 16, 16), (5, 9, 20)])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jnp_bitwise(r, n, k, seed):
    preds, payload, valid = _hard_rows(np.random.default_rng(seed), r, n)
    _assert_same(_row_topk_jnp(preds, payload, valid, k), _port(preds, payload, valid, k))


def test_nan_signed_zero_and_invalid_order():
    """The order the JAX package's CPU route gives: -0.0 ties +0.0 in column
    order, NaN of either sign after -inf (and after invalid slots), an
    invalid slot keeps its own payload and validity."""
    preds = np.array([[NAN, 1.0, -INF, 5.0, -NAN, 0.0, 2.0, 3.0]], np.float32)
    valid = np.array([[1, 1, 1, 0, 1, 1, 0, 1]], np.float32)
    payload = np.arange(8, dtype=np.float32)[None, :]
    want = _row_topk_jnp(preds, payload, valid, 8)
    got = _port(preds, payload, valid, 8)
    _assert_same(want, got)
    keys, pay, val = (x.numpy()[0] for x in got)
    np.testing.assert_array_equal(keys[:6], [3, 1, 0, -INF, -INF, -INF])
    assert np.isnan(keys[6:]).all()
    np.testing.assert_array_equal(pay, [7, 1, 5, 2, 3, 6, 0, 4])
    np.testing.assert_array_equal(val[3:6], [1, 0, 0])  # slot 3 comes back as (-inf, 3, 0)
    # -0.0 and +0.0 tie in column order, and keep their bits
    zeros = np.array([[0.0, -0.0, 0.0, -0.0]], np.float32)
    ones = np.ones_like(zeros)
    _assert_same(_row_topk_jnp(zeros, ones * np.arange(4), ones, 4), _port(zeros, ones * np.arange(4), ones, 4))


def test_order_key_is_the_stable_sort_of_negated_keys():
    preds, _, valid = _hard_rows(np.random.default_rng(3), 16, 200, nan_share=0.2)
    keys = torch.where(torch.from_numpy(valid) > 0, torch.from_numpy(preds), -torch.inf)
    want = torch.sort(-keys, dim=-1, stable=True).indices
    got = torch.sort(row_topk_module.descending_order_key(keys), dim=-1, stable=True).indices
    assert torch.equal(want, got)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rows_mask_equals_the_masked_jnp_route(seed):
    """Rows outside the mask come back as (-inf, 0, 0); the rest equal the
    JAX route's top-k of the same rows (the table keeps only those, as its
    ``jnp.where(over, top, ...)`` does)."""
    rng = np.random.default_rng(seed)
    preds, payload, valid = _hard_rows(rng, 40, 70)
    rows = rng.random(40) < 0.3
    rows[0] = True
    k = 12
    full = [np.asarray(x) for x in _row_topk_jnp(preds, payload, valid, k)]
    fill = (-INF, 0.0, 0.0)
    want = [np.where(rows[:, None], x, np.float32(f)) for x, f in zip(full, fill)]
    _assert_same(want, _port(preds, payload, valid, k, rows=rows))
    none = _port(preds, payload, valid, k, rows=np.zeros(40, bool))
    _assert_same([np.full((40, k), f, np.float32) for f in fill], none)


@pytest.mark.parametrize("r,n,k", [(8, 100, 5), (20, 300, 7), (5, 9, 20)])
def test_plain_matches_interpret_kernel_on_nan_free_rows(r, n, k):
    rng = np.random.default_rng(r * n)
    preds, payload, valid = _hard_rows(rng, r, n, nan_share=0.0)
    preds[np.isnan(preds)] = 0.5
    want = row_topk_tiled(preds, payload, valid, k, interpret=True)
    _assert_same(want, _port(preds, payload, valid, k))


def test_interpret_kernel_breaks_on_nan():
    """The interpret-mode kernel's compare-exchange (``<``/``>``) is false
    against NaN, so a NaN stays where the network left it instead of sorting
    last; the port follows ``_row_topk_jnp`` instead."""
    preds = np.array([[0.5, 2.0, NAN, 1.0, 0.5, -1.0, 0.25, 3.0]], np.float32)
    ones = np.ones_like(preds)
    got = np.asarray(row_topk_tiled(preds, ones, ones, 8, interpret=True)[0])[0]
    want = np.asarray(_row_topk_jnp(preds, ones, ones, 8)[0])[0]
    np.testing.assert_array_equal(want[:7], [3, 2, 1, 0.5, 0.5, 0.25, -1])
    assert np.isnan(want[7])
    assert not np.isnan(got[7])  # the NaN is not last
    _assert_same((want,), (torch.from_numpy(np.asarray(_port(preds, ones, ones, 8)[0])[0]),))


def test_arguments_are_checked():
    x = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="positive int"):
        ops.row_topk(x, x, x, 0)
    with pytest.raises(ValueError, match=r"\[rows, cols\]"):
        ops.row_topk(x[0], x[0], x[0], 2)
    with pytest.raises(ValueError, match="one shape"):
        ops.row_topk(x, x[:, :3], x, 2)
    with pytest.raises(ValueError, match="bool mask"):
        ops.row_topk(x, x, x, 2, rows=torch.ones(3))
    with pytest.raises(ValueError, match="CUDA kernel"):
        ops.row_topk_f32(x, x, x, 2)


def test_launch_counter_and_geometry(monkeypatch):
    """With the card faked (the launch recorded instead of made), the
    wrapper counts one launch under ``row_topk`` and passes its plan: the
    padded survivor count, the select grid (at most the rows, and as many
    blocks as the SMs hold by their threads and shared memory), 64 threads a
    block for rows up to 1024 wide, the key cache up to 16384 columns and a
    scratch buffer only past 8192 survivors; the CPU route counts none."""
    calls = []

    def fake_launch(kernel, lib, device, fn, *args):
        calls.append((kernel, args[4:11], args[11] is not None))
        ops.count_launch(kernel)

    monkeypatch.setattr(row_topk_module, "check_cuda", lambda *args: None)
    monkeypatch.setattr(row_topk_module, "_launcher", lambda: (None, "row_topk_f32"))
    monkeypatch.setattr(row_topk_module, "_sm_count", lambda device: 132)
    monkeypatch.setattr(row_topk_module, "launch", fake_launch)
    ops.reset_launch_counts()
    x = torch.zeros(3, 2176)
    assert [t.shape for t in ops.row_topk_f32(x, x, x, 64, rows=torch.ones(3, dtype=torch.bool))] == [(3, 64)] * 3
    w = torch.zeros(2, 40000)
    ops.row_topk_f32(w, w, w, 10)
    ops.row_topk_f32(w, w, w, 20000)
    big = torch.zeros(2048, 2176)
    ops.row_topk_f32(big, big, big, 64)
    narrow = torch.zeros(4096, 256)
    ops.row_topk_f32(narrow, narrow, narrow, 128)
    assert ops.row_topk_f32(x[:0], x[:0], x[:0], 4)[0].shape == (0, 4)
    assert ops.launch_counts()["row_topk"] == 5
    assert calls == [
        ("row_topk", (3, 2176, 64, 64, 3, 256, 1), False),
        ("row_topk", (2, 40000, 10, 16, 2, 256, 0), False),
        ("row_topk", (2, 40000, 20000, 32768, 2, 256, 0), True),
        ("row_topk", (2048, 2176, 64, 64, 1056, 256, 1), False),
        ("row_topk", (4096, 256, 128, 128, 3300, 64, 1), False),
    ]
    monkeypatch.undo()
    ops.reset_launch_counts()
    ops.row_topk(x, x, x, 3)
    assert not any(ops.launch_counts().values())


_C_TYPES = {
    "const void*": ctypes.c_void_p,
    "void*": ctypes.c_void_p,
    "long long": ctypes.c_longlong,
    "int": ctypes.c_int,
}


def test_ctypes_signature_matches_the_c_launcher():
    """The launcher's parameters (the stream last) match the ctypes argtypes
    its wrapper declares: a missing one would hand the kernel a truncated
    pointer. The plan's constants are the kernel's and the shared header's,
    and every kernel the wrapper names for profilers is one of them."""
    csrc = Path(row_topk_module.__file__).parent.parent / "csrc"
    source = (csrc / row_topk_module.SOURCE).read_text()
    extern = source[source.index('extern "C" {') :]
    for name, argtypes in row_topk_module._SIGNATURES.items():
        params = re.search(rf"int {name}\(([^)]*)\)", extern).group(1)
        c_types = [re.sub(r"\s*\w+$", "", p.strip()) for p in params.split(",")]
        assert [_C_TYPES[t] for t in c_types] == list(argtypes), name
        assert c_types[-1] == "void*"  # the stream
    # the tile the wrapper's plan assumes is the shared header's
    header = (csrc / "bitonic.cuh").read_text()
    assert '#include "bitonic.cuh"' in source and "bitonic::kTile" in source
    assert f"kTile = {row_topk_module.TILE};" in header
    assert f"kThreads = {row_topk_module.THREADS};" in source
    assert f"kCacheKeys = {row_topk_module.CACHE_KEYS};" in source
    assert f"kSharedSort = {row_topk_module.SHARED_SORT};" in source
    assert f"kRankMax = {row_topk_module.RANK_MAX};" in source
    assert f"kRankOut = {row_topk_module.RANK_OUT};" in source
    assert f"threads != (n <= {row_topk_module.NARROW_COLS} ? {row_topk_module.NARROW_THREADS} : kThreads)" in source
    for kernel in row_topk_module.CUDA_KERNELS:
        assert re.search(rf"__global__ void(\s+__launch_bounds__\([\w:]+\))?\s+{kernel}\(", source + header), kernel


def test_library_names_follow_the_shared_header(monkeypatch, tmp_path):
    """Both sorting sources include bitonic.cuh: editing it renames (so
    rebuilds) both libraries, and editing one source renames only its own."""
    csrc = Path(row_topk_module.__file__).parent.parent / "csrc"
    for path in csrc.glob("*.cu*"):
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(kernel_build, "CSRC_DIR", tmp_path)
    sources = ("row_topk.cu", "qsketch.cu", "segment_sum.cu")
    before = {name: kernel_build.library_path(name) for name in sources}
    for name in sources[:2]:
        assert '#include "bitonic.cuh"' in (tmp_path / name).read_text()
    with open(tmp_path / "bitonic.cuh", "a") as f:
        f.write("// edited\n")
    edited = {name: kernel_build.library_path(name) for name in sources}
    assert all(edited[name] != before[name] for name in sources)
    with open(tmp_path / "row_topk.cu", "a") as f:
        f.write("// edited\n")
    assert kernel_build.library_path("row_topk.cu") != edited["row_topk.cu"]
    assert kernel_build.library_path("qsketch.cu") == edited["qsketch.cu"]


# ---------------------------------------------------------------------------
# the select-then-sort plan and its arithmetic, emulated in numpy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 7, 64, 300, 2176, 16384, 16385, 40000])
def test_select_plan_sizes_for_every_k(n):
    """For k from 1 to n: k survivors padded to the next power of two, the
    keys cached in shared memory up to 16384 columns, the survivors sorted
    in shared memory up to 8192 (padded) and past that in scratch by tiles
    and merges that cover each survivor once; the select grid never exceeds
    the rows, and its shared memory fits a block."""
    ks = range(1, n + 1) if n <= 2176 else sorted({1, 2, 64, 1000, 8192, 8193, n // 2, n - 1, n})
    for k in ks:
        plan = row_topk_module.row_topk_plan(8, n, k, 132)
        assert plan.k == k and plan.k_pad >= k and plan.k_pad < 2 * k and plan.k_pad & (plan.k_pad - 1) == 0
        assert plan.cache == (n <= row_topk_module.CACHE_KEYS)
        assert plan.global_sort == (plan.k_pad > row_topk_module.SHARED_SORT)
        assert plan.smem_bytes == (0 if plan.global_sort else 8 * plan.k_pad) + (4 * n if plan.cache else 0)
        assert plan.smem_bytes <= 227 * 1024 - row_topk_module._STATIC_SMEM
        assert 1 <= plan.blocks <= 8
        assert plan.threads == (row_topk_module.NARROW_THREADS if n <= row_topk_module.NARROW_COLS else row_topk_module.THREADS)
        if plan.global_sort:
            assert plan.scratch_words == 2 * 8 * plan.k_pad
            run = row_topk_module.TILE
            for pass_run, way in plan.merges:
                assert pass_run == run and plan.k_pad % (run * way) == 0
                run *= way
            assert run == plan.k_pad
        else:
            assert plan.scratch_words == 0 and plan.merges == ()
    # the select grid: the blocks the SMs hold by their threads, never more than the rows
    assert row_topk_module.row_topk_plan(2048, 2176, 64, 132).blocks == 132 * 8
    assert row_topk_module.row_topk_plan(5, 2176, 64, 132).blocks == 5


def _desc_keys(preds, valid):
    """The kernel's slot key: the complement of the ascending order-preserving
    bits of where(valid > 0, preds, -inf), -0.0 as +0.0, NaN all ones."""
    key = np.where(valid > 0, preds, -np.inf).astype(np.float32)
    bits = np.where(key == 0, np.float32(0), key).view(np.uint32).astype(np.int64)
    ascending = np.where(bits & 0x80000000, ~bits & 0xFFFFFFFF, bits | 0x80000000)
    return np.where(np.isnan(key), 0xFFFFFFFF, ~ascending & 0xFFFFFFFF).astype(np.int64)


def select_emulated(desc, k, rank_max=row_topk_module.RANK_MAX, threads=row_topk_module.THREADS):
    """``select_row``'s arithmetic: the radix passes (8 bits, until every key
    of the prefix survives or at most ``rank_max`` share it), then the
    survivors from each thread's odd-length run of columns: the keys below
    the prefix, and of those that share it all, the first ``need`` in column
    order, or the ``need`` lowest packed keys (ranked directly)."""
    n = desc.size
    prefix, fixed, need, count = 0, 0, k, n
    for shift in (24, 16, 8, 0):
        if not (need < count and count > rank_max):
            break
        match = (desc & fixed) == prefix
        hist = np.bincount((desc[match] >> shift) & 255, minlength=256)
        digit = int(np.searchsorted(np.cumsum(hist), need))
        prefix |= digit << shift
        fixed |= 0xFF << shift
        need -= int(hist[:digit].sum())
        count = int(hist[digit])
    per = (-(-n // threads)) | 1
    owned = np.zeros(n, np.int64)
    for t in range(threads):
        owned[t * per : min(n, t * per + per)] += 1
    assert (owned == 1).all()  # every column in exactly one thread's run
    top = desc & fixed
    less = np.flatnonzero(top < prefix)
    eq = np.flatnonzero(top == prefix)
    assert eq.size == count and less.size == k - need
    if need < count <= rank_max:
        packed = desc[eq].astype(np.uint64) << np.uint64(32) | eq.astype(np.uint64)
        place = (packed[None, :] < packed[:, None]).sum(axis=1)
        taken = eq[place < need]
    else:
        taken = eq[:need]
    chosen = np.sort(np.concatenate([less, taken]))
    assert chosen.size == k
    return chosen


def _select_rows(rng):
    """Rows that stress the select: the mixed rows of the parity tests, every
    key tied, ties at the threshold, only NaN and -inf, fewer valid slots
    than k, scores spread over one binade (one radix bucket on top)."""
    n = 297
    preds, payload, valid = _hard_rows(rng, 4, n)
    tied = np.full((1, n), 0.5, np.float32)
    steps = (rng.integers(0, 3, (1, n)) / 2).astype(np.float32)
    nan_inf = np.where(rng.random((1, n)) < 0.5, np.float32(NAN), np.float32(-INF))
    nan_inf[0, ::3] = -np.float32(NAN)
    binade = (0.5 + rng.random((1, n)) / 2).astype(np.float32)
    all_preds = np.concatenate([preds, tied, steps, nan_inf, binade])
    all_valid = np.concatenate([valid, np.ones((4, n), np.float32)])
    all_valid[-4, ::2] = 0  # a tied row with invalid slots
    return all_preds, all_valid


@pytest.mark.parametrize("rank_max", [8, row_topk_module.RANK_MAX, row_topk_module.THREADS])
@pytest.mark.parametrize("seed", [0, 1])
def test_radix_select_keeps_the_first_k_of_the_stable_order(seed, rank_max):
    """For every k from 1 to n, the emulated select keeps exactly the
    columns of the first k of the plain version's order, and ordering the
    survivors' packed (key, column) gives that order: by the count of
    survivors below each (k up to ``RANK_OUT``) and by the shared-memory
    sort. A smaller ``rank_max`` than the kernel's takes more radix passes
    and ranks fewer candidates."""
    preds, valid = _select_rows(np.random.default_rng(seed))
    keys = torch.where(torch.from_numpy(valid) > 0, torch.from_numpy(preds), -torch.inf)
    order = torch.sort(row_topk_module.descending_order_key(keys), dim=-1, stable=True).indices.numpy()
    desc = _desc_keys(preds, valid)
    for row in range(preds.shape[0]):
        for k in range(1, preds.shape[1] + 1):
            chosen = select_emulated(desc[row], k, rank_max)
            np.testing.assert_array_equal(chosen, np.sort(order[row, :k]))
            packed = desc[row, chosen].astype(np.uint64) << np.uint64(32) | chosen.astype(np.uint64)
            if k <= row_topk_module.RANK_OUT:
                place = (packed[None, :] < packed[:, None]).sum(axis=1)
                ranked = np.empty_like(packed)
                ranked[place] = packed
            else:
                k_pad = row_topk_module.next_pow2(k)
                padded = np.concatenate([packed, np.full(k_pad - k, 2**64 - 1, np.uint64)])
                ranked = sort_shared_emulated(padded)[:k]
            np.testing.assert_array_equal((ranked & np.uint64(0xFFFFFFFF)).astype(np.int64), order[row, :k])
