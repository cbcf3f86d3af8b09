"""The port's segment-sum / bincount against the JAX package's kernel.

The JAX side runs as its own tests run it on the CPU: ``segment_sum_tiled``
in interpret mode (the real Pallas kernel body) and ``bincount_dispatch``
under ``forced_backend("interpret")``. The port's side is the plain
version its entry points take for CPU tensors; the CUDA kernels are held
against the same plain versions on the card by ``chip_smoke.py``.

Tolerances: bit-exact on integer-valued data (every partial sum is exact
in float32 on both sides); rtol 1e-6 on float data, whose sums are taken
in another order (the TPU kernel contracts 512-row blocks on the matrix
unit, ``index_add_`` adds row by row).
"""
import ctypes
import re
from importlib import import_module
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metrics_tpu import ops as jax_ops
from metrics_tpu.ops.scatter_pallas import segment_sum_tiled
from metrics_tpu_torch import ops
from metrics_tpu_torch.ops import build as kernel_build
from metrics_tpu_torch.ops.segment_sum import segment_fold_geometry, segment_sum_geometry

torch.set_num_threads(2)

segment_sum_module = import_module("metrics_tpu_torch.ops.segment_sum")

_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "long long": ctypes.c_longlong, "int": ctypes.c_int}

# the ragged B/D/S grid of tests/ops/test_scatter_pallas.py
GRID = [(1, 1, 1), (300, 3, 40), (512, 1, 128), (1024, 130, 7), (2048, 5, 1000)]


def _jax_segment_sum(vals: np.ndarray, ids: np.ndarray, s: int) -> np.ndarray:
    return np.asarray(segment_sum_tiled(jnp.asarray(vals), jnp.asarray(ids, jnp.int32), s, interpret=True))


@pytest.mark.parametrize("b,d,s", GRID)
@pytest.mark.parametrize("kind", ["integer", "float"])
def test_segment_sum_matches_jax_kernel(b, d, s, kind):
    rng = np.random.default_rng(b * 31 + d * 7 + s)
    if kind == "integer":
        vals = rng.integers(-9, 9, (b, d)).astype(np.float32)
    else:
        vals = rng.random((b, d), dtype=np.float32)
    ids = rng.integers(0, s, b).astype(np.int32)
    want = _jax_segment_sum(vals, ids, s)
    got = ops.segment_sum_dispatch(torch.from_numpy(vals), torch.from_numpy(ids), s).numpy()
    assert got.shape == (s, d) and got.dtype == np.float32
    if kind == "integer":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_segment_sum_drops_negative_and_out_of_range_ids():
    vals = np.ones((6,), np.float32)
    ids = np.array([-3, -1, 0, 1, 4, 99], np.int32)
    want = _jax_segment_sum(vals, ids, 4)
    got = ops.segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), 4).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1.0, 1.0, 0.0, 0.0])


def test_segment_sum_int64_ids_past_int32_drop():
    """An int64 label past 2**31 must drop, not wrap into range."""
    ids = torch.tensor([2**32 + 1, 1, 2**31, -(2**33), 0], dtype=torch.int64)
    vals = torch.arange(1, 6, dtype=torch.float32)
    got = ops.segment_sum(vals, ids, 3)
    assert torch.equal(got, torch.tensor([5.0, 2.0, 0.0]))


def test_segment_sum_is_row_order_sequential():
    """The plain version adds row by row: bit-equal to a sequential numpy
    loop. The CUDA kernel sums each (segment, column) in row order too, so
    ``chip_smoke.py`` can hold it to the plain version bit for bit."""
    rng = np.random.default_rng(7)
    vals = rng.standard_normal((700, 3)).astype(np.float32)
    ids = rng.integers(-2, 12, 700)
    want = np.zeros((10, 3), np.float32)
    for i, s in enumerate(ids):
        if 0 <= s < 10:
            want[s] += vals[i]
    got = ops.segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), 10).numpy()
    np.testing.assert_array_equal(got, want)


def test_segment_sum_dispatch_restores_trailing_dims():
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 4, (400, 2, 3)).astype(np.float32)
    ids = rng.integers(0, 25, 400).astype(np.int32)
    want = np.asarray(jax_ops.segment_sum_dispatch(jnp.asarray(vals), jnp.asarray(ids), 25))
    got = ops.segment_sum_dispatch(torch.from_numpy(vals), torch.from_numpy(ids), 25).numpy()
    assert got.shape == (25, 2, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b,s", [(1, 1), (300, 40), (2048, 1000), (4096, 10_000)])
def test_bincount_matches_jax_kernel(b, s):
    rng = np.random.default_rng(b + s)
    ids = rng.integers(0, s, b).astype(np.int32)
    with jax_ops.forced_backend("interpret"):
        want = np.asarray(jax_ops.bincount_dispatch(jnp.asarray(ids), s))
    got = ops.bincount_dispatch(torch.from_numpy(ids), s)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_bincount_tensor_negatives_and_out_of_range_drop():
    ids = np.array([-1, 0, 2, 2, 5, -7, 3], np.int32)
    with jax_ops.forced_backend("interpret"):
        want = np.asarray(jax_ops.bincount_dispatch(jnp.asarray(ids), 4))
    got = ops.bincount_dispatch(torch.from_numpy(ids), 4).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1, 0, 2, 1])


def test_bincount_int64_ids_past_int32_drop():
    ids = torch.tensor([2**32 + 2, 2, 1, 2**31 + 1], dtype=torch.int64)
    got = ops.bincount_dispatch(ids, 4)
    assert torch.equal(got, torch.tensor([0, 1, 1, 0], dtype=torch.int32))


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.uint8])
def test_bincount_narrow_ids_are_promoted(dtype):
    """minlength=300 does not fit int8/uint8: the masking must still drop
    the negatives rather than wrap them into a valid bin."""
    ids = np.array([0, 5, 5, 100], dtype)
    with jax_ops.forced_backend("interpret"):
        want = np.asarray(jax_ops.bincount_dispatch(jnp.asarray(ids), 300))
    got = ops.bincount_dispatch(torch.from_numpy(ids), 300).numpy()
    np.testing.assert_array_equal(got, want)
    tensor_ids = torch.tensor([-1, 5, -128], dtype=torch.int8)
    assert int(ops.bincount_dispatch(tensor_ids, 300).sum()) == 1


@pytest.mark.parametrize("host", [np.array([0, -1, 2]), [0, -1, 2], (0, -1, 2)])
def test_bincount_host_negatives_raise(host):
    with pytest.raises(ValueError, match="non-negative"):
        jax_ops.bincount_dispatch(host, 4)
    with pytest.raises(ValueError, match="non-negative"):
        ops.bincount_dispatch(host, 4, device="cpu")


@pytest.mark.parametrize(
    "bad", [np.array([0.0, 1.0]), [0.5, 1.0], torch.tensor([0.0, 1.0]), torch.tensor([True, False])]
)
def test_bincount_float_and_bool_ids_raise(bad):
    with pytest.raises(TypeError, match="integer-typed"):
        ops.bincount_dispatch(bad, 4, device="cpu")


@pytest.mark.parametrize("minlength", [0, -3, 2.0, True, None])
def test_bincount_minlength_must_be_positive_int(minlength):
    with pytest.raises(ValueError, match="positive int"):
        ops.bincount_dispatch(torch.tensor([0, 1]), minlength)


def test_host_ids_go_to_the_card_unless_cpu_is_asked():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.bincount_dispatch(np.array([0, 1]), 4)
    assert ops.bincount_dispatch(np.array([0, 1]), 4, device="cpu").device.type == "cpu"


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA kernel"):
        ops.bincount_i32(torch.tensor([0, 1]), 4)
    with pytest.raises(ValueError, match="CUDA kernel"):
        ops.segment_sum_f32(torch.ones(2), torch.tensor([0, 1]), 4)
    ops.bincount_dispatch(torch.tensor([0, 1]), 4)  # the CPU path launches nothing
    assert all(n == 0 for n in ops.launch_counts().values())


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No silent fallback: a missing compiler is an error naming it."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        kernel_build.build("segment_sum.cu")
    assert not (tmp_path / "_build").exists()


def test_library_path_is_keyed_on_the_source():
    path = kernel_build.library_path("segment_sum.cu")
    assert path.parent == kernel_build.BUILD_DIR
    assert path.name.startswith("segment_sum-") and path.suffix == ".so"


@pytest.mark.parametrize(
    "d,s", [(1, 1), (1, 1_000_000), (2, 1000), (16, 2052), (130, 1000), (33, 7), (1, 10**9)]
)
def test_segment_sum_geometry_covers_the_output(d, s):
    """The launch the wrapper computes covers every (segment, column) and
    fits the kernel's shared-memory tile (8 warps x sw x dc <= 10240)."""
    dc, sw, seg_tiles, col_chunks = segment_sum_geometry(d, s)
    assert 1 <= dc <= 32 and sw >= 1
    assert 8 * sw * dc <= 10240
    assert seg_tiles * 8 * sw >= s and (seg_tiles - 1) * 8 * sw < s
    assert col_chunks * dc >= d and (col_chunks - 1) * dc < d


# (B, D, S, order_free): the main paths' shapes (the sketch's compaction, the
# retrieval insert, the flagship's rank sums, the sliced updates, K2's
# parity shapes, a long batch over few segments, one hot segment, the
# multiclass sketch) and edge shapes (B = 0, S = 1, D = 2002, B under one
# chunk, B past int32 rows per split)
FOLD_SHAPES = [
    (16384, 3, 4100, False),
    (2048, 1, 8192, False),
    (4096, 2, 1000, False),
    (256, 1, 1000, False),
    (256, 1, 1000, True),
    (4096, 1, 1000, True),
    (4096, 1, 100_000, True),
    (8192, 256, 128, True),
    (4096, 1000, 64, True),
    (1 << 20, 1, 64, True),
    (1 << 20, 1, 64, False),
    (65536, 3, 4100, False),
    (16384, 2002, 4100, False),
    (0, 1, 1, True),
    (0, 3, 5, False),
    (5000, 1, 1, True),
    (5000, 1, 1, False),
    (100, 2002, 7, True),
    (100, 3, 7, False),
    (3 << 20, 1, 1, True),
]


def _partition(n: int, step: int, parts: int):
    """The half-open ranges [k step, min(n, (k + 1) step)) of ``parts`` blocks."""
    return [(min(n, k * step), min(n, (k + 1) * step)) for k in range(parts)]


@pytest.mark.parametrize("b,d,s,order_free", FOLD_SHAPES)
def test_segment_fold_geometry_covers_every_row_segment_and_column_once(b, d, s, order_free):
    """The grid (segment tiles, column chunks, row splits) of a fold covers
    every (row, segment, column) exactly once: the grid is a product, so each
    axis's block ranges must tile [0, n) without gap or overlap. The float
    sum keeps one row split (its order is its result), the tile fits the
    kernel's 40 KB, and the grid fits CUDA's limits."""
    g = segment_fold_geometry(b, d, s, order_free)
    assert 1 <= g.dc <= 32 and g.sw >= 1 and 8 * g.sw * g.dc <= 10240
    assert 1 <= g.splits <= 65535 and 1 <= g.col_chunks <= 65535 and 1 <= g.seg_tiles < 2**31
    if not order_free:
        assert g.splits == 1 and g.rows_per_split == b and g.dc <= 16
    for n, step, parts in ((b, g.rows_per_split, g.splits), (s, 8 * g.sw, g.seg_tiles), (d, g.dc, g.col_chunks)):
        ranges = _partition(n, step, parts)
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(lo <= hi for lo, hi in ranges)
        assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))  # no gap, no overlap
        assert parts == 1 or ranges[-2][1] < n  # no block past the end but the first
    blocks = g.seg_tiles * g.col_chunks * g.splits
    if order_free and b * min(d, 32) >= 2 * 4096 * 264:
        assert blocks >= 264  # long batches fill the card whatever S is
    if b * s * d <= 2_000_000:
        # emulate the blocks: every cell of every row folded exactly once
        seen = np.zeros((max(b, 1), s, d), np.int8)
        for r0, r1 in _partition(b, g.rows_per_split, g.splits):
            for s0, s1 in _partition(s, 8 * g.sw, g.seg_tiles):
                for c0, c1 in _partition(d, g.dc, g.col_chunks):
                    seen[r0:r1, s0:s1, c0:c1] += 1
        assert (seen[:b] == 1).all()


def _wrapping_sum(vals: np.ndarray, ids: np.ndarray, s: int) -> np.ndarray:
    wide = np.zeros((s,) + vals.shape[1:], np.int64)
    for i, seg in enumerate(ids):
        if 0 <= seg < s:
            wide[seg] += vals[i]
    return wide.astype(np.int32)


@pytest.mark.parametrize("b,s", [(5000, 3), (9000, 64), (4096, 1)])
def test_int32_sum_split_over_rows_combines_to_the_whole(b, s):
    """The int32 sum's row splits (the card's partial tiles) combined by
    wrapping add, in the geometry's own splits and at other split points,
    equal the plain version over all rows bit for bit."""
    rng = np.random.default_rng(b + s)
    vals = rng.integers(-(2**31), 2**31 - 1, b).astype(np.int32)
    ids = rng.integers(-2, s + 2, b)
    ids[rng.random(b) < 0.01] = 2**33
    whole = ops.segment_sum_reference(torch.from_numpy(vals), torch.from_numpy(ids), s)
    g = segment_fold_geometry(b, 1, s, True)
    cuts = [(r0, r1) for r0, r1 in _partition(b, g.rows_per_split, g.splits)]
    for parts in (cuts, [(0, 1), (1, b)], [(0, b // 3), (b // 3, b - 7), (b - 7, b)]):
        acc = torch.zeros(s, dtype=torch.int32)
        for r0, r1 in parts:
            part = ops.segment_sum_reference(torch.from_numpy(vals[r0:r1]), torch.from_numpy(ids[r0:r1]), s)
            acc = torch.from_numpy((acc.numpy().astype(np.int64) + part.numpy()).astype(np.int32))  # wraps
        assert torch.equal(acc, whole)
    np.testing.assert_array_equal(whole.numpy(), _wrapping_sum(vals, ids, s))


@pytest.mark.parametrize(
    "case", ["90% of 4096 rows in one segment", "[65536] -> 4", "[4096, 3] -> 4100 sketch buckets"]
)
def test_plain_segment_sum_matches_jax_at_skewed_shapes(case):
    """The plain version against jax.ops.segment_sum and the interpret-mode
    kernel where most rows share a segment: bit for bit on integer-valued
    data, and the plain version equals a sequential row-order sum."""
    rng = np.random.default_rng(len(case))
    if case.startswith("90%"):
        b, d, s = 4096, 2, 200
        ids = rng.integers(0, s, b)
        ids[rng.random(b) < 0.9] = 17
    elif case.startswith("[65536]"):
        b, d, s = 65536, 1, 4
        ids = rng.integers(-1, s + 1, b)
    else:  # a compaction's buckets: sorted, pad rows in one bucket
        b, d, s = 4096, 3, 4100
        ids = np.full(b, 4097)
        ids[:3000] = np.sort(rng.integers(0, 4097, 3000))
    vals = rng.integers(-8, 8, (b, d)).astype(np.float32)
    if d == 1:
        vals = vals[:, 0]
    got = ops.segment_sum_reference(torch.from_numpy(vals), torch.from_numpy(ids), s).numpy()
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(ids, jnp.int32), num_segments=s))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_segment_sum(vals, ids.astype(np.int32), s))
    floats = rng.standard_normal(vals.shape).astype(np.float32)
    seq = np.zeros((s,) + floats.shape[1:], np.float32)
    for i, seg in enumerate(ids):
        if 0 <= seg < s:
            seq[seg] += floats[i]
    np.testing.assert_array_equal(ops.segment_sum_reference(torch.from_numpy(floats), torch.from_numpy(ids), s).numpy(), seq)


def test_ctypes_signatures_match_the_c_launchers_of_segment_sum():
    """Each C launcher of segment_sum.cu (the stream last) matches the ctypes
    argtypes its wrapper declares."""
    mod = segment_sum_module
    source = (Path(mod.__file__).parent.parent / "csrc" / mod.SOURCE).read_text()
    extern = source[source.index('extern "C" {') :]
    assert set(re.findall(r"^int (\w+)\(", extern, re.M)) == set(mod._SIGNATURES)
    for name, argtypes in mod._SIGNATURES.items():
        params = re.search(rf"int {name}\(([^)]*)\)", extern).group(1)
        c_types = [re.sub(r"\s*\w+$", "", p.strip()) for p in params.split(",")]
        assert [_C_TYPES[t] for t in c_types] == list(argtypes), name
        assert c_types[-1] == "void*"  # the stream
