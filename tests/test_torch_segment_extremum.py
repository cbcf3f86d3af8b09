"""The port's segment max/min (K2) and int32 segment sum against the JAX package.

The JAX side runs as its own tests run it on the CPU: ``jax.ops.segment_max``
/ ``segment_min`` (the registry's fallback) and ``segment_extremum_tiled`` in
interpret mode (the real Pallas kernel body). The port's side is the plain
version its entry points take for CPU tensors; the CUDA kernel is held
against the same plain version on the card by ``chip_smoke.py``
(``parity_segment_extremum``).

Tolerance: bit for bit, NaN by position (an extremum never rounds). The
sign of a NaN is not compared: XLA keeps the sign of whichever NaN its
scatter met, the port writes the canonical quiet NaN.
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metrics_tpu.ops import segment_max_dispatch as jax_segment_max_dispatch
from metrics_tpu.ops import segment_min_dispatch as jax_segment_min_dispatch
from metrics_tpu.ops.scatter_pallas import segment_extremum_tiled
from metrics_tpu_torch import ops
from metrics_tpu_torch.ops import segment_extremum as segment_extremum_module
from metrics_tpu_torch.ops.segment_sum import segment_fold_geometry
from metrics_tpu_torch.utils.data import maximum_ieee, minimum_ieee

torch.set_num_threads(2)


def _assert_same(got: np.ndarray, want: np.ndarray) -> None:
    """Bit-equal, NaN by position."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def _values(rng: np.random.Generator, b: int, d: int) -> np.ndarray:
    """Quantized values (ties) with NaN of both signs, +-0.0 and +-inf."""
    vals = (rng.integers(-16, 16, (b, d)) / 4).astype(np.float32)
    pick = rng.random((b, d))
    vals[pick < 0.05] = np.nan
    vals[(pick >= 0.05) & (pick < 0.1)] = -np.nan
    vals[(pick >= 0.1) & (pick < 0.25)] = -0.0
    vals[(pick >= 0.25) & (pick < 0.3)] = 0.0
    vals[(pick >= 0.3) & (pick < 0.33)] = np.inf
    vals[(pick >= 0.33) & (pick < 0.36)] = -np.inf
    return vals


def _ids(rng: np.random.Generator, b: int, s: int) -> np.ndarray:
    """Ids over [-2, s + 2) (some drop) with segment s - 1 always empty."""
    ids = rng.integers(-2, s + 2, b)
    ids[ids == s - 1] = -1
    return ids.astype(np.int32)


# (rows, columns, segments): D = 1, 3, 256 (the TPU route's cap) and 300
# (past it); S < 64 and S >> B
CASES = [(40, 1, 7), (64, 3, 5), (24, 256, 130), (16, 300, 9), (32, 1, 500), (300, 3, 40)]


@pytest.mark.parametrize("b,d,s", CASES)
@pytest.mark.parametrize("is_max", [True, False])
def test_plain_version_matches_jax_segment_and_interpret_kernel(b, d, s, is_max):
    rng = np.random.default_rng(b * 7 + d * 3 + s + is_max)
    vals, ids = _values(rng, b, d), _ids(rng, b, s)
    jax_fn = jax.ops.segment_max if is_max else jax.ops.segment_min
    want = np.asarray(jax_fn(jnp.asarray(vals), jnp.asarray(ids), num_segments=s))
    kernel = np.asarray(segment_extremum_tiled(jnp.asarray(vals), jnp.asarray(ids), s, is_max, interpret=True))
    got = ops.segment_extremum_reference(torch.from_numpy(vals), torch.from_numpy(ids), s, is_max).numpy()
    _assert_same(got, want)
    _assert_same(got, kernel)
    # the empty segment holds the fold's identity
    assert np.all(got[s - 1] == (-np.inf if is_max else np.inf))


@pytest.mark.parametrize("is_max", [True, False])
def test_signed_zeros_in_either_order(is_max):
    """max gives +0.0 over -0.0 and min -0.0 over +0.0, whichever comes first."""
    vals = np.array([-0.0, 0.0, 0.0, -0.0, -0.0, -0.0, 0.0, 0.0], np.float32)
    ids = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32)
    jax_fn = jax.ops.segment_max if is_max else jax.ops.segment_min
    want = np.asarray(jax_fn(jnp.asarray(vals), jnp.asarray(ids), num_segments=4))
    got = ops.segment_min(torch.from_numpy(vals), torch.from_numpy(ids), 4) if not is_max else ops.segment_max(
        torch.from_numpy(vals), torch.from_numpy(ids), 4
    )
    _assert_same(got.numpy(), want)
    mixed_sign = is_max is False
    assert list(np.signbit(got.numpy())) == [mixed_sign, mixed_sign, True, False]


@pytest.mark.parametrize("is_max", [True, False])
def test_nan_of_either_sign_anywhere_makes_the_segment_nan(is_max):
    vals = np.array([np.nan, 1.0, 1.0, -np.nan, 2.0, np.inf, -np.inf, -np.nan], np.float32)
    ids = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32)
    got = ops.segment_extremum_reference(torch.from_numpy(vals), torch.from_numpy(ids), 5, is_max).numpy()
    assert np.isnan(got[:2]).all() and np.isnan(got[3])
    assert got[2] == (np.inf if is_max else 2.0)
    assert got[4] == (-np.inf if is_max else np.inf)
    jax_fn = jax.ops.segment_max if is_max else jax.ops.segment_min
    _assert_same(got, np.asarray(jax_fn(jnp.asarray(vals), jnp.asarray(ids), num_segments=5)))


def test_int64_ids_past_int32_drop():
    """An int64 id past 2**31 drops; a downcast would wrap it into range."""
    vals = torch.tensor([5.0, 1.0, 7.0, -3.0, 2.0])
    ids = torch.tensor([2**32 + 1, 1, 2**31, -(2**33), 0], dtype=torch.int64)
    got = ops.segment_max(vals, ids, 3)
    assert torch.equal(got, torch.tensor([2.0, 1.0, -torch.inf]))
    got = ops.segment_min(vals, ids, 3)
    assert torch.equal(got, torch.tensor([2.0, 1.0, torch.inf]))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float64])
def test_plain_version_keeps_other_dtypes(dtype):
    """CPU leaves of other dtypes fold in their own dtype, as jax.ops does
    (integers fill empty segments with the dtype's lowest / highest value)."""
    rng = np.random.default_rng(3)
    vals = rng.integers(-50, 50, (30, 2))
    ids = _ids(rng, 30, 6)
    np_dtype = {torch.int32: np.int32, torch.int64: np.int64, torch.float64: np.float64}[dtype]
    for is_max in (True, False):
        got = ops.segment_extremum_reference(torch.from_numpy(vals.astype(np_dtype)), torch.from_numpy(ids), 6, is_max)
        assert got.dtype == dtype
        want = np.full((6, 2), 0, np_dtype)
        for s in range(6):
            rows = vals[ids == s].astype(np_dtype)
            if rows.size:
                want[s] = rows.max(axis=0) if is_max else rows.min(axis=0)
            elif dtype.is_floating_point:
                want[s] = -np.inf if is_max else np.inf
            else:
                info = np.iinfo(np_dtype)
                want[s] = info.min if is_max else info.max
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("is_max", [True, False])
def test_dispatch_restores_trailing_dims(is_max):
    rng = np.random.default_rng(11)
    vals = _values(rng, 50, 6).reshape(50, 2, 3)
    ids = _ids(rng, 50, 8)
    jax_fn = jax_segment_max_dispatch if is_max else jax_segment_min_dispatch
    port_fn = ops.segment_max_dispatch if is_max else ops.segment_min_dispatch
    want = np.asarray(jax_fn(jnp.asarray(vals), jnp.asarray(ids), 8))
    got = port_fn(torch.from_numpy(vals), torch.from_numpy(ids), 8).numpy()
    assert got.shape == (8, 2, 3)
    _assert_same(got, want)


def test_float_ids_raise():
    with pytest.raises(TypeError, match="integer-typed"):
        ops.segment_max(torch.ones(3), torch.tensor([0.0, 1.0, 2.0]), 3)


@pytest.mark.parametrize("shape", [(200,), (90, 3)])
def test_segment_sum_int32_matches_jax_and_wraps(shape):
    """int32 payloads (SlicedMetric's counters) sum exactly and wrap modulo
    2**32, as XLA's int32 scatter-add does; the card's segment_sum_i32
    adds as uint32 for the same result."""
    rng = np.random.default_rng(len(shape))
    vals = rng.integers(-(2**31), 2**31 - 1, shape).astype(np.int32)
    ids = _ids(rng, shape[0], 12)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(ids), num_segments=12))
    got = ops.segment_sum_dispatch(torch.from_numpy(vals), torch.from_numpy(ids), 12)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    wide = np.zeros((12,) + shape[1:], np.int64)
    for i, s in enumerate(ids):
        if 0 <= s < 12:
            wide[s] += vals[i]
    assert (np.abs(wide) > 2**31).any()  # the data do wrap
    np.testing.assert_array_equal(got.numpy(), wide.astype(np.int32))


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    ops.reset_launch_counts()
    for kernel in (ops.segment_max_f32, ops.segment_min_f32, ops.segment_sum_i32):
        with pytest.raises(ValueError, match="CUDA kernel"):
            kernel(torch.ones(2, dtype=torch.int32 if kernel is ops.segment_sum_i32 else torch.float32), torch.tensor([0, 1]), 4)
    ops.segment_max_dispatch(torch.ones(2), torch.tensor([0, 1]), 4)  # the CPU path launches nothing
    ops.segment_sum_dispatch(torch.ones(2, dtype=torch.int32), torch.tensor([0, 1]), 4)
    assert all(n == 0 for n in ops.launch_counts().values())


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "long long": ctypes.c_longlong, "int": ctypes.c_int}


def test_ctypes_signatures_match_the_c_launchers():
    """Each C launcher of segment_extremum.cu (the stream last) matches the
    ctypes argtypes its wrapper declares."""
    mod = segment_extremum_module
    source = (Path(mod.__file__).parent.parent / "csrc" / mod.SOURCE).read_text()
    extern = source[source.index('extern "C" {') :]
    assert set(re.findall(r"^int (\w+)\(", extern, re.M)) == set(mod._SIGNATURES)
    for name, argtypes in mod._SIGNATURES.items():
        params = re.search(rf"int {name}\(([^)]*)\)", extern).group(1)
        c_types = [re.sub(r"\s*\w+$", "", p.strip()) for p in params.split(",")]
        assert [_C_TYPES[t] for t in c_types] == list(argtypes), name
        assert c_types[-1] == "void*"  # the stream


@pytest.mark.parametrize("is_max", [True, False])
@pytest.mark.parametrize("b,d,s", [(5000, 1, 3), (9000, 1, 64), (300, 4, 5), (4096, 2, 1)])
def test_split_over_rows_combines_to_the_whole(is_max, b, d, s):
    """K2's row splits (the card's partial tiles) folded with the fold's own
    combine (maximum_ieee / minimum_ieee, which the combine kernel computes)
    equal the plain version over all rows, NaN of both signs, +-0.0, +-inf
    and dropped ids included, in the geometry's own splits and at other
    split points."""
    rng = np.random.default_rng(b * d + s + is_max)
    vals, ids = _values(rng, b, d), rng.integers(-2, s + 2, b).astype(np.int64)
    ids[rng.random(b) < 0.01] = -(2**33)
    if d == 1:
        vals = vals[:, 0]
    combine = maximum_ieee if is_max else minimum_ieee
    whole = ops.segment_extremum_reference(torch.from_numpy(vals), torch.from_numpy(ids), s, is_max)
    g = segment_fold_geometry(b, d, s, True)
    geometry_cuts = [(min(b, z * g.rows_per_split), min(b, (z + 1) * g.rows_per_split)) for z in range(g.splits)]
    for cuts in (geometry_cuts, [(0, 1), (1, b)], [(0, b // 2), (b // 2, b // 2), (b // 2, b)], [(0, b - 1), (b - 1, b)]):
        acc = None
        for r0, r1 in cuts:
            part = ops.segment_extremum_reference(torch.from_numpy(vals[r0:r1]), torch.from_numpy(ids[r0:r1]), s, is_max)
            acc = part if acc is None else combine(acc, part)
        _assert_same(acc.numpy(), whole.numpy())
        # the empty parts hold the identity, and the signs of zeros survive
        np.testing.assert_array_equal(np.signbit(acc.numpy()), np.signbit(whole.numpy()))


@pytest.mark.parametrize("is_max", [True, False])
@pytest.mark.parametrize("case", ["90% of 4096 rows in one segment", "[65536] -> 4", "all rows in one segment"])
def test_plain_version_matches_jax_at_skewed_shapes(is_max, case):
    """The plain version against jax.ops.segment_max/min and the
    interpret-mode kernel where most rows share a segment."""
    rng = np.random.default_rng(len(case) + is_max)
    if case.startswith("90%"):
        b, d, s = 4096, 2, 100
        vals, ids = _values(rng, b, d), _ids(rng, b, s)
        ids[rng.random(b) < 0.9] = 3
    elif case.startswith("[65536]"):
        b, d, s = 65536, 1, 4
        vals, ids = _values(rng, b, d)[:, 0], rng.integers(-1, s + 1, b).astype(np.int32)
    else:
        b, d, s = 3000, 1, 64
        vals, ids = _values(rng, b, d)[:, 0], np.full(b, 9, np.int32)
        vals[np.isnan(vals)] = 1.0  # one segment: keep it NaN-free, so the fold's value shows
    jax_fn = jax.ops.segment_max if is_max else jax.ops.segment_min
    want = np.asarray(jax_fn(jnp.asarray(vals), jnp.asarray(ids), num_segments=s))
    got = ops.segment_extremum_reference(torch.from_numpy(vals), torch.from_numpy(ids), s, is_max).numpy()
    _assert_same(got, want)
    kernel = np.asarray(segment_extremum_tiled(jnp.asarray(vals), jnp.asarray(ids), s, is_max, interpret=True))
    _assert_same(got, kernel)
