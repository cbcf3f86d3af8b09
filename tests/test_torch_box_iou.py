"""The port's box IoU against the JAX package's, on the CPU.

* The port's plain version (what CPU tensors take, and what the CUDA
  kernels are held to on the card) against the jnp broadcast
  ``functional/detection/box_ops.py:box_iou``, the JAX package's CPU route:
  bit for bit, on random, degenerate (zero-area, touching, inverted, signed
  zero), zero-padded and integer boxes, in float32 and float64.
* Against the interpret-mode Pallas kernels ``box_iou_tiled`` and
  ``box_iou_batched_tiled``: within atol = 1e-5, the tolerance of the JAX
  package's own kernel tests (``tests/ops/test_box_iou_pallas.py``). They
  are not bit-equal: XLA contracts ``area1 + area2`` into
  ``fma(x22 - x21, y22 - y21, area1)`` there, which
  ``test_interpret_kernel_union_is_fma_contracted`` pins, so that nobody
  moves the port toward it.
* The routing (shapes, dtypes, launch counter names).
"""
import ctypes
import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.functional.detection.box_ops import box_iou as jax_box_iou
from metrics_tpu.ops.box_iou_pallas import box_iou_batched_tiled, box_iou_dispatch, box_iou_tiled
from metrics_tpu_torch import ops
from metrics_tpu_torch.functional.detection import box_iou as functional_box_iou

# the module (the package's `box_iou` attribute is the entry-point function)
box_iou_module = importlib.import_module("metrics_tpu_torch.ops.box_iou")

torch.set_num_threads(2)


def _boxes(rng, n, dtype=np.float32, scale=100.0):
    xy = rng.uniform(0, scale, (n, 2))
    wh = rng.uniform(0, scale / 2, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(dtype)


def _degenerate(boxes):
    """Zero-area, touching, inverted, signed-zero and zero-padded rows."""
    b = boxes.copy()
    n = len(b)
    b[0] = [10, 10, 10, 20]  # zero width
    b[1] = [10, 10, 20, 10]  # zero height
    b[2] = [20, 20, 10, 10]  # inverted
    b[3] = [-0.0, 0.0, 0.0, -0.0]  # signed zeros, zero area
    b[4] = [0.0, -0.0, 5.0, 5.0]
    b[5] = b[6] + np.array([b[6, 2] - b[6, 0], 0, b[6, 2] - b[6, 0], 0], b.dtype)  # touches row 6
    b[n - 3 :] = 0  # zero padding
    return b


def _bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.int64 if x.dtype == np.float64 else np.int32)


def _port(a, b):
    return box_iou_module.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()


# one shape per test (eager jnp compiles each primitive once per shape),
# several contents: (seed, coordinate scale, degenerate rows)
PAIRWISE_CASES = [(0, 100.0, False), (1, 100.0, True), (2, 1e4, True), (3, 1.0, True)]


@pytest.mark.parametrize("seed,scale,degenerate", PAIRWISE_CASES)
def test_pairwise_matches_jnp_bitwise(seed, scale, degenerate):
    rng = np.random.default_rng(seed)
    a, b = _boxes(rng, 130, scale=scale), _boxes(rng, 70, scale=scale)
    if degenerate:
        a, b = _degenerate(a), _degenerate(b)
        b[:4] = a[:4]
    want = np.asarray(jax_box_iou(a, b))
    got = _port(a, b)
    assert got.dtype == np.float32 and got.shape == (130, 70)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(functional_box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()), _bits(want))


@pytest.mark.parametrize("seed,scale,pad_from", [(0, 100.0, 5), (1, 100.0, 3), (2, 1e4, 1)])
def test_batched_matches_jnp_bitwise(seed, scale, pad_from):
    u, d, g = 50, 8, 5
    rng = np.random.default_rng(seed)
    a = _degenerate(_boxes(rng, u * d + 8, scale=scale))[: u * d].reshape(u, d, 4)
    b = _degenerate(_boxes(rng, u * g + 8, scale=scale))[: u * g].reshape(u, g, 4)
    b[:, pad_from:] = 0  # per-unit zero padding, as the mAP packing leaves it
    want = np.asarray(jax_box_iou(a, b))
    got = _port(a, b)
    assert got.shape == (u, d, g)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_float64_matches_jnp_bitwise_and_stays_float64():
    rng = np.random.default_rng(64)
    a = _degenerate(_boxes(rng, 48, np.float64)).reshape(6, 8, 4)
    b = _degenerate(_boxes(rng, 30, np.float64)).reshape(6, 5, 4)
    with jax.enable_x64(True):
        want = np.asarray(jax_box_iou(jnp.asarray(a), jnp.asarray(b)))
    got = _port(a, b)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # mixed float32/float64 promotes to float64
    mixed = box_iou_module.box_iou(torch.from_numpy(a[0].astype(np.float32)), torch.from_numpy(b[0]))
    assert mixed.dtype == torch.float64


def test_integer_boxes_give_float32_equal_to_jnp():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 60, (30, 4)).astype(np.int32)
    b = rng.integers(0, 60, (20, 4)).astype(np.int32)
    a[:, 2:] += a[:, :2]
    b[:, 2:] += b[:, :2]
    want = np.asarray(jax_box_iou(a, b))
    assert want.dtype == np.float32
    for dtype in (torch.int32, torch.int64):
        got = box_iou_module.box_iou(torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    half = box_iou_module.box_iou(torch.from_numpy(a).half(), torch.from_numpy(b).half())
    assert half.dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1])
def test_pairwise_within_interpret_kernel_tolerance(seed):
    rng = np.random.default_rng(seed)
    a, b = _degenerate(_boxes(rng, 130)), _degenerate(_boxes(rng, 70))
    want = np.asarray(box_iou_tiled(a, b, interpret=True))
    np.testing.assert_allclose(_port(a, b), want, atol=1e-5, rtol=0)


def test_batched_within_interpret_kernel_tolerance():
    rng = np.random.default_rng(9)
    a = _degenerate(_boxes(rng, 40 * 8)).reshape(40, 8, 4)
    b = _degenerate(_boxes(rng, 40 * 5)).reshape(40, 5, 4)
    want = np.asarray(box_iou_batched_tiled(a, b, interpret=True))
    np.testing.assert_allclose(_port(a, b), want, atol=1e-5, rtol=0)


def test_interpret_kernel_union_is_fma_contracted():
    """Where the interpret-mode kernel's IoU differs from the unfused order
    (the port's and the jnp broadcast's), it is ``inter / (fma(x22 - x21,
    y22 - y21, area1) - inter)``: the FMA taken once, in float64 and
    rounded, reproduces every such value bit for bit. (Whether XLA
    contracts depends on the compiled tile grid: at this shape it does on
    every pair it vectorises.)"""
    rng = np.random.default_rng(2024)
    a, b = _boxes(rng, 200), _boxes(rng, 300)
    interp = np.asarray(box_iou_tiled(a, b, interpret=True))

    x11, y11, x12, y12 = (a[:, i][:, None] for i in range(4))
    x21, y21, x22, y22 = (b[:, i][None, :] for i in range(4))
    w = np.maximum(np.minimum(x12, x22) - np.maximum(x11, x21), np.float32(0))
    h = np.maximum(np.minimum(y12, y22) - np.maximum(y11, y21), np.float32(0))
    inter = w * h
    area1 = (x12 - x11) * (y12 - y11)
    # the product of two float32s is exact in float64, and so is its sum
    # with area1 at these magnitudes: one rounding, as an FMA does
    fused = ((x22 - x21).astype(np.float64) * (y22 - y21).astype(np.float64) + area1.astype(np.float64)).astype(np.float32)
    union = fused - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        modelled = np.where(union > 0, inter / np.where(union > 0, union, np.float32(1)), np.float32(0))

    port = _port(a, b)
    differ = _bits(port) != _bits(interp)
    assert 0 < differ.sum() < differ.size // 10
    np.testing.assert_array_equal(_bits(modelled)[differ], _bits(interp)[differ])
    np.testing.assert_allclose(port, interp, atol=1e-5, rtol=0)


def test_shapes_that_no_kernel_takes_raise():
    a = torch.zeros(5, 4)
    with pytest.raises(ValueError, match="leading"):
        box_iou_module.box_iou(torch.zeros(2, 5, 4), torch.zeros(3, 5, 4))
    with pytest.raises(ValueError, match="box tensors"):
        box_iou_module.box_iou(a, torch.zeros(2, 5, 4))
    with pytest.raises(ValueError, match="box tensors"):
        box_iou_module.box_iou(torch.zeros(5, 3), a)


def test_kernel_wrappers_take_card_tensors_only():
    a = torch.zeros(5, 4)
    with pytest.raises(ValueError, match="CUDA kernel"):
        ops.box_iou_pairwise(a, a)
    with pytest.raises(ValueError, match="CUDA kernel"):
        ops.box_iou_batched(a[None], a[None])


def test_launch_counter_names_and_geometry(monkeypatch):
    """With the card faked (the launch recorded instead of made), each
    wrapper counts one launch under its own name, with the kernel's
    geometry: the run width per G (or M), the row threads, the 32- or
    64-bit offsets, and 16-byte aligned boxes (a view that starts mid-box
    is copied); the empty case launches nothing. The CPU route counts
    none."""
    calls = []

    def fake_launch(kernel, lib, device, fn, *args):
        calls.append((kernel, fn, args[3:], args[0] % 16, args[1] % 16))
        ops.count_launch(kernel)

    class FakeLib:
        box_iou_f32 = "f32"
        box_iou_f64 = "f64"

    monkeypatch.setattr(box_iou_module, "check_cuda", lambda *args: None)
    monkeypatch.setattr(box_iou_module, "load_library", lambda: FakeLib)
    monkeypatch.setattr(box_iou_module, "launch", fake_launch)
    ops.reset_launch_counts()
    assert ops.box_iou_pairwise(torch.zeros(6, 4), torch.zeros(40, 4)).shape == (6, 40)
    assert ops.box_iou_batched(torch.zeros(3, 8, 4, dtype=torch.float64), torch.zeros(3, 5, 4)).shape == (3, 8, 5)
    assert ops.box_iou_batched(torch.zeros(0, 8, 4), torch.zeros(0, 5, 4)).shape == (0, 8, 5)
    # a view one float past a box boundary
    flat = torch.zeros(4 * 30 + 1)
    assert flat[1:].view(30, 4).data_ptr() % 16 != 0
    assert ops.box_iou_pairwise(flat[1:].view(30, 4), flat[1:].view(30, 4)[:6]).shape == (30, 6)
    counts = ops.launch_counts()
    assert counts["box_iou_pairwise"] == 2 and counts["box_iou_batched"] == 1
    assert calls == [
        ("box_iou_pairwise", "f32", (1, 6, 40, 1, 6, 0), 0, 0),
        ("box_iou_batched", "f64", (3, 8, 5, 1, 8, 0), 0, 0),
        ("box_iou_pairwise", "f32", (1, 30, 6, 1, 30, 0), 0, 0),
    ]
    # a launch with threads enough takes runs of 4 and walks rows
    assert ops.box_iou_batched(torch.zeros(65536, 8, 4), torch.zeros(65536, 8, 4)).shape == (65536, 8, 8)
    assert calls[-1] == ("box_iou_batched", "f32", (65536, 8, 8, 4, 4, 0), 0, 0)
    monkeypatch.undo()
    ops.reset_launch_counts()
    box_iou_module.box_iou(torch.zeros(6, 4), torch.zeros(4, 4))
    assert not any(ops.launch_counts().values())


# (units, d, g) -> (vec, wide): the mAP chunk, the parity shapes, widths
# not a multiple of 4, one-box rows and units, and offsets past 2**31 in
# the output or in the boxes
GEOMETRY_CASES = [
    ((65536, 8, 8), 4, False),
    ((1, 4096, 4096), 4, False),
    ((1, 1024, 1024), 4, False),
    ((1, 1000, 3000), 4, False),
    ((4096, 128, 32), 4, False),
    ((1024, 128, 128), 4, False),
    ((16384, 64, 16), 4, False),
    ((1000, 100, 30), 2, False),
    ((1, 1000, 3001), 1, False),
    ((1, 999, 3002), 2, False),
    ((1, 1001, 3003), 1, False),
    ((65536, 1, 8), 4, False),
    ((65536, 8, 1), 1, False),
    ((1, 1, 4096), 1, False),  # 1024 runs of 4: too few threads
    ((64, 1, 4096), 2, False),
    ((1, 4096, 1), 1, False),
    ((1, 32767, 65536), 4, False),  # 2**31 - 2**16 outputs
    ((1, 32768, 65536), 4, True),  # 2**31 outputs
    ((1, 2**29, 1), 1, True),  # the boxes' offsets pass 2**31
]


@pytest.mark.parametrize("shape,vec,wide", GEOMETRY_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_geometry_vector_width_row_walk_and_offsets(shape, vec, wide, dtype):
    """In float32 the run width is the widest of 4, 2 that divides G and
    leaves the launch MIN_THREADS threads, else 1, so every run is one
    aligned vector store; in float64 it is 1. A thread
    walks at most MAX_ROWS rows, as many as keep MIN_THREADS threads in the
    launch and MIN_UNIT_LANES lanes a unit; 64-bit offsets exactly when the
    output or the boxes hold 2**31 elements or more."""
    units, d, g = shape
    got_vec, row_threads, got_wide = box_iou_module.box_iou_geometry(units, d, g, dtype)
    assert (got_vec, got_wide) == (vec if dtype == torch.float32 else 1, wide)
    assert got_vec == 1 or (g % got_vec == 0 and units * d * (g // got_vec) >= box_iou_module.MIN_THREADS)
    assert wide == (max(units * d * g, 4 * units * max(d, g)) >= 2**31)
    rows = -(-d // row_threads)
    assert 1 <= row_threads <= d and rows <= box_iou_module.MAX_ROWS
    assert rows & (rows - 1) == 0 and row_threads == -(-d // rows)
    runs = g // got_vec

    def keeps(r):
        lanes = -(-d // r) * runs
        return units * lanes >= box_iou_module.MIN_THREADS and lanes >= box_iou_module.MIN_UNIT_LANES

    assert rows == 1 or keeps(rows)
    assert rows == box_iou_module.MAX_ROWS or 2 * rows > d or not keeps(2 * rows)


def test_geometry_of_the_main_shapes():
    """The walks chosen at the main shapes (the mAP chunk walks 2 rows, so
    each unit's 8 lanes write 4 whole rows a step; float64 walks 8)."""
    geometry = box_iou_module.box_iou_geometry
    assert geometry(65536, 8, 8) == (4, 4, False)
    assert geometry(65536, 8, 8, torch.float64) == (1, 1, False)
    assert geometry(1, 4096, 4096) == (4, 512, False)
    assert geometry(1, 1024, 1024) == (4, 512, False)
    assert geometry(1024, 128, 128) == (4, 16, False)
    assert geometry(1000, 100, 30) == (2, 13, False)


def _div32(n, d):
    """The kernel's Div32: n // d by multiply-high, for n < 2**31."""
    s = 0
    while (1 << s) < d:
        s += 1
    m = ((1 << 32) * ((1 << s) - d)) // d + 1
    assert m < 1 << 32
    n = np.asarray(n, np.uint64)
    return (((n * np.uint64(m)) >> np.uint64(32)) + n) >> np.uint64(s)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 8, 15, 750, 1000, 1024, 3001, 65535, 2**20 + 7, 2**30, 2**31 - 1])
def test_magic_division_is_exact_below_2_31(d):
    rng = np.random.default_rng(d)
    n = np.concatenate([np.arange(0, 4096), rng.integers(0, 2**31, 100_000), [2**31 - 1, 2**31 - 2]])
    n = np.concatenate([n, np.clip(np.arange(1, 64)[:, None] * d + np.arange(-1, 2)[None, :], 0, 2**31 - 1).ravel()])
    np.testing.assert_array_equal(_div32(n, d), n.astype(np.uint64) // np.uint64(d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "shape", [(65536 // 64, 8, 8), (1, 512, 512), (1, 100, 301), (7, 100, 30), (3, 16, 5), (5, 1, 8), (5, 8, 1), (1, 1, 1), (2, 33, 7)]
)
def test_kernel_index_map_writes_every_output_once(shape, dtype, monkeypatch):
    """The kernel's index arithmetic, emulated thread by thread with the
    wrapper's geometry (the thread floor lowered so that these small shapes
    walk rows too): unit, row and column runs from two multiply-high
    divisions, then the walk over every row_threads-th row; every output
    is written exactly once, from its own unit's boxes."""
    monkeypatch.setattr(box_iou_module, "MIN_THREADS", 64)
    box_iou_module.box_iou_geometry.cache_clear()
    units, d, g = shape
    vec, row_threads, _ = box_iou_module.box_iou_geometry(units, d, g, dtype)
    box_iou_module.box_iou_geometry.cache_clear()
    runs = g // vec
    t = np.arange(units * row_threads * runs)
    q = _div32(t, runs).astype(np.int64)
    c = (t - q * runs) * vec
    u = _div32(q, row_threads).astype(np.int64)
    r0 = q - u * row_threads
    hits = np.zeros((units, d, g), np.int64)
    for k in range(-(-d // row_threads)):
        r = r0 + k * row_threads
        live = r < d
        for v in range(vec):
            np.add.at(hits, (u[live], r[live], c[live] + v), 1)
    assert (hits == 1).all()


def _kernel_iou(a, b, max_fn, min_fn):
    """The kernel's per-output arithmetic in numpy (float32 or float64
    throughout, no contraction), with the given min/max."""
    one = a.dtype.type
    area1 = (a[:, None, 2] - a[:, None, 0]) * (a[:, None, 3] - a[:, None, 1])
    area2 = (b[None, :, 2] - b[None, :, 0]) * (b[None, :, 3] - b[None, :, 1])

    def clip0(x):
        return np.where((x > 0) | np.isnan(x), x, one(0))

    w = clip0(min_fn(a[:, None, 2], b[None, :, 2]) - max_fn(a[:, None, 0], b[None, :, 0]))
    h = clip0(min_fn(a[:, None, 3], b[None, :, 3]) - max_fn(a[:, None, 1], b[None, :, 1]))
    inter = w * h
    union = (area1 + area2) - inter
    return np.where(union > 0, inter / np.where(union > 0, union, one(1)), one(0))


EDGE_VALUES = [0.0, -0.0, 1.0, -1.0, 7.5, np.inf, -np.inf, np.nan, -np.nan]
#: with a subnormal and a huge value, whose IoUs can be subnormal
EXTREME_VALUES = EDGE_VALUES + [1e-40, 3e38]


def _edge_boxes(rng, n, dtype, values=EDGE_VALUES):
    """Boxes whose coordinates come from ``values`` (NaN of both signs,
    +-0, +-inf) and small integers, so equal, touching and signed-zero
    coordinates meet often."""
    values = np.array(list(values) + [2.0, 3.0, 4.0, 5.0], dtype=np.float64)
    out = rng.choice(values, (n, 4))
    with np.errstate(invalid="ignore", over="ignore"):
        out[: n // 2, 2:] += out[: n // 2, :2]  # half of them ordered boxes over the same values
        return out.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_min_max_zero_sign_and_nan_payload_never_reach_the_output(dtype):
    """The kernel's float32 min/max is PTX max.NaN/min.NaN: the canonical
    NaN for a NaN operand, and either zero for +-0 operands. Every such
    choice gives the same bits as the select chain (the NaN operand itself,
    the second of equal operands): a min/max result only reaches a
    subtraction and clip0. Also no output is NaN or -0."""
    rng = np.random.default_rng(17)
    a, b = _edge_boxes(rng, 300, dtype, EXTREME_VALUES), _edge_boxes(rng, 301, dtype, EXTREME_VALUES)
    canon = dtype(np.nan)

    def chain_max(x, y):
        return np.where(np.isnan(x), x, np.where(np.isnan(y), y, np.where(x > y, x, y)))

    def chain_min(x, y):
        return np.where(np.isnan(x), x, np.where(np.isnan(y), y, np.where(x < y, x, y)))

    def first_max(x, y):  # canonical NaN, the first operand of equal ones
        return np.where(np.isnan(x) | np.isnan(y), canon, np.where(x >= y, x, y))

    def first_min(x, y):
        return np.where(np.isnan(x) | np.isnan(y), canon, np.where(x <= y, x, y))

    def plus_zero_max(x, y):  # canonical NaN, +0 over -0
        m = first_max(x, y)
        return np.where((m == 0) & ~np.isnan(m), dtype(0.0), m)

    def minus_zero_min(x, y):
        m = first_min(x, y)
        return np.where((m == 0) & ~np.isnan(m), dtype(-0.0), m)

    with np.errstate(all="ignore"):
        want = _kernel_iou(a, b, chain_max, chain_min)
        for max_fn, min_fn in ((first_max, first_min), (plus_zero_max, minus_zero_min), (plus_zero_max, first_min)):
            np.testing.assert_array_equal(_bits(_kernel_iou(a, b, max_fn, min_fn)), _bits(want))
    assert not np.isnan(want).any() and not np.signbit(want).any()
    got = _port(a, b)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _jax_dispatch(a, b):
    """The JAX package's entry point on the CPU: box_iou_dispatch routes to
    the jnp broadcast there."""
    if a.dtype == np.float64:
        with jax.enable_x64(True):
            return np.asarray(box_iou_dispatch(jnp.asarray(a), jnp.asarray(b)))
    return np.asarray(box_iou_dispatch(a, b))


# pairwise [N, M]: M = 1, 2, 3 mod 4, N = 1 and M = 1
@pytest.mark.parametrize("n,m", [(37, 61), (38, 62), (39, 63), (1, 64), (64, 1), (1, 1)])
def test_pairwise_edge_widths_match_jax_dispatch_bitwise(n, m):
    rng = np.random.default_rng(n * 1000 + m)
    a, b = _degenerate(_boxes(rng, n + 8))[:n], _degenerate(_boxes(rng, m + 8))[:m]
    want = _jax_dispatch(a, b)
    assert want.shape == (n, m)
    np.testing.assert_array_equal(_bits(_port(a, b)), _bits(want))


# batched [U, D, G]: G = 1, 2, 3 mod 4, D = 1, G = 1
@pytest.mark.parametrize("d,g", [(8, 5), (8, 6), (8, 7), (1, 8), (8, 1), (1, 1)])
def test_batched_edge_widths_match_jax_dispatch_bitwise(d, g):
    u = 12
    rng = np.random.default_rng(d * 100 + g)
    a = _degenerate(_boxes(rng, u * d + 8))[: u * d].reshape(u, d, 4)
    b = _degenerate(_boxes(rng, u * g + 8))[: u * g].reshape(u, g, 4)
    want = _jax_dispatch(a, b)
    assert want.shape == (u, d, g)
    np.testing.assert_array_equal(_bits(_port(a, b)), _bits(want))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("batched", [False, True])
def test_edge_values_match_jax_dispatch_bitwise(dtype, batched):
    """NaN of both signs, +-0 and +-inf, in the dtype itself: the port's
    plain version (what the kernels are held to) against the JAX package's
    entry point, bit for bit."""
    rng = np.random.default_rng(23)
    a, b = _edge_boxes(rng, 96, dtype), _edge_boxes(rng, 90, dtype)
    if batched:
        a, b = a.reshape(6, 16, 4), b.reshape(6, 15, 4)
    want = _jax_dispatch(a, b)
    got = _port(a, b)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


_C_TYPES = {
    "const void*": ctypes.c_void_p,
    "void*": ctypes.c_void_p,
    "long long": ctypes.c_longlong,
    "int": ctypes.c_int,
    "float": ctypes.c_float,
}


@pytest.mark.parametrize("module", ["box_iou", "segment_sum", "qsketch"])
def test_ctypes_signatures_match_the_c_launchers(module):
    """Each C launcher's parameters (the stream last) match the ctypes
    argtypes its wrapper declares: a missing one would hand the kernel a
    truncated pointer."""
    mod = importlib.import_module(f"metrics_tpu_torch.ops.{module}")
    source = (Path(mod.__file__).parent.parent / "csrc" / mod.SOURCE).read_text()
    extern = source[source.index('extern "C" {') :]
    for name, argtypes in mod._SIGNATURES.items():
        params = re.search(rf"int {name}\(([^)]*)\)", extern).group(1)
        c_types = [re.sub(r"\s*\w+$", "", p.strip()) for p in params.split(",")]
        assert [_C_TYPES[t] for t in c_types] == list(argtypes), name
        assert c_types[-1] == "void*"  # the stream


def test_jax_cpu_flushes_subnormal_ious_to_zero():
    """A property of the reference, not to be copied: XLA on the CPU
    flushes a subnormal float32 IoU (a small intersection over a union
    near float32's largest value) to +0, where the port's plain version,
    like the kernel on the card, keeps IEEE's subnormal result."""
    a = np.array([[-1.0, 2.0, 3e38, 3.0]], np.float32)
    b = np.array([[1.0, 2.0, 4.0, 6.0], [1e-40, 1.0, 2.0, 5.0]], np.float32)
    got = _port(a, b)
    want = _jax_dispatch(a, b)
    assert (got > 0).all() and (got < np.finfo(np.float32).tiny).all()
    np.testing.assert_array_equal(want, np.zeros_like(want))
    np.testing.assert_array_equal(_bits(got), _bits(_kernel_iou(a, b, np.maximum, np.minimum)))
