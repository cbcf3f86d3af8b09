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
from metrics_tpu.ops.box_iou_pallas import box_iou_batched_tiled, box_iou_tiled
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
    geometry; the empty case launches nothing. The CPU route counts none."""
    calls = []

    def fake_launch(kernel, lib, device, fn, *args):
        calls.append((kernel, fn, args[3:]))
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
    counts = ops.launch_counts()
    assert counts["box_iou_pairwise"] == 1 and counts["box_iou_batched"] == 1
    assert calls == [("box_iou_pairwise", "f32", (1, 6, 40, 32)), ("box_iou_batched", "f64", (3, 8, 5, 8))]
    monkeypatch.undo()
    ops.reset_launch_counts()
    box_iou_module.box_iou(torch.zeros(6, 4), torch.zeros(4, 4))
    assert not any(ops.launch_counts().values())


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
