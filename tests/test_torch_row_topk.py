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
    wrapper counts one launch under ``row_topk``, passes n_pad and a scratch
    buffer only past one block's 16384 keys; the CPU route counts none."""
    calls = []

    def fake_launch(kernel, lib, device, fn, *args):
        calls.append((kernel, args[4:8], args[8] is not None))
        ops.count_launch(kernel)

    class FakeLib:
        row_topk_f32 = "row_topk_f32"

    monkeypatch.setattr(row_topk_module, "check_cuda", lambda *args: None)
    monkeypatch.setattr(row_topk_module, "load_library", lambda: FakeLib)
    monkeypatch.setattr(row_topk_module, "launch", fake_launch)
    ops.reset_launch_counts()
    x = torch.zeros(3, 2176)
    assert [t.shape for t in ops.row_topk_f32(x, x, x, 64, rows=torch.ones(3, dtype=torch.bool))] == [(3, 64)] * 3
    w = torch.zeros(2, 40000)
    ops.row_topk_f32(w, w, w, 10)
    assert ops.row_topk_f32(x[:0], x[:0], x[:0], 4)[0].shape == (0, 4)
    assert ops.launch_counts()["row_topk"] == 2
    assert calls == [("row_topk", (3, 2176, 64, 4096), False), ("row_topk", (2, 40000, 10, 65536), True)]
    monkeypatch.undo()
    ops.reset_launch_counts()
    ops.row_topk(x, x, x, 3)
    assert not any(ops.launch_counts().values())


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "long long": ctypes.c_longlong}


def test_ctypes_signature_matches_the_c_launcher():
    """The launcher's parameters (the stream last) match the ctypes argtypes
    its wrapper declares: a missing one would hand the kernel a truncated
    pointer."""
    source = (Path(row_topk_module.__file__).parent.parent / "csrc" / row_topk_module.SOURCE).read_text()
    extern = source[source.index('extern "C" {') :]
    for name, argtypes in row_topk_module._SIGNATURES.items():
        params = re.search(rf"int {name}\(([^)]*)\)", extern).group(1)
        c_types = [re.sub(r"\s*\w+$", "", p.strip()) for p in params.split(",")]
        assert [_C_TYPES[t] for t in c_types] == list(argtypes), name
        assert c_types[-1] == "void*"  # the stream
    # the run length the wrapper assumes is the kernel's (the shared network's)
    header = (Path(row_topk_module.__file__).parent.parent / "csrc" / "bitonic.cuh").read_text()
    assert '#include "bitonic.cuh"' in source and "using bitonic::kRun;" in source
    assert f"kRun = {row_topk_module._RUN};" in header


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
