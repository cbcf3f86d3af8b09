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
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metrics_tpu import ops as jax_ops
from metrics_tpu.ops.scatter_pallas import segment_sum_tiled
from metrics_tpu_torch import ops
from metrics_tpu_torch.ops import build as kernel_build
from metrics_tpu_torch.ops.segment_sum import segment_sum_geometry

torch.set_num_threads(2)

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
