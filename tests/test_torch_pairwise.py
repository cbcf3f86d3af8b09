"""The pairwise functionals: the port against the JAX package and float64.

Cosine, euclidean, linear and manhattan over the same seeded numpy rows
(``x`` [12, 7], ``y`` [9, 7]) in every reduction (None, "none", "mean",
"sum") and ``zero_diagonal`` setting (None, True, False), with one input
and with two. Each result is held within rtol 1e-5 / atol 1e-5 of the JAX
package's (float32 in a different order) and of the same formula in
float64 numpy, where euclidean's expansion ``|x|^2 + |y|^2 - 2 x.y`` is
held within 1e-4 absolute (float32 cancellation at squared norms up to
about 60), and a row's distance to itself, the square root of that
residue, within 1e-2. A set diagonal is exactly 0 in both. Also: the invalid shapes,
the manhattan distance in chunks bit-equal to one chunk, and the product
independent of the TF32 flags.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional.pairwise as jpw
import metrics_tpu_torch.functional as tfn
import metrics_tpu_torch.functional.pairwise as tpw
from metrics_tpu_torch.functional.pairwise.manhattan import _pairwise_manhattan_distance_update

torch.set_num_threads(2)

_rng = np.random.RandomState(21)
X = (_rng.randn(12, 7) * 1.5).astype(np.float32)
Y = (_rng.randn(9, 7) * 1.5).astype(np.float32)

NAMES = ["pairwise_cosine_similarity", "pairwise_euclidean_distance", "pairwise_linear_similarity", "pairwise_manhattan_distance"]


def _float64(name, x, y, zero_diagonal):
    x, y = x.astype(np.float64), y.astype(np.float64)
    if name == "pairwise_cosine_similarity":
        out = (x / np.linalg.norm(x, axis=1, keepdims=True)) @ (y / np.linalg.norm(y, axis=1, keepdims=True)).T
    elif name == "pairwise_euclidean_distance":
        out = np.sqrt(np.maximum(((x[:, None, :] - y[None, :, :]) ** 2).sum(-1), 0.0))
    elif name == "pairwise_linear_similarity":
        out = x @ y.T
    else:
        out = np.abs(x[:, None, :] - y[None, :, :]).sum(-1)
    if zero_diagonal:
        n = min(out.shape)
        out[np.arange(n), np.arange(n)] = 0
    return out


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean(-1)
    if reduction == "sum":
        return out.sum(-1)
    return out


@pytest.mark.parametrize("zero_diagonal", [None, True, False], ids=str)
@pytest.mark.parametrize("reduction", [None, "none", "mean", "sum"], ids=str)
@pytest.mark.parametrize("two_inputs", [False, True], ids=["x", "xy"])
@pytest.mark.parametrize("name", NAMES)
def test_pairwise_matches_jax_and_float64(name, reduction, zero_diagonal, two_inputs):
    y_np = Y if two_inputs else None
    got = getattr(tpw, name)(
        torch.from_numpy(X), None if y_np is None else torch.from_numpy(y_np), reduction=reduction, zero_diagonal=zero_diagonal
    )
    want = getattr(jpw, name)(jnp.asarray(X), None if y_np is None else jnp.asarray(y_np), reduction=reduction, zero_diagonal=zero_diagonal)
    got = got.numpy()
    assert got.dtype == np.float32 and got.shape == np.asarray(want).shape
    zero = zero_diagonal if zero_diagonal is not None else not two_inputs
    # a row's euclidean distance to itself is the square root of the
    # expansion's rounding residue (up to about sqrt(4 eps |x|^2) = 1e-2
    # here) in any float32 implementation, the JAX package's too
    self_distance = name == "pairwise_euclidean_distance" and not two_inputs and not zero
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-2 if self_distance else 1e-5)
    ref = _reduce(_float64(name, X, X if y_np is None else y_np, zero), reduction)
    atol = 1e-2 if self_distance else 1e-4 if name == "pairwise_euclidean_distance" else 1e-5
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=atol)
    if zero and reduction in (None, "none"):
        n = min(got.shape)
        assert np.array_equal(got[np.arange(n), np.arange(n)], np.zeros(n, np.float32))


def test_functional_exports():
    for name in NAMES:
        assert getattr(tfn, name) is getattr(tpw, name)


@pytest.mark.parametrize("name", NAMES)
def test_invalid_shapes_raise_as_jax(name):
    fn = getattr(tpw, name)
    with pytest.raises(ValueError, match="Expected argument `x` to be a 2D tensor"):
        fn(torch.ones(3))
    with pytest.raises(ValueError, match="Expected argument `y` to be a 2D tensor"):
        fn(torch.ones(3, 2), torch.ones(3, 3))
    with pytest.raises(ValueError, match="Expected argument `y` to be a 2D tensor"):
        fn(torch.ones(3, 2), torch.ones(2))
    with pytest.raises(ValueError, match="Expected reduction"):
        fn(torch.ones(3, 2), reduction="max")
    with pytest.raises(ValueError, match="Expected reduction"):
        getattr(jpw, name)(jnp.ones((3, 2)), reduction="max")


@pytest.mark.parametrize("chunk_rows", [1, 2, 5, 12])
def test_manhattan_chunks_are_bit_equal_to_one_chunk(chunk_rows):
    x, y = torch.from_numpy(X), torch.from_numpy(Y)
    whole = _pairwise_manhattan_distance_update(x, y)
    per_row = y.shape[0] * y.shape[1] * 4
    chunked = _pairwise_manhattan_distance_update(x, y, chunk_bytes=chunk_rows * per_row)
    assert torch.equal(whole.view(torch.int32), chunked.view(torch.int32))
    big = torch.from_numpy((_rng.randn(33, 64) * 3).astype(np.float32))
    one = _pairwise_manhattan_distance_update(big, zero_diagonal=True)
    assert torch.equal(one, _pairwise_manhattan_distance_update(big, zero_diagonal=True, chunk_bytes=chunk_rows * 33 * 64 * 4))


def test_product_does_not_depend_on_tf32_flags():
    x, y = torch.from_numpy(X), torch.from_numpy(Y)
    before = [getattr(tpw, name)(x, y) for name in NAMES]
    flag, precision = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
        after = [getattr(tpw, name)(x, y) for name in NAMES]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
        torch.set_float32_matmul_precision(precision)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
