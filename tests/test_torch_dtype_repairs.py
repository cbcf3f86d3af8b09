"""Three repairs of the port, each against the JAX package.

- Integer images: SSIM, MS-SSIM and UQI refuse them with one ``TypeError``
  (functionals at the call, classes at ``update``). The JAX package raises
  too, by accident of its internals: ``OverflowError`` on uint8 (its
  Gaussian's ``arange``) and ``TypeError`` on int16/int32/int64 (its
  convolution's dtypes), the classes at ``compute``. Both are pinned.
- float64 inputs: the JAX package runs with x64 off, so float64 inputs
  become float32 and every state and value is float32. Over 21 metrics and
  float64, float32, float16 and bfloat16 inputs, the port's value and
  state dtypes equal the JAX package's, except where the port widens half
  precision to float32 and the JAX package keeps it (a property pinned in
  ``tests/test_torch_sliced.py``, listed here in ``WIDENS_HALF``). Values
  on float64 inputs are bit-equal to the port's on the same inputs rounded
  to float32; ``image_gradients`` gives float32 and int32 for float64 and
  int64 images. A float64 batch after a float32 one leaves the states
  float32, eager and through ``compile_update``.
- Sliced classification on probability and multilabel rows: ``select_topk``
  writes its mask out of place, which ``torch.func.vmap`` batches, and
  ranks a batched tensor by a float64 totalOrder key (some torch versions
  cannot batch the integer key's dtype view). Sliced
  Accuracy, Precision, Recall, F1Score and StatScores equal the JAX
  package's slice by slice (bit for bit).
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import metrics_tpu
import metrics_tpu.functional as jax_functional
from metrics_tpu.sliced import SlicedMetric as JaxSliced
import metrics_tpu_torch
import metrics_tpu_torch.functional as torch_functional
from metrics_tpu_torch.sliced import SlicedMetric

torch.set_num_threads(2)

_rng = np.random.default_rng(0)

# ---------------------------------------------------------------------------
# integer images
# ---------------------------------------------------------------------------
INT_DTYPES = {"uint8": np.uint8, "int16": np.int16, "int32": np.int32, "int64": np.int64}
IMAGE_FUNCTIONALS = {
    "structural_similarity_index_measure": "StructuralSimilarityIndexMeasure",
    "multiscale_structural_similarity_index_measure": "MultiScaleStructuralSimilarityIndexMeasure",
    "universal_image_quality_index": "UniversalImageQualityIndex",
}
#: what the JAX package raises on integer images (functional, and class at compute)
JAX_RAISES = {"uint8": OverflowError, "int16": TypeError, "int32": TypeError, "int64": TypeError}


def _int_images(dtype):
    rng = np.random.default_rng(0)
    preds = rng.integers(0, 246, (2, 3, 180, 180))
    target = np.clip(preds + rng.integers(-10, 11, preds.shape), 0, 255)
    return preds.astype(dtype), target.astype(dtype)


@pytest.mark.parametrize("dtype", list(INT_DTYPES))
@pytest.mark.parametrize("fn", list(IMAGE_FUNCTIONALS))
def test_integer_images_raise_in_both_packages(fn, dtype):
    preds, target = _int_images(INT_DTYPES[dtype])
    with pytest.raises(TypeError, match="floating point images"):
        getattr(torch_functional, fn)(torch.from_numpy(preds), torch.from_numpy(target))
    port = getattr(metrics_tpu_torch, IMAGE_FUNCTIONALS[fn])(device="cpu")
    with pytest.raises(TypeError, match="floating point images"):
        port.update(torch.from_numpy(preds), torch.from_numpy(target))  # before anything is computed

    with pytest.raises(JAX_RAISES[dtype]):
        getattr(jax_functional, fn)(jnp.asarray(preds), jnp.asarray(target))
    ref = getattr(metrics_tpu, IMAGE_FUNCTIONALS[fn])()
    ref.update(jnp.asarray(preds), jnp.asarray(target))  # the JAX package raises no earlier than compute
    with pytest.raises(JAX_RAISES[dtype]):
        ref.compute()


def test_float_and_int_pair_is_refused():
    x = torch.rand(1, 1, 16, 16)
    with pytest.raises(TypeError, match="floating point images"):
        torch_functional.structural_similarity_index_measure(x, (x * 255).to(torch.uint8))


# ---------------------------------------------------------------------------
# the dtype table
# ---------------------------------------------------------------------------
N = 64
_P = _rng.random(N).astype(np.float32) + 0.1
_T = (_P + 0.1 * _rng.random(N)).astype(np.float32)
_IMG_P = _rng.random((2, 3, 16, 16)).astype(np.float32)
_IMG_T = (_IMG_P * 0.8 + 0.1 * _rng.random((2, 3, 16, 16))).astype(np.float32)
_LABELS = (_rng.random(N) < 0.5).astype(np.int64)

#: name -> (constructor arguments, input kind)
TABLE = {
    "MeanSquaredError": ({}, "pair"),
    "MeanAbsoluteError": ({}, "pair"),
    "R2Score": ({}, "pair"),
    "PearsonCorrCoef": ({}, "pair"),
    "ExplainedVariance": ({}, "pair"),
    "MeanSquaredLogError": ({}, "pair"),
    "MeanAbsolutePercentageError": ({}, "pair"),
    "TweedieDevianceScore": ({"power": 1.5}, "pair"),
    "PeakSignalNoiseRatio": ({}, "image"),
    "StructuralSimilarityIndexMeasure": ({"kernel_size": (7, 7)}, "image"),
    "UniversalImageQualityIndex": ({"kernel_size": (7, 7)}, "image"),
    "SymmetricMeanAbsolutePercentageError": ({}, "pair"),
    "SpearmanCorrCoef": ({}, "pair"),
    "CosineSimilarity": ({}, "rows"),
    "SumMetric": ({}, "one"),
    "MeanMetric": ({}, "one"),
    "MaxMetric": ({}, "one"),
    "MinMetric": ({}, "one"),
    "CatMetric": ({}, "one"),
    "AUROC": ({}, "scores"),
    "HingeLoss": ({}, "scores"),
}
#: these sum half-precision inputs in float32 where the JAX package keeps
#: the half type (its weakly typed float default)
WIDENS_HALF = {
    "MeanSquaredError", "MeanAbsoluteError", "PearsonCorrCoef", "ExplainedVariance", "MeanSquaredLogError",
    "MeanAbsolutePercentageError", "TweedieDevianceScore", "PeakSignalNoiseRatio",
    "SymmetricMeanAbsolutePercentageError", "HingeLoss",
}
FLOAT_DTYPES = {"float64": torch.float64, "float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}


def _both(array, dtype):
    """The same values for both packages; half-precision JAX inputs from
    the torch tensor's bits."""
    t = torch.from_numpy(array).to(dtype)
    if dtype == torch.bfloat16:
        return t, jax.lax.bitcast_convert_type(jnp.asarray(t.view(torch.int16).numpy()), jnp.bfloat16)
    return t, jnp.asarray(t.numpy())


def _inputs(kind, dtype):
    """``(port args, jax args)``."""
    if kind == "pair":
        (a, ja), (b, jb) = _both(_P, dtype), _both(_T, dtype)
        return (a, b), (ja, jb)
    if kind == "rows":
        (a, ja), (b, jb) = _both(_P.reshape(8, 8), dtype), _both(_T.reshape(8, 8), dtype)
        return (a, b), (ja, jb)
    if kind == "image":
        (a, ja), (b, jb) = _both(_IMG_P, dtype), _both(_IMG_T, dtype)
        return (a, b), (ja, jb)
    if kind == "one":
        a, ja = _both(_P, dtype)
        return (a,), (ja,)
    a, ja = _both(_P / 1.2, dtype)
    return (a, torch.from_numpy(_LABELS)), (ja, jnp.asarray(_LABELS))


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def _port_run(name, args, inputs):
    metric = getattr(metrics_tpu_torch, name)(device="cpu", **args)
    metric.update(*inputs)
    return metric, metric.compute()


@pytest.mark.parametrize("dtype", list(FLOAT_DTYPES))
@pytest.mark.parametrize("name", list(TABLE))
def test_value_and_state_dtypes_follow_jax(name, dtype):
    args, kind = TABLE[name]
    port_in, jax_in = _inputs(kind, FLOAT_DTYPES[dtype])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port, value = _port_run(name, args, port_in)
        ref = getattr(metrics_tpu, name)(**args)
        ref.update(*jax_in)
        want = ref.compute()
    got_dtypes = [_dtype_name(value)] + [_dtype_name(getattr(port, k)) for k in ref._defaults if not isinstance(getattr(port, k), list)]
    want_dtypes = [_dtype_name(want)] + [_dtype_name(getattr(ref, k)) for k in ref._defaults if not isinstance(getattr(ref, k), list)]
    if dtype in ("float16", "bfloat16") and name in WIDENS_HALF:
        want_dtypes = ["float32" if d == dtype else d for d in want_dtypes]
    assert got_dtypes == want_dtypes
    for k in port._defaults:  # list states too (SSIM, UQI, CatMetric keep their inputs)
        chunks = getattr(port, k)
        for chunk in chunks if isinstance(chunks, list) else [chunks]:
            assert chunk.dtype != torch.float64, k

    if dtype == "float64":
        rounded = tuple(x.to(torch.float32) if x.dtype == torch.float64 else x for x in port_in)
        _, value32 = _port_run(name, args, rounded)
        assert torch.equal(value, value32)


@pytest.mark.parametrize("name", ["MeanSquaredError", "PeakSignalNoiseRatio", "R2Score", "TweedieDevianceScore"])
@pytest.mark.parametrize("fused", [False, True])
def test_float64_batch_midstream_keeps_float32_states(name, fused):
    args, kind = TABLE[name]
    first, _ = _inputs(kind, torch.float32)
    second, _ = _inputs(kind, torch.float64)
    metric = getattr(metrics_tpu_torch, name)(device="cpu", **args)
    plain = getattr(metrics_tpu_torch, name)(device="cpu", **args)
    target = metrics_tpu_torch.MetricCollection([metric]) if fused else metric
    if fused:
        target.compile_update()
    target.update(*first)
    target.update(*second)
    plain.update(*first)
    plain.update(*(x.to(torch.float32) for x in second))
    for k in metric._defaults:
        state = getattr(metric, k)
        assert state.dtype != torch.float64, k
        assert torch.equal(state, getattr(plain, k)), k


@pytest.mark.parametrize("dtype", ["float64", "int64", "float32", "int32", "uint8", "float16"])
def test_image_gradients_dtypes_follow_jax(dtype):
    img = np.arange(2 * 3 * 5 * 6).reshape(2, 3, 5, 6) % 17
    port = torch_functional.image_gradients(torch.from_numpy(img.astype(dtype)))
    ref = jax_functional.image_gradients(jnp.asarray(img.astype(dtype)))
    for got, want in zip(port, ref):
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fn", ["mean_squared_error", "mean_absolute_error", "peak_signal_noise_ratio", "structural_similarity_index_measure"])
def test_functionals_on_float64_match_float32(fn):
    kind = "image" if fn in ("peak_signal_noise_ratio", "structural_similarity_index_measure") else "pair"
    port64, jax_in = _inputs(kind, torch.float64)
    port32, _ = _inputs(kind, torch.float32)
    got = getattr(torch_functional, fn)(*port64)
    assert got.dtype == torch.float32
    assert torch.equal(got, getattr(torch_functional, fn)(*port32))
    assert str(np.asarray(getattr(jax_functional, fn)(*jax_in)).dtype) == "float32"


# ---------------------------------------------------------------------------
# sliced classification on probability and multilabel rows
# ---------------------------------------------------------------------------
SLICES = 5
SLICED = {
    "Accuracy": {"num_classes": 4},
    "Precision": {"num_classes": 4, "average": "micro"},
    "Recall": {"num_classes": 4, "average": "micro"},
    "F1Score": {"num_classes": 4, "average": "micro"},
    "StatScores": {"num_classes": 4, "reduce": "micro"},
}


def _probability_rows(seed, n=32):
    rng = np.random.default_rng(seed)
    scores = rng.random((n, 4)).astype(np.float32)
    return scores / scores.sum(1, keepdims=True), rng.integers(0, 4, n), rng.integers(0, SLICES, n)


def _multilabel_rows(seed, n=32):
    rng = np.random.default_rng(seed)
    return rng.random((n, 4)).astype(np.float32), rng.integers(0, 2, (n, 4)), rng.integers(0, SLICES, n)


@pytest.mark.parametrize("rows", ["probability", "multilabel"])
@pytest.mark.parametrize("name", list(SLICED))
def test_sliced_classification_matches_jax(name, rows):
    make = _probability_rows if rows == "probability" else _multilabel_rows
    port = SlicedMetric(getattr(metrics_tpu_torch, name)(device="cpu", **SLICED[name]), SLICES)
    ref = JaxSliced(getattr(metrics_tpu, name)(**SLICED[name]), num_slices=SLICES)
    for seed in (0, 1):
        preds, target, ids = make(seed)
        port.update(torch.from_numpy(ids), torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(ids), jnp.asarray(preds), jnp.asarray(target))
    got, want = port.compute(), ref.compute()
    assert got.dtype == torch.float32 if got.is_floating_point() else got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("topk", [1, 2, 3])
def test_select_topk_is_vmappable(topk):
    """Under ``vmap`` the ranking takes the float64 key (``_rank_key``): the
    same masks and labels as the integer totalOrder key, NaN of both signs,
    signed zeros, infinities and subnormals among the rows."""
    from metrics_tpu_torch.utils.data import select_topk, to_categorical

    x = torch.from_numpy(_probability_rows(3, n=64)[0]).reshape(8, 8, 4)
    edges = torch.tensor([float("nan"), -float("nan"), float("inf"), -float("inf"), 0.0, -0.0, 1e-45, -1e-45])
    x[0, :, 0] = edges
    x[1, :, 1], x[1, :, 2] = 0.0, -0.0
    x[2, :, 3] = edges.flip(0)
    batched = torch.func.vmap(lambda r: select_topk(r, topk=topk))(x)
    assert torch.equal(batched, torch.stack([select_topk(r, topk=topk) for r in x]))
    labels = torch.func.vmap(to_categorical)(x)
    assert torch.equal(labels, torch.stack([to_categorical(r) for r in x]))
