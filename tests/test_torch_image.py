"""SSIM, MS-SSIM, UQI and the image gradients: the port against the JAX package.

Every functional and class of ``metrics_tpu/functional/image/{ssim,uqi,
gradients}.py`` and ``metrics_tpu/image/{ssim,uqi}.py`` on the same seeded
numpy images (restoration-style pairs: the target a scaled, noisy copy of
the prediction), over ``kernel_size``, ``sigma``, ``data_range``,
``reduction``, ``betas`` and ``normalize``. Values are held within rtol
1e-5 of the JAX package's (atol 1e-6 for elementwise maps), NaN positions
exactly, the image gradients bit for bit, and every argument error to the
JAX package's type and message (shapes printed in each library's
spelling). Maps are compared at windows of 7 x 7 and wider: in a smaller
window the local variance ``E[p^2] - mu^2`` cancels in float32, and both
libraries' maps sit up to about 2e-5 from a float64 evaluation of the same
formulas (measured: the port convolves in float64 and rounds once, the JAX
package accumulates in float32, and the float32 epilogue is the same). Such
kernels are compared through their mean and sum at rtol 1e-5, and their
maps, port and JAX package alike, within 5e-5 of the float64 evaluation
(the port's code on float64 images). Plain torch: no kernel is involved.
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu
import metrics_tpu.functional as jax_functional
import metrics_tpu_torch
import metrics_tpu_torch.functional as torch_functional
from metrics_tpu_torch.convert import state_from_jax


def _jax_shapes(message):
    """``message`` with torch's shapes in the JAX package's spelling."""
    return re.sub(r"torch\.Size\(\[([^\]]*)\]\)", r"(\1)", message)


torch.set_num_threads(2)

RTOL, ATOL_MAP = 1e-5, 1e-6

_rng = np.random.RandomState(15)


def _pair(n, h, w, c=3):
    preds = _rng.rand(n, c, h, w).astype(np.float32)
    target = (preds * 0.75 + 0.1 * _rng.rand(n, c, h, w)).astype(np.float32)
    return preds, target


PAIR_SMALL = _pair(4, 32, 40)
PAIR_MS = _pair(2, 64, 72)  # MS-SSIM at kernel 3: H // 16 > 2
PAIR_MS_DEFAULT = _pair(1, 176, 176)  # MS-SSIM at the default kernel 11: H // 16 > 10


def _zero_patch(pair):
    """Both images zero over a corner: every window inside it is constant
    in both, so UQI divides 0 by 0 there (NaN), as SSIM does not."""
    preds, target = (x.copy() for x in pair)
    preds[:, :, :14, :16] = 0.0
    target[:, :, :14, :16] = 0.0
    return preds, target


PAIR_ZERO = _zero_patch(PAIR_SMALL)
#: three rows: a 7-row window's pad of 3 reflects twice, as numpy's
#: ``jnp.pad(mode="reflect")`` does (``F.pad`` refuses a pad that wide)
PAIR_THIN = tuple(np.ascontiguousarray(x[:, :, :3, :8]) for x in PAIR_SMALL)


def _close(got, want, elementwise):
    """``got`` (the port) against ``want`` (the JAX package): NaN by
    position, rtol 1e-5 (atol 1e-6 for a map)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_MAP if elementwise else 0.0, equal_nan=True)


def _run_both(name, pair, kwargs):
    preds, target = pair
    want = getattr(jax_functional, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = getattr(torch_functional, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    return got, want


SSIM_CASES = [
    {},
    {"kernel_size": (7, 7)},
    {"kernel_size": (5, 9), "sigma": (0.8, 1.7)},
    {"data_range": 1.0},
    {"data_range": 2.5, "k1": 0.02, "k2": 0.05},
    {"reduction": "sum"},
    {"reduction": "none"},
    {"reduction": "none", "kernel_size": (7, 9), "sigma": (1.0, 2.0), "data_range": 1.0},
    {"kernel_size": (3, 3), "sigma": (0.5, 0.5)},
    {"reduction": "sum", "kernel_size": (3, 3)},
    {"kernel_size": (1, 5)},  # a zero pad on one axis: the JAX package's crop leaves both axes
    {"reduction": "sum", "data_range": 1.0, "kernel_size": (9, 1)},
]


@pytest.mark.parametrize("kwargs", SSIM_CASES, ids=[str(c) for c in SSIM_CASES])
def test_ssim_functional(kwargs):
    got, want = _run_both("structural_similarity_index_measure", PAIR_SMALL, kwargs)
    _close(got, want, kwargs.get("reduction") == "none")


UQI_CASES = [
    ({}, PAIR_SMALL),
    ({"kernel_size": (7, 7), "sigma": (1.0, 2.0)}, PAIR_SMALL),
    ({"reduction": "sum"}, PAIR_SMALL),
    ({"reduction": "none"}, PAIR_SMALL),
    ({"data_range": 3.0}, PAIR_SMALL),
    ({"reduction": "none"}, PAIR_ZERO),
    ({"reduction": "none", "kernel_size": (7, 7)}, PAIR_ZERO),
    ({"kernel_size": (3, 3)}, PAIR_ZERO),
    ({}, PAIR_ZERO),
]


@pytest.mark.parametrize("kwargs,pair", UQI_CASES, ids=[f"{c}-{'zero' if p is PAIR_ZERO else 'rand'}" for c, p in UQI_CASES])
def test_uqi_functional(kwargs, pair):
    got, want = _run_both("universal_image_quality_index", pair, kwargs)
    if pair is PAIR_ZERO and kwargs.get("reduction") == "none":
        assert np.isnan(np.asarray(want)).any()  # the case holds NaN
    _close(got, want, kwargs.get("reduction") == "none")


def test_ssim_zero_patch_has_no_nan():
    got, want = _run_both("structural_similarity_index_measure", PAIR_ZERO, {"reduction": "none"})
    assert not np.isnan(np.asarray(want)).any()
    _close(got, want, True)


SMALL_WINDOW_CASES = [
    ("structural_similarity_index_measure", {"kernel_size": (3, 3), "sigma": (0.5, 0.5)}, PAIR_SMALL),
    ("structural_similarity_index_measure", {"kernel_size": (9, 1), "data_range": 1.0}, PAIR_SMALL),
    ("universal_image_quality_index", {"kernel_size": (3, 3)}, PAIR_ZERO),
    # the reflect pad, shared by UQI (``_local_moments``)
    ("structural_similarity_index_measure", {"kernel_size": (7, 1)}, PAIR_THIN),
]


@pytest.mark.parametrize("name,kwargs,pair", SMALL_WINDOW_CASES, ids=[f"{n}-{k}" for n, k, _ in SMALL_WINDOW_CASES])
def test_small_window_maps(name, kwargs, pair):
    """Small windows' maps: NaN by position, and the port and the JAX
    package each within 5e-5 of the float64 evaluation (their float32
    cancellation; see the module docstring)."""
    kwargs = {**kwargs, "reduction": "none"}
    got, want = _run_both(name, pair, kwargs)
    f64 = getattr(torch_functional, name)(*(torch.from_numpy(x).double() for x in pair), **kwargs).numpy()
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(f64))
    for value in (got, want):
        np.testing.assert_allclose(value, f64, rtol=0.0, atol=5e-5)


MS_CASES = [
    ({"kernel_size": (3, 3)}, PAIR_MS),
    ({"kernel_size": (3, 3), "normalize": "relu"}, PAIR_MS),
    ({"kernel_size": (3, 3), "normalize": "simple"}, PAIR_MS),
    ({"kernel_size": (3, 3), "betas": (0.2, 0.3, 0.5)}, PAIR_MS),
    ({"kernel_size": (5, 3), "sigma": (1.0, 0.7), "betas": (0.5, 0.5), "data_range": 1.0}, PAIR_MS),
    ({"kernel_size": (3, 3), "reduction": "sum", "normalize": "simple"}, PAIR_MS),
    ({}, PAIR_MS_DEFAULT),
]


@pytest.mark.parametrize("kwargs,pair", MS_CASES, ids=[str(c) for c, _ in MS_CASES])
def test_ms_ssim_functional(kwargs, pair):
    got, want = _run_both("multiscale_structural_similarity_index_measure", pair, kwargs)
    _close(got, want, False)


ERROR_CASES = [
    ("structural_similarity_index_measure", "dtype", {}),
    ("structural_similarity_index_measure", "shape", {}),
    ("structural_similarity_index_measure", "ndim", {}),
    ("structural_similarity_index_measure", None, {"kernel_size": (11,)}),
    ("structural_similarity_index_measure", None, {"kernel_size": (4, 4)}),
    ("structural_similarity_index_measure", None, {"kernel_size": (-3, 3)}),
    ("structural_similarity_index_measure", None, {"sigma": (1.5, 0.0)}),
    ("universal_image_quality_index", "dtype", {}),
    ("universal_image_quality_index", "ndim", {}),
    ("universal_image_quality_index", None, {"sigma": (1.5,)}),
    ("multiscale_structural_similarity_index_measure", None, {"betas": [0.5, 0.5]}),
    ("multiscale_structural_similarity_index_measure", None, {"betas": (1, 2)}),
    ("multiscale_structural_similarity_index_measure", None, {"normalize": "tanh"}),
    ("multiscale_structural_similarity_index_measure", "small", {}),
    ("multiscale_structural_similarity_index_measure", None, {"kernel_size": (5, 3)}),
    ("multiscale_structural_similarity_index_measure", None, {"kernel_size": (3, 5)}),
]


def _bad_inputs(kind):
    preds, target = PAIR_MS
    if kind == "dtype":
        return preds, target.astype(np.float16)
    if kind == "shape":
        return preds, target[:, :, :-1]
    if kind == "ndim":
        return preds[0], target[0]
    if kind == "small":
        return preds[:, :, :16, :16], target[:, :, :16, :16]
    return preds, target


@pytest.mark.parametrize("name,kind,kwargs", ERROR_CASES, ids=[f"{n}-{k}-{a}" for n, k, a in ERROR_CASES])
def test_argument_errors_match(name, kind, kwargs):
    preds, target = _bad_inputs(kind)
    with pytest.raises(Exception) as want:
        getattr(jax_functional, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    with pytest.raises(Exception) as got:
        getattr(torch_functional, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    assert got.type is want.type
    if kind == "dtype":  # the dtypes print in each library's own spelling
        assert str(got.value).split(" Got")[0] == str(want.value).split(" Got")[0]
    else:
        assert _jax_shapes(str(got.value)) == str(want.value)


CLASS_ERRORS = [
    ("MultiScaleStructuralSimilarityIndexMeasure", {"betas": (1, 2)}),
    ("MultiScaleStructuralSimilarityIndexMeasure", {"normalize": "tanh"}),
]


@pytest.mark.parametrize("cls,kwargs", CLASS_ERRORS, ids=[str(k) for _, k in CLASS_ERRORS])
def test_class_argument_errors_match(cls, kwargs):
    with pytest.raises(ValueError) as want:
        getattr(metrics_tpu, cls)(**kwargs)
    with pytest.raises(ValueError) as got:
        getattr(metrics_tpu_torch, cls)(device="cpu", **kwargs)
    assert str(got.value) == str(want.value)


CLASS_CASES = [
    ("StructuralSimilarityIndexMeasure", {}, PAIR_SMALL),
    ("StructuralSimilarityIndexMeasure", {"data_range": 1.0, "kernel_size": (5, 5)}, PAIR_SMALL),
    ("StructuralSimilarityIndexMeasure", {"reduction": "none"}, PAIR_SMALL),
    ("UniversalImageQualityIndex", {}, PAIR_SMALL),
    ("UniversalImageQualityIndex", {"reduction": "none"}, PAIR_ZERO),
    ("MultiScaleStructuralSimilarityIndexMeasure", {"kernel_size": (3, 3)}, PAIR_MS),
    ("MultiScaleStructuralSimilarityIndexMeasure", {"kernel_size": (3, 3), "normalize": "relu", "betas": (0.4, 0.6)}, PAIR_MS),
]


@pytest.mark.parametrize("cls,kwargs,pair", CLASS_CASES, ids=[f"{c}-{k}" for c, k, _ in CLASS_CASES])
def test_modular_against_jax(cls, kwargs, pair):
    """Two updates (the halves of the batch) then ``compute``; ``forward``'s
    batch value (SSIM and UQI: an MS-SSIM batch value would compile the
    JAX package's five scales at one more shape); the list states;
    ``reset``; the pure-state API and ``state_from_jax``."""
    preds, target = pair
    half = preds.shape[0] // 2
    jm = getattr(metrics_tpu, cls)(**kwargs)
    tm = getattr(metrics_tpu_torch, cls)(device="cpu", **kwargs)
    elementwise = kwargs.get("reduction") == "none"
    for lo, hi in ((0, half), (half, None)):
        batch = (preds[lo:hi], target[lo:hi])
        if cls.startswith("MultiScale"):
            jm.update(*(jnp.asarray(x) for x in batch))
            tm.update(*(torch.from_numpy(x) for x in batch))
            continue
        _close(tm(*(torch.from_numpy(x) for x in batch)), jm(*(jnp.asarray(x) for x in batch)), elementwise)
    _close(tm.compute(), jm.compute(), elementwise)
    assert [tuple(t.shape) for t in tm.preds] == [tuple(np.shape(t)) for t in jm.preds]
    np.testing.assert_array_equal(torch.cat(tm.target).numpy(), np.concatenate([np.asarray(t) for t in jm.target]))

    state = {name: [np.asarray(v) for v in getattr(jm, name)] for name in ("preds", "target")}
    carried = state_from_jax(state, tm)
    _close(tm.compute_state(carried), jm.compute(), elementwise)
    pure = tm.update_state(tm.init_state(), torch.from_numpy(preds), torch.from_numpy(target))
    _close(tm.compute_state(pure), jm.compute(), elementwise)

    tm.reset()
    assert tm.preds == [] and tm.target == []


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int32, np.int16, np.uint8])
def test_image_gradients_bit_equal(dtype):
    img = (_rng.randn(2, 3, 9, 7) * 50).astype(dtype)
    jdy, jdx = jax_functional.image_gradients(jnp.asarray(img))
    tdy, tdx = torch_functional.image_gradients(torch.from_numpy(img))
    for got, want in ((tdy, jdy), (tdx, jdx)):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy().view(np.uint8), want.view(np.uint8))


def test_image_gradients_doc_example():
    img = torch.arange(16, dtype=torch.float32).reshape(1, 1, 4, 4)
    dy, dx = torch_functional.image_gradients(img)
    want_dy, want_dx = jax_functional.image_gradients(jnp.arange(16, dtype=jnp.float32).reshape(1, 1, 4, 4))
    np.testing.assert_array_equal(dy.numpy(), np.asarray(want_dy))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(want_dx))


@pytest.mark.parametrize("bad", ["list", "ndim3"])
def test_image_gradients_errors(bad):
    if bad == "list":
        with pytest.raises(TypeError, match="expects a value of <Array> type"):
            torch_functional.image_gradients([[1.0]])
        with pytest.raises(TypeError, match="expects a value of <Array> type"):
            jax_functional.image_gradients([[1.0]])
        return
    with pytest.raises(RuntimeError) as got:
        torch_functional.image_gradients(torch.zeros(3, 4, 4))
    with pytest.raises(RuntimeError) as want:
        jax_functional.image_gradients(jnp.zeros((3, 4, 4)))
    assert str(got.value) == str(want.value)


def test_data_range_none_reads_nothing():
    """``data_range=None`` is taken on the images' device: the functional
    runs under the fused update's host-read probe."""
    from metrics_tpu_torch.core.fused import _NoHostReads

    preds, target = (torch.from_numpy(x) for x in PAIR_SMALL)
    with _NoHostReads():
        value = torch_functional.structural_similarity_index_measure(preds, target)
        uqi = torch_functional.universal_image_quality_index(preds, target)
    want = jax_functional.structural_similarity_index_measure(*(jnp.asarray(x) for x in PAIR_SMALL))
    _close(value, want, False)
    assert torch.isfinite(uqi)


def test_conv_ignores_precision_flags():
    """The grouped convolution is taken in float64 and rounded once: the
    caller's TF32 and matmul-precision settings change no bit (on the CPU
    they would not anyway; this pins that the call leaves them as found)."""
    before = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    preds, target = (torch.from_numpy(x) for x in PAIR_SMALL)
    a = torch_functional.structural_similarity_index_measure(preds, target, reduction="none")
    torch.set_float32_matmul_precision("medium")
    try:
        b = torch_functional.structural_similarity_index_measure(preds, target, reduction="none")
    finally:
        torch.set_float32_matmul_precision(before[1])
    assert torch.equal(a, b)
    assert (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()) == before
