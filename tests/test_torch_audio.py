"""The audio family: the port against the JAX package on the CPU.

Every functional and class of ``metrics_tpu/functional/audio/{snr,sdr,pit,
stoi}.py`` and ``metrics_tpu/audio/{snr,sdr,pit,stoi}.py`` on the same
seeded numpy signals (each estimate a short causal filter of its target
plus noise at a set SNR). Tolerances:

- SNR, SI-SNR and SI-SDR: within 1e-4 dB;
- SDR, direct solve and conjugate gradient alike:
  ``|d| <= 1e-4 + 1e-5 * 10**(SDR / 10)`` dB (float32 rounding grows as the
  coherence nears 1, about tenfold per 10 dB). The port computes SDR in
  float64 and rounds once, so the gap is the JAX package's own float32
  error: on these signals (white targets through a short filter) it sits
  well inside the bound, the CG path's too, so the CG bound is not
  loosened past the direct one; on voiced sources it reaches about 4x the
  bound, which a test pins as a property of the reference;
- PIT: ``best_perm`` equal, ``best_metric`` under its metric's bound; past
  six speakers ``best_perm`` equal to the JAX package's own solver's (the
  same C++ source and flags) and its total equal to scipy's optimum;
- STOI and eSTOI: within 1e-5;
- sliced SI-SDR: per-slice states bit-equal to the plain segment fold of
  the per-row values, values within 1e-4 dB of the JAX ``SlicedMetric``.

Half-precision inputs differ by design: the JAX package computes the SNR
family's float16 and bfloat16 inputs in their own dtype (float16 epsilon,
float16 state), the port widens them to float32 first. The dtype table pins
both. The Hungarian solver is built here with ``g++`` into a temporary
directory; a broken source raises with the compiler's output.
"""
import re
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu.audio as jax_audio
import metrics_tpu.functional.audio as jax_functional
import metrics_tpu_torch
import metrics_tpu_torch.audio as torch_audio
import metrics_tpu_torch.functional.audio as torch_functional
from metrics_tpu.sliced import SlicedMetric as JaxSlicedMetric
from metrics_tpu_torch import native
from metrics_tpu_torch.convert import state_from_jax
from metrics_tpu_torch.ops import segment_sum_reference
from metrics_tpu_torch.sliced import SlicedMetric

torch.set_num_threads(2)

ATOL_DB = 1e-4
STOI_ATOL = 1e-5
_FILTER = np.array([1.0, 0.5, -0.2, 0.1])


def _signals(seed, shape, snr_db=10.0):
    """``(preds, target)`` float32: target white noise, preds the target
    through a causal 4-tap filter plus noise at ``snr_db``."""
    rng = np.random.default_rng(seed)
    target = rng.standard_normal(shape)
    filtered = np.apply_along_axis(lambda x: np.convolve(x, _FILTER)[: shape[-1]], -1, target)
    noise = rng.standard_normal(shape)
    noise *= np.sqrt(np.mean(filtered**2) / (np.mean(noise**2) * 10 ** (snr_db / 10)))
    return (filtered + noise).astype(np.float32), target.astype(np.float32)


def _sdr_bound(sdr_db):
    return 1e-4 + 1e-5 * 10 ** (np.asarray(sdr_db, np.float64) / 10)


def _close_db(got, want, bound=ATOL_DB):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.abs(got.astype(np.float64) - want.astype(np.float64)) <= bound), (got, want)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the docstring values
# ---------------------------------------------------------------------------

DOC_TARGET = np.array([3.0, -0.5, 2.0, 7.0], np.float32)
DOC_PREDS = np.array([2.5, 0.0, 2.0, 8.0], np.float32)
DOC_PIT_PREDS = np.array([[[-0.0579, 0.3560, -0.9604], [-0.1719, 0.3205, 0.2951]]], np.float32)
DOC_PIT_TARGET = np.array([[[1.0958, -0.1648, 0.5228], [-0.4100, 1.1942, -0.5103]]], np.float32)


@pytest.mark.parametrize(
    "name, value",
    [
        ("signal_noise_ratio", 16.180481),
        ("scale_invariant_signal_distortion_ratio", 18.402992),
        ("scale_invariant_signal_noise_ratio", 15.091757),
    ],
)
def test_docstring_values(name, value):
    got = getattr(torch_functional, name)(_t(DOC_PREDS), _t(DOC_TARGET))
    want = getattr(jax_functional, name)(jnp.asarray(DOC_PREDS), jnp.asarray(DOC_TARGET))
    assert got.dtype == torch.float32 and got.shape == ()
    _close_db(got, want)
    _close_db(got, np.float32(value))


def test_docstring_pit():
    best_metric, best_perm = torch_functional.permutation_invariant_training(
        _t(DOC_PIT_PREDS), _t(DOC_PIT_TARGET), torch_functional.scale_invariant_signal_distortion_ratio, "max"
    )
    _close_db(best_metric, np.array([-5.1091003], np.float32))
    assert best_perm.dtype == torch.int32 and best_perm.tolist() == [[0, 1]]
    metric = torch_audio.PermutationInvariantTraining(torch_functional.scale_invariant_signal_distortion_ratio, "max", device="cpu")
    _close_db(metric(_t(DOC_PIT_PREDS), _t(DOC_PIT_TARGET)), np.float32(-5.1091003))


# ---------------------------------------------------------------------------
# SNR, SI-SNR, SI-SDR
# ---------------------------------------------------------------------------

SNR_CASES = [
    (name, shape, kwargs)
    for name, kw_options in (
        ("signal_noise_ratio", ({}, {"zero_mean": True})),
        ("scale_invariant_signal_distortion_ratio", ({}, {"zero_mean": True})),
        ("scale_invariant_signal_noise_ratio", ({},)),
    )
    for shape in ((1000,), (4, 2000), (2, 3, 1500))
    for kwargs in kw_options
]


@pytest.mark.parametrize("name, shape, kwargs", SNR_CASES)
def test_snr_family_functional(name, shape, kwargs):
    preds, target = _signals(len(shape) + shape[-1], shape, snr_db=12.0)
    preds = preds + 0.3  # a DC offset, which zero_mean removes
    got = getattr(torch_functional, name)(_t(preds), _t(target), **kwargs)
    want = getattr(jax_functional, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    assert tuple(got.shape) == shape[:-1] and got.dtype == torch.float32
    _close_db(got, want)


# ---------------------------------------------------------------------------
# SDR
# ---------------------------------------------------------------------------

SDR_CASES = [
    (0.0, 4000, {}),
    (10.0, 4000, {}),
    (20.0, 4000, {}),
    (30.0, 4000, {}),
    (40.0, 4000, {}),
    (20.0, 8000, {"filter_length": 16}),
    (20.0, 2000, {"filter_length": 64}),
    (10.0, 1000, {"filter_length": 128, "zero_mean": True}),
    (20.0, 4000, {"load_diag": 1e-3}),
    (20.0, 4000, {"zero_mean": True, "load_diag": 1e-2}),
    (0.0, 4000, {"use_cg_iter": 10}),
    (20.0, 4000, {"use_cg_iter": 10}),
    (40.0, 4000, {"use_cg_iter": 10}),
    (20.0, 4000, {"use_cg_iter": 3, "filter_length": 64}),
    (30.0, 8000, {"use_cg_iter": 10, "filter_length": 128, "load_diag": 1e-3}),
]


@pytest.mark.parametrize("snr_db, length, kwargs", SDR_CASES)
def test_sdr_functional(snr_db, length, kwargs):
    preds, target = _signals(int(snr_db) + length, (3, length), snr_db=snr_db)
    got = torch_functional.signal_distortion_ratio(_t(preds), _t(target), **kwargs)
    want = np.asarray(jax_functional.signal_distortion_ratio(jnp.asarray(preds), jnp.asarray(target), **kwargs))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3,)
    _close_db(got, want, _sdr_bound(want))


def test_sdr_filter_length_512_and_float64_agree():
    """At the default filter of 512 taps, and against a float64 SDR (the
    port's own code on float64 tensors, bypassing the float32 cast), the
    float32 result stays under the scaled bound."""
    from metrics_tpu_torch.functional.audio.sdr import _sdr_kernel

    preds, target = _signals(5, (2, 4000), snr_db=15.0)
    got = torch_functional.signal_distortion_ratio(_t(preds), _t(target))
    want = np.asarray(jax_functional.signal_distortion_ratio(jnp.asarray(preds), jnp.asarray(target)))
    _close_db(got, want, _sdr_bound(want))
    wide = _sdr_kernel(_t(preds).double(), _t(target).double(), None, 512, False, None)
    _close_db(got, wide.numpy(), _sdr_bound(wide.numpy()))


def _voiced(rng, n, length, fs):
    """Voiced-speech-like sources: five harmonics of a 90-250 Hz pitch under a
    syllable envelope over a noise floor of 0.01."""
    t = np.arange(length) / fs
    rows = []
    for _ in range(n):
        f0, rate, phase = rng.uniform(90, 250), rng.uniform(2, 5), rng.uniform(0, 2 * np.pi, 6)
        carrier = sum(np.sin(2 * np.pi * k * f0 * t + phase[k]) / k for k in range(1, 6))
        rows.append(np.clip(np.sin(2 * np.pi * rate * t + phase[0]), 0, None) * carrier + 0.01 * rng.standard_normal(length))
    return np.stack(rows)


def test_sdr_float64_inside_and_the_references_float32_drift():
    """Pinned property of the reference: on voiced sources (a narrow-band
    spectrum, so an ill-conditioned 512 x 512 Toeplitz system) the JAX
    package's float32 SDR drifts from a float64 evaluation by up to about
    4.2 times the SDR bound (measured 4.25 here, at -11.6 dB), while the
    port, which computes in float64 and rounds once, stays within float32
    rounding of it. ROADMAP.md C."""
    rng = np.random.default_rng(0)
    target = _voiced(rng, 8, 8000, 8000)
    other = _voiced(rng, 8, 8000, 8000)
    sir = rng.uniform(-15, 20, (8, 1))
    gain = np.sqrt((target**2).mean(-1, keepdims=True) / (other**2).mean(-1, keepdims=True)) * 10 ** (-sir / 20)
    preds = (target + gain * other + 0.001 * rng.standard_normal(target.shape)).astype(np.float32)
    target = target.astype(np.float32)
    from metrics_tpu_torch.functional.audio.sdr import _sdr_kernel

    wide = _sdr_kernel(_t(preds).double(), _t(target).double(), None, 512, False, None).numpy()
    got = torch_functional.signal_distortion_ratio(_t(preds), _t(target)).numpy()
    want = np.asarray(jax_functional.signal_distortion_ratio(jnp.asarray(preds), jnp.asarray(target)))
    assert np.all(np.abs(got - wide) <= 1e-6 + 2**-23 * np.abs(wide))
    share = np.abs(want - wide) / _sdr_bound(wide)
    assert share.max() <= 10.0, share


# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------

_JAX_DTYPES = {"float64": np.float64, "float32": np.float32, "float16": np.float16, "bfloat16": jnp.bfloat16, "int32": np.int32}
_TORCH_DTYPES = {"float64": torch.float64, "float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16, "int32": torch.int32}


def _typed(x, dtype_name):
    """``x`` (float32) in ``dtype_name`` for both packages: integers as
    rounded hundredths, so both see the same integers."""
    if dtype_name == "int32":
        x = np.round(x * 100)
    jax_x = jnp.asarray(x, _JAX_DTYPES[dtype_name])
    torch_x = _t(np.asarray(jax_x.astype(jnp.float32))).to(_TORCH_DTYPES[dtype_name])
    return jax_x, torch_x


@pytest.mark.parametrize("dtype_name", ["float64", "float32", "float16", "bfloat16", "int32"])
@pytest.mark.parametrize("name", ["signal_noise_ratio", "scale_invariant_signal_distortion_ratio", "scale_invariant_signal_noise_ratio"])
def test_snr_family_dtype_table(name, dtype_name):
    """float64 and float32 agree with the JAX package in float32. Half
    precision: the port computes in float32 on the same (rounded) values
    and so equals its float32 result on them; the JAX package computes in
    the half dtype with its epsilon, and lands within that dtype's
    rounding. Integers raise ``ValueError`` in both (``finfo``)."""
    preds, target = _signals(3, (2, 1000), snr_db=10.0)
    (jp, tp), (jt, tt) = _typed(preds, dtype_name), _typed(target, dtype_name)
    fn, jax_fn = getattr(torch_functional, name), getattr(jax_functional, name)
    if dtype_name == "int32":
        with pytest.raises(ValueError, match="not inexact"):
            jax_fn(jp, jt)
        with pytest.raises(ValueError, match="not inexact"):
            fn(tp, tt)
        return
    got, want = fn(tp, tt), np.asarray(jax_fn(jp, jt))
    assert got.dtype == torch.float32
    if dtype_name in ("float64", "float32"):
        assert want.dtype == np.float32
        _close_db(got, want)
        return
    # half precision: the port's value is its float32 value on the rounded inputs
    assert torch.equal(got, fn(tp.float(), tt.float()))
    assert str(want.dtype) == dtype_name
    half_step = {"float16": 2.0**-10, "bfloat16": 2.0**-7}[dtype_name] * 16  # a few ulps of a ~10 dB value
    gap = np.abs(got.numpy() - want.astype(np.float32))
    assert np.all(gap <= half_step), gap


@pytest.mark.parametrize("dtype_name", ["float64", "float32", "float16", "bfloat16", "int32"])
def test_sdr_dtype_table(dtype_name):
    """SDR computes in float32 from every input dtype, in both packages."""
    preds, target = _signals(4, (2, 2000), snr_db=10.0)
    (jp, tp), (jt, tt) = _typed(preds, dtype_name), _typed(target, dtype_name)
    got = torch_functional.signal_distortion_ratio(tp, tt, filter_length=64)
    want = np.asarray(jax_functional.signal_distortion_ratio(jp, jt, filter_length=64))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    _close_db(got, want, _sdr_bound(want))


@pytest.mark.parametrize("dtype_name", ["float64", "float32", "float16", "bfloat16"])
def test_class_state_dtypes(dtype_name):
    """The port's states stay float32 sum and int32 count for every input
    dtype; the JAX package's float sum takes a half input's dtype (its
    ``jnp.asarray(0.0)`` default is weakly typed), which is the pinned
    difference."""
    preds, target = _signals(6, (2, 1000), snr_db=10.0)
    (jp, tp), (jt, tt) = _typed(preds, dtype_name), _typed(target, dtype_name)
    metric, jax_metric = torch_audio.SignalNoiseRatio(device="cpu"), jax_audio.SignalNoiseRatio()
    metric.update(tp, tt)
    jax_metric.update(jp, jt)
    assert metric.sum_snr.dtype == torch.float32 and metric.total.dtype == torch.int32
    assert np.asarray(jax_metric.total).dtype == np.int32
    want_sum = np.asarray(jax_metric.sum_snr)
    assert str(want_sum.dtype) == (dtype_name if dtype_name in ("float16", "bfloat16") else "float32")
    if dtype_name in ("float64", "float32"):
        _close_db(metric.compute(), jax_metric.compute())


# ---------------------------------------------------------------------------
# PIT
# ---------------------------------------------------------------------------


def _speakers(seed, batch, spk, length, swap=True):
    """Estimates of ``spk`` speakers, each its source plus leakage of the
    others and noise, in a seeded order per row."""
    rng = np.random.default_rng(seed)
    target = rng.standard_normal((batch, spk, length)).astype(np.float32)
    preds = np.empty_like(target)
    for b in range(batch):
        order = rng.permutation(spk) if swap else np.arange(spk)
        mix = target[b, order] + 0.3 * target[b].mean(0, keepdims=True)
        preds[b] = mix + 0.2 * rng.standard_normal((spk, length))
    return preds, target


PIT_CASES = [
    (spk, metric, eval_func)
    for spk in (2, 3, 4, 6, 7, 8)
    for metric, eval_func in (
        ("scale_invariant_signal_distortion_ratio", "max"),
        ("signal_noise_ratio", "max"),
        ("scale_invariant_signal_noise_ratio", "min"),
    )
]


@pytest.mark.parametrize("spk, metric, eval_func", PIT_CASES)
def test_pit_functional(spk, metric, eval_func):
    preds, target = _speakers(spk, 4, spk, 1000)
    got_metric, got_perm = torch_functional.permutation_invariant_training(
        _t(preds), _t(target), getattr(torch_functional, metric), eval_func
    )
    want_metric, want_perm = jax_functional.permutation_invariant_training(
        jnp.asarray(preds), jnp.asarray(target), getattr(jax_functional, metric), eval_func
    )
    assert got_perm.dtype == torch.int32 and got_metric.dtype == torch.float32
    np.testing.assert_array_equal(got_perm.numpy(), np.asarray(want_perm))
    _close_db(got_metric, want_metric)


@pytest.mark.parametrize("filter_length, use_cg_iter", [(16, None), (64, 10)])
def test_pit_sdr_kwargs(filter_length, use_cg_iter):
    """PIT over SDR with its keyword arguments forwarded, functional and
    class (whose base keyword ``device`` goes to the metric)."""
    preds, target = _speakers(11, 3, 2, 2000)
    kw = {"filter_length": filter_length, "use_cg_iter": use_cg_iter}
    got_metric, got_perm = torch_functional.permutation_invariant_training(
        _t(preds), _t(target), torch_functional.signal_distortion_ratio, "max", **kw
    )
    want_metric, want_perm = jax_functional.permutation_invariant_training(
        jnp.asarray(preds), jnp.asarray(target), jax_functional.signal_distortion_ratio, "max", **kw
    )
    np.testing.assert_array_equal(got_perm.numpy(), np.asarray(want_perm))
    _close_db(got_metric, want_metric, _sdr_bound(np.asarray(want_metric)))
    metric = torch_audio.PermutationInvariantTraining(torch_functional.signal_distortion_ratio, device="cpu", **kw)
    jax_metric = jax_audio.PermutationInvariantTraining(jax_functional.signal_distortion_ratio, **kw)
    assert metric.kwargs == kw and metric.device.type == "cpu"
    metric.update(_t(preds), _t(target))
    jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
    want = np.asarray(jax_metric.compute())
    _close_db(metric.compute(), want, _sdr_bound(want))


@pytest.mark.parametrize("spk", [7, 8, 10])
@pytest.mark.parametrize("maximize", [True, False])
def test_hungarian_path_matches_jax_solver_and_scipy(spk, maximize):
    """Past six speakers: the port's solver gives the JAX package's
    assignment (the same source and flags) and scipy's optimal total."""
    from scipy.optimize import linear_sum_assignment

    from metrics_tpu.native import lsap as jax_lsap

    rng = np.random.default_rng(spk)
    costs = rng.standard_normal((5, spk, spk)).astype(np.float32)
    got = native.lsap(costs, maximize=maximize)
    assert got.dtype == np.int32 and got.shape == (5, spk)
    np.testing.assert_array_equal(got, jax_lsap(costs, maximize=maximize))
    for b in range(5):
        rows, cols = linear_sum_assignment(costs[b].astype(np.float64), maximize=maximize)
        assert sorted(got[b].tolist()) == list(range(spk))
        np.testing.assert_allclose(
            costs[b].astype(np.float64)[np.arange(spk), got[b]].sum(), costs[b].astype(np.float64)[rows, cols].sum(), rtol=0, atol=1e-9
        )


def test_lsap_refuses_non_finite_and_bad_shapes():
    with pytest.raises(ValueError, match="invalid numeric entries"):
        native.lsap(np.array([[[0.0, np.inf], [1.0, 2.0]]]))
    with pytest.raises(ValueError, match="invalid numeric entries"):
        native.lsap(np.array([[[0.0, np.nan], [1.0, 2.0]]]))
    with pytest.raises(ValueError, match="square cost matrices"):
        native.lsap(np.zeros((2, 3, 4)))
    np.testing.assert_array_equal(native.lsap(np.array([[4.0, 1.0], [2.0, 8.0]])), [[1, 0]])


def test_lsap_builds_with_gxx_in_a_fresh_directory(tmp_path):
    """The copy of the source builds into an empty directory, is named by
    its hash and loads; a second build finds it."""
    if shutil.which("g++") is None:  # decided in the test, never at import
        pytest.fail("g++ is required to build the Hungarian solver")
    lib_path = native.build(native.SOURCE, tmp_path)
    assert lib_path.parent == tmp_path and lib_path.is_file()
    assert re.fullmatch(r"lsap-[0-9a-f]{16}\.so", lib_path.name)
    assert native.build(native.SOURCE, tmp_path) == lib_path
    assert list(tmp_path.iterdir()) == [lib_path]  # no temporary file left
    lib = native.load_library(native.SOURCE, tmp_path)
    costs = np.ascontiguousarray(np.random.default_rng(0).standard_normal((3, 7, 7)))
    out = np.empty((3, 7), np.int32)
    import ctypes

    rc = lib.lsap_batch(
        costs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), 3, 7, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    )
    assert rc == 0
    np.testing.assert_array_equal(out, native.lsap(costs))
    assert (native.SOURCE.read_text().split("#include", 1)[1] == (native.SOURCE.parent.parent.parent / "metrics_tpu" / "native" / "lsap.cpp").read_text().split("#include", 1)[1])


def test_lsap_broken_source_raises_with_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s message and leaves
    no library; PIT past six speakers then raises too: no fallback."""
    broken = tmp_path / "lsap.cpp"
    broken.write_text(native.SOURCE.read_text().replace("return 0;\n}\n\n}  // extern", "return 0 +;\n}\n\n}  // extern"))
    build_dir = tmp_path / "build"
    with pytest.raises(RuntimeError, match=r"g\+\+ failed to build .*lsap\.cpp(.|\n)*error"):
        native.build(broken, build_dir)
    assert not any(build_dir.glob("*.so")) and not any(build_dir.glob("*.tmp"))
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", build_dir)
    monkeypatch.setattr(native, "load_library", lambda source=broken, build_dir=build_dir: native.build(source, build_dir))
    preds, target = _speakers(1, 2, 7, 500)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        torch_functional.permutation_invariant_training(_t(preds), _t(target), torch_functional.signal_noise_ratio)
    assert native.native_lsap_available() is False


def test_pit_permutate():
    preds, target = _speakers(3, 4, 3, 200)
    _, perm = torch_functional.permutation_invariant_training(_t(preds), _t(target), torch_functional.signal_noise_ratio)
    _, jax_perm = jax_functional.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(target), jax_functional.signal_noise_ratio)
    got = torch_functional.pit_permutate(_t(preds), perm)
    want = jax_functional.pit_permutate(jnp.asarray(preds), jax_perm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # on a 4-D input too ([batch, spk, channel, time])
    four = np.stack([preds, preds * 2], axis=2)
    np.testing.assert_array_equal(
        torch_functional.pit_permutate(_t(four), perm).numpy(), np.asarray(jax_functional.pit_permutate(jnp.asarray(four), jax_perm))
    )


def test_pit_errors_match_jax():
    preds, target = _speakers(0, 2, 2, 100)
    cases = [
        ((preds, target[:, :1]), {}),
        ((preds, target), {"eval_func": "mean"}),
        ((preds[0, 0], target[0, 0]), {}),
    ]
    for (p, t), kw in cases:
        with pytest.raises((RuntimeError, ValueError)) as want:
            jax_functional.permutation_invariant_training(jnp.asarray(p), jnp.asarray(t), jax_functional.signal_noise_ratio, **kw)
        with pytest.raises(want.type) as got:
            torch_functional.permutation_invariant_training(_t(p), _t(t), torch_functional.signal_noise_ratio, **kw)
        assert str(got.value).replace("torch.Size([", "(").replace("])", ")") == str(want.value).replace(",)", ")")
    with pytest.raises(ValueError, match='eval_func can only be "max" or "min" but got mean'):
        torch_audio.PermutationInvariantTraining(torch_functional.signal_noise_ratio, "mean", device="cpu")


# ---------------------------------------------------------------------------
# the classes: forward, accumulation, reset, pure state, merge, carry
# ---------------------------------------------------------------------------

CLASS_CASES = [
    ("SignalNoiseRatio", {}, ATOL_DB),
    ("SignalNoiseRatio", {"zero_mean": True}, ATOL_DB),
    ("ScaleInvariantSignalNoiseRatio", {}, ATOL_DB),
    ("ScaleInvariantSignalDistortionRatio", {}, ATOL_DB),
    ("ScaleInvariantSignalDistortionRatio", {"zero_mean": True}, ATOL_DB),
    ("SignalDistortionRatio", {"filter_length": 64}, None),
    ("SignalDistortionRatio", {"use_cg_iter": 10, "filter_length": 32}, None),
    ("PermutationInvariantTraining", {"metric_func": "scale_invariant_signal_distortion_ratio"}, ATOL_DB),
    ("PermutationInvariantTraining", {"metric_func": "signal_noise_ratio", "eval_func": "min"}, ATOL_DB),
]
BATCHES = 3


def _class_pair(cls_name, kwargs):
    kw, jax_kw = dict(kwargs), dict(kwargs)
    if "metric_func" in kwargs:
        kw["metric_func"] = getattr(torch_functional, kwargs["metric_func"])
        jax_kw["metric_func"] = getattr(jax_functional, kwargs["metric_func"])
    return getattr(jax_audio, cls_name)(**jax_kw), getattr(torch_audio, cls_name)(device="cpu", **kw)


def _class_batch(cls_name, i):
    if cls_name == "PermutationInvariantTraining":
        preds, target = _speakers(100 + i, 3, 2, 800)
    else:
        preds, target = _signals(100 + i, (3, 1200), snr_db=5.0 + 5 * i)
    return (jnp.asarray(preds), jnp.asarray(target)), (_t(preds), _t(target))


@pytest.mark.parametrize("cls_name, kwargs, atol", CLASS_CASES)
def test_class_matches_jax(cls_name, kwargs, atol):
    jax_metric, metric = _class_pair(cls_name, kwargs)
    for i in range(BATCHES):
        (jp, jt), (tp, tt) = _class_batch(cls_name, i)
        got, want = metric(tp, tt), np.asarray(jax_metric(jp, jt))
        _close_db(got, want, atol if atol is not None else _sdr_bound(want))
    for name in metric._defaults:
        got, want = getattr(metric, name), np.asarray(getattr(jax_metric, name))
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), name
        assert got.dtype in (torch.float32, torch.int32)
    assert int(metric.total) == int(jax_metric.total)
    value, want = metric.compute(), np.asarray(jax_metric.compute())
    _close_db(value, want, atol if atol is not None else _sdr_bound(want))
    state = metric.init_state()
    for i in range(BATCHES):
        state = metric.update_state(state, *_class_batch(cls_name, i)[1])
    assert torch.equal(metric.compute_state(state), value)
    metric.reset()
    for name, default in metric._defaults.items():
        assert torch.equal(getattr(metric, name), default)


@pytest.mark.parametrize("cls_name, kwargs, atol", CLASS_CASES)
def test_merge_states_and_state_from_jax(cls_name, kwargs, atol):
    """Two halves merged equal the JAX package's merge, and a JAX state
    carried over keeps updating like the JAX metric."""
    jax_metric, metric = _class_pair(cls_name, kwargs)
    halves, jax_halves = [], []
    for lo, hi in ((0, 1), (1, BATCHES)):
        s, js = metric.init_state(), jax_metric.init_state()
        for i in range(lo, hi):
            (jp, jt), (tp, tt) = _class_batch(cls_name, i)
            s, js = metric.update_state(s, tp, tt), jax_metric.update_state(js, jp, jt)
        halves.append(s)
        jax_halves.append(js)
    merged, jax_merged = metric.merge_states(*halves), jax_metric.merge_states(*jax_halves)
    want = np.asarray(jax_metric.compute_state(jax_merged))
    _close_db(metric.compute_state(merged), want, atol if atol is not None else _sdr_bound(want))
    carried = state_from_jax({k: np.asarray(v) for k, v in jax_halves[0].items()}, metric)
    assert {k: v.dtype for k, v in carried.items()} == {k: v.dtype for k, v in metric.init_state().items()}
    for i in range(1, BATCHES):
        (jp, jt), (tp, tt) = _class_batch(cls_name, i)
        carried, jax_halves[0] = metric.update_state(carried, tp, tt), jax_metric.update_state(jax_halves[0], jp, jt)
    want = np.asarray(jax_metric.compute_state(jax_halves[0]))
    _close_db(metric.compute_state(carried), want, atol if atol is not None else _sdr_bound(want))


def test_audio_collection_fuses_on_the_cpu():
    """SNR, SI-SNR, SI-SDR and PIT(SI-SDR) fuse (the fused update's plain
    version on the CPU) and equal the eager members bit for bit; STOI takes
    the eager leg (``__jit_unsafe__``)."""

    def make():
        return metrics_tpu_torch.MetricCollection(
            {
                "snr": torch_audio.SignalNoiseRatio(device="cpu"),
                "si_snr": torch_audio.ScaleInvariantSignalNoiseRatio(device="cpu"),
                "si_sdr": torch_audio.ScaleInvariantSignalDistortionRatio(device="cpu"),
                "stoi": torch_audio.ShortTimeObjectiveIntelligibility(8000, device="cpu"),
            }
        )

    eager, fused = make(), make()
    handle = fused.compile_update()
    for i in range(2):
        preds, target = _speech(200 + i, 2, 8000, 12.0)
        eager.update(_t(preds), _t(target))
        fused.update(_t(preds), _t(target))
    assert not handle.declined
    assert [name for name in fused if handle._static_unfusible(fused[name])] == ["stoi"]
    for name, metric in eager.items():
        for state in metric._defaults:
            assert torch.equal(getattr(fused[name], state), getattr(metric, state)), (name, state)
    pit = metrics_tpu_torch.MetricCollection(
        [torch_audio.PermutationInvariantTraining(torch_functional.scale_invariant_signal_distortion_ratio, device="cpu")]
    )
    pit_eager = torch_audio.PermutationInvariantTraining(torch_functional.scale_invariant_signal_distortion_ratio, device="cpu")
    handle = pit.compile_update()
    for i in range(2):
        (_, _), (tp, tt) = _class_batch("PermutationInvariantTraining", i)
        pit.update(tp, tt)
        pit_eager.update(tp, tt)
    assert not handle.declined
    assert torch.equal(pit["PermutationInvariantTraining"].sum_pit_metric, pit_eager.sum_pit_metric)


# ---------------------------------------------------------------------------
# the sliced SI-SDR (per condition)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls_name", ["ScaleInvariantSignalDistortionRatio", "SignalNoiseRatio", "ScaleInvariantSignalNoiseRatio"])
def test_sliced_against_jax_and_the_plain_fold(cls_name):
    """``SlicedMetric`` keyed by condition: the per-slice states equal the
    plain segment fold of the per-row values bit for bit, and the values
    are within 1e-4 dB of the JAX ``SlicedMetric``."""
    conditions = 5
    metric = SlicedMetric(getattr(torch_audio, cls_name)(device="cpu"), conditions)
    jax_metric = JaxSlicedMetric(getattr(jax_audio, cls_name)(), conditions)
    rows_values, rows_ids = [], []
    for i in range(3):
        preds, target = _signals(300 + i, (16, 1500), snr_db=4.0 + 4 * i)
        ids = np.random.default_rng(i).integers(0, conditions, 16).astype(np.int32)
        metric.update(_t(ids), _t(preds), _t(target))
        jax_metric.update(jnp.asarray(ids), jnp.asarray(preds), jnp.asarray(target))
        functional = {
            "ScaleInvariantSignalDistortionRatio": torch_functional.scale_invariant_signal_distortion_ratio,
            "SignalNoiseRatio": torch_functional.signal_noise_ratio,
            "ScaleInvariantSignalNoiseRatio": torch_functional.scale_invariant_signal_noise_ratio,
        }[cls_name]
        rows_values.append(torch.stack([functional(_t(preds[r : r + 1]), _t(target[r : r + 1]))[0] for r in range(16)]))
        rows_ids.append(_t(ids))
    value = metric.compute()
    _close_db(value, np.asarray(jax_metric.compute()))
    sum_name = [k for k in metric._template._defaults if k != "total"][0]
    # the plain fold of the per-row values, update by update, as the metric adds them
    want_sum = torch.zeros(conditions)
    want_total = torch.zeros(conditions, dtype=torch.int32)
    for vals, ids in zip(rows_values, rows_ids):
        want_sum = want_sum + segment_sum_reference(vals, ids, conditions)
        want_total = want_total + segment_sum_reference(torch.ones(16, dtype=torch.int32), ids, conditions)
    assert torch.equal(getattr(metric, sum_name), want_sum)
    assert torch.equal(metric.total, want_total)
    for name in metric._template._defaults:
        np.testing.assert_array_equal(metric.state_dict()[name].dtype == torch.float32, np.asarray(getattr(jax_metric, name)).dtype == np.float32)


# ---------------------------------------------------------------------------
# STOI / eSTOI
# ---------------------------------------------------------------------------


def _speech(seed, batch, fs, snr_db, seconds=1.5, floor=0.01):
    """Seeded speech-like utterances (harmonic stacks under a syllable-rate
    envelope, which leaves near-silent frames, over a noise floor
    ``floor`` times the peak, as a recording has; the corpus of
    ``tests/audio/pesq_corpus.py`` has the same) and noisy versions at
    ``snr_db``."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * fs)) / fs
    clean = np.stack(
        [
            np.clip(np.sin(2 * np.pi * rng.uniform(2, 4) * t + rng.uniform(0, 6)), 0, None)
            * sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 6)) / (k + 1) for k, f in enumerate(rng.uniform(100, 250) * np.arange(1, 6)))
            for _ in range(batch)
        ]
    )
    clean = clean + floor * rng.standard_normal(clean.shape)
    noise = rng.standard_normal(clean.shape)
    noise *= np.sqrt(np.mean(clean**2) / (np.mean(noise**2) * 10 ** (snr_db / 10)))
    return (clean + noise).astype(np.float32), clean.astype(np.float32)


@pytest.mark.parametrize("fs", [8000, 10000, 16000])
@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("snr_db", [0.0, 15.0])
def test_stoi_functional(fs, extended, snr_db):
    preds, target = _speech(int(fs + snr_db), 3, fs, snr_db)
    got = torch_functional.short_time_objective_intelligibility(_t(preds), _t(target), fs, extended)
    want = np.asarray(jax_functional.short_time_objective_intelligibility(preds, target, fs, extended))
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=STOI_ATOL)


def _stoi_float64(preds, target, fs, extended):
    """The port's STOI kernel run in float64 on the same host part: the
    reference both float32 results are measured against."""
    from metrics_tpu_torch.functional.audio import stoi as port_stoi

    out = []
    for p, t in zip(preds.astype(np.float64), target.astype(np.float64)):
        x, y, bucket, n = port_stoi._prepare(p, t, fs)
        obm = torch.from_numpy(port_stoi._third_octave_matrix(port_stoi._FS, port_stoi._NFFT, port_stoi._NUM_BANDS, port_stoi._MIN_FREQ))
        window = torch.from_numpy(port_stoi._hann(port_stoi._N_FRAME))
        n_valid = torch.tensor([float(n)], dtype=torch.float64)
        out.append(float(port_stoi._stoi_kernel(_t(x)[None], _t(y)[None], obm, window, bucket, extended, n_valid)[0]))
    return np.array(out)


@pytest.mark.parametrize("extended", [False, True])
def test_stoi_digital_silence_is_float32_limited_in_both(extended):
    """Pinned property of the reference: where the clean signal is exactly
    zero between syllables (no noise floor), near-empty bands make both
    float32 STOIs drift from a float64 evaluation by up to about 1.6e-4
    (measured: the JAX package 1.6e-4, the port 9e-5), so the 1e-5 parity
    bound holds only on signals with a noise floor. Both stay within 5e-4
    of float64 here (ROADMAP.md C)."""
    preds, target = _speech(8000, 3, 8000, 0.0, floor=0.0)
    wide = _stoi_float64(preds, target, 8000, extended)
    got = torch_functional.short_time_objective_intelligibility(_t(preds), _t(target), 8000, extended).numpy()
    want = np.asarray(jax_functional.short_time_objective_intelligibility(preds, target, 8000, extended))
    assert np.abs(got - wide).max() <= 5e-4 and np.abs(want - wide).max() <= 5e-4


def test_stoi_batched_shape_one_utterance_and_class():
    preds, target = _speech(7, 6, 8000, 5.0)
    batched = torch_functional.short_time_objective_intelligibility(_t(preds.reshape(2, 3, -1)), _t(target.reshape(2, 3, -1)), 8000)
    want = np.asarray(jax_functional.short_time_objective_intelligibility(preds.reshape(2, 3, -1), target.reshape(2, 3, -1), 8000))
    assert batched.shape == (2, 3)
    np.testing.assert_allclose(batched.numpy(), want, rtol=0, atol=STOI_ATOL)
    one = torch_functional.short_time_objective_intelligibility(_t(preds[0]), _t(target[0]), 8000)
    assert one.shape == () and abs(float(one) - float(want[0, 0])) <= STOI_ATOL
    for extended in (False, True):
        metric = torch_audio.ShortTimeObjectiveIntelligibility(8000, extended=extended, device="cpu")
        jax_metric = jax_audio.ShortTimeObjectiveIntelligibility(8000, extended=extended)
        for lo in (0, 3):
            metric.update(_t(preds[lo : lo + 3]), _t(target[lo : lo + 3]))
            jax_metric.update(preds[lo : lo + 3], target[lo : lo + 3])
        assert metric.sum_stoi.dtype == torch.float32 and metric.total.dtype == torch.int32 and int(metric.total) == 6
        assert abs(float(metric.compute()) - float(jax_metric.compute())) <= STOI_ATOL
        carried = state_from_jax({k: np.asarray(getattr(jax_metric, k)) for k in jax_metric._defaults}, metric)
        assert abs(float(metric.compute_state(carried)) - float(jax_metric.compute())) <= STOI_ATOL


def test_stoi_errors_match_jax():
    short = np.random.default_rng(0).standard_normal(2000).astype(np.float32)
    with pytest.raises(ValueError) as want:
        jax_functional.short_time_objective_intelligibility(short, short, 8000)
    with pytest.raises(ValueError) as got:
        torch_functional.short_time_objective_intelligibility(_t(short), _t(short), 8000)
    assert str(got.value) == str(want.value) and "Not enough non-silent signal" in str(got.value)
    with pytest.raises(ValueError, match="same shape"):
        torch_functional.short_time_objective_intelligibility(_t(short), _t(short[:-1]), 8000)
    for fs in (0, -8000, 8000.0):
        with pytest.raises(ValueError) as want:
            jax_audio.ShortTimeObjectiveIntelligibility(fs)
        with pytest.raises(ValueError) as got:
            torch_audio.ShortTimeObjectiveIntelligibility(fs, device="cpu")
        assert str(got.value) == str(want.value)


def test_entry_points_refuse_to_run_without_a_card(monkeypatch):
    """No CPU fallback: without ``device="cpu"`` an entry point asks for
    the card, which raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (
        lambda: torch_audio.SignalNoiseRatio(),
        lambda: torch_audio.ShortTimeObjectiveIntelligibility(8000),
        lambda: torch_audio.PermutationInvariantTraining(torch_functional.signal_noise_ratio),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    preds, target = _speech(1, 1, 8000, 5.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_functional.short_time_objective_intelligibility(preds, target, 8000)
