"""Mixed input dtypes: the port held to the JAX package over a grid of pairs.

Every class and functional at a shared path that takes ``(preds, target)``
goes through both packages on the CPU with the same seeded numpy inputs,
over a grid of dtype pairs:

- classification and curves (binary, multiclass and multilabel inputs):
  float32, float64, float16 and bfloat16 probabilities against int64, int32,
  uint8 and bool targets;
- regression, audio, image, pairwise, ``KLDivergence`` and ``AUC``:
  (float32, float64), (float64, float32), (float16, float32),
  (bfloat16, float32), (float32, bfloat16), (float32, int64) and
  (int64, float32).

Half-precision JAX inputs are built from the torch tensor's bits
(``jax.lax.bitcast_convert_type``), so both packages see the same values.
Each case holds one of:

- both packages raise, with the same exception type;
- both compute, within the family's tolerance, with the JAX package's
  output dtypes (``HingeLoss`` returns float32 where the JAX package's
  half-precision state gives a half value: the port widens half precision,
  ``ROADMAP.md`` C, "float16 sums");
- a property of the reference (``HALF_GAPS``): the JAX package computes
  part of the work in the half dtype of one input (its epsilon, or a
  difference or a log taken before the promotion) where the port computes
  in float32. Such a case holds the port within the family's tolerance of
  a float64 evaluation of the rounded inputs (the JAX package with x64 on)
  and pins the JAX package's distance from it past that tolerance. Where
  both packages normalise in the half dtype (``pairwise_cosine_similarity``),
  both are held to the float64 evaluation within four ulp of that dtype.

Left out, as their inputs are not a ``(preds, target)`` pair of float or
label tensors: text (strings), detection (lists of box dicts), retrieval (a
third ``indexes`` tensor), PESQ and STOI (host DSP at a sample rate), the
FID, KID, IS and LPIPS extractors (images through a network), the
aggregators and wrappers (one input, or a metric).

The repairs the grid found (``ROADMAP.md`` C.13-C.18) each have a named
test below as well.
"""
import inspect
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import metrics_tpu
import metrics_tpu.functional as jax_functional
import metrics_tpu_torch
import metrics_tpu_torch.functional as torch_functional

torch.set_num_threads(2)

DTYPES = {
    "f64": torch.float64,
    "f32": torch.float32,
    "f16": torch.float16,
    "bf16": torch.bfloat16,
    "i64": torch.int64,
    "i32": torch.int32,
    "u8": torch.uint8,
    "bool": torch.bool,
}
LABEL_PAIRS = [(p, t) for p in ("f32", "f64", "f16", "bf16") for t in ("i64", "i32", "u8", "bool")]
FLOAT_PAIRS = [("f32", "f64"), ("f64", "f32"), ("f16", "f32"), ("bf16", "f32"), ("f32", "bf16"), ("f32", "i64"), ("i64", "f32")]

#: family -> (rtol, atol) of its parity tests
TOLERANCE = {
    "classification": (1e-6, 1e-7),
    "regression": (1e-5, 1e-6),
    "audio": (0.0, 1e-4),  # dB
    "image": (1e-5, 1e-6),
    "pairwise": (1e-5, 1e-6),
}

N = 32
_rng = np.random.default_rng(0)
_PROBS = _rng.random((N, 4))
_PROBS = _PROBS / _PROBS.sum(1, keepdims=True)
_LABELS = _rng.integers(0, 4, N)
_BINARY_PROBS = _rng.random(N)
_BINARY_LABELS = (_rng.random(N) < 0.5).astype(np.int64)
_POSITIVE = _rng.random(N) * 4 + 0.5
_POSITIVE_T = _POSITIVE + _rng.random(N)
_ROWS = _rng.random((8, 8)) + 0.5
_ROWS_T = _ROWS + _rng.random((8, 8))
_PAIRWISE_X = _rng.random((6, 5)) * 3
_PAIRWISE_Y = _rng.random((4, 5)) * 3
_AUDIO_T = _rng.standard_normal((2, 64)) * 3
_AUDIO_P = _AUDIO_T + _rng.standard_normal((2, 64))
_PIT_T = _rng.standard_normal((2, 2, 64)) * 3
_PIT_P = _PIT_T[:, ::-1] + _rng.standard_normal((2, 2, 64))
_IMG_P = _rng.random((2, 3, 16, 16)) * 8
_IMG_T = _IMG_P * 0.8 + _rng.random((2, 3, 16, 16))
_DIST_Q = _PROBS[::-1].copy()
_AUC_X = np.sort(_rng.random(N)) * 4
_AUC_Y = _rng.random(N) * 4
_ML_PROBS = _rng.random((N, 4))
_ML_LABELS = (_rng.random((N, 4)) < 0.5).astype(np.int64)


def _integral(values, dtype_name):
    """Integer dtypes get whole numbers of the same scale."""
    return np.round(values) if dtype_name in ("i64", "i32", "u8", "bool") else values


def _pair(preds, target):
    return lambda pd, td: (_integral(preds, pd), _integral(target, td))


#: input kind -> (preds dtype, target dtype) -> numpy (preds, target)
KINDS = {
    "multiclass": lambda pd, td: (_PROBS, _LABELS % 2 if td == "bool" else _LABELS),
    "binary": lambda pd, td: (_BINARY_PROBS, _BINARY_LABELS),
    "multilabel": lambda pd, td: (_ML_PROBS, _ML_LABELS),
    "pair": _pair(_POSITIVE, _POSITIVE_T),
    "rows": _pair(_ROWS, _ROWS_T),
    "pairwise": _pair(_PAIRWISE_X, _PAIRWISE_Y),
    "audio": _pair(_AUDIO_P, _AUDIO_T),
    "pit": _pair(_PIT_P, _PIT_T),
    "image": _pair(_IMG_P, _IMG_T),
    "distributions": lambda pd, td: (_PROBS, _DIST_Q),
    "curve": _pair(_AUC_X, _AUC_Y),
}
LABEL_KINDS = ("multiclass", "binary", "multilabel")


class _Functional(str):
    """A constructor argument naming a functional, resolved per package."""


def _resolve(kwargs, module):
    return {k: getattr(module, v) if isinstance(v, _Functional) else v for k, v in kwargs.items()}


C4 = {"num_classes": 4}
MACRO = dict(C4, average="macro")
BINNED = dict(C4, thresholds=5)
SI_SDR = {"metric_func": _Functional("scale_invariant_signal_distortion_ratio")}
SSIM_ARGS = {"kernel_size": (7, 7), "data_range": 10.0}
MS_SSIM_ARGS = {"kernel_size": (3, 3), "betas": (0.5, 0.5), "data_range": 10.0}

#: case name -> (family, input kind, class, class kwargs, functional, functional kwargs)
SPECS = {
    # multiclass probabilities against labels
    "accuracy": ("classification", "multiclass", "Accuracy", {}, "accuracy", {}),
    "precision": ("classification", "multiclass", "Precision", MACRO, "precision", MACRO),
    "recall": ("classification", "multiclass", "Recall", MACRO, "recall", MACRO),
    "f1": ("classification", "multiclass", "F1Score", MACRO, "f1_score", MACRO),
    "fbeta": ("classification", "multiclass", "FBetaScore", dict(MACRO, beta=2.0), "fbeta_score", dict(MACRO, beta=2.0)),
    "specificity": ("classification", "multiclass", "Specificity", MACRO, "specificity", MACRO),
    "stat_scores": ("classification", "multiclass", "StatScores", dict(C4, reduce="macro"), "stat_scores", dict(C4, reduce="macro")),
    "precision_recall": ("classification", "multiclass", None, {}, "precision_recall", MACRO),
    "confusion_matrix": ("classification", "multiclass", "ConfusionMatrix", C4, "confusion_matrix", C4),
    "cohen_kappa": ("classification", "multiclass", "CohenKappa", C4, "cohen_kappa", C4),
    "jaccard": ("classification", "multiclass", "JaccardIndex", C4, "jaccard_index", C4),
    "mcc": ("classification", "multiclass", "MatthewsCorrCoef", C4, "matthews_corrcoef", C4),
    "hamming": ("classification", "multiclass", "HammingDistance", {}, "hamming_distance", {}),
    "hinge": ("classification", "multiclass", "HingeLoss", {}, "hinge_loss", {}),
    "calibration": ("classification", "multiclass", "CalibrationError", {}, "calibration_error", {}),
    "dice": ("classification", "multiclass", None, {}, "dice_score", {}),
    "auroc": ("classification", "multiclass", "AUROC", C4, "auroc", C4),
    "average_precision": ("classification", "multiclass", "AveragePrecision", C4, "average_precision", C4),
    "roc": ("classification", "multiclass", "ROC", C4, "roc", C4),
    "pr_curve": ("classification", "multiclass", "PrecisionRecallCurve", C4, "precision_recall_curve", C4),
    "binned_pr_curve": ("classification", "multiclass", "BinnedPrecisionRecallCurve", BINNED, None, {}),
    "binned_ap": ("classification", "multiclass", "BinnedAveragePrecision", BINNED, None, {}),
    "binned_recall_at_precision": (
        "classification", "multiclass", "BinnedRecallAtFixedPrecision", dict(BINNED, min_precision=0.3), None, {},
    ),
    # binary probabilities against 0/1 targets
    "binary_accuracy": ("classification", "binary", "Accuracy", {}, "accuracy", {}),
    "binary_precision": ("classification", "binary", "Precision", {}, "precision", {}),
    "binary_recall": ("classification", "binary", "Recall", {}, "recall", {}),
    "binary_f1": ("classification", "binary", "F1Score", {}, "f1_score", {}),
    "binary_specificity": ("classification", "binary", "Specificity", {}, "specificity", {}),
    "binary_stat_scores": ("classification", "binary", "StatScores", {}, "stat_scores", {}),
    "binary_confusion_matrix": ("classification", "binary", "ConfusionMatrix", {"num_classes": 2}, "confusion_matrix", {"num_classes": 2}),
    "binary_cohen_kappa": ("classification", "binary", "CohenKappa", {"num_classes": 2}, "cohen_kappa", {"num_classes": 2}),
    "binary_jaccard": ("classification", "binary", "JaccardIndex", {"num_classes": 2}, "jaccard_index", {"num_classes": 2}),
    "binary_mcc": ("classification", "binary", "MatthewsCorrCoef", {"num_classes": 2}, "matthews_corrcoef", {"num_classes": 2}),
    "binary_hamming": ("classification", "binary", "HammingDistance", {}, "hamming_distance", {}),
    "binary_hinge": ("classification", "binary", "HingeLoss", {}, "hinge_loss", {}),
    "binary_calibration": ("classification", "binary", "CalibrationError", {}, "calibration_error", {}),
    "binary_auroc": ("classification", "binary", "AUROC", {}, "auroc", {}),
    "binary_average_precision": ("classification", "binary", "AveragePrecision", {}, "average_precision", {}),
    "binary_roc": ("classification", "binary", "ROC", {}, "roc", {}),
    "binary_pr_curve": ("classification", "binary", "PrecisionRecallCurve", {}, "precision_recall_curve", {}),
    "binary_binned_ap": ("classification", "binary", "BinnedAveragePrecision", {"num_classes": 1, "thresholds": 5}, None, {}),
    # multilabel probabilities against indicator rows
    "multilabel_accuracy": ("classification", "multilabel", "Accuracy", {}, "accuracy", {}),
    "multilabel_precision": ("classification", "multilabel", "Precision", MACRO, "precision", MACRO),
    "multilabel_recall": ("classification", "multilabel", "Recall", MACRO, "recall", MACRO),
    "multilabel_f1": ("classification", "multilabel", "F1Score", MACRO, "f1_score", MACRO),
    "multilabel_hamming": ("classification", "multilabel", "HammingDistance", {}, "hamming_distance", {}),
    "multilabel_stat_scores": (
        "classification", "multilabel", "StatScores", dict(C4, reduce="macro"), "stat_scores", dict(C4, reduce="macro"),
    ),
    "multilabel_confusion_matrix": (
        "classification", "multilabel", "ConfusionMatrix", dict(C4, multilabel=True), "confusion_matrix", dict(C4, multilabel=True),
    ),
    "multilabel_auroc": ("classification", "multilabel", "AUROC", C4, "auroc", C4),
    "multilabel_average_precision": ("classification", "multilabel", "AveragePrecision", C4, "average_precision", C4),
    "multilabel_roc": ("classification", "multilabel", "ROC", C4, "roc", C4),
    "multilabel_pr_curve": ("classification", "multilabel", "PrecisionRecallCurve", C4, "precision_recall_curve", C4),
    # float pairs
    "kl_divergence": ("classification", "distributions", "KLDivergence", {}, "kl_divergence", {}),
    "auc": ("classification", "curve", "AUC", {}, "auc", {}),
    "mse": ("regression", "pair", "MeanSquaredError", {}, "mean_squared_error", {}),
    "mae": ("regression", "pair", "MeanAbsoluteError", {}, "mean_absolute_error", {}),
    "msle": ("regression", "pair", "MeanSquaredLogError", {}, "mean_squared_log_error", {}),
    "mape": ("regression", "pair", "MeanAbsolutePercentageError", {}, "mean_absolute_percentage_error", {}),
    "smape": (
        "regression", "pair", "SymmetricMeanAbsolutePercentageError", {}, "symmetric_mean_absolute_percentage_error", {},
    ),
    "r2": ("regression", "pair", "R2Score", {}, "r2_score", {}),
    "pearson": ("regression", "pair", "PearsonCorrCoef", {}, "pearson_corrcoef", {}),
    "spearman": ("regression", "pair", "SpearmanCorrCoef", {}, "spearman_corrcoef", {}),
    "explained_variance": ("regression", "pair", "ExplainedVariance", {}, "explained_variance", {}),
    "tweedie": ("regression", "pair", "TweedieDevianceScore", {"power": 1.5}, "tweedie_deviance_score", {"power": 1.5}),
    "cosine": ("regression", "rows", "CosineSimilarity", {}, "cosine_similarity", {}),
    "snr": ("audio", "audio", "SignalNoiseRatio", {}, "signal_noise_ratio", {}),
    "si_snr": ("audio", "audio", "ScaleInvariantSignalNoiseRatio", {}, "scale_invariant_signal_noise_ratio", {}),
    "si_sdr": ("audio", "audio", "ScaleInvariantSignalDistortionRatio", {}, "scale_invariant_signal_distortion_ratio", {}),
    "sdr": ("audio", "audio", "SignalDistortionRatio", {"filter_length": 8}, "signal_distortion_ratio", {"filter_length": 8}),
    "pit": ("audio", "pit", "PermutationInvariantTraining", SI_SDR, "permutation_invariant_training", SI_SDR),
    "psnr": ("image", "image", "PeakSignalNoiseRatio", {"data_range": 10.0}, "peak_signal_noise_ratio", {"data_range": 10.0}),
    "ssim": ("image", "image", "StructuralSimilarityIndexMeasure", SSIM_ARGS, "structural_similarity_index_measure", SSIM_ARGS),
    "ms_ssim": (
        "image", "image", "MultiScaleStructuralSimilarityIndexMeasure", MS_SSIM_ARGS,
        "multiscale_structural_similarity_index_measure", MS_SSIM_ARGS,
    ),
    "uqi": ("image", "image", "UniversalImageQualityIndex", {"kernel_size": (7, 7)}, "universal_image_quality_index", {"kernel_size": (7, 7)}),
    "pairwise_cosine": ("pairwise", "pairwise", None, {}, "pairwise_cosine_similarity", {}),
    "pairwise_euclidean": ("pairwise", "pairwise", None, {}, "pairwise_euclidean_distance", {}),
    "pairwise_linear": ("pairwise", "pairwise", None, {}, "pairwise_linear_similarity", {}),
    "pairwise_manhattan": ("pairwise", "pairwise", None, {}, "pairwise_manhattan_distance", {}),
}

#: (case, preds dtype, target dtype) where the JAX package computes part of
#: the work in a half dtype (value: "reference"), or where both packages do
#: ("both")
HALF_GAPS = {
    **{(name, pd, td): "reference" for name in ("msle", "pearson", "tweedie", "si_snr") for pd, td in (("f16", "f32"), ("bf16", "f32"), ("f32", "bf16"))},
    **{(name, pd, td): "reference" for name in ("snr", "si_sdr", "pit") for pd, td in (("bf16", "f32"), ("f32", "bf16"))},
    ("r2", "f32", "bf16"): "reference",
    ("explained_variance", "f32", "bf16"): "reference",
    ("pairwise_cosine", "f16", "f32"): "both",
    ("pairwise_cosine", "bf16", "f32"): "both",
}


#: classes whose states sum half-precision inputs in float32 where the JAX
#: package keeps the half dtype (``tests/test_torch_dtype_repairs.py``)
WIDENS_HALF = {"HingeLoss"}


def _cases():
    for name, (family, kind, cls, _, fn, _) in SPECS.items():
        for pd, td in LABEL_PAIRS if kind in LABEL_KINDS else FLOAT_PAIRS:
            for leg in ("functional", "class"):
                if (cls if leg == "class" else fn) is not None:
                    yield pytest.param(name, pd, td, leg, id=f"{name}-{leg}-{pd}-{td}")


def _both(values, dtype_name):
    """A torch tensor and the JAX array of the same values (a bfloat16
    array from the tensor's bits)."""
    t = torch.from_numpy(np.ascontiguousarray(values)).to(DTYPES[dtype_name])
    if t.dtype == torch.bfloat16:
        return t, jax.lax.bitcast_convert_type(jnp.asarray(t.view(torch.int16).numpy()), jnp.bfloat16)
    return t, jnp.asarray(t.numpy())


def _port_functional(fn, kwargs, preds, target):
    f = getattr(torch_functional, fn)
    kwargs = _resolve(kwargs, torch_functional)
    if "device" in inspect.signature(f).parameters:
        kwargs["device"] = "cpu"
    return f(preds, target, **kwargs)


def _class_value(module, functionals, cls, kwargs, preds, target, **extra):
    metric = getattr(module, cls)(**_resolve(kwargs, functionals), **extra)
    metric.update(preds, target)
    return metric.compute()


def _outcome(run):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return run()
    except Exception as err:  # noqa: BLE001 -- the outcome compared is the exception's type
        return err


def _leaves(x):
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [leaf for item in x for leaf in _leaves(item)]
    return [x]


def _float64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(x).astype(np.float64)


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def _close(got, want, rtol, atol):
    g, w = _leaves(got), _leaves(want)
    return len(g) == len(w) and all(
        np.shape(_float64(a)) == np.shape(_float64(b)) and np.allclose(_float64(a), _float64(b), rtol=rtol, atol=atol, equal_nan=True)
        for a, b in zip(g, w)
    )


def _float64_evaluation(leg, cls, ckw, fn, fkw, preds, target):
    """The JAX package with x64 on, on the rounded inputs in float64."""
    with warnings.catch_warnings(), jax.enable_x64(True):
        warnings.simplefilter("ignore")
        a, b = (jnp.asarray(t.to(torch.float64).numpy()) for t in (preds, target))
        if leg == "class":
            return _class_value(metrics_tpu, jax_functional, cls, ckw, a, b)
        return getattr(jax_functional, fn)(a, b, **_resolve(fkw, jax_functional))


@pytest.mark.parametrize("name, pd, td, leg", list(_cases()))
def test_pair_grid(name, pd, td, leg):
    family, kind, cls, ckw, fn, fkw = SPECS[name]
    (preds, jax_preds), (target, jax_target) = (_both(v, d) for v, d in zip(KINDS[kind](pd, td), (pd, td)))
    if leg == "class":
        got = _outcome(lambda: _class_value(metrics_tpu_torch, torch_functional, cls, ckw, preds, target, device="cpu"))
        want = _outcome(lambda: _class_value(metrics_tpu, jax_functional, cls, ckw, jax_preds, jax_target))
    else:
        got = _outcome(lambda: _port_functional(fn, fkw, preds, target))
        want = _outcome(lambda: getattr(jax_functional, fn)(jax_preds, jax_target, **_resolve(fkw, jax_functional)))

    if isinstance(got, Exception) or isinstance(want, Exception):
        assert isinstance(got, Exception) and isinstance(want, Exception), (got, want)
        assert type(got) is type(want), (got, want)
        return

    rtol, atol = TOLERANCE[family]
    gap = HALF_GAPS.get((name, pd, td))
    if gap is None:
        assert _close(got, want, rtol, atol), (got, want)
    else:
        ref = _float64_evaluation(leg, cls, ckw, fn, fkw, preds, target)
        if gap == "both":
            half = DTYPES[pd] if pd in ("f16", "bf16") else DTYPES[td]
            rtol = 4 * torch.finfo(half).eps
            assert _close(got, ref, rtol, atol) and _close(want, ref, rtol, atol), (got, want, ref)
        else:
            assert _close(got, ref, rtol, atol), (got, ref)
            assert not _close(want, ref, rtol, atol), (want, ref)  # the reference's half arithmetic

    want_dtypes = [_dtype_name(np.asarray(w)) for w in _leaves(want)]
    if leg == "class" and cls in WIDENS_HALF:
        want_dtypes = ["float32" if d in ("float16", "bfloat16") else d for d in want_dtypes]
    assert [_dtype_name(g) for g in _leaves(got)] == want_dtypes


# ---------------------------------------------------------------------------
# the repairs, one named test each
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pd, td", [("f64", "f32"), ("f32", "f64"), ("f64", "f64")])
def test_c13_spearman_rounds_float64_before_its_dtype_check(pd, td):
    """C.13: float64 rounds to float32 before the same-dtype check, as at the
    JAX package's intake; the value and the exact states are float32."""
    (preds, jp), (target, jt) = _both(_POSITIVE, pd), _both(_POSITIVE_T, td)
    got = torch_functional.spearman_corrcoef(preds, target)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_functional.spearman_corrcoef(jp, jt)), rtol=1e-5)
    metric = metrics_tpu_torch.SpearmanCorrCoef(exact=True, device="cpu")
    metric.update(preds, target)
    assert [s.dtype for s in metric.preds + metric.target] == [torch.float32, torch.float32]
    assert torch.equal(metric.compute(), got)


@pytest.mark.parametrize("pd, td", [("f16", "f32"), ("f32", "bf16"), ("f32", "i64")])
def test_c13_other_mixed_pairs_still_raise_in_both(pd, td):
    (preds, jp), (target, jt) = _both(_integral(_POSITIVE, pd), pd), _both(_integral(_POSITIVE_T, td), td)
    with pytest.raises(TypeError, match="same data type"):
        torch_functional.spearman_corrcoef(preds, target)
    with pytest.raises(TypeError, match="same data type"):
        jax_functional.spearman_corrcoef(jp, jt)


SNR_FAMILY = {
    "signal_noise_ratio": "SignalNoiseRatio",
    "scale_invariant_signal_noise_ratio": "ScaleInvariantSignalNoiseRatio",
    "scale_invariant_signal_distortion_ratio": "ScaleInvariantSignalDistortionRatio",
}


@pytest.mark.parametrize("td", ["i64", "i32", "u8"])
@pytest.mark.parametrize("fn", list(SNR_FAMILY))
def test_c14_snr_family_takes_an_integer_target(fn, td):
    """C.14: only the estimate's dtype is checked; an integer reference takes
    its float dtype, as jnp's promotion does. The class's states are float32."""
    target_values = np.abs(_AUDIO_T) if td == "u8" else _AUDIO_T
    (preds, jp), (target, jt) = _both(_AUDIO_P, "f32"), _both(np.round(target_values), td)
    got = getattr(torch_functional, fn)(preds, target)
    np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jax_functional, fn)(jp, jt)), rtol=0, atol=1e-4)
    metric = getattr(metrics_tpu_torch, SNR_FAMILY[fn])(device="cpu")
    metric.update(preds, target)
    assert all(getattr(metric, k).dtype in (torch.float32, torch.int32) for k in metric._defaults)
    np.testing.assert_allclose(metric.compute().numpy(), got.mean().numpy(), rtol=1e-6)


@pytest.mark.parametrize("pd", ["i64", "i32"])
@pytest.mark.parametrize("fn", list(SNR_FAMILY))
def test_c14_integer_estimates_still_raise_in_both(fn, pd):
    (preds, jp), (target, jt) = _both(np.round(_AUDIO_P), pd), _both(_AUDIO_T, "f32")
    with pytest.raises(ValueError):
        getattr(torch_functional, fn)(preds, target)
    with pytest.raises(ValueError):
        getattr(jax_functional, fn)(jp, jt)


@pytest.mark.parametrize("fn", ["structural_similarity_index_measure", "universal_image_quality_index"])
def test_c15_image_pair_rounds_before_its_dtype_check(fn):
    """C.15: SSIM, MS-SSIM and UQI share C.13's check and its repair."""
    (preds, jp), (target, jt) = _both(_IMG_P, "f64"), _both(_IMG_T, "f32")
    got = getattr(torch_functional, fn)(preds, target, kernel_size=(7, 7))
    assert got.dtype == torch.float32
    assert torch.equal(got, getattr(torch_functional, fn)(preds.to(torch.float32), target, kernel_size=(7, 7)))
    np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jax_functional, fn)(jp, jt, kernel_size=(7, 7))), rtol=1e-5)


@pytest.mark.parametrize(
    "cls, kwargs",
    [("Accuracy", {}), ("ConfusionMatrix", C4), ("AUROC", C4), ("ROC", C4), ("HingeLoss", {}), ("CalibrationError", {})],
)
def test_c16_bool_labels_against_class_scores_raise_type_error(cls, kwargs):
    """C.16: bool labels against ``[N, C]`` scores raise ``TypeError`` in both
    (the JAX package's one-hot and label table refuse a bool ``iota``); bool
    targets of binary and multilabel inputs compute in both (the grid)."""
    (preds, jp), (target, jt) = _both(_PROBS, "f32"), _both(_LABELS % 2, "bool")
    port = getattr(metrics_tpu_torch, cls)(device="cpu", **kwargs)
    with pytest.raises(TypeError):
        port.update(preds, target)
        port.compute()
    ref = getattr(metrics_tpu, cls)(**kwargs)
    with pytest.raises(TypeError):
        ref.update(jp, jt)
        ref.compute()


@pytest.mark.parametrize("fn", ["pairwise_cosine_similarity", "pairwise_euclidean_distance", "pairwise_linear_similarity", "pairwise_manhattan_distance"])
@pytest.mark.parametrize("dtype", ["f64", "i64"])
def test_c17_pairwise_takes_the_x64_off_dtypes(fn, dtype):
    """C.17: float64 rows give float32 distances and integer rows are taken
    (``pairwise_cosine_similarity`` raised on them), as in the JAX package."""
    (x, jx), (y, jy) = _both(_integral(_PAIRWISE_X, dtype), dtype), _both(_integral(_PAIRWISE_Y, dtype), dtype)
    got = getattr(torch_functional, fn)(x, y)
    want = np.asarray(getattr(jax_functional, fn)(jx, jy))
    assert _dtype_name(got) == str(want.dtype)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pd, td", [("f64", "f64"), ("f32", "bf16"), ("bf16", "f32"), ("i64", "i64")])
def test_c18_auc_promotes_before_the_trapezoid(pd, td):
    """C.18: ``auc`` takes the x64-off dtypes and one common dtype before the
    trapezoid, as ``jnp.trapezoid`` does (``torch.trapezoid`` averaged ``y``
    in its own dtype)."""
    (x, jx), (y, jy) = _both(_integral(_AUC_X, pd), pd), _both(_integral(_AUC_Y, td), td)
    got = torch_functional.auc(x, y)
    want = np.asarray(jax_functional.auc(jx, jy))
    assert _dtype_name(got) == str(want.dtype)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
