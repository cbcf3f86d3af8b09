"""Output dtypes of the curve family: the port against the JAX package.

Every output of ``roc``, ``auroc``, ``precision_recall_curve`` and
``average_precision``, and of ``ROC``, ``PrecisionRecallCurve``,
``AveragePrecision`` and ``AUROC`` in their three state modes (the sketched
default, ``exact=True``, ``capacity=N``), has the JAX package's dtype over
float16, bfloat16, float32 and float64 scores with mixed, all-negative and
all-positive targets (the JAX package runs with x64 off, so float64 scores
become float32 there). The scalar values (``auroc``, ``average_precision``)
are float32 whatever the targets hold. The half-precision JAX inputs are
built from the torch tensor's bits, so both sides see the same scores.
"""
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

N = 24
DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64}
TARGETS = ("mixed", "all_negative", "all_positive")
FUNCTIONALS = ("roc", "auroc", "precision_recall_curve", "average_precision")
CLASSES = ("ROC", "PrecisionRecallCurve", "AveragePrecision", "AUROC")
MODES = {"sketched": {}, "exact": {"exact": True}, "capacity": {"capacity": 64}}


def _inputs(dtype_name, target_kind):
    rng = np.random.default_rng(0)
    scores = torch.from_numpy(rng.random(N).astype(np.float32)).to(DTYPES[dtype_name])
    target = {
        "mixed": (rng.random(N) < 0.5).astype(np.int64),
        "all_negative": np.zeros(N, np.int64),
        "all_positive": np.ones(N, np.int64),
    }[target_kind]
    if scores.dtype == torch.bfloat16:
        jax_scores = jax.lax.bitcast_convert_type(jnp.asarray(scores.view(torch.int16).numpy()), jnp.bfloat16)
    else:
        jax_scores = jnp.asarray(scores.numpy())
    return scores, torch.from_numpy(target), jax_scores, jnp.asarray(target)


def _dtypes(out):
    if isinstance(out, (list, tuple)):
        return [d for item in out for d in _dtypes(item)]
    return [str(out.dtype).replace("torch.", "")]


@pytest.mark.parametrize("target_kind", TARGETS)
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_functional_output_dtypes_match_jax(name, dtype_name, target_kind):
    scores, target, jax_scores, jax_target = _inputs(dtype_name, target_kind)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the degenerate targets' warnings
        got = getattr(torch_functional, name)(scores, target, device="cpu")
        want = getattr(jax_functional, name)(jax_scores, jax_target)
    assert _dtypes(got) == _dtypes(want)
    if name in ("auroc", "average_precision"):
        assert got.dtype == torch.float32  # the value's dtype never follows the targets


@pytest.mark.parametrize("target_kind", TARGETS)
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", CLASSES)
def test_class_output_dtypes_match_jax(name, mode, dtype_name, target_kind):
    scores, target, jax_scores, jax_target = _inputs(dtype_name, target_kind)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got_metric = getattr(metrics_tpu_torch, name)(device="cpu", **MODES[mode])
        want_metric = getattr(metrics_tpu, name)(**MODES[mode])
        got_metric.update(scores, target)
        want_metric.update(jax_scores, jax_target)
        got, want = got_metric.compute(), want_metric.compute()
    assert _dtypes(got) == _dtypes(want)


def test_float64_scores_give_float32_curves_whatever_the_targets():
    """The repro of the fault: float64 scores with an all-zero target used
    to give a float64 value, and float32 with a mixed one."""
    scores = torch.rand(20, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    for target in (torch.zeros(20, dtype=torch.long), torch.arange(20) % 2):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert torch_functional.auroc(scores, target, device="cpu").dtype == torch.float32
            assert all(x.dtype == torch.float32 for x in torch_functional.roc(scores, target, device="cpu"))


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_multiclass_output_dtypes_match_jax(dtype_name):
    rng = np.random.default_rng(1)
    probs = rng.random((30, 3)).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    scores = torch.from_numpy(probs).to(DTYPES[dtype_name])
    if scores.dtype == torch.bfloat16:
        jax_scores = jax.lax.bitcast_convert_type(jnp.asarray(scores.view(torch.int16).numpy()), jnp.bfloat16)
    else:
        jax_scores = jnp.asarray(scores.numpy())
    target = rng.integers(0, 3, 30)
    for name in FUNCTIONALS:
        got = getattr(torch_functional, name)(scores, torch.from_numpy(target), num_classes=3, device="cpu")
        want = getattr(jax_functional, name)(jax_scores, jnp.asarray(target), num_classes=3)
        assert _dtypes(got) == _dtypes(want), name
