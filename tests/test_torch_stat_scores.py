"""The port's stat-scores family against the JAX package's, on the CPU.

StatScores, Accuracy (subset and top-k included), Precision, Recall,
FBetaScore/F1Score, Specificity and HammingDistance, functional and
modular, over the input cases of ``tests/classification/inputs.py``
(binary, multilabel, multiclass, multi-dim multi-class, logits and the
missing-class case). The same seeded numpy inputs go to both packages.
Counts and states are int32 on both sides and must agree bit for bit;
values hold to rtol 1e-6 and atol 1e-7 (the macro/weighted class sums
reduce in another order on XLA's CPU than in torch). The typed errors
match. An epoch started in JAX continues in the port (``state_from_jax``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu.classification as jcls
import metrics_tpu.functional as jfn
import metrics_tpu_torch.classification as tcls
import metrics_tpu_torch.functional as tfn
from metrics_tpu_torch.convert import state_from_jax
from tests.classification.inputs import (
    _input_binary,
    _input_binary_logits,
    _input_binary_prob,
    _input_multiclass,
    _input_multiclass_logits,
    _input_multiclass_prob,
    _input_multiclass_with_missing_class,
    _input_multidim_multiclass,
    _input_multidim_multiclass_prob,
    _input_multilabel_logits,
    _input_multilabel_prob,
)
from tests.helpers.testers import NUM_CLASSES

torch.set_num_threads(2)

RTOL, ATOL = 1e-6, 1e-7

INPUTS = {
    "binary_prob": _input_binary_prob,
    "binary": _input_binary,
    "binary_logits": _input_binary_logits,
    "multilabel_prob": _input_multilabel_prob,
    "multilabel_logits": _input_multilabel_logits,
    "multiclass_prob": _input_multiclass_prob,
    "multiclass": _input_multiclass,
    "multiclass_logits": _input_multiclass_logits,
    "multidim_prob": _input_multidim_multiclass_prob,
    "multidim": _input_multidim_multiclass,
    "missing_class": _input_multiclass_with_missing_class,
}

C = NUM_CLASSES
_MC = ("multiclass_prob", "multiclass", "multiclass_logits", "missing_class")
_MDMC = ("multidim_prob", "multidim")
_PROBS = ("multiclass_prob", "multiclass_logits", "multidim_prob")

# (case, averaging arguments): every input case with the averages it takes
CONFIGS = (
    [(case, dict(average="micro")) for case in ("binary_prob", "binary", "binary_logits")]
    + [("binary_prob", dict(average="macro", num_classes=1))]
    + [
        (case, dict(average=avg, num_classes=C))
        for case in ("multilabel_prob", "multilabel_logits") + _MC
        for avg in ("micro", "macro", "weighted", "none", "samples")
    ]
    + [(case, dict(average="micro", num_classes=C, top_k=2)) for case in ("multilabel_prob",) + _PROBS[:2]]
    + [(case, dict(average="macro", num_classes=C, top_k=3)) for case in _PROBS[:2]]
    + [(_PROBS[2], dict(average=avg, num_classes=C, top_k=2, mdmc_average="global")) for avg in ("micro", "macro")]
    + [
        (case, dict(average=avg, num_classes=C, ignore_index=1))
        for case in ("multiclass_prob", "multiclass")
        for avg in ("micro", "macro", "weighted", "none")
    ]
    + [
        (case, dict(average=avg, num_classes=C, mdmc_average=mdmc))
        for case in _MDMC
        for avg in ("micro", "macro", "none")
        for mdmc in ("global", "samplewise")
    ]
    + [(case, dict(average="samples", num_classes=C, mdmc_average="global")) for case in _MDMC]
    + [("multidim", dict(average="macro", num_classes=C, mdmc_average="samplewise", ignore_index=0))]
)
CONFIG_IDS = [f"{case}-" + "-".join(f"{k}={v}" for k, v in kw.items()) for case, kw in CONFIGS]

# functional name -> (JAX class name, extra keyword arguments)
METRICS = {
    "accuracy": ("Accuracy", {}),
    "precision": ("Precision", {}),
    "recall": ("Recall", {}),
    "f1_score": ("F1Score", {}),
    "fbeta_score": ("FBetaScore", {"beta": 0.5}),
    "specificity": ("Specificity", {}),
    "stat_scores": ("StatScores", {}),
}


def _stat_scores_args(kw):
    """StatScores names the averages ``reduce``/``mdmc_reduce``."""
    kw = dict(kw)
    avg = kw.pop("average")
    kw["reduce"] = {"weighted": "macro", "none": "macro"}.get(avg, avg)
    if "mdmc_average" in kw:
        kw["mdmc_reduce"] = kw.pop("mdmc_average")
    return kw


def _args(name, kw):
    kw = dict(kw, **METRICS[name][1])
    return _stat_scores_args(kw) if name == "stat_scores" else kw


def _batch(case, i=0):
    inputs = INPUTS[case]
    return inputs.preds[i], inputs.target[i]


def _both(jax_call, port_call):
    """``(want, got)`` from both sides, or None when the JAX side raised and
    the port raised the same error."""
    try:
        want = jax_call()
    except (ValueError, RuntimeError) as err:
        with pytest.raises(type(err)) as got:
            port_call()
        assert str(got.value) == str(err)
        return None
    return want, port_call()


def _assert_value(got, want, exact=False):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, equal_nan=True)


def _assert_states(metric, jax_metric):
    for name in metric._defaults:
        got, want = getattr(metric, name), getattr(jax_metric, name)
        if isinstance(want, list):
            assert len(got) == len(want)
            got, want = (torch.cat(got) if got else torch.zeros(0)), (np.concatenate(want) if want else np.zeros(0))
        want = np.asarray(want)
        assert got.dtype == torch.int32 and want.dtype == np.int32, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


@pytest.mark.parametrize("case, kw", CONFIGS, ids=CONFIG_IDS)
@pytest.mark.parametrize("name", list(METRICS))
def test_functional_matches_jax(name, case, kw):
    preds, target = _batch(case)
    args = _args(name, kw)
    pair = _both(
        lambda: getattr(jfn, name)(jnp.asarray(preds), jnp.asarray(target), **args),
        lambda: getattr(tfn, name)(preds, target, device="cpu", **args),
    )
    if pair is not None:
        _assert_value(pair[1], pair[0], exact=name == "stat_scores")


@pytest.mark.parametrize("case, kw", CONFIGS, ids=CONFIG_IDS)
@pytest.mark.parametrize("name", ["accuracy", "precision", "fbeta_score", "specificity", "stat_scores"])
def test_modular_matches_jax(name, case, kw):
    """forward (the batch value) and update over the batches, then compute;
    the states bit for bit after every batch."""
    cls_name, _ = METRICS[name]
    args = _args(name, kw)
    pair = _both(lambda: getattr(jcls, cls_name)(**args), lambda: getattr(tcls, cls_name)(device="cpu", **args))
    if pair is None:
        return
    jm, tm = pair
    inputs = INPUTS[case]
    for i in range(len(inputs.preds)):
        preds, target = inputs.preds[i], inputs.target[i]
        call = (lambda m: m.update) if i % 2 else (lambda m: m)
        pair = _both(lambda: call(jm)(jnp.asarray(preds), jnp.asarray(target)), lambda: call(tm)(preds, target))
        if pair is None:
            return  # the batch raised the same error on both sides
        if not i % 2:
            _assert_value(pair[1], pair[0], exact=name == "stat_scores")
        _assert_states(tm, jm)
    _assert_value(tm.compute(), jm.compute(), exact=name == "stat_scores")


@pytest.mark.parametrize("case", ["multilabel_prob", "multidim_prob", "multidim", "multiclass_prob"])
def test_subset_accuracy_matches_jax(case):
    """Subset accuracy keeps int32 correct/total; on multi-class inputs it
    switches itself off and counts as plain accuracy."""
    jm, tm = jcls.Accuracy(subset_accuracy=True), tcls.Accuracy(subset_accuracy=True, device="cpu")
    inputs = INPUTS[case]
    for preds, target in zip(inputs.preds, inputs.target):
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(preds, target)
        _assert_states(tm, jm)
    assert tm.subset_accuracy == jm.subset_accuracy and tm.mode == jm.mode
    _assert_value(tm.compute(), jm.compute())
    preds, target = _batch(case)
    want = jfn.accuracy(jnp.asarray(preds), jnp.asarray(target), subset_accuracy=True)
    _assert_value(tfn.accuracy(preds, target, subset_accuracy=True, device="cpu"), want)


@pytest.mark.parametrize("case", ["multilabel_prob", "multiclass_prob", "multidim", "binary_prob"])
def test_hamming_matches_jax(case):
    jm, tm = jcls.HammingDistance(), tcls.HammingDistance(device="cpu")
    inputs = INPUTS[case]
    for preds, target in zip(inputs.preds, inputs.target):
        _assert_value(tm(preds, target), jm(jnp.asarray(preds), jnp.asarray(target)))
        _assert_states(tm, jm)
    _assert_value(tm.compute(), jm.compute())
    preds, target = _batch(case)
    _assert_value(tfn.hamming_distance(preds, target, device="cpu"), jfn.hamming_distance(jnp.asarray(preds), jnp.asarray(target)))


def _with_ignored_targets(case, share=0.25, seed=3):
    """The case's batches with a share of the targets set to -1."""
    rng = np.random.RandomState(seed)
    inputs = INPUTS[case]
    target = np.where(rng.rand(*inputs.target.shape) < share, -1, inputs.target)
    return inputs.preds, target


@pytest.mark.parametrize("case", ["multiclass_prob", "multiclass", "multidim_prob", "multidim"])
@pytest.mark.parametrize("average", ["micro", "macro"])
def test_negative_ignore_index_accuracy_matches_jax(case, average):
    """Accuracy infers the input mode, so it drops positions whose target is
    a negative ``ignore_index`` (a data-dependent shape)."""
    preds_all, target_all = _with_ignored_targets(case)
    kw = dict(average=average, num_classes=C, ignore_index=-1)
    jm, tm = jcls.Accuracy(**kw), tcls.Accuracy(device="cpu", **kw)
    for preds, target in zip(preds_all, target_all):
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(preds, target)
        _assert_states(tm, jm)
    _assert_value(tm.compute(), jm.compute())
    want = jfn.accuracy(jnp.asarray(preds_all[0]), jnp.asarray(target_all[0]), **kw)
    _assert_value(tfn.accuracy(preds_all[0], target_all[0], device="cpu", **kw), want)


@pytest.mark.parametrize("reduce", ["micro", "macro"])
@pytest.mark.parametrize("name", ["stat_scores", "precision"])
def test_negative_ignore_index_raises_where_the_mode_is_not_inferred(name, reduce):
    preds, target = _with_ignored_targets("multiclass")
    kw = dict(ignore_index=-1)
    if name == "stat_scores":
        kw.update(reduce=reduce, num_classes=C if reduce == "macro" else None)
    else:
        kw.update(average=reduce, num_classes=None if reduce == "micro" else C)
    for call in (
        lambda: getattr(jfn, name)(jnp.asarray(preds[0]), jnp.asarray(target[0]), **kw),
        lambda: getattr(tfn, name)(preds[0], target[0], device="cpu", **kw),
    ):
        with pytest.raises(ValueError, match="negative|not valid"):
            call()


@pytest.mark.parametrize(
    "cls_name, kw, match",
    [
        ("Accuracy", dict(average="median"), "The `average` has to be one of"),
        ("Precision", dict(average="median"), "The `average` has to be one of"),
        ("FBetaScore", dict(average="median"), "The `average` has to be one of"),
        ("Specificity", dict(average="median"), "The `average` has to be one of"),
        ("StatScores", dict(reduce="macro"), "you have to provide the number of classes"),
        ("StatScores", dict(reduce="weighted"), "The `reduce` weighted is not valid"),
        ("StatScores", dict(mdmc_reduce="mean"), "The `mdmc_reduce` mean is not valid"),
        ("Accuracy", dict(top_k=0), "The `top_k` should be an integer larger than 0"),
        ("Recall", dict(num_classes=3, ignore_index=3), "is not valid for inputs with 3 classes"),
    ],
)
def test_constructor_errors_match_jax(cls_name, kw, match):
    with pytest.raises(ValueError, match=match):
        getattr(jcls, cls_name)(**kw)
    with pytest.raises(ValueError, match=match):
        getattr(tcls, cls_name)(device="cpu", **kw)


@pytest.mark.parametrize("name", ["accuracy", "precision", "specificity", "fbeta_score"])
def test_functional_average_errors_match_jax(name):
    preds, target = _batch("multiclass")
    for kw, match in ((dict(average="median"), "The `average` has to be one of"), (dict(average="macro"), "number of classes")):
        with pytest.raises(ValueError, match=match):
            getattr(jfn, name)(jnp.asarray(preds), jnp.asarray(target), **kw)
        with pytest.raises(ValueError, match=match):
            getattr(tfn, name)(preds, target, device="cpu", **kw)


def test_accuracy_mode_switch_raises_like_jax():
    for m, wrap in ((jcls.Accuracy(), jnp.asarray), (tcls.Accuracy(device="cpu"), torch.from_numpy)):
        m.update(wrap(_input_binary_prob.preds[0]), wrap(_input_binary_prob.target[0]))
        with pytest.raises(ValueError, match="You can not use DataType.MULTICLASS inputs with DataType.BINARY inputs"):
            m.update(wrap(_input_multiclass.preds[0]), wrap(_input_multiclass.target[0]))


def test_accuracy_top_k_on_multilabel_raises_like_jax():
    preds, target = _batch("multilabel_prob")
    for fn, wrap in ((jfn.accuracy, jnp.asarray), (tfn.accuracy, torch.from_numpy)):
        with pytest.raises(ValueError, match="top_k"):
            fn(wrap(preds), wrap(target), top_k=2)


@pytest.mark.parametrize("ties", [False, True])
def test_top_k_accuracy_ranks_ties_to_the_lower_index(ties):
    """Top-k picks the k highest scores, ties to the lower index (as
    ``lax.top_k``); the count equals numpy's stable argsort."""
    rng = np.random.RandomState(4)
    preds = rng.rand(64, 7).astype(np.float32)
    if ties:
        preds = np.round(preds * 3).astype(np.float32) / 3
    target = rng.randint(0, 7, 64)
    for k in (1, 3):
        want = jfn.accuracy(jnp.asarray(preds), jnp.asarray(target), top_k=k)
        got = tfn.accuracy(preds, target, top_k=k, device="cpu")
        _assert_value(got, want)
        topk = np.argsort(-preds, axis=1, kind="stable")[:, :k]
        count = int((topk == target[:, None]).any(axis=1).sum())
        assert got.item() == np.float32(count) / np.float32(64)


def test_forward_and_pure_state_api_leave_the_state_dict_alone():
    """update_state builds new tensors (and new lists for list states)."""
    for kw in (dict(reduce="macro", num_classes=C), dict(reduce="samples")):
        metric = tcls.StatScores(device="cpu", **kw)
        state = metric.init_state()
        preds, target = _batch("multiclass")
        new = metric.update_state(state, preds, target)
        for name, value in state.items():
            if isinstance(value, list):
                assert value == [] and len(new[name]) == 1
            else:
                assert int(value.abs().sum()) == 0
        assert metric.compute_state(new).shape == tfn.stat_scores(preds, target, device="cpu", **kw).shape


def _carry(jm, tm):
    state = {k: ([np.asarray(x) for x in v] if isinstance(v, list) else np.asarray(v)) for k, v in jm.state_dict().items()}
    return state_from_jax(state, tm, host_from=jm)


@pytest.mark.parametrize(
    "cls_name, kw, case",
    [
        ("Accuracy", dict(num_classes=C, average="macro"), "multiclass_prob"),
        ("Accuracy", dict(subset_accuracy=True), "multilabel_prob"),
        ("StatScores", dict(reduce="macro", num_classes=C, mdmc_reduce="samplewise"), "multidim_prob"),
        ("StatScores", dict(reduce="samples"), "multilabel_prob"),
    ],
)
def test_epoch_started_in_jax_continues_in_the_port(cls_name, kw, case):
    """Two batches in JAX, the state (list states included) and the host
    state (Accuracy's mode and subset switch) carried, two more in the
    port: the JAX value of the four."""
    jm, tm = getattr(jcls, cls_name)(**kw), getattr(tcls, cls_name)(device="cpu", **kw)
    inputs = INPUTS[case]
    for i in range(2):
        jm.update(jnp.asarray(inputs.preds[i]), jnp.asarray(inputs.target[i]))
    tm.load_state_dict(_carry(jm, tm))
    if cls_name == "Accuracy":
        assert tm.mode == jm.mode and tm.subset_accuracy == jm.subset_accuracy
    for i in range(2, len(inputs.preds)):
        jm.update(jnp.asarray(inputs.preds[i]), jnp.asarray(inputs.target[i]))
        tm.update(inputs.preds[i], inputs.target[i])
    _assert_states(tm, jm)
    _assert_value(tm.compute(), jm.compute(), exact=cls_name == "StatScores")


def test_accuracy_checks_read_the_inputs_once(monkeypatch):
    """Accuracy's mode check and the formatter share one read of the values."""
    import metrics_tpu_torch.utils.checks as checks

    reads = []
    real = checks._value_stats
    monkeypatch.setattr(checks, "_value_stats", lambda p, t: reads.append(1) or real(p, t))
    metric = tcls.Accuracy(num_classes=C, average="macro", device="cpu")
    for i in range(3):
        metric.update(*_batch("multiclass", i))
    assert len(reads) == 3


def test_metrics_default_to_the_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcls.Accuracy()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfn.precision(np.array([0, 1]), np.array([0, 1]))
