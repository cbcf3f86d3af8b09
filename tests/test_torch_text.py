"""The text family: the port against the JAX package.

Every functional of ``metrics_tpu/functional/text/`` and every class of
``metrics_tpu/text/`` but BERTScore (``tests/test_torch_bertscore.py``) on
the same inputs (``tests/text/inputs.py``, the stored-oracle corpus of
``tests/text/oracle_corpus.py`` and a seeded corpus made with numpy), over
the argument grids the JAX package's tests sweep. The classes are compared
batch by batch (``forward``), accumulated, after ``reset`` and after a
carry of every state (``carry_from_jax``); their states are compared too
(a list state by its concatenation: the port's grows one chunk per update,
the JAX package's one element per sentence).

Tolerance: bit-equality (value and dtype), except BLEU and SacreBLEU, whose
score the port takes in float64 from the float32 counts and rounds once,
where XLA takes ``log`` and ``exp`` in float32: within 4 float32 ulp of
the JAX package's, and equal to a float64 evaluation rounded once
(``test_bleu_log_exp_gap_is_pinned`` pins XLA's share of differing logs).
The port runs with ``device="cpu"``; no kernel is involved. ROUGE-Lsum
takes the regex sentence splitter in both packages (no ``punkt`` data is
installed, and the JAX package's download is switched off by its cache).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu
import metrics_tpu.functional.text as jax_text
import metrics_tpu.functional.text.rouge as jax_rouge_module
import metrics_tpu_torch
import metrics_tpu_torch.functional.text as torch_text
from metrics_tpu_torch.convert import carry_from_jax
from tests.text.inputs import (
    _inputs_error_rate_batch_size_1,
    _inputs_error_rate_batch_size_2,
    _inputs_multiple_references,
)
from tests.text.oracle_corpus import flat_corpus

torch.set_num_threads(2)

ULP_BOUND = 4


@pytest.fixture(autouse=True, scope="module")
def _offline_punkt():
    """The JAX package tries an nltk download when ``punkt`` is missing;
    its cached probe result says "not usable", which is what that download
    gives offline, so no network call is made."""
    saved = jax_rouge_module._PUNKT_USABLE
    jax_rouge_module._PUNKT_USABLE = False
    yield
    jax_rouge_module._PUNKT_USABLE = saved


def _seeded_corpus(n=6, seed=0):
    """``n`` hypotheses with two references each, from a seeded vocabulary
    with punctuation and case (substitutions, a deletion and a shifted span)."""
    rng = np.random.default_rng(seed)
    vocab = ["the", "a", "cat", "dog", "sat", "on", "mat", "It", "ran,", "fast.", "Big", "red", "house", "and", "!"]
    preds, targets = [], []
    for _ in range(n):
        hyp = list(rng.choice(vocab, rng.integers(4, 12)))
        refs = []
        for _ in range(2):
            ref = [w if rng.random() > 0.25 else str(rng.choice(vocab)) for w in hyp]
            if len(ref) > 3:
                del ref[int(rng.integers(len(ref)))]
                cut = int(rng.integers(1, len(ref) - 1))
                ref = ref[cut:] + ref[:cut]
            refs.append(" ".join(ref))
        preds.append(" ".join(hyp))
        targets.append(refs)
    return preds, targets


SEEDED = _seeded_corpus()
FLAT = flat_corpus()
MT_BATCHES = (
    [FLAT[0][:3], FLAT[0][3:]],
    [FLAT[1][:3], FLAT[1][3:]],
)


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------
def _host(x):
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (float, int, str)):
        return x
    return np.asarray(x)


def _same(got, want, path="value"):
    """Bit-equality of two results (dicts, lists, arrays): same keys, same
    lengths, same dtypes and shapes, the same values (NaN by position)."""
    got, want = _host(got), _host(want)
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}[{k}]")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, (float, int, str)):
        assert got == want, (path, got, want)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=path)


def _ulps(got, want):
    got = np.asarray(_host(got), np.float32).reshape(-1)
    want = np.asarray(_host(want), np.float32).reshape(-1)
    return np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))


def _close_ulp(got, want):
    assert _host(got).dtype == _host(want).dtype == np.float32
    assert int(_ulps(got, want).max()) <= ULP_BOUND, (got, want)


def _flat_state(value):
    """A state as one host array (a list state by its concatenation)."""
    if isinstance(value, list):
        return np.concatenate([np.atleast_1d(_host(v)) for v in value]) if value else np.zeros(0, np.float32)
    return _host(value)


def _check_class(name, args, batches, compare=_same, jax_args=None):
    """``forward`` per batch, ``compute``, states, ``reset`` and the carry of
    every state, the port's class against the JAX package's."""
    port = getattr(metrics_tpu_torch, name)(device="cpu", **args)
    ref = getattr(metrics_tpu, name)(**(args if jax_args is None else jax_args))
    for preds, target in batches:
        compare(port(preds, target), ref(preds, target))
    compare(port.compute(), ref.compute())
    for state in ref._defaults:
        got, want = _flat_state(getattr(port, state)), _flat_state(getattr(ref, state))
        assert got.dtype == want.dtype, state
        np.testing.assert_array_equal(got, want, err_msg=state)

    carried = carry_from_jax(ref, getattr(metrics_tpu_torch, name)(device="cpu", **args))
    compare(carried.compute(), ref.compute())

    port.reset()
    ref.reset()
    port.update(*batches[0])
    ref.update(*batches[0])
    compare(port.compute(), ref.compute())


# ---------------------------------------------------------------------------
# the WER family
# ---------------------------------------------------------------------------
_ERROR_RATE = {
    "word_error_rate": "WordErrorRate",
    "char_error_rate": "CharErrorRate",
    "match_error_rate": "MatchErrorRate",
    "word_information_lost": "WordInfoLost",
    "word_information_preserved": "WordInfoPreserved",
}
_ERROR_INPUTS = {"batch1": _inputs_error_rate_batch_size_1, "batch2": _inputs_error_rate_batch_size_2}


@pytest.mark.parametrize("inputs", list(_ERROR_INPUTS))
@pytest.mark.parametrize("fn", list(_ERROR_RATE))
def test_error_rate_functional(fn, inputs):
    data = _ERROR_INPUTS[inputs]
    for preds, target in zip(data.preds, data.targets):
        _same(getattr(torch_text, fn)(preds, target, device="cpu"), getattr(jax_text, fn)(preds, target))
    flat_p = [p for b in data.preds for p in b]
    flat_t = [t for b in data.targets for t in b]
    _same(getattr(torch_text, fn)(flat_p, flat_t, device="cpu"), getattr(jax_text, fn)(flat_p, flat_t))
    # a single string on both sides
    _same(getattr(torch_text, fn)(flat_p[0], flat_t[0], device="cpu"), getattr(jax_text, fn)(flat_p[0], flat_t[0]))


@pytest.mark.parametrize("inputs", list(_ERROR_INPUTS))
@pytest.mark.parametrize("fn", list(_ERROR_RATE))
def test_error_rate_class(fn, inputs):
    data = _ERROR_INPUTS[inputs]
    _check_class(_ERROR_RATE[fn], {}, list(zip(data.preds, data.targets)))


def test_error_rate_states_are_float32_sums():
    metric = metrics_tpu_torch.WordInfoLost(device="cpu")
    assert [metric._defaults[k].dtype for k in ("errors", "target_total", "preds_total")] == [torch.float32] * 3


# ---------------------------------------------------------------------------
# BLEU and SacreBLEU
# ---------------------------------------------------------------------------
def _bleu_float64(preds, target, n_gram, smooth, tokenizer=None):
    """BLEU from the port's host counts, in float64 and rounded once."""
    from metrics_tpu_torch.functional.text.bleu import _bleu_score_update, _tokenize_fn

    num, den = np.zeros(n_gram), np.zeros(n_gram)
    p_len, t_len = _bleu_score_update(preds, target, num, den, 0.0, 0.0, n_gram, tokenizer or _tokenize_fn)
    if num.min() == 0:
        return np.float32(0.0)
    prec = (num + 1.0) / (den + 1.0) if smooth else num / den
    if smooth:
        prec[0] = num[0] / den[0]
    geo = np.exp(np.sum((1.0 / n_gram) * np.log(prec)))
    bp = 1.0 if p_len > t_len else np.exp(1 - t_len / p_len)
    return np.float32(bp * geo)


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("n_gram", [1, 2, 3, 4])
def test_bleu_functional(n_gram, smooth):
    for preds, target in list(zip(*MT_BATCHES)) + [SEEDED]:
        got = torch_text.bleu_score(preds, target, n_gram=n_gram, smooth=smooth, device="cpu")
        _close_ulp(got, jax_text.bleu_score(preds, target, n_gram=n_gram, smooth=smooth))
        assert got.numpy() == _bleu_float64(preds, target, n_gram, smooth)


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("n_gram", [1, 2, 4])
def test_bleu_class(n_gram, smooth):
    batches = list(zip(*MT_BATCHES)) + [SEEDED]
    _check_class("BLEUScore", {"n_gram": n_gram, "smooth": smooth}, batches, compare=_close_ulp)


def test_bleu_zero_numerator_returns_zero():
    got = torch_text.bleu_score(["a b"], [["c d"]], device="cpu")
    _same(got, jax_text.bleu_score(["a b"], [["c d"]]))


_TOKENIZERS = ("none", "13a", "zh", "intl", "char")


@pytest.mark.parametrize("lowercase", [False, True])
@pytest.mark.parametrize("tokenize", _TOKENIZERS)
def test_sacre_bleu_functional(tokenize, lowercase):
    from metrics_tpu_torch.functional.text.sacre_bleu import _SacreBLEUTokenizer

    for preds, target in (FLAT, SEEDED):
        got = torch_text.sacre_bleu_score(preds, target, tokenize=tokenize, lowercase=lowercase, device="cpu")
        _close_ulp(got, jax_text.sacre_bleu_score(preds, target, tokenize=tokenize, lowercase=lowercase))
        want = _bleu_float64(preds, target, 4, False, _SacreBLEUTokenizer(tokenize, lowercase))
        assert got.numpy() == want


@pytest.mark.parametrize("lowercase", [False, True])
@pytest.mark.parametrize("tokenize", _TOKENIZERS)
def test_sacre_bleu_tokenizers_match(tokenize, lowercase):
    from metrics_tpu.functional.text.sacre_bleu import _SacreBLEUTokenizer as JaxTokenizer
    from metrics_tpu_torch.functional.text.sacre_bleu import _SacreBLEUTokenizer

    lines = FLAT[0] + [r for refs in FLAT[1] for r in refs]
    port, ref = _SacreBLEUTokenizer(tokenize, lowercase), JaxTokenizer(tokenize, lowercase)
    assert [port(line) for line in lines] == [ref(line) for line in lines]


@pytest.mark.parametrize("tokenize", ["13a", "char", "intl"])
def test_sacre_bleu_class(tokenize):
    _check_class("SacreBLEUScore", {"tokenize": tokenize}, list(zip(*MT_BATCHES)), compare=_close_ulp)


def test_sacre_bleu_argument_errors():
    with pytest.raises(ValueError, match="tokenize"):
        torch_text.sacre_bleu_score(["a"], [["a"]], tokenize="bad", device="cpu")
    with pytest.raises(ValueError, match="tokenize"):
        metrics_tpu_torch.SacreBLEUScore(tokenize="bad", device="cpu")
    with pytest.raises(ValueError, match="Corpus has different size"):
        torch_text.bleu_score(["a", "b"], [["a"]], device="cpu")


def test_bleu_log_exp_gap_is_pinned():
    """XLA's float32 ``log`` and ``exp`` on the CPU against correctly
    rounded ones (float64, rounded once, what the port's BLEU computes) on
    2**16 seeded values in (1e-3, 1): they differ on a share of inputs, by
    at most 1 ulp. If the share ever reaches 0, BLEU could be held bit for
    bit."""
    x = np.random.default_rng(0).uniform(1e-3, 1.0, 1 << 16).astype(np.float32)
    for jax_fn, exact in ((jnp.log, np.log), (jnp.exp, np.exp)):
        xla = np.asarray(jax_fn(jnp.asarray(x)))
        rounded = exact(x.astype(np.float64)).astype(np.float32)
        differ = float(np.mean(xla != rounded))
        assert 0.02 < differ < 0.25, (jax_fn.__name__, differ)
        assert int(_ulps(xla, rounded).max()) <= 1
    # over the BLEU grid the two packages stay within the stated bound, and differ somewhere
    gaps = []
    for n_gram in (1, 2, 3, 4):
        for smooth in (False, True):
            for preds, target in list(zip(*MT_BATCHES)) + [SEEDED, FLAT]:
                got = torch_text.bleu_score(preds, target, n_gram=n_gram, smooth=smooth, device="cpu")
                gaps.append(int(_ulps(got, jax_text.bleu_score(preds, target, n_gram=n_gram, smooth=smooth))[0]))
    assert max(gaps) <= ULP_BOUND
    assert any(gaps), "BLEU is bit-equal on the whole grid: tighten the tolerance"


# ---------------------------------------------------------------------------
# chrF
# ---------------------------------------------------------------------------
_CHRF_GRID = [
    dict(n_char_order=c, n_word_order=w, lowercase=lc, whitespace=ws)
    for c, w in ((6, 2), (6, 0), (4, 1))
    for lc in (False, True)
    for ws in (False, True)
]


@pytest.mark.parametrize("sentence", [False, True])
@pytest.mark.parametrize("args", _CHRF_GRID, ids=lambda a: "-".join(str(v) for v in a.values()))
def test_chrf_functional(args, sentence):
    for preds, target in (FLAT, SEEDED):
        got = torch_text.chrf_score(preds, target, return_sentence_level_score=sentence, device="cpu", **args)
        _same(got, jax_text.chrf_score(preds, target, return_sentence_level_score=sentence, **args))


@pytest.mark.parametrize("sentence", [False, True])
@pytest.mark.parametrize("args", _CHRF_GRID[:4], ids=lambda a: "-".join(str(v) for v in a.values()))
def test_chrf_class(args, sentence):
    _check_class("CHRFScore", dict(args, return_sentence_level_score=sentence), list(zip(*MT_BATCHES)) + [SEEDED])


def test_chrf_argument_errors():
    for kwargs in ({"n_char_order": 0}, {"n_word_order": -1}, {"beta": -1.0}):
        with pytest.raises(ValueError, match="Expected argument"):
            metrics_tpu_torch.CHRFScore(device="cpu", **kwargs)


# ---------------------------------------------------------------------------
# TER
# ---------------------------------------------------------------------------
_TER_GRID = [
    dict(normalize=n, no_punctuation=p, lowercase=lc, asian_support=a)
    for n in (False, True)
    for p in (False, True)
    for lc in (False, True)
    for a in (False, True)
]


@pytest.mark.parametrize("args", _TER_GRID, ids=lambda a: "-".join(str(int(v)) for v in a.values()))
def test_ter_functional(args):
    for preds, target in (FLAT, SEEDED):
        got = torch_text.translation_edit_rate(preds, target, return_sentence_level_score=True, device="cpu", **args)
        _same(got, jax_text.translation_edit_rate(preds, target, return_sentence_level_score=True, **args))


@pytest.mark.parametrize("sentence", [False, True])
@pytest.mark.parametrize("args", _TER_GRID[::5], ids=lambda a: "-".join(str(int(v)) for v in a.values()))
def test_ter_class(args, sentence):
    _check_class("TranslationEditRate", dict(args, return_sentence_level_score=sentence), list(zip(*MT_BATCHES)) + [SEEDED])


def test_ter_argument_errors():
    with pytest.raises(ValueError, match="boolean"):
        torch_text.translation_edit_rate(["a"], [["a"]], normalize=1, device="cpu")
    with pytest.raises(ValueError, match="boolean"):
        metrics_tpu_torch.TranslationEditRate(lowercase="yes", device="cpu")


# ---------------------------------------------------------------------------
# EED
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("language", ["en", "ja"])
def test_eed_functional(language):
    for preds, target in (FLAT, SEEDED):
        got = torch_text.extended_edit_distance(preds, target, language=language, return_sentence_level_score=True, device="cpu")
        _same(got, jax_text.extended_edit_distance(preds, target, language=language, return_sentence_level_score=True))
    _same(
        torch_text.extended_edit_distance(FLAT[0], FLAT[1], alpha=3.0, rho=0.1, deletion=0.5, device="cpu"),
        jax_text.extended_edit_distance(FLAT[0], FLAT[1], alpha=3.0, rho=0.1, deletion=0.5),
    )


@pytest.mark.parametrize("sentence", [False, True])
@pytest.mark.parametrize("language", ["en", "ja"])
def test_eed_class(language, sentence):
    _check_class(
        "ExtendedEditDistance",
        {"language": language, "return_sentence_level_score": sentence},
        list(zip(*MT_BATCHES)) + [SEEDED],
    )


def test_eed_argument_errors():
    with pytest.raises(ValueError, match="language"):
        metrics_tpu_torch.ExtendedEditDistance(language="de", device="cpu")
    with pytest.raises(ValueError, match="alpha"):
        torch_text.extended_edit_distance(["a"], [["a"]], alpha=-1.0, device="cpu")


# ---------------------------------------------------------------------------
# ROUGE
# ---------------------------------------------------------------------------
_ROUGE_KEYS = (("rouge1", "rouge2", "rougeL", "rougeLsum"), ("rougeL",), ("rouge3", "rouge1"))
_SUMMARIES = (
    ["The cat sat on the mat. It was happy! Then it slept.", "My name is John", "Dogs run fast. Cats do not."],
    [["A cat sat on a mat. It was glad.", "the cat was on the mat"], ["Is your name John"], ["Dogs are fast runners. Cats are slow."]],
)


@pytest.mark.parametrize("use_stemmer", [False, True])
@pytest.mark.parametrize("accumulate", ["best", "avg"])
@pytest.mark.parametrize("keys", _ROUGE_KEYS, ids=lambda k: "-".join(k))
def test_rouge_functional(keys, accumulate, use_stemmer):
    for preds, target in (_SUMMARIES, FLAT, SEEDED):
        got = torch_text.rouge_score(preds, target, accumulate=accumulate, use_stemmer=use_stemmer, rouge_keys=keys, device="cpu")
        _same(got, jax_text.rouge_score(preds, target, accumulate=accumulate, use_stemmer=use_stemmer, rouge_keys=keys))
    # single strings on both sides
    args = dict(accumulate=accumulate, use_stemmer=use_stemmer, rouge_keys=keys)
    _same(torch_text.rouge_score("My name is John", "Is your name John", device="cpu", **args),
          jax_text.rouge_score("My name is John", "Is your name John", **args))


@pytest.mark.parametrize("accumulate", ["best", "avg"])
@pytest.mark.parametrize("keys", _ROUGE_KEYS[:2], ids=lambda k: "-".join(k))
def test_rouge_class(keys, accumulate):
    batches = [(_SUMMARIES[0][:2], _SUMMARIES[1][:2]), (_SUMMARIES[0][2:], _SUMMARIES[1][2:]), SEEDED]
    _check_class("ROUGEScore", {"rouge_keys": keys, "accumulate": accumulate, "use_stemmer": True}, batches)


def test_rouge_lsum_takes_the_offline_splitter():
    from metrics_tpu_torch.functional.text import rouge as port_rouge

    assert port_rouge._punkt_usable() is False  # no punkt data here, and nothing is downloaded
    text = "One sentence here. Another one! A third?"
    assert port_rouge._add_newline_to_end_of_each_sentence(text) == jax_rouge_module._add_newline_to_end_of_each_sentence(text)


def test_rouge_argument_errors():
    with pytest.raises(ValueError, match="unknown rouge key"):
        torch_text.rouge_score("a", "a", rouge_keys=("rouge10",), device="cpu")
    with pytest.raises(ValueError, match="unknown accumulate"):
        metrics_tpu_torch.ROUGEScore(accumulate="max", device="cpu")


# ---------------------------------------------------------------------------
# SQuAD
# ---------------------------------------------------------------------------
def _qa_set(n=12, seed=0):
    rng = np.random.default_rng(seed)
    words = ["the", "a", "Denver", "Broncos", "1976", "Super", "Bowl", "champions", "in", "an", "of", "Santa", "Clara", "!"]
    preds, targets = [], []
    for i in range(n):
        answers = [" ".join(rng.choice(words, rng.integers(1, 5))) for _ in range(rng.integers(1, 4))]
        pick = rng.random()
        pred = answers[0] if pick < 0.3 else (" ".join(rng.choice(words, rng.integers(0, 4))) if pick < 0.9 else answers[-1].upper())
        preds.append({"prediction_text": pred, "id": str(i)})
        targets.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": str(i)})
    return preds, targets


def test_squad_functional():
    preds, targets = _qa_set()
    _same(torch_text.squad(preds, targets, device="cpu"), jax_text.squad(preds, targets))
    _same(torch_text.squad(preds[0], targets[0], device="cpu"), jax_text.squad(preds[0], targets[0]))


def test_squad_class():
    preds, targets = _qa_set(20, seed=1)
    batches = [(preds[i : i + 7], targets[i : i + 7]) for i in range(0, 20, 7)]
    _check_class("SQuAD", {}, batches)
    assert metrics_tpu_torch.SQuAD(device="cpu")._defaults["total"].dtype == torch.int32


def test_squad_errors_and_unanswered():
    with pytest.raises(KeyError, match="prediction_text"):
        torch_text.squad([{"id": "1"}], [{"answers": {"text": ["a"]}, "id": "1"}], device="cpu")
    with pytest.raises(KeyError, match="'answers'"):
        torch_text.squad([{"prediction_text": "a", "id": "1"}], [{"id": "1"}], device="cpu")
    preds = [{"prediction_text": "a", "id": "1"}]
    targets = [{"answers": {"text": ["a"]}, "id": "1"}, {"answers": {"text": ["b"]}, "id": "2"}]
    with pytest.warns(UserWarning, match="Unanswered question 2"):
        got = torch_text.squad(preds, targets, device="cpu")
    _same(got, jax_text.squad(preds, targets))


# ---------------------------------------------------------------------------
# the stored oracle and the fused collection
# ---------------------------------------------------------------------------
def test_engine_scores_match_stored_oracle():
    """The port's engines over the stored-oracle corpus give the pinned
    values of ``tests/text/fixtures/text_engine_scores.csv`` at the
    tolerance of ``tests/text/test_stored_oracle.py`` (abs 1e-5)."""
    import csv
    import os

    path = os.path.join(os.path.dirname(__file__), "text", "fixtures", "text_engine_scores.csv")
    with open(path) as fh:
        pinned = {row["case"]: float(row["score"]) for row in csv.DictReader(fh)}
    preds, targets = FLAT
    got = {}
    for tokenize in _TOKENIZERS:
        for lowercase in (False, True):
            got[f"sacrebleu_{tokenize}_lc{int(lowercase)}"] = float(
                torch_text.sacre_bleu_score(preds, targets, tokenize=tokenize, lowercase=lowercase, device="cpu")
            )
    for normalize in (False, True):
        for no_punct in (False, True):
            for lowercase in (False, True):
                key = f"ter_norm{int(normalize)}_nopunct{int(no_punct)}_lc{int(lowercase)}"
                got[key] = float(torch_text.translation_edit_rate(
                    preds, targets, normalize=normalize, no_punctuation=no_punct, lowercase=lowercase, device="cpu"
                ))
    got["chrf"] = float(torch_text.chrf_score(preds, targets, n_word_order=0, device="cpu"))
    got["chrfpp"] = float(torch_text.chrf_score(preds, targets, device="cpu"))
    got["chrf_lc"] = float(torch_text.chrf_score(preds, targets, n_word_order=0, lowercase=True, device="cpu"))
    got["eed"] = float(torch_text.extended_edit_distance(preds, targets, device="cpu"))
    assert set(got) == set(pinned)
    for key, value in got.items():
        assert value == pytest.approx(pinned[key], abs=1e-5), key


def test_text_metrics_take_the_eager_leg_of_a_fused_collection():
    """String inputs cannot be captured: ``compile_update`` sends the text
    members to the eager leg, and the values equal an eager collection's."""
    members = lambda: [metrics_tpu_torch.WordErrorRate(device="cpu"), metrics_tpu_torch.CharErrorRate(device="cpu")]
    fused = metrics_tpu_torch.MetricCollection(members())
    eager = metrics_tpu_torch.MetricCollection(members())
    handle = fused.compile_update()
    data = _inputs_error_rate_batch_size_2
    for preds, target in zip(data.preds, data.targets):
        fused.update(preds, target)
        eager.update(preds, target)
    assert all(handle._never_fused(name) for name in ("WordErrorRate", "CharErrorRate"))
    _same(fused.compute(), eager.compute())


def test_text_states_live_on_the_metric_device():
    metric = metrics_tpu_torch.CHRFScore(return_sentence_level_score=True, device="cpu")
    metric.update(*SEEDED)
    assert all(getattr(metric, name).device.type == "cpu" for name in metric._state_names())
    assert len(metric.sentence_chrf_score) == 1  # one chunk per update
    assert metric.sentence_chrf_score[0].shape == (len(SEEDED[0]),)
