"""BERTScore and its BERT encoder: the port against the JAX package.

Nothing is downloaded: a tiny BERT (hidden size 32, 2 layers, 2 heads) and
its WordPiece vocabulary are built here, as ``tests/text/test_bertscore.py``
builds them. The weights are a seeded ``FlaxBertModel``'s, which the JAX
package runs; the port's :class:`~metrics_tpu_torch.models.bert.BertModel`
gets them through :func:`metrics_tpu_torch.convert.bert_from_flax`. The
port's ``bert_score`` and ``BERTScore`` run on the CPU (``device="cpu"``).

Tolerance: 1e-5 absolute on hidden states and on precision, recall and F1.
Both packages compute in float32 in different orders (the port's attention
scales after the product, Flax's before, and the reductions differ); the
port's module run in float64 sits within 2e-6 of each side's float32
hidden states and scores on these inputs (``test_float64_bounds_both_sides``),
so 1e-5 is five times what either side's own rounding gives.
"""
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax

import metrics_tpu
import metrics_tpu.text
from metrics_tpu.functional.text.bert import bert_score as jax_bert_score
import metrics_tpu_torch
from metrics_tpu_torch.convert import bert_from_flax, carry_from_jax
from metrics_tpu_torch.functional.text.bert import bert_score
from metrics_tpu_torch.models.bert import BertConfig, BertModel, build_bert

torch.set_num_threads(2)

ATOL = 1e-5

_VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
    "hello", "there", "general", "kenobi", "master", "the", "cat", "sat",
    "on", "a", "mat", "dog", "ran", "fast", "big", "red", "house",
]
_PREDS = ["hello there", "the cat sat on a mat", "the big red dog ran fast on the mat", "a dog"]
_TARGET = ["hello there", "a cat sat on the mat", "the big red cat ran fast on a mat", "the red house"]
_WIDTHS = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64, max_position_embeddings=64)


@pytest.fixture(scope="module")
def tokenizer(tmp_path_factory):
    from transformers import BertTokenizerFast

    directory = tmp_path_factory.mktemp("tiny_bert_vocab")
    vocab_file = directory / "vocab.txt"
    vocab_file.write_text("\n".join(_VOCAB))
    return BertTokenizerFast(vocab_file=str(vocab_file), do_lower_case=True)


@pytest.fixture(scope="module")
def flax_model():
    from transformers import BertConfig as HFConfig, FlaxBertModel

    return FlaxBertModel(HFConfig(vocab_size=len(_VOCAB), **_WIDTHS), seed=0)


@pytest.fixture(scope="module")
def port_model(flax_model):
    model = BertModel(BertConfig(vocab_size=len(_VOCAB), **_WIDTHS)).eval()
    model.load_state_dict(bert_from_flax(jax.tree_util.tree_map(np.asarray, flax_model.params)))
    return model


def _batch(tokenizer, texts):
    enc = tokenizer(texts, padding=True, return_tensors="np")
    return enc["input_ids"], enc["attention_mask"]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), atol=atol, rtol=0)


def test_hidden_states_match_flax(tokenizer, flax_model, port_model):
    ids, mask = _batch(tokenizer, _PREDS)  # rows with padding
    assert (mask == 0).any()
    want = flax_model(input_ids=ids, attention_mask=mask, output_hidden_states=True).hidden_states
    got = port_model(torch.from_numpy(ids), torch.from_numpy(mask)).hidden_states
    assert len(got) == len(want) == _WIDTHS["num_hidden_layers"] + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g.detach().numpy(), np.asarray(w))


def test_float64_bounds_both_sides(tokenizer, flax_model, port_model):
    """The port's module in float64 against both packages' float32: the
    stated tolerance is well above either side's rounding."""
    ids, mask = _batch(tokenizer, _PREDS)
    exact = port_model.to(torch.float64)
    try:
        ref = exact(torch.from_numpy(ids), torch.from_numpy(mask)).hidden_states
        flax = flax_model(input_ids=ids, attention_mask=mask, output_hidden_states=True).hidden_states
        got64 = bert_score(_PREDS, _TARGET, model=exact, user_tokenizer=tokenizer, device="cpu")
    finally:
        port_model.to(torch.float32)
    got = port_model(torch.from_numpy(ids), torch.from_numpy(mask)).hidden_states
    for r, g, f in zip(ref, got, flax):
        _close(g.detach().numpy(), r.detach().numpy(), atol=2e-6)
        _close(np.asarray(f), r.detach().numpy(), atol=2e-6)
    got32 = bert_score(_PREDS, _TARGET, model=port_model, user_tokenizer=tokenizer, device="cpu")
    want = jax_bert_score(_PREDS, _TARGET, model=flax_model, user_tokenizer=tokenizer)
    for key in ("precision", "recall", "f1"):
        _close(got32[key], got64[key], atol=2e-6)
        _close(want[key], got64[key], atol=2e-6)


def test_transformers_state_dict_loads_as_is(tokenizer):
    from transformers import BertConfig as HFConfig, BertModel as HFBertModel

    torch.manual_seed(0)
    hf = HFBertModel(HFConfig(vocab_size=len(_VOCAB), **_WIDTHS)).eval()
    port = BertModel(BertConfig(vocab_size=len(_VOCAB), **_WIDTHS)).eval()
    port.load_state_dict(hf.state_dict())  # strict: the same names and shapes
    ids, mask = _batch(tokenizer, _TARGET)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask), output_hidden_states=True)
        got = port(torch.from_numpy(ids), torch.from_numpy(mask))
    for g, w in zip(got.hidden_states, want.hidden_states):
        _close(g.numpy(), w.numpy(), atol=1e-6)
    _close(got.pooler_output.numpy(), want.pooler_output.numpy(), atol=1e-6)
    # a transformers torch model runs through the port's bert_score as well
    a = bert_score(_PREDS, _TARGET, model=hf, user_tokenizer=tokenizer, device="cpu")
    b = bert_score(_PREDS, _TARGET, model=port, user_tokenizer=tokenizer, device="cpu")
    for key in ("precision", "recall", "f1"):
        _close(a[key], b[key], atol=1e-6)


def test_bert_from_flax_maps_every_leaf(flax_model, port_model):
    params = jax.tree_util.tree_map(np.asarray, flax_model.params)
    state = bert_from_flax({"params": params})
    assert set(state) == set(port_model.state_dict())
    kernel = params["encoder"]["layer"]["0"]["attention"]["self"]["query"]["kernel"]
    np.testing.assert_array_equal(state["encoder.layer.0.attention.self.query.weight"].numpy(), kernel.T)
    np.testing.assert_array_equal(state["embeddings.LayerNorm.weight"].numpy(), params["embeddings"]["LayerNorm"]["scale"])


@pytest.mark.parametrize("idf", [False, True])
@pytest.mark.parametrize("num_layers", [None, 0, 1, 2])
def test_bert_score_matches_jax(tokenizer, flax_model, port_model, idf, num_layers):
    args = dict(user_tokenizer=tokenizer, idf=idf, num_layers=num_layers, batch_size=3, max_length=32)
    got = bert_score(_PREDS, _TARGET, model=port_model, device="cpu", **args)
    want = jax_bert_score(_PREDS, _TARGET, model=flax_model, **args)
    assert set(got) == set(want)
    for key in ("precision", "recall", "f1"):
        assert len(got[key]) == len(_PREDS)
        _close(got[key], want[key])


def test_bert_score_all_layers(tokenizer, flax_model, port_model):
    got = bert_score(_PREDS, _TARGET, model=port_model, user_tokenizer=tokenizer, all_layers=True, batch_size=2, device="cpu")
    want = jax_bert_score(_PREDS, _TARGET, model=flax_model, user_tokenizer=tokenizer, all_layers=True, batch_size=2)
    for key in ("precision", "recall", "f1"):
        assert np.shape(got[key]) == np.shape(want[key]) == (_WIDTHS["num_hidden_layers"] + 1, len(_PREDS))
        _close(got[key], want[key])


def test_bert_score_dict_inputs_and_user_forward_fn(tokenizer, flax_model, port_model):
    p_ids, p_mask = _batch(tokenizer, _PREDS)
    t_ids, t_mask = _batch(tokenizer, _TARGET)
    preds = {"input_ids": p_ids, "attention_mask": p_mask}
    target = {"input_ids": t_ids, "attention_mask": t_mask}
    got = bert_score(preds, target, model=port_model, idf=True, device="cpu")
    want = jax_bert_score(preds, target, model=flax_model, idf=True)
    for key in ("precision", "recall", "f1"):
        _close(got[key], want[key])
    # tensors in the dicts take the same path
    as_tensors = {k: torch.from_numpy(v) for k, v in preds.items()}, {k: torch.from_numpy(v) for k, v in target.items()}
    again = bert_score(*as_tensors, model=port_model, idf=True, device="cpu")
    assert again == got

    def port_forward(model, batch):
        return model(batch["input_ids"], batch["attention_mask"]).hidden_states[-1]

    def jax_forward(model, batch):
        out = model(input_ids=batch["input_ids"], attention_mask=batch["attention_mask"], output_hidden_states=True)
        return out.hidden_states[-1]

    got = bert_score(_PREDS, _TARGET, model=port_model, user_tokenizer=tokenizer, user_forward_fn=port_forward, device="cpu")
    want = jax_bert_score(_PREDS, _TARGET, model=flax_model, user_tokenizer=tokenizer, user_forward_fn=jax_forward)
    direct = bert_score(_PREDS, _TARGET, model=port_model, user_tokenizer=tokenizer, device="cpu")
    for key in ("precision", "recall", "f1"):
        _close(got[key], want[key])
        assert got[key] == direct[key]
    # a plain (input_ids, attention_mask) callable
    plain = bert_score(_PREDS, _TARGET, model=lambda i, m: port_model(i, m).hidden_states[-1], user_tokenizer=tokenizer, device="cpu")
    assert plain["f1"] == direct["f1"]


def test_bert_score_rescale_with_local_baseline(tokenizer, flax_model, port_model, tmp_path):
    csv_path = tmp_path / "baseline.csv"
    rows = ["LAYER,P,R,F"] + [f"{i},{0.2 + 0.05 * i},{0.25},{0.3 - 0.02 * i}" for i in range(_WIDTHS["num_hidden_layers"] + 1)]
    csv_path.write_text("\n".join(rows))
    for kwargs in ({"num_layers": 2}, {"num_layers": None}, {"all_layers": True}):
        args = dict(user_tokenizer=tokenizer, rescale_with_baseline=True, baseline_path=str(csv_path), **kwargs)
        got = bert_score(_PREDS, _TARGET, model=port_model, device="cpu", **args)
        want = jax_bert_score(_PREDS, _TARGET, model=flax_model, **args)
        for key in ("precision", "recall", "f1"):
            _close(got[key], want[key])
    with pytest.raises(ValueError, match="baseline_path"):
        bert_score(_PREDS, _TARGET, model=port_model, user_tokenizer=tokenizer, rescale_with_baseline=True, device="cpu")


def test_bert_score_class_matches_jax(tokenizer, flax_model, port_model):
    port = metrics_tpu_torch.BERTScore(model=port_model, user_tokenizer=tokenizer, batch_size=2, max_length=16, idf=True, device="cpu")
    ref = metrics_tpu.text.BERTScore(model=flax_model, user_tokenizer=tokenizer, batch_size=2, max_length=16, idf=True)
    for lo, hi in ((0, 1), (1, 4)):
        port.update(_PREDS[lo:hi], _TARGET[lo:hi])
        ref.update(_PREDS[lo:hi], _TARGET[lo:hi])
    for name in ("preds_input_ids", "preds_attention_mask", "target_input_ids", "target_attention_mask"):
        assert len(getattr(port, name)) == 2
        got = torch.cat(getattr(port, name)).numpy()
        want = np.concatenate([np.asarray(c) for c in getattr(ref, name)])
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    got, want = port.compute(), ref.compute()
    whole = bert_score(_PREDS, _TARGET, model=port_model, user_tokenizer=tokenizer, batch_size=2, idf=True, device="cpu")
    for key in ("precision", "recall", "f1"):
        _close(got[key], want[key])
        _close(got[key], whole[key], atol=1e-6)

    carried = carry_from_jax(ref, metrics_tpu_torch.BERTScore(model=port_model, user_tokenizer=tokenizer, batch_size=2, max_length=16, idf=True, device="cpu"))
    assert carried.compute() == got

    port.reset()
    port.update(_PREDS[:2], _TARGET[:2])
    first = bert_score(_PREDS[:2], _TARGET[:2], model=port_model, user_tokenizer=tokenizer, idf=True, device="cpu")
    for key in ("precision", "recall", "f1"):
        _close(port.compute()[key], first[key], atol=1e-6)


def test_bert_score_longer_than_max_length_repads_chunks(tokenizer, port_model):
    """truncation=False at update time: a batch wider than ``max_length``
    re-pads the chunks already stored, on the device."""
    metric = metrics_tpu_torch.BERTScore(model=port_model, user_tokenizer=tokenizer, max_length=4, device="cpu")
    metric.update(_PREDS[:1], _TARGET[:1])
    metric.update(_PREDS[2:3], _TARGET[2:3])
    widths = {int(c.shape[1]) for c in metric.preds_input_ids}
    assert len(widths) == 1 and widths.pop() > 4
    got = metric.compute()
    want = bert_score([_PREDS[0], _PREDS[2]], [_TARGET[0], _TARGET[2]], model=port_model, user_tokenizer=tokenizer, device="cpu")
    for key in ("precision", "recall", "f1"):
        _close(got[key], want[key], atol=1e-6)


def test_special_token_mask_takes_the_first_maximum():
    from metrics_tpu.functional.text.bert import _process_attention_mask_for_special_tokens as jax_mask
    from metrics_tpu_torch.functional.text.bert import _process_attention_mask_for_special_tokens

    rng = np.random.default_rng(0)
    lengths = rng.integers(1, 12, 32)
    mask = (np.arange(12)[None] < lengths[:, None]).astype(np.int32)
    got = _process_attention_mask_for_special_tokens(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_mask(jax.numpy.asarray(mask))))


def test_bert_score_errors(port_model):
    with pytest.raises(ValueError, match="same"):
        bert_score(["a"], ["a", "b"], model=lambda i, m: None, device="cpu")
    with pytest.raises(ValueError, match="model"):
        bert_score(["a"], ["b"], device="cpu")
    with pytest.raises(ValueError, match="user_tokenizer|tokenizer"):
        metrics_tpu_torch.BERTScore(device="cpu")
    with pytest.raises(ValueError, match="all_layers"):
        tok = {"input_ids": np.array([[2, 5, 3]]), "attention_mask": np.ones((1, 3), np.int64)}
        bert_score(tok, tok, model=port_model, user_forward_fn=lambda m, b: None, all_layers=True, device="cpu")
    out = bert_score([], [], model=lambda i, m: None, return_hash=True, device="cpu")
    assert out == jax_bert_score([], [], model=lambda i, m: None, return_hash=True)


def test_build_bert_is_seeded():
    config = BertConfig(vocab_size=40, **_WIDTHS)
    a, b = build_bert(config, seed=3, device="cpu"), build_bert(config, seed=3, device="cpu")
    c = build_bert(config, seed=4, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["encoder.layer.0.attention.self.query.weight"], sc["encoder.layer.0.attention.self.query.weight"])
    assert float(sa["embeddings.LayerNorm.weight"].min()) == 1.0
    assert abs(float(sa["embeddings.word_embeddings.weight"].std()) - 0.02) < 2e-3


def test_bert_score_from_a_local_checkpoint(tokenizer, tmp_path):
    """``model_name_or_path`` loads a LOCAL transformers checkpoint (model and
    tokenizer, through ``AutoModel``/``AutoTokenizer``): the same scores as
    the model and tokenizer passed directly."""
    from transformers import BertConfig as HFConfig, BertModel as HFBertModel

    torch.manual_seed(1)
    hf = HFBertModel(HFConfig(vocab_size=len(_VOCAB), **_WIDTHS)).eval()
    hf.save_pretrained(str(tmp_path))
    tokenizer.save_pretrained(str(tmp_path))
    direct = bert_score(_PREDS, _TARGET, model=hf, user_tokenizer=tokenizer, num_layers=1, device="cpu")
    loaded = bert_score(_PREDS, _TARGET, model_name_or_path=str(tmp_path), num_layers=1, device="cpu")
    metric = metrics_tpu_torch.BERTScore(model_name_or_path=str(tmp_path), num_layers=1, device="cpu")
    metric.update(_PREDS, _TARGET)
    for key in ("precision", "recall", "f1"):
        assert loaded[key] == direct[key]
        _close(metric.compute()[key], direct[key], atol=1e-6)
    with pytest.raises(ValueError, match="num_layers=3 is forbidden"):
        metrics_tpu_torch.BERTScore(model_name_or_path=str(tmp_path), num_layers=3, device="cpu")
