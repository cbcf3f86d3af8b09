"""The port's input canonicalisation and array helpers against the JAX package's.

``_input_format_classification`` is run over the input-style grid of
tests/classification/test_inputs.py (both packages on the same numpy
inputs, full batch and batch of one): the deduced case and the canonical
int32 tensors must be identical, and every rejected input must raise in
both. The helpers of utils/data.py are compared on ties, NaNs and dtypes.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metrics_tpu.utils import checks as jax_checks
from metrics_tpu.utils import data as jax_data
from metrics_tpu_torch import MeanSquaredError
from metrics_tpu_torch.parallel import distributed
from metrics_tpu_torch.utils import checks, data
from tests.classification.inputs import (
    _input_binary as _bin,
    _input_binary_prob as _bin_prob,
    _input_multiclass as _mc,
    _input_multiclass_prob as _mc_prob,
    _input_multidim_multiclass as _mdmc,
    _input_multidim_multiclass_prob as _mdmc_prob,
    _input_multilabel as _ml,
    _input_multilabel_multidim as _mlmd,
    _input_multilabel_multidim_prob as _mlmd_prob,
    _input_multilabel_prob as _ml_prob,
)
from tests.helpers.testers import NUM_CLASSES, THRESHOLD

torch.set_num_threads(2)

_rng = np.random.default_rng(42)
_mc_prob_2cls_preds = _rng.random((1, 32, 2)).astype(np.float32)
_mc_prob_2cls = (_mc_prob_2cls_preds / _mc_prob_2cls_preds.sum(2, keepdims=True), _rng.integers(0, 2, (1, 32)))

CASES = [
    ("bin", _bin, None, False, None),
    ("bin-1", _bin, 1, False, None),
    ("bin_prob", _bin_prob, None, None, None),
    ("ml_prob", _ml_prob, None, None, None),
    ("ml", _ml, None, False, None),
    ("ml_prob-top2", _ml_prob, None, None, 2),
    ("mlmd", _mlmd, None, False, None),
    ("mc", _mc, NUM_CLASSES, None, None),
    ("mc-no-classes", _mc, None, None, None),
    ("mc_prob", _mc_prob, None, None, None),
    ("mc_prob-top2", _mc_prob, None, None, 2),
    ("mdmc", _mdmc, NUM_CLASSES, None, None),
    ("mdmc_prob", _mdmc_prob, None, None, None),
    ("mdmc_prob-top2", _mdmc_prob, None, None, 2),
    ("bin-as-mc", _bin, None, None, None),
    ("bin_prob-as-mc", _bin_prob, None, True, None),
    ("ml-as-mc", _ml, None, True, None),
    ("ml_prob-as-mc", _ml_prob, None, True, None),
    ("mlmd-as-mc", _mlmd, None, True, None),
    ("mlmd_prob-as-mc", _mlmd_prob, None, True, None),
    ("mc_prob_2cls-as-bin", _mc_prob_2cls, None, False, None),
]


@pytest.mark.parametrize("name,inputs,num_classes,multiclass,top_k", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("batch", ["full", "one"])
def test_input_format_matches_jax(name, inputs, num_classes, multiclass, top_k, batch):
    sl = np.s_[:] if batch == "full" else np.s_[[0], ...]
    preds, target = np.asarray(inputs[0][0])[sl], np.asarray(inputs[1][0])[sl]
    kwargs = dict(threshold=THRESHOLD, num_classes=num_classes, multiclass=multiclass, top_k=top_k)
    want_p, want_t, want_mode = jax_checks._input_format_classification(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got_p, got_t, got_mode = checks._input_format_classification(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    assert got_mode == want_mode
    assert got_p.dtype == got_t.dtype == torch.int32
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


def _ri(*shape, low=0, high=2):
    return _rng.integers(low, high, shape)


def _rf(*shape):
    return _rng.random(shape).astype(np.float32)


BAD = [
    (_ri(7), _ri(7).astype(np.float32), None, None, None),
    (_ri(7), -_ri(7) - 1, None, None, None),
    (-_ri(7) - 1, _ri(7), None, None, None),
    (_rf(7), _ri(7, low=2, high=4), None, False, None),
    (_ri(7, low=2, high=4), _ri(7), None, False, None),
    (_ri(8), _ri(7), None, None, None),
    (_ri(7), _ri(7, 4), None, None, None),
    (_ri(7, 3), _ri(7, 4), None, None, None),
    (_rf(7, 3), _ri(7, 3, low=2, high=4), None, None, None),
    (_rf(7, 3), _ri(7, low=3, high=5), None, None, None),
    (_ri(7, 3), _ri(7), None, None, None),
    (_rf(7), _ri(7), 2, None, None),
    (_rf(7, 3), _ri(7, low=0, high=3), 4, None, None),
    (_rf(7, 3), _ri(7, 3), 4, True, None),
    (_rf(7, 3), _ri(7, low=0, high=3), None, None, 3),
    (_rf(7), _ri(7), None, None, 1),
    (_ri(7, 3), _ri(7, 3), None, None, 1),
]


@pytest.mark.parametrize("preds,target,num_classes,multiclass,top_k", BAD)
def test_rejected_inputs_raise_in_both(preds, target, num_classes, multiclass, top_k):
    kwargs = dict(num_classes=num_classes, multiclass=multiclass, top_k=top_k)
    with pytest.raises(ValueError) as jax_err:
        jax_checks._input_format_classification(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    with pytest.raises(ValueError) as err:
        checks._input_format_classification(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    assert str(err.value) == str(jax_err.value)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_select_topk_ties_and_nans_match_jax(k):
    x = np.array(
        [[0.5, 0.5, 0.1, 0.5], [np.nan, 0.2, np.nan, 0.9], [-0.0, 0.0, -1.0, 0.0], [-np.nan, 1.0, 1.0, -np.inf]],
        np.float32,
    )
    want = np.asarray(jax_data.select_topk(jnp.asarray(x), k))
    got = data.select_topk(torch.from_numpy(x), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    want_dim0 = np.asarray(jax_data.select_topk(jnp.asarray(x), k, dim=0))
    np.testing.assert_array_equal(data.select_topk(torch.from_numpy(x), k, dim=0).numpy(), want_dim0)


def test_to_onehot_matches_jax_out_of_range_included():
    labels = np.array([[0, 2], [3, 5]])  # 5 is past num_classes=4: an all-zero row
    want = np.asarray(jax_data.to_onehot(jnp.asarray(labels), 4))
    got = data.to_onehot(torch.from_numpy(labels), 4)
    assert got.shape == (2, 4, 2) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(data.to_onehot(torch.tensor([0, 3])).numpy(), np.asarray(jax_data.to_onehot(jnp.asarray([0, 3]))))


@pytest.mark.parametrize("descending", [False, True])
def test_stable_sort_with_payloads_matches_jax(descending):
    rng = np.random.default_rng(1)
    key = rng.integers(0, 4, (3, 50)).astype(np.float32)  # many ties: stability shows
    payload = rng.random((3, 50)).astype(np.float32)
    flags = rng.random((3, 50)) < 0.5
    want = jax_data.stable_sort_with_payloads(
        jnp.asarray(key), jnp.asarray(payload), jnp.asarray(flags), descending=descending
    )
    got = data.stable_sort_with_payloads(
        torch.from_numpy(key), torch.from_numpy(payload), torch.from_numpy(flags), descending=descending
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].dtype == torch.bool


def test_stable_sort_descending_needs_a_signed_key():
    with pytest.raises(ValueError, match="signed-integer"):
        data.stable_sort_with_payloads(torch.tensor([1, 2], dtype=torch.uint8), descending=True)


def test_dim_zero_reducers_keep_the_jax_dtypes():
    x = np.array([[1, 2], [3, -4]], np.int32)
    for name in ("dim_zero_sum", "dim_zero_mean", "dim_zero_max", "dim_zero_min"):
        want = np.asarray(getattr(jax_data, name)(jnp.asarray(x)))
        got = getattr(data, name)(torch.from_numpy(x)).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want)
    parts = [np.array([1.0, 2.0], np.float32), np.array(3.0, np.float32)]
    np.testing.assert_array_equal(
        data.dim_zero_cat([torch.from_numpy(p) for p in parts]).numpy(), np.asarray(jax_data.dim_zero_cat(parts))
    )
    with pytest.raises(ValueError, match="No samples"):
        data.dim_zero_cat([])


def test_apply_to_collection_and_squeeze():
    nested = {"a": [torch.tensor([1.0]), torch.tensor([2.0, 3.0])], "b": (torch.tensor(4.0), "x")}
    out = data.apply_to_collection(nested, torch.Tensor, lambda t: t * 2)
    assert out["b"][1] == "x" and torch.equal(out["a"][1], torch.tensor([4.0, 6.0]))
    squeezed = data._squeeze_if_scalar(nested)
    assert squeezed["a"][0].shape == () and squeezed["a"][1].shape == (2,)


def test_one_process_needs_no_sync():
    assert not distributed.distributed_available()
    assert distributed.world_size() == 1
    x = torch.arange(6.0).reshape(2, 3)
    gathered = distributed.gather_all_arrays(x)
    assert len(gathered) == 1 and gathered[0] is x
    # one process: compute neither syncs nor raises
    m = MeanSquaredError(device="cpu")
    m.update(torch.tensor([1.0, 2.0]), torch.tensor([1.0, 4.0]))
    assert float(m.compute()) == 2.0 and not m._is_synced and m._cache is None
