"""The base-API methods the fused update needs, against the JAX package:
``Metric.clone``, ``persistent``, ``to_device`` and ``state_reductions``,
and ``MetricCollection.persistent``, ``to_device`` and
``state_reductions``.
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu
import metrics_tpu_torch as tm
from metrics_tpu_torch.sliced import SlicedMetric
from metrics_tpu_torch.windowed import WindowedMetric

torch.set_num_threads(2)


def _makers(pkg, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return {
            "confmat": lambda: pkg.ConfusionMatrix(num_classes=3, **kw),
            "accuracy": lambda: pkg.Accuracy(**kw),
            "auroc_sketch": lambda: pkg.AUROC(**kw),
            "auroc_exact": lambda: pkg.AUROC(exact=True, **kw),
            "auroc_capacity": lambda: pkg.AUROC(num_classes=3, capacity=16, **kw),
            "kld_none": lambda: pkg.KLDivergence(reduction="none", **kw),
            "hinge": lambda: pkg.HingeLoss(**kw),
            "mse": lambda: pkg.MeanSquaredError(**kw),
            "psnr": lambda: pkg.PeakSignalNoiseRatio(**kw),
            "ndcg": lambda: pkg.RetrievalNormalizedDCG(**kw),
        }


def _spec(reductions):
    """String reducers as they are; a callable as its kind."""
    return {k: v if isinstance(v, str) or v is None else "callable" for k, v in reductions.items()}


@pytest.mark.parametrize("name", list(_makers(tm)))
def test_state_reductions_match_jax(name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = tm_metric = _makers(tm, device="cpu")[name]()
        want = _makers(metrics_tpu)[name]()
    assert _spec(got.state_reductions()) == _spec(want.state_reductions())
    assert tm_metric._persistent == {k: False for k in tm_metric._defaults}


def test_collection_state_reductions_and_persistent():
    col = tm.MetricCollection([tm.ConfusionMatrix(num_classes=3, device="cpu"), tm.MeanSquaredError(device="cpu")])
    want = metrics_tpu.MetricCollection([metrics_tpu.ConfusionMatrix(num_classes=3), metrics_tpu.MeanSquaredError()])
    assert {k: _spec(v) for k, v in col.state_reductions().items()} == {k: _spec(v) for k, v in want.state_reductions().items()}
    col.persistent(True)
    assert all(all(m._persistent.values()) for m in col.values())
    col.persistent(False)
    assert not any(any(m._persistent.values()) for m in col.values())
    assert "ConfusionMatrix.confmat" in col.state_dict()  # every state is saved whatever the flag


def test_persistent_flag_toggles_all_states():
    m = tm.MeanSquaredError(device="cpu")
    assert m._persistent == {"sum_squared_error": False, "total": False}
    m.persistent(True)
    assert all(m._persistent.values())
    assert "total" in m.state_dict()


def test_clone_is_independent():
    m = tm.ConfusionMatrix(num_classes=3, device="cpu")
    m.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
    c = m.clone()
    c.update(torch.tensor([2]), torch.tensor([2]))
    assert int(m.compute().sum()) == 3 and int(c.compute().sum()) == 4
    want = metrics_tpu.ConfusionMatrix(num_classes=3)
    want.update(jnp.asarray([0, 1, 2]), jnp.asarray([0, 1, 1]))
    np.testing.assert_array_equal(m.compute().numpy(), np.asarray(want.clone().compute()))


def test_clone_keeps_host_state_and_sketch_bounds():
    m = tm.AUROC(device="cpu")
    m.update(torch.rand(10, generator=torch.Generator().manual_seed(0)), torch.arange(10) % 2)
    c = m.clone()
    assert c._sketch_case_locked and torch.equal(c.csketch, m.csketch)
    assert float(c.compute()) == float(m.compute())


def test_to_device_moves_states_defaults_lists_and_templates():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        exact = tm.AUROC(exact=True, device="cpu")
    exact.update(torch.rand(6), torch.tensor([0, 1, 0, 1, 1, 0]))
    assert exact.to_device(torch.device("cpu")) is exact
    assert all(t.device.type == "cpu" for t in exact.preds)
    sliced = SlicedMetric(tm.MeanSquaredError(device="cpu"), 4)
    sliced.update(torch.tensor([0, 1, 3]), torch.tensor([1.0, 2.0, 3.0]), torch.zeros(3))
    value = sliced.compute()
    sliced.to_device("cpu")
    assert sliced.device == sliced._template.device == sliced._dirty.device == torch.device("cpu")
    torch.testing.assert_close(sliced.compute(), value, rtol=0, atol=0, equal_nan=True)
    ring = WindowedMetric(tm.MeanSquaredError(device="cpu"), window=3)
    ring.update(torch.ones(2), torch.zeros(2))
    ring.to_device("cpu")
    ring.reset()
    assert all(getattr(ring, k).device.type == "cpu" for k in ring._defaults)


def test_to_device_to_the_card():
    """Where there is a card the states move there; without one the move
    raises, as every entry point of the port does."""
    m = tm.MeanSquaredError(device="cpu")
    m.update(torch.ones(3), torch.zeros(3))
    if torch.cuda.is_available():
        m.to_device("cuda")
        assert m.sum_squared_error.is_cuda and m._defaults["total"].is_cuda and float(m.compute()) == 1.0
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            m.to_device("cuda")
