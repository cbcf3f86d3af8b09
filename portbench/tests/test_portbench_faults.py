"""The check that decides ``correct`` fails what it must: the control (the
reference one precision down in the program's place) and a run whose timed
path is broken underneath, at tiny sizes on the CPU. Each run skips only the
look for a card (``run_cell`` on the CPU) and drives the rest."""
import math

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

CELLS = ["imagenet1k.val-fused", "imagenet1k.val-eager", "criteo-kaggle.eval-fused"]


def _run(cell, **kw):
    return harness.run_cell(cell, tiny.SEED, 0.3, False, "cpu", overrides=tiny.BY_CELL[cell], **kw)


def _not_correct(cell, **kw):
    """The run reports ``correct`` false, or raises (run.py then prints no
    result and exits with another code than 0)."""
    try:
        return _run(cell, **kw)["correct"] is False
    except Exception:  # noqa: BLE001 - any failure of the broken program counts
        return True


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"] is True, result["checks"]


@pytest.mark.parametrize("cell", ["imagenet1k.val-fused", "criteo-kaggle.eval-fused"])
@pytest.mark.parametrize("seed", [1, 2, 2**40 + 9])
def test_the_control_fails(cell, seed):
    c = harness.Cell(harness.load_benchmark(), cell, overrides=tiny.BY_CELL[cell])
    failing = 0
    for data in c.code.make_sets(c.config, seed, 2, torch.device("cpu"), 0, 1):
        out = c.code.control(c.config, data)
        numbers = c.code.compare(c.config, out["values"], out["snapshot"], c.code.reference(c.config, data))
        failing += any(not (v <= c.config["limits"][k]) for k, v in numbers.items())
    assert failing == 2


def _unchanged(original):
    def update(self, *args, **kwargs):
        return None

    return update


def _half_batch(original):
    def update(self, *args, **kwargs):
        n = args[0].shape[0] // 2
        return original(self, *(a[:n] for a in args), **kwargs)

    return update


FAULTS = {"state unchanged": _unchanged, "half of each batch": _half_batch}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_update_is_not_correct(cell, fault, monkeypatch):
    from metrics_tpu_torch import MetricCollection

    monkeypatch.setattr(MetricCollection, "update", FAULTS[fault](MetricCollection.update))
    assert _not_correct(cell)


ALTERED = {
    "imagenet1k.val-fused": ("confmat", lambda v: v + torch.eye(v.shape[0], dtype=v.dtype)[0]),
    "imagenet1k.val-eager": ("auroc", lambda v: v + 1e-5),
    "criteo-kaggle.eval-fused": ("ap", lambda v: v + 1e-3),
}


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_produced_is_not_correct(cell, monkeypatch):
    from metrics_tpu_torch import MetricCollection

    compute = MetricCollection.compute
    key, alter = ALTERED[cell]

    def altered(self):
        values = compute(self)
        values[key] = alter(values[key])
        return values

    monkeypatch.setattr(MetricCollection, "compute", altered)
    result = _run(cell)
    assert result["correct"] is False and not math.isnan(result["checks"][next(iter(result["checks"]))]["value"])


def _rank_worker_without_exchange(*args):
    """A spawned rank whose metrics never sync (each keeps its own share)."""
    _no_exchange()
    harness.rank_worker(*args)


def _no_exchange():
    from metrics_tpu_torch.core.metric import Metric

    Metric._syncs_compute = lambda self: False


def test_the_exchange_between_ranks_left_out_is_not_correct(monkeypatch, tmp_path):
    from metrics_tpu_torch.core.metric import Metric

    root = tiny.with_ddp_cell(harness.REPO, tmp_path)
    monkeypatch.setattr(Metric, "_syncs_compute", lambda self: False)
    result = harness.run_cell(
        tiny.DDP_CELL, tiny.SEED, 0.3, False, "cpu", overrides=tiny.IMAGENET, root=root, worker=_rank_worker_without_exchange
    )
    assert result["correct"] is False


@pytest.mark.parametrize("trace", [False, True])
def test_four_ranks_with_the_exchange_are_correct(trace, tmp_path):
    root = tiny.with_ddp_cell(harness.REPO, tmp_path)
    result = harness.run_cell(tiny.DDP_CELL, tiny.SEED, 0.3, trace, "cpu", overrides=tiny.IMAGENET, root=root)
    assert result["correct"] is True and result["device"]["count"] == 4
    if trace:
        assert result["metrics"]["sync_ms"]["value"] > 0
