"""The fused update seeded by the port's fusibility manifest, on the CPU.

``compile_update()`` (seeded: a class the manifest proves ``fusible``
skips the probe) against ``compile_update(use_manifest=False)`` (probed)
and the eager update, on the classification, regression, curve, retrieval
and sliced collections: states bit-equal after every batch, probes skipped
on the seeded handle only. Then the manifest's failure modes: a planted
wrong ``fusible`` verdict (``METRICS_TPU_TORCH_MANIFEST``) makes the seeded
build fail, warn, stop trusting the manifest, re-probe and run the refuted
member on the eager leg, bit-equal to eager;
``METRICS_TPU_TORCH_VERIFY_MANIFEST=1`` probes anyway and warns at the
planted verdict; ``METRICS_TPU_TORCH_NO_MANIFEST=1`` turns seeding off; and
``use_manifest`` is part of a handle's config.
"""
import json
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu_torch as tm
from metrics_tpu_torch import MetricCollection
from metrics_tpu_torch.analysis import manifest as mf

torch.set_num_threads(2)


class HostReader(tm.Metric):
    """A metric whose update reads the card: never capturable."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def _update(self, preds, target):
        self.total = self.total + float(preds.sum().item())

    def _compute(self):
        return self.total


# a module path inside the package gives the class a manifest key
HostReader.__module__ = "metrics_tpu_torch.aggregation"
HOST_READER_KEY = "aggregation.py::HostReader"


def _leaders(collection):
    if collection._groups_checked:
        return [cg[0] for cg in collection._groups.values()]
    return list(collection.keys())


def _state_bits(collection):
    out = {}
    for name in _leaders(collection):
        m = collection[name]
        for k in m._defaults:
            v = getattr(m, k)
            v = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
            out[f"{name}.{k}"] = (v.dtype, tuple(v.shape), v.detach().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    return out


def _classification_batches(rng, n=6):
    out = []
    for i in range(n):
        rows = (61, 64, 50)[i % 3]
        p = rng.rand(rows, 5).astype(np.float32)
        p /= p.sum(-1, keepdims=True)
        out.append(((torch.from_numpy(p), torch.from_numpy(rng.randint(0, 5, rows))), {}))
    return out


def _binary_batches(rng, n=6):
    return [((torch.from_numpy(rng.rand(64).astype(np.float32)), torch.from_numpy(rng.randint(0, 2, 64))), {}) for _ in range(n)]


def _regression_batches(rng, n=6):
    return [((torch.from_numpy(rng.rand(48).astype(np.float32) + 0.1), torch.from_numpy(rng.rand(48).astype(np.float32) + 0.1)), {}) for _ in range(n)]


def _retrieval_batches(rng, n=6):
    out = []
    for _ in range(n):
        preds = torch.from_numpy(rng.rand(64).astype(np.float32))
        target = torch.from_numpy(rng.randint(0, 2, 64))
        out.append(((preds, target), {"indexes": torch.from_numpy(rng.randint(0, 8, 64))}))
    return out


def _sliced_batches(rng, n=6):
    out = []
    for _ in range(n):
        ids = torch.from_numpy(rng.randint(0, 4, 32))
        out.append(((ids, torch.from_numpy(rng.rand(32).astype(np.float32)), torch.from_numpy(rng.rand(32).astype(np.float32))), {}))
    return out


COLLECTIONS = {
    "classification": (
        lambda: MetricCollection(
            [
                tm.Accuracy(device="cpu"),
                tm.F1Score(num_classes=5, average="macro", device="cpu"),
                tm.ConfusionMatrix(num_classes=5, device="cpu"),
                tm.CohenKappa(num_classes=5, device="cpu"),
                tm.MatthewsCorrCoef(num_classes=5, device="cpu"),
                tm.JaccardIndex(num_classes=5, device="cpu"),
            ]
        ),
        _classification_batches,
        {"buckets": (64,)},
    ),
    "curves": (
        lambda: MetricCollection([tm.AUROC(device="cpu"), tm.AveragePrecision(device="cpu"), tm.CalibrationError(device="cpu")]),
        _binary_batches,
        {},
    ),
    "regression": (
        lambda: MetricCollection(
            [
                tm.MeanSquaredError(device="cpu"),
                tm.MeanAbsoluteError(device="cpu"),
                tm.PearsonCorrCoef(device="cpu"),
                tm.R2Score(device="cpu"),
                tm.SpearmanCorrCoef(device="cpu"),
                tm.ExplainedVariance(device="cpu"),
            ]
        ),
        _regression_batches,
        {},
    ),
    "retrieval": (
        lambda: MetricCollection([tm.RetrievalNormalizedDCG(device="cpu"), tm.RetrievalMAP(device="cpu")]),
        _retrieval_batches,
        {"buckets": (64,)},
    ),
    "sliced": (
        lambda: MetricCollection([tm.SlicedMetric(tm.MeanSquaredError(device="cpu"), num_slices=4)]),
        _sliced_batches,
        {},
    ),
}


def _three(make, batches, compile_kw):
    cols = {mode: make() for mode in ("eager", "seeded", "probed")}
    for col in cols.values():
        args, kw = batches[0]
        col.update(*args, **kw)
    handles = {
        "seeded": cols["seeded"].compile_update(**compile_kw),
        "probed": cols["probed"].compile_update(use_manifest=False, **compile_kw),
    }
    return cols, handles


class TestSeededAgainstProbed:
    @pytest.mark.parametrize("name", sorted(COLLECTIONS))
    def test_bit_equal_after_every_batch(self, name):
        make, batches_of, compile_kw = COLLECTIONS[name]
        batches = batches_of(np.random.RandomState(11))
        cols, handles = _three(make, batches, compile_kw)
        for i, (args, kw) in enumerate(batches[1:]):
            for col in cols.values():
                col.update(*args, **kw)
            eager = _state_bits(cols["eager"])
            for mode in ("seeded", "probed"):
                assert _state_bits(cols[mode]) == eager, (name, mode, i)
        seeded, probed = handles["seeded"], handles["probed"]
        fusible_leaders = [
            n for n in _leaders(cols["seeded"]) if mf.manifest_verdict(type(cols["seeded"][n])) == "fusible"
        ]
        assert seeded.manifest_probe_skips > 0 if fusible_leaders else seeded.manifest_probe_skips == 0
        assert probed.manifest_probe_skips == 0
        assert seeded.n_probes + seeded.manifest_probe_skips == probed.n_probes
        assert seeded.declined == probed.declined == {}
        assert seeded._fusible.keys() == probed._fusible.keys() and all(seeded._fusible.values())
        values = {mode: cols[mode].compute() for mode in cols}
        for key, value in values["eager"].items():
            for mode in ("seeded", "probed"):
                got = values[mode][key]
                assert torch.equal(torch.as_tensor(got), torch.as_tensor(value)) or (
                    torch.isnan(torch.as_tensor(value)).all() and torch.isnan(torch.as_tensor(got)).all()
                ), (name, mode, key)

    def test_the_classification_leaders_split_by_verdict(self):
        make, batches_of, compile_kw = COLLECTIONS["classification"]
        batches = batches_of(np.random.RandomState(3))
        cols, handles = _three(make, batches, compile_kw)
        args, kw = batches[1]
        cols["seeded"].update(*args, **kw)
        verdicts = {n: mf.manifest_verdict(type(cols["seeded"][n])) for n in _leaders(cols["seeded"])}
        assert "fusible" in verdicts.values() and "unknown" in verdicts.values()
        h = handles["seeded"]
        assert h.manifest_probe_skips == sum(v == "fusible" for v in verdicts.values())
        assert h.n_probes == sum(v != "fusible" for v in verdicts.values())
        assert {key for key in h._manifest_seeded} == {(n, key[1]) for n, v in verdicts.items() if v == "fusible" for key in h._fusible if key[0] == n}


@pytest.fixture
def planted(monkeypatch, tmp_path):
    """The committed manifest plus a wrong `fusible` verdict for HostReader."""
    data = json.loads(mf.default_manifest_path().read_text())
    data["metrics"][HOST_READER_KEY] = {
        "verdict": "fusible",
        "reason": None,
        "detail": None,
        "declared_jit_unsafe": None,
        "states": {},
    }
    path = tmp_path / "planted.json"
    path.write_text(json.dumps(data))
    monkeypatch.setenv(mf.ENV_MANIFEST_PATH, str(path))
    mf.invalidate_runtime_cache()
    yield path
    monkeypatch.delenv(mf.ENV_MANIFEST_PATH)
    mf.invalidate_runtime_cache()


def _host_reader_collections():
    def make():
        return MetricCollection({"host": HostReader(device="cpu"), "mse": tm.MeanSquaredError(device="cpu")})

    return make(), make()


class TestStaleManifest:
    def test_planted_verdict_warns_demotes_and_stays_bit_equal(self, planted):
        assert mf.manifest_verdict(HostReader) == "fusible"
        rng = np.random.RandomState(5)
        batches = [(torch.from_numpy(rng.rand(16).astype(np.float32)), torch.from_numpy(rng.rand(16).astype(np.float32))) for _ in range(4)]
        eager, fused = _host_reader_collections()
        for col in (eager, fused):
            col.update(*batches[0])
        handle = fused.compile_update()
        with pytest.warns(UserWarning, match="fusibility manifest is stale") as caught:
            for batch in batches[1:]:
                eager.update(*batch)
                fused.update(*batch)
        assert sum("stale" in str(w.message) for w in caught) == 1
        assert "host" in handle.declined and "item" in handle.declined["host"]
        assert handle._eager_names == {"host"} and not handle._use_manifest
        assert _state_bits(fused) == _state_bits(eager)
        assert handle.cache_size == 1 and handle.n_compiles == 1  # the failed build left no entry
        # warm reuse keeps matching the request the handle was built with
        assert fused.compile_update() is handle

    def test_verify_mode_probes_and_warns_at_the_planted_verdict(self, planted, monkeypatch):
        monkeypatch.setenv(mf.ENV_VERIFY_MANIFEST, "1")
        rng = np.random.RandomState(6)
        batches = [(torch.from_numpy(rng.rand(16).astype(np.float32)), torch.from_numpy(rng.rand(16).astype(np.float32))) for _ in range(3)]
        eager, fused = _host_reader_collections()
        for col in (eager, fused):
            col.update(*batches[0])
        handle = fused.compile_update()
        with pytest.warns(UserWarning, match="says `HostReader` is fusible but the probe declines it") as caught:
            for batch in batches[1:]:
                eager.update(*batch)
                fused.update(*batch)
        assert not any("stale. Probing" in str(w.message) for w in caught)
        assert handle.manifest_probe_skips == 0 and handle.n_probes == 2 and handle._use_manifest
        assert _state_bits(fused) == _state_bits(eager)

    def test_verify_mode_is_quiet_on_the_committed_manifest(self, monkeypatch):
        monkeypatch.setenv(mf.ENV_VERIFY_MANIFEST, "1")
        make, batches_of, compile_kw = COLLECTIONS["regression"]
        batches = batches_of(np.random.RandomState(7))
        col = make()
        col.update(*batches[0][0])
        handle = col.compile_update(**compile_kw)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            for args, _ in batches[1:]:
                col.update(*args)
        assert handle.manifest_probe_skips == 0 and handle.n_probes > 0 and not handle.declined

    def test_no_manifest_env_turns_seeding_off(self, monkeypatch):
        monkeypatch.setenv(mf.ENV_NO_MANIFEST, "1")
        make, batches_of, compile_kw = COLLECTIONS["regression"]
        batches = batches_of(np.random.RandomState(8))
        col = make()
        col.update(*batches[0][0])
        handle = col.compile_update(**compile_kw)
        col.update(*batches[1][0])
        assert handle.manifest_probe_skips == 0 and handle.n_probes == len(col)


class TestConfig:
    def test_use_manifest_is_part_of_the_config(self):
        col = MetricCollection([tm.MeanSquaredError(device="cpu")])
        col.update(torch.rand(8), torch.rand(8))
        seeded = col.compile_update()
        assert seeded.config_matches() and seeded.config_matches(use_manifest=True)
        assert not seeded.config_matches(use_manifest=False)
        assert col.compile_update() is seeded
        probed = col.compile_update(use_manifest=False)
        assert probed is not seeded and probed.config_matches(use_manifest=False)
        assert col.compile_update(use_manifest=False) is probed

    def test_seeded_member_records_its_keys(self):
        col = MetricCollection([tm.MeanSquaredError(device="cpu")])
        col.update(torch.rand(8), torch.rand(8))
        handle = col.compile_update()
        col.update(torch.rand(8), torch.rand(8))
        col.update(torch.rand(6), torch.rand(6))  # a second signature
        assert handle.manifest_probe_skips == 2 and handle.n_probes == 0
        assert len(handle._manifest_seeded) == 2 and handle.cache_size == 2
