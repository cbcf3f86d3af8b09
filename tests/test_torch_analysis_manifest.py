"""The port's manifests (``metrics_tpu_torch/analysis/{fusibility,layout}_manifest.json``)
held to the port's probe and compared with the JAX package's.

* Freshness: ``--manifest --check`` and a deterministic rebuild.
* Coverage: every metric class at a path both packages share is classified.
* The port against the JAX manifest: every verdict, every state entry
  (names, symbolic shapes, reducers) and every dtype equal, except the
  differences named below with their reasons.
* Soundness: every class the port's manifest calls ``fusible`` passes the
  port's probe on the CPU (the run under ``_NoHostReads`` and the capture
  rule); each of the JAX manifest's ``fusible`` classes is ``fusible`` here
  or named with its reason.
* The runtime surface: ``Metric.static_fusibility``/``static_sliceability``,
  ``SlicedMetric``'s rejection reason, the layout lookups, the environment
  variables, and the layout rules (TL-SHARD, TL-MERGE, TL-WIRE, TL-LOCK).
"""
import importlib
import json
import pathlib
import warnings

import pytest
import torch

import metrics_tpu_torch as tm
from metrics_tpu_torch import MetricCollection
from metrics_tpu_torch.analysis import analyze_source, get_rules, interp
from metrics_tpu_torch.analysis import layout as lay
from metrics_tpu_torch.analysis import manifest as mf
from metrics_tpu_torch.analysis.cli import main as cli_main
from metrics_tpu_torch.analysis.layout_rules import GUARDED_FIELDS
from metrics_tpu_torch.utils.exceptions import MetricsUserError

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_MANIFEST = json.loads((REPO / "scripts" / "fusibility_manifest.json").read_text())["metrics"]
PORT_ROOT = REPO / "metrics_tpu_torch"


@pytest.fixture(scope="module")
def project():
    return interp.Project()


@pytest.fixture(scope="module")
def built(project):
    return mf.build_manifest(project), lay.build_layout_manifest(project)


@pytest.fixture(scope="module")
def committed():
    return json.loads(mf.default_manifest_path().read_text())["metrics"]


# ---------------------------------------------------------------------------
# freshness, schema, coverage
# ---------------------------------------------------------------------------

class TestFreshness:
    def test_manifest_check_reports_both_fresh(self, capsys):
        assert cli_main(["--manifest", "--check"]) == 0
        out = capsys.readouterr().out
        assert "fusibility manifest" in out and "layout manifest" in out and out.count("is fresh") == 2

    def test_build_is_deterministic_and_equals_the_committed_bytes(self, built):
        fus, layout = built
        assert mf.render_manifest(fus) == mf.default_manifest_path().read_text()
        assert lay.render_layout_manifest(layout) == lay.default_layout_manifest_path().read_text()

    def test_stale_manifest_fails_the_check(self, tmp_path, capsys):
        stale = tmp_path / "f.json"
        stale.write_text("{}\n")
        assert cli_main(["--manifest", "--check", "--manifest-path", str(stale)]) == 1
        assert "STALE" in capsys.readouterr().err

    def test_manifest_mode_writes_both_files(self, tmp_path, capsys):
        fus, layout = tmp_path / "f.json", tmp_path / "l.json"
        assert cli_main(["--manifest", "--manifest-path", str(fus), "--layout-manifest-path", str(layout)]) == 0
        assert fus.read_text() == mf.default_manifest_path().read_text()
        assert layout.read_text() == lay.default_layout_manifest_path().read_text()
        capsys.readouterr()


class TestSchema:
    def test_header_and_entries(self, committed):
        doc = json.loads(mf.default_manifest_path().read_text())
        assert doc["version"] == mf.MANIFEST_VERSION == 1 and doc["tool"] == "tracelint"
        for key, entry in committed.items():
            assert set(entry) == {"verdict", "reason", "detail", "declared_jit_unsafe", "states"}, key
            assert entry["verdict"] in ("fusible", "unsafe", "unknown")
            assert (entry["reason"] is not None) == (entry["verdict"] == "unsafe")
            for leaf in entry["states"].values():
                assert set(leaf) == {"container", "shape", "dtype", "dist_reduce_fx", "sliceable"}

    def test_every_class_at_a_shared_path_is_classified(self, committed):
        shared = [k for k in JAX_MANIFEST if (PORT_ROOT / k.split("::")[0]).is_file()]
        assert len(shared) == 88
        assert not [k for k in shared if k not in committed]

    def test_every_runtime_metric_class_has_an_entry(self, committed):
        missing = []
        for key in committed:
            module, name = key.split("::")
            cls = getattr(importlib.import_module("metrics_tpu_torch." + module[:-3].replace("/", ".")), name)
            assert mf.class_key(cls) == key
        for name in dir(tm):
            cls = getattr(tm, name)
            if isinstance(cls, type) and issubclass(cls, tm.Metric) and cls is not tm.Metric and mf.class_key(cls) not in committed:
                missing.append(name)
        assert not missing


# ---------------------------------------------------------------------------
# the port against the JAX manifest
# ---------------------------------------------------------------------------

#: verdicts that differ, (port, JAX, why)
VERDICT_DIFFERENCES = {
    "regression/tweedie_deviance.py::TweedieDevianceScore": (
        "fusible",
        "unknown",
        "the port's domain check returns early under the capture rule; the JAX package's raises under tracing",
    ),
    "image/kid.py::KernelInceptionDistance": (
        "fusible",
        "unknown",
        "the port's interpreter reads `self.add_state` (the reservoirs a callable extractor registers at its"
        " first update, which runs eagerly by an instance-level declaration) as host bookkeeping; the JAX"
        " interpreter leaves the call unresolved",
    ),
    "detection/mean_ap.py::MeanAveragePrecision": (
        "unknown",
        "fusible",
        "the port packs the list-of-dicts input on the host (`_pack_images`: numpy offsets, a host-to-device"
        " index copy), which a capture cannot hold; only its padded dict batch captures, so the probe decides",
    ),
    "image/lpip.py::LearnedPerceptualImagePatchSimilarity": (
        "unknown",
        "unsafe",
        "the port's range check reads the card once eagerly and nothing under the capture rule; the scorer"
        " `self.net` is a callable the analysis cannot see",
    ),
    "text/squad.py::SQuAD": (
        "unsafe",
        "unknown",
        "the port sums the host scores with numpy (`_float32_sums`): a host update, read as such",
    ),
}

#: classes of the port with no JAX counterpart
PORT_ONLY = {"classification/_sketch.py::CurveModesMixin": "the update shared by ROC, PrecisionRecallCurve and AveragePrecision"}

#: the JAX manifest's fusible classes the port's does not call fusible
NOT_FUSIBLE_IN_PORT = {"detection/mean_ap.py::MeanAveragePrecision": VERDICT_DIFFERENCES["detection/mean_ap.py::MeanAveragePrecision"][2]}

_LOOP = "registered in a loop over constant names (or through a module constant), which the port's analyzer unrolls and the JAX one does not see"
#: state entries that differ: class -> leaf -> why
STATE_DIFFERENCES = {
    **{
        k: {leaf: _LOOP for leaf in ("tp", "fp", "tn", "fn")}
        for k in (
            "classification/accuracy.py::Accuracy",
            "classification/f_beta.py::F1Score",
            "classification/f_beta.py::FBetaScore",
            "classification/precision_recall.py::Precision",
            "classification/precision_recall.py::Recall",
            "classification/precision_recall.py::_PrecisionRecallBase",
            "classification/specificity.py::Specificity",
            "classification/stat_scores.py::StatScores",
        )
    },
    "regression/pearson.py::PearsonCorrCoef": {leaf: _LOOP for leaf in ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")},
    "sliced/metric.py::SlicedMetric": {"_slice_rows": _LOOP},
    "image/psnr.py::PeakSignalNoiseRatio": {
        "data_range": "the port registers the host scalar `float(data_range)` (a 0-d float32 state); the JAX"
        " analyzer reads `jnp.asarray(float(...))` as a state of unknown rank and dtype"
    },
}

_POSITIONAL = "the JAX analyzer reads a positional dtype (`jnp.zeros((), jnp.int32)`) as the constructor's float32 default; the state is int32 in both packages"
#: dtypes that differ (ROADMAP.md C records them): class -> leaf -> why
DTYPE_DIFFERENCES = {
    "detection/mean_ap.py::MeanAveragePrecision": {"images_seen": _POSITIONAL},
    "windowed/metric.py::WindowedMetric": {"_ring_rows": _POSITIONAL},
    "image/psnr.py::PeakSignalNoiseRatio": {"data_range": STATE_DIFFERENCES["image/psnr.py::PeakSignalNoiseRatio"]["data_range"]},
}


class TestAgainstTheJaxManifest:
    def test_verdict_differences_are_exactly_the_named_ones(self, committed):
        differ = {
            k: (committed[k]["verdict"], JAX_MANIFEST[k]["verdict"])
            for k in JAX_MANIFEST
            if k in committed and (committed[k]["verdict"], committed[k]["reason"]) != (JAX_MANIFEST[k]["verdict"], JAX_MANIFEST[k]["reason"])
        }
        # SQuAD's and LPIPS's reasons move with their verdicts
        assert set(differ) == set(VERDICT_DIFFERENCES)
        for key, (port, jax_verdict, why) in VERDICT_DIFFERENCES.items():
            assert differ[key] == (port, jax_verdict) and why

    def test_port_only_classes_are_named(self, committed):
        assert {k for k in committed if k not in JAX_MANIFEST} == set(PORT_ONLY)

    @pytest.mark.parametrize("key", sorted(k for k, v in JAX_MANIFEST.items() if v["verdict"] == "fusible"))
    def test_jax_fusible_class_is_fusible_or_named(self, committed, key):
        assert len([k for k, v in JAX_MANIFEST.items() if v["verdict"] == "fusible"]) == 35
        if key in NOT_FUSIBLE_IN_PORT:
            assert committed[key]["verdict"] != "fusible" and NOT_FUSIBLE_IN_PORT[key]
        else:
            assert committed[key]["verdict"] == "fusible", committed[key]["detail"]

    @pytest.mark.parametrize("key", sorted(k for k in JAX_MANIFEST if (PORT_ROOT / k.split("::")[0]).is_file()))
    def test_state_entries_equal_but_the_named(self, committed, key):
        ours, theirs = committed[key]["states"], JAX_MANIFEST[key]["states"]
        named = STATE_DIFFERENCES.get(key, {})
        for leaf in sorted(set(ours) | set(theirs)):
            abstract = lambda e: (e["container"], e["shape"], e["dist_reduce_fx"], e["sliceable"]) if e else None  # noqa: E731
            if leaf in named:
                assert abstract(ours.get(leaf)) != abstract(theirs.get(leaf)), (key, leaf, "no longer differs")
                continue
            assert abstract(ours.get(leaf)) == abstract(theirs.get(leaf)), (key, leaf)
            why = DTYPE_DIFFERENCES.get(key, {}).get(leaf)
            if why:
                assert ours[leaf]["dtype"] != theirs[leaf]["dtype"], (key, leaf, "dtype no longer differs")
            else:
                assert ours[leaf]["dtype"] == theirs[leaf]["dtype"], (key, leaf)


# ---------------------------------------------------------------------------
# soundness: every fusible verdict passes the port's probe on the CPU
# ---------------------------------------------------------------------------

_G = torch.Generator().manual_seed(0)
_N = 32


def _rand(*shape):
    return torch.rand(*shape, generator=_G)


def _ints(hi, *shape):
    return torch.randint(0, hi, shape, generator=_G)


def _features(x):
    return x.reshape(x.shape[0], -1)[:, :8].float()


def _logits(x):
    return x.reshape(x.shape[0], -1)[:, :10].float()


_REGRESSION = lambda: ((_rand(_N) + 0.1, _rand(_N) + 0.1), {})  # noqa: E731
_BINARY = lambda: ((_rand(_N), _ints(2, _N)), {})  # noqa: E731
_MULTICLASS = lambda: ((torch.softmax(_rand(_N, 3), -1), _ints(3, _N)), {})  # noqa: E731
_RETRIEVAL = lambda: ((_rand(_N), _ints(2, _N)), {"indexes": _ints(4, _N)})  # noqa: E731
_SIGNAL = lambda: ((_rand(4, 64), _rand(4, 64)), {})  # noqa: E731
_IMAGES = lambda: ((_rand(4, 3, 4, 4), True), {})  # noqa: E731

#: class key -> (constructor kwargs, batch, eager updates before compiling)
PROBE_INPUTS = {
    "audio/sdr.py::ScaleInvariantSignalDistortionRatio": ({}, _SIGNAL, 0),
    "audio/snr.py::ScaleInvariantSignalNoiseRatio": ({}, _SIGNAL, 0),
    "audio/snr.py::SignalNoiseRatio": ({}, _SIGNAL, 0),
    "classification/auroc.py::AUROC": ({}, _BINARY, 0),
    "classification/avg_precision.py::AveragePrecision": ({}, _BINARY, 0),
    "classification/calibration_error.py::CalibrationError": ({}, _BINARY, 0),
    "classification/cohen_kappa.py::CohenKappa": ({"num_classes": 3}, _MULTICLASS, 0),
    "classification/confusion_matrix.py::ConfusionMatrix": ({"num_classes": 3}, _MULTICLASS, 0),
    "classification/hinge.py::HingeLoss": ({}, lambda: ((_rand(_N) - 0.5, _ints(2, _N)), {}), 0),
    "classification/jaccard.py::JaccardIndex": ({"num_classes": 3}, _MULTICLASS, 0),
    "classification/matthews_corrcoef.py::MatthewsCorrCoef": ({"num_classes": 3}, _MULTICLASS, 0),
    "classification/precision_recall_curve.py::PrecisionRecallCurve": ({}, _BINARY, 0),
    "classification/roc.py::ROC": ({}, _BINARY, 0),
    "image/fid.py::FrechetInceptionDistance": ({"feature": _features, "feature_dim": 8}, _IMAGES, 0),
    "image/inception.py::InceptionScore": ({"feature": _logits, "num_classes": 10}, lambda: ((_rand(4, 3, 4, 4),), {}), 0),
    # a callable extractor's width is learnt by its first (eager) update
    "image/kid.py::KernelInceptionDistance": ({"feature": _features, "subset_size": 2}, _IMAGES, 1),
    "regression/cosine_similarity.py::CosineSimilarity": ({}, lambda: ((_rand(_N, 4), _rand(_N, 4)), {}), 0),
    "regression/explained_variance.py::ExplainedVariance": ({}, _REGRESSION, 0),
    "regression/log_mse.py::MeanSquaredLogError": ({}, _REGRESSION, 0),
    "regression/mae.py::MeanAbsoluteError": ({}, _REGRESSION, 0),
    "regression/mape.py::MeanAbsolutePercentageError": ({}, _REGRESSION, 0),
    "regression/mse.py::MeanSquaredError": ({}, _REGRESSION, 0),
    "regression/pearson.py::PearsonCorrCoef": ({}, _REGRESSION, 0),
    "regression/r2.py::R2Score": ({}, _REGRESSION, 0),
    "regression/spearman.py::SpearmanCorrCoef": ({}, _REGRESSION, 0),
    "regression/symmetric_mape.py::SymmetricMeanAbsolutePercentageError": ({}, _REGRESSION, 0),
    "regression/tweedie_deviance.py::TweedieDevianceScore": ({}, _REGRESSION, 0),
    "retrieval/average_precision.py::RetrievalMAP": ({}, _RETRIEVAL, 0),
    "retrieval/fall_out.py::RetrievalFallOut": ({}, _RETRIEVAL, 0),
    "retrieval/hit_rate.py::RetrievalHitRate": ({}, _RETRIEVAL, 0),
    "retrieval/ndcg.py::RetrievalNormalizedDCG": ({}, _RETRIEVAL, 0),
    "retrieval/precision.py::RetrievalPrecision": ({}, _RETRIEVAL, 0),
    "retrieval/r_precision.py::RetrievalRPrecision": ({}, _RETRIEVAL, 0),
    "retrieval/recall.py::RetrievalRecall": ({}, _RETRIEVAL, 0),
    "retrieval/reciprocal_rank.py::RetrievalMRR": ({}, _RETRIEVAL, 0),
}

#: fusible classes with no probe of their own, and why
NOT_PROBED = {"retrieval/base.py::RetrievalMetric": "abstract (ABC): probed through its nine subclasses above"}


def _class_of(key):
    module, name = key.split("::")
    return getattr(importlib.import_module("metrics_tpu_torch." + module[:-3].replace("/", ".")), name)


class TestSoundness:
    def test_every_fusible_verdict_has_a_probe_input(self, committed):
        fusible = {k for k, v in committed.items() if v["verdict"] == "fusible"}
        assert fusible == set(PROBE_INPUTS) | set(NOT_PROBED)

    @pytest.mark.parametrize("key", sorted(PROBE_INPUTS))
    def test_fusible_verdict_passes_the_probe(self, key):
        kwargs, batch, warm = PROBE_INPUTS[key]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            metric = _class_of(key)(device="cpu", **kwargs)
            args, kw = batch()
            for _ in range(warm):
                metric.update(*args, **kw)
            collection = MetricCollection({"m": metric})
            handle = collection.compile_update(use_manifest=False)
            collection.update(*args, **kw)
        assert handle.n_probes == 1 and handle.manifest_probe_skips == 0
        assert not handle.declined and handle._fusible and all(handle._fusible.values()), handle.declined

    @pytest.mark.parametrize("key", sorted(PROBE_INPUTS))
    def test_seeded_handle_skips_the_probe(self, key):
        kwargs, batch, warm = PROBE_INPUTS[key]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            metric = _class_of(key)(device="cpu", **kwargs)
            args, kw = batch()
            for _ in range(warm):
                metric.update(*args, **kw)
            collection = MetricCollection({"m": metric})
            handle = collection.compile_update()
            collection.update(*args, **kw)
        assert handle.manifest_probe_skips == 1 and handle.n_probes == 0 and handle._use_manifest


# ---------------------------------------------------------------------------
# the runtime surface
# ---------------------------------------------------------------------------

class TestRuntimeSurface:
    def test_static_fusibility_answers_from_the_port_manifest(self, committed):
        assert tm.ConfusionMatrix.static_fusibility() == committed["classification/confusion_matrix.py::ConfusionMatrix"]
        assert tm.ConfusionMatrix.static_fusibility()["verdict"] == "fusible"
        assert tm.PermutationInvariantTraining.static_fusibility()["verdict"] == "unsafe"

        class Mine(tm.MeanSquaredError):
            pass

        assert Mine.static_fusibility() is None
        assert Mine(device="cpu").static_sliceability() is None

    def test_static_sliceability(self):
        assert tm.MeanSquaredError(device="cpu").static_sliceability() == {"sum_squared_error": True, "total": True}
        psnr = tm.PeakSignalNoiseRatio(data_range=1.0, device="cpu").static_sliceability()
        assert psnr["data_range"] is False and psnr["sum_squared_error"] is False

    def test_sliced_rejection_carries_the_manifest_reason(self):
        with pytest.raises(MetricsUserError, match="fusibility manifest's per-leaf `sliceable` verdict agrees"):
            tm.SlicedMetric(tm.PeakSignalNoiseRatio(data_range=1.0, device="cpu"), num_slices=4)

    def test_class_key_and_lookup(self):
        assert mf.class_key(tm.AUROC) == "classification/auroc.py::AUROC"
        assert mf.class_key(int) is None
        assert mf.lookup_class(tm.AUROC)["verdict"] == "fusible"
        assert mf.manifest_verdict(tm.PeakSignalNoiseRatio) == "unknown"
        assert mf.manifest_verdict(tm.BLEUScore) == "unsafe"

    def test_no_manifest_env_and_alternate_path(self, monkeypatch, tmp_path):
        monkeypatch.setenv(mf.ENV_NO_MANIFEST, "1")
        assert mf.runtime_manifest() == {} and mf.manifest_verdict(tm.AUROC) == "unknown"
        assert lay.runtime_layout() == {} and lay.leaf_may_shard("confmat") is None
        monkeypatch.delenv(mf.ENV_NO_MANIFEST)
        path = tmp_path / "m.json"
        path.write_text(json.dumps({"version": 1, "tool": "tracelint", "metrics": {"classification/auroc.py::AUROC": {"verdict": "unknown"}}}))
        monkeypatch.setenv(mf.ENV_MANIFEST_PATH, str(path))
        mf.invalidate_runtime_cache()
        try:
            assert mf.manifest_verdict(tm.AUROC) == "unknown" and mf.manifest_verdict(tm.ConfusionMatrix) == "unknown"
        finally:
            monkeypatch.delenv(mf.ENV_MANIFEST_PATH)
            mf.invalidate_runtime_cache()
        assert mf.manifest_verdict(tm.AUROC) == "fusible"

    def test_the_environment_variables_are_the_ports_own(self):
        names = (mf.ENV_MANIFEST_PATH, mf.ENV_NO_MANIFEST, mf.ENV_VERIFY_MANIFEST, lay.ENV_LAYOUT_MANIFEST_PATH)
        assert names == (
            "METRICS_TPU_TORCH_MANIFEST",
            "METRICS_TPU_TORCH_NO_MANIFEST",
            "METRICS_TPU_TORCH_VERIFY_MANIFEST",
            "METRICS_TPU_TORCH_LAYOUT_MANIFEST",
        )
        assert mf.default_manifest_path().parent == lay.default_layout_manifest_path().parent == PORT_ROOT / "analysis"


# ---------------------------------------------------------------------------
# the layout manifest
# ---------------------------------------------------------------------------

class TestLayoutManifest:
    def test_header_and_leaf_records(self):
        doc = json.loads(lay.default_layout_manifest_path().read_text())
        assert doc["version"] == lay.LAYOUT_VERSION == 1 and doc["tool"] == "tracelint"
        for key, ent in doc["classes"].items():
            for rec in ent["leaves"].values():
                assert rec["shard_axis"] in ("[S]", "[R]", "replicated")
                assert rec["reshard"] in ("reshape", "fold", "gather", "opaque")
                assert rec["wire"] in ("array", "list", "opaque")
                assert (rec["partition_spec"] == ["slices"]) == (rec["shard_axis"] == "[S]")

    def test_known_entries(self):
        cm = lay.layout_for_class(tm.ConfusionMatrix)
        assert cm["sliceable"] and cm["leaves"]["confmat"]["shard_axis"] == "[S]" and cm["leaves"]["confmat"]["reshard"] == "reshape"
        auroc = lay.layout_for_class(tm.AUROC)
        assert not auroc["sliceable"] and auroc["leaves"]["csketch"]["reducer"] == "merge" and auroc["leaves"]["csketch"]["reshard"] == "fold"
        windowed = lay.layout_for_class(tm.WindowedMetric)
        assert windowed["leaves"]["_ring_rows"]["shard_axis"] == "[R]"

    def test_synthetic_sliced_metric_entry(self):
        ent = lay.layout_for_class(tm.SlicedMetric)
        assert ent["dynamic_leaves"] == "template-broadcast" and ent["leaves"]["_slice_rows"]["shard_axis"] == "[S]"

    def test_prefix_constants_agree_with_the_runtime(self):
        from metrics_tpu_torch.observability import recorder
        from metrics_tpu_torch.sliced import metric as sliced

        assert lay.SLICED_PREFIX == recorder.SLICED_FOOTPRINT_PREFIX == sliced.SLICED_FOOTPRINT_PREFIX
        assert lay.SKETCH_PREFIX == recorder.SKETCH_FOOTPRINT_PREFIX
        assert lay.WINDOWED_PREFIX == recorder.WINDOWED_FOOTPRINT_PREFIX
        assert lay.SLICE_ROWS == sliced.SLICE_ROWS

    def test_path_universe_and_shard_verdicts(self):
        universe = lay.shard_path_universe(json.loads(lay.default_layout_manifest_path().read_text()))
        assert universe["sliced/confmat"] == {"[S]"} and universe["confmat"] == set()
        assert lay.leaf_may_shard("_slice_rows") is True
        assert lay.leaf_may_shard("sliced/sum_squared_error") is True
        assert lay.leaf_may_shard("csketch") is False
        assert lay.leaf_may_shard("never_seen_leaf") is None


_SHARD_UNIVERSE_SRC = '''
from torch.distributed.tensor import Replicate, Shard
RULES = (("sliced/.*", Shard(0)), (".*", Replicate()))
BAD = ((".*", Shard(0)),)
'''

_MERGE_SRC = '''
class _Fold:
    merge_like = True
    def __call__(self, stacked):
        return stacked[0] - stacked[1]
class _Ring:
    merge_like = True
    windowed_kind = "ring"
    def __call__(self, stacked):
        return torch.sum(stacked)
class _RingOk:
    merge_like = True
    windowed_kind = "ring"
    def __call__(self, stacked):
        return torch.sum(stacked, dim=0)
class _Host:
    merge_like = True
    def __call__(self, stacked):
        return stacked * time.time()
'''


class TestLayoutRules:
    def test_shard_rule_set_coverage(self):
        kept, _ = analyze_source(_SHARD_UNIVERSE_SRC, "sliced/rules.py", rules=get_rules(["TL-SHARD"]))
        assert [v.line for v in kept] == [4]

    def test_shard_spec_dict_claiming_a_replicated_leaf(self):
        src = "from torch.distributed.tensor import Shard, Replicate\nSPECS = {'confmat': Shard(0), 'sliced/confmat': Shard(0), 'csketch': Replicate()}\n"
        kept, _ = analyze_source(src, "sliced/specs.py", rules=get_rules(["TL-SHARD"]))
        assert len(kept) == 1 and "confmat" in kept[0].message

    def test_merge_rule(self):
        kept, _ = analyze_source(_MERGE_SRC, "sketches/x.py", rules=get_rules(["TL-MERGE"]))
        assert sorted(v.message.split("`")[1].split(".")[0] for v in kept) == ["_Fold", "_Host", "_Ring"]

    def test_wire_rule(self):
        src = (
            "class M(Metric):\n    def __init__(self):\n        super().__init__()\n"
            "        self.add_state('a', default=make_it(), dist_reduce_fx='sum')\n"
            "        self.add_state('b', default=torch.zeros(3), dist_reduce_fx=lambda x: x)\n"
            "        self.add_state('c', default=torch.zeros(3), dist_reduce_fx='sum')\n"
            "    def _update(self, x):\n        self.c = self.c + x\n"
        )
        kept, _ = analyze_source(src, "classification/x.py", rules=get_rules(["TL-WIRE"]))
        assert sorted(v.message.split("`")[1] for v in kept) == ["a", "b"]

    def test_lock_registry_names_the_ports_fields(self):
        for relpath, classes in GUARDED_FIELDS.items():
            text = (PORT_ROOT / relpath).read_text()
            for cls, locks in classes.items():
                assert f"class {cls}" in text
                for lock, fields in locks.items():
                    for name in {lock} | fields:
                        assert f"self.{name}" in text, (relpath, name)

    def test_lock_rule_flags_an_unlocked_access(self):
        src = (
            "class AsyncUpdateHandle:\n    def __init__(self):\n        self._pending = 0\n"
            "    def good(self):\n        with self._cond:\n            return self._pending\n"
            "    def bad(self):\n        return self._pending\n"
            "    def _peek_locked(self):\n        return self._pending\n"
        )
        kept, _ = analyze_source(src, "core/pipeline.py", rules=get_rules(["TL-LOCK"]))
        assert [v.line for v in kept] == [8]
