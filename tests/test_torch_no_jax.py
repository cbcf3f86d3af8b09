"""metrics_tpu_torch and chip_smoke.py stand without JAX and without the JAX package.

A subprocess in which ``jax`` and ``metrics_tpu`` cannot be imported
imports the port and every one of its modules, and chip_smoke.py.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "metrics_tpu"):
    sys.modules[name] = None  # any import of them now raises ImportError
import metrics_tpu_torch
import metrics_tpu_torch.retrieval
names = [m.name for m in pkgutil.walk_packages(metrics_tpu_torch.__path__, "metrics_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("core.fused", "core.pipeline", "observability.freshness", "classification.hinge",
             "classification.kl_divergence", "functional.classification.dice", "utils.prng",
             "sketches.rank", "regression.spearman", "regression.pearson", "regression.cosine_similarity",
             "functional.regression.tweedie_deviance", "functional.regression.r2", "aggregation",
             "wrappers", "wrappers.bootstrapping", "wrappers.classwise", "wrappers.minmax", "wrappers.multioutput",
             "wrappers.tracker", "functional.pairwise", "functional.pairwise.helpers", "functional.pairwise.cosine",
             "functional.pairwise.euclidean", "functional.pairwise.linear", "functional.pairwise.manhattan",
             "parallel", "parallel.distributed", "functional.image.helper", "functional.image.gradients",
             "functional.image.ssim", "functional.image.uqi", "image.ssim", "image.uqi", "image.fid", "image.kid",
             "image.inception", "image.lpip", "models", "models.inception", "models.lpips", "ops.sqrtm",
             "utils.imports", "models.bert", "text", "functional.text", "functional.text.helper",
             "text.bleu", "text.sacre_bleu", "text.chrf", "text.ter", "text.eed", "text.rouge", "text.squad",
             "text.bert", "text.wer", "text.cer", "text.mer", "text.wil", "text.wip",
             "functional.text.bleu", "functional.text.sacre_bleu", "functional.text.chrf", "functional.text.ter",
             "functional.text.eed", "functional.text.rouge", "functional.text.squad", "functional.text.bert",
             "functional.text.wer", "functional.text.cer", "functional.text.mer", "functional.text.wil",
             "functional.text.wip", "audio", "audio.snr", "audio.sdr", "audio.pit", "audio.stoi",
             "audio.pesq", "functional.audio", "functional.audio.snr", "functional.audio.sdr",
             "functional.audio.pit", "functional.audio.stoi", "functional.audio.pesq",
             "functional.audio._pesq_engine", "native", "observability", "observability.recorder",
             "observability.trace", "observability.exporters", "observability.aggregate",
             "observability.memory", "observability.profiling", "observability.timeseries",
             "observability.drift", "observability.health", "observability.wire",
             "observability.collector", "core.readers", "analysis", "analysis.engine", "analysis.baseline",
             "analysis.reporters", "analysis.rules", "analysis.interp", "analysis.stateflow", "analysis.manifest",
             "analysis.layout", "analysis.layout_rules", "analysis.cli", "analysis.__main__", "sliced.sharding"):
    assert "metrics_tpu_torch." + name in names, name
from metrics_tpu_torch import BootStrapper, CompositionalMetric, MeanMetric, MetricTracker  # noqa: F401
from metrics_tpu_torch.parallel import class_reduce, gather_all_arrays, sync_pytree  # noqa: F401
from metrics_tpu_torch import FrechetInceptionDistance, KernelInceptionDistance, InceptionScore  # noqa: F401
from metrics_tpu_torch import LearnedPerceptualImagePatchSimilarity, UniversalImageQualityIndex  # noqa: F401
from metrics_tpu_torch.convert import bert_from_flax, inception_from_flax, lpips_from_flax  # noqa: F401
from metrics_tpu_torch import BERTScore, BLEUScore, ROUGEScore, SQuAD, TranslationEditRate  # noqa: F401
from metrics_tpu_torch.audio import PerceptualEvaluationSpeechQuality, ShortTimeObjectiveIntelligibility  # noqa: F401
from metrics_tpu_torch import PermutationInvariantTraining, SignalDistortionRatio  # noqa: F401
from metrics_tpu_torch.native import lsap  # noqa: F401
from metrics_tpu_torch.sliced import shard_sliced_states, sliced_partition_specs  # noqa: F401
from metrics_tpu_torch.parallel.distributed import RankSharding, layout_verify_counters  # noqa: F401
from metrics_tpu_torch.observability import HealthMonitor, MetricRecorder, TimeSeriesRegistry, get_recorder  # noqa: F401
from metrics_tpu_torch.observability import FleetCollector, SnapshotSink, decode_snapshot, encode_snapshot  # noqa: F401
from metrics_tpu_torch.core.readers import ReaderCache, pad_ids  # noqa: F401
from metrics_tpu_torch.retrieval.base import layout_cache_totals  # noqa: F401
import chip_smoke
assert not any(k == "jax" or k.startswith(("jax.", "metrics_tpu.")) for k, v in sys.modules.items() if v is not None)
print(len(names))
"""


def test_port_imports_with_jax_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # every module of the port was imported (sliced, windowed, audio, the
    # nine telemetry modules of observability/ and the fleet plane's two)
    assert int(out.stdout.strip()) >= 221


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_import_in_the_source():
    files = sorted((REPO / "metrics_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for module in _imported_modules(path):
            root = module.split(".")[0]
            assert root not in ("jax", "jaxlib", "metrics_tpu", "flax"), f"{path.name} imports {module}"


_BLOCKED_OPTIONAL = """
import sys
for name in ("jax", "jaxlib", "metrics_tpu", "nltk", "regex", "transformers"):
    sys.modules[name] = None  # any import of them now raises ImportError
import metrics_tpu_torch.text, metrics_tpu_torch.functional.text
from metrics_tpu_torch import BERTScore, ROUGEScore, SacreBLEUScore
from metrics_tpu_torch.functional.text import bert_score, rouge_score, sacre_bleu_score
from metrics_tpu_torch.utils.imports import _NLTK_AVAILABLE, _REGEX_AVAILABLE, _TRANSFORMERS_AVAILABLE
assert not (_NLTK_AVAILABLE or _REGEX_AVAILABLE or _TRANSFORMERS_AVAILABLE)
raised = []
for call in (
    lambda: ROUGEScore(device="cpu"),  # rougeLsum by default
    lambda: ROUGEScore(rouge_keys=("rouge1",), use_stemmer=True, device="cpu"),
    lambda: rouge_score("a b", "a b", use_stemmer=True, device="cpu"),
    lambda: rouge_score("a. b", "a b", rouge_keys=("rougeLsum",), device="cpu"),
    lambda: SacreBLEUScore(tokenize="intl", device="cpu"),
    lambda: sacre_bleu_score(["a"], [["a"]], tokenize="intl", device="cpu"),
    lambda: BERTScore(model_name_or_path="local-dir", device="cpu"),
    lambda: bert_score(["a"], ["a"], model_name_or_path="local-dir", device="cpu"),
):
    try:
        call()
    except ModuleNotFoundError as err:
        raised.append(str(err).split(".")[0])
print(len(raised))
print("|".join(raised))
# what needs none of them still runs
print(float(ROUGEScore(rouge_keys=("rouge1",), device="cpu")("a b c", "a b d")["rouge1_fmeasure"]))
print(float(SacreBLEUScore(tokenize="13a", device="cpu")(["a b c d"], [["a b c d"]])))
"""


def test_text_imports_without_optional_packages():
    """With ``nltk``, ``regex`` and ``transformers`` hidden (and JAX), the
    text family imports; what needs one of them raises the JAX package's
    ``ModuleNotFoundError`` where it is built or called."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _BLOCKED_OPTIONAL], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "8", out.stdout
    assert "ROUGE-Lsum calculation requires that `nltk` is installed" in lines[1]
    assert "`'intl'` tokenization requires that `regex` is installed" in lines[1]
    assert "Stemmer and/or `rougeLsum` requires that `nltk` is installed" in lines[1]
    assert float(lines[2]) == float(np.float32(2 / 3))
    assert float(lines[3]) == 1.0
