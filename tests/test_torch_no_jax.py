"""metrics_tpu_torch and chip_smoke.py stand without JAX and without the JAX package.

A subprocess in which ``jax`` and ``metrics_tpu`` cannot be imported
imports the port and every one of its modules, and chip_smoke.py.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

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
             "image.inception", "image.lpip", "models", "models.inception", "models.lpips", "ops.sqrtm"):
    assert "metrics_tpu_torch." + name in names, name
from metrics_tpu_torch import BootStrapper, CompositionalMetric, MeanMetric, MetricTracker  # noqa: F401
from metrics_tpu_torch.parallel import class_reduce, gather_all_arrays, sync_pytree  # noqa: F401
from metrics_tpu_torch import FrechetInceptionDistance, KernelInceptionDistance, InceptionScore  # noqa: F401
from metrics_tpu_torch import LearnedPerceptualImagePatchSimilarity, UniversalImageQualityIndex  # noqa: F401
from metrics_tpu_torch.convert import inception_from_flax, lpips_from_flax  # noqa: F401
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
    assert int(out.stdout.strip()) >= 80  # every module of the port was imported (sliced and windowed included)


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
