"""Every name in an ``__all__`` of the JAX package imports from the port's
module at the same path.

The JAX modules are read as text (their ``__all__`` literals), the port's
are imported. Excepted are the names that ROADMAP.md's queue A lists as not
to be ported: the ``ops/dispatch.py`` registry (the port routes by device
only, with no kill switch) and ``utils/compat.py`` (a ``jax.shard_map``
import shim, which has no counterpart).
"""
import ast
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_ROOT = REPO / "metrics_tpu"

NOT_PORTED = {
    "metrics_tpu.ops.dispatch": {
        "NO_PALLAS_ENV",
        "KernelSpec",
        "register_kernel",
        "get_kernel",
        "kernel_names",
        "pallas_disabled",
        "forced_backend",
        "dispatch_mode",
        "dispatch",
    },
    "metrics_tpu.utils.compat": {"*"},
}


def _jax_all():
    out = {}
    for path in sorted(JAX_ROOT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in tree.body:
            if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
                module = ".".join(path.relative_to(REPO).with_suffix("").parts)
                out[module.removesuffix(".__init__")] = list(ast.literal_eval(node.value))
    return out


JAX_ALL = _jax_all()


def test_the_jax_package_has_all_lists():
    assert "metrics_tpu" in JAX_ALL and "metrics_tpu.sliced" in JAX_ALL and len(JAX_ALL) >= 20


@pytest.mark.parametrize("module", sorted(JAX_ALL))
def test_every_exported_name_imports_from_the_port(module):
    skipped = NOT_PORTED.get(module, set())
    if "*" in skipped:
        assert not (REPO / "metrics_tpu_torch" / Path(*module.split(".")[1:])).with_suffix(".py").exists()
        return
    port = importlib.import_module(module.replace("metrics_tpu", "metrics_tpu_torch", 1))
    missing = [name for name in JAX_ALL[module] if name not in skipped and not hasattr(port, name)]
    assert not missing, f"{module}: {missing}"
    # a package the JAX package gives an __all__ gets one in the port
    if Path(port.__file__).name == "__init__.py":
        assert hasattr(port, "__all__"), module
        assert not [n for n in JAX_ALL[module] if n not in skipped and n not in port.__all__], module


def test_package_reexports_at_shared_paths():
    """Names the JAX package re-exports from a package without an
    ``__all__`` (``ops``) or beside its ``__all__``, at the same paths."""
    from metrics_tpu_torch import MetricRecorder, get_recorder
    from metrics_tpu_torch.core import FUSED_ENTRY, AsyncQueueFull, AsyncUpdateHandle, AsyncWorkerError, FusedUpdate
    from metrics_tpu_torch.ops import NEWTON_SCHULZ_ITERS
    from metrics_tpu_torch.sliced import SLICED_FOOTPRINT_PREFIX
    from metrics_tpu_torch.windowed import ring_merge_fx

    import metrics_tpu.ops

    assert NEWTON_SCHULZ_ITERS == metrics_tpu.ops.NEWTON_SCHULZ_ITERS
    assert SLICED_FOOTPRINT_PREFIX == "sliced/" and callable(ring_merge_fx) and callable(get_recorder)
    assert all(isinstance(c, type) for c in (MetricRecorder, FusedUpdate, AsyncUpdateHandle, AsyncQueueFull, AsyncWorkerError))
    assert isinstance(FUSED_ENTRY, str)
