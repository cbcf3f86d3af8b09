"""The docstring examples of metrics_tpu_torch run and print what they show (on the CPU)."""
import doctest
import importlib
import pkgutil

import pytest
import torch

import metrics_tpu_torch

torch.set_num_threads(2)

def _has_examples(module: str) -> bool:
    return any(t.examples for t in doctest.DocTestFinder().find(importlib.import_module(module)))


_MODULES = sorted(info.name for info in pkgutil.walk_packages(metrics_tpu_torch.__path__, "metrics_tpu_torch."))
_WITH_EXAMPLES = [name for name in _MODULES if _has_examples(name)]


def test_examples_exist():
    assert len(_WITH_EXAMPLES) >= 4
    # every retrieval functional shows its value
    retrieval = [name for name in _WITH_EXAMPLES if name.startswith("metrics_tpu_torch.functional.retrieval.")]
    assert len(retrieval) == 8
    # the audio family shows its values: every functional module and every class module but STOI's and PESQ's
    audio = [name for name in _WITH_EXAMPLES if ".audio." in name]
    assert sorted(audio) == sorted(
        [f"metrics_tpu_torch.functional.audio.{m}" for m in ("pesq", "pit", "sdr", "snr", "stoi")]
        + [f"metrics_tpu_torch.audio.{m}" for m in ("pit", "sdr", "snr")]
    )


@pytest.mark.parametrize("module", _WITH_EXAMPLES)
def test_docstring_examples(module):
    result = doctest.testmod(importlib.import_module(module), optionflags=doctest.NORMALIZE_WHITESPACE)
    assert result.failed == 0 and result.attempted > 0
