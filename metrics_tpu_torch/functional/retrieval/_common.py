"""Shared preamble of the single-query retrieval functionals."""
from typing import Any, Optional, Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs
from metrics_tpu_torch.utils.data import _as_tensor

Tensor = torch.Tensor


def _inputs(
    preds: Any, target: Any, device: Optional[Union[str, torch.device]], allow_non_binary_target: bool = False
) -> Tuple[Tensor, Tensor]:
    """Checked flat float32 preds and target; host data goes to ``device``
    (the card unless ``device="cpu"``), tensors stay where they are."""
    return _check_retrieval_functional_inputs(
        _as_tensor(preds, device), _as_tensor(target, device), allow_non_binary_target=allow_non_binary_target
    )


def _descending(preds: Tensor) -> Tensor:
    """The stable descending order of ``preds`` (``argsort(-preds)``)."""
    return torch.argsort(-preds, stable=True)


def _zero(preds: Tensor) -> Tensor:
    return torch.zeros((), dtype=preds.dtype, device=preds.device)
