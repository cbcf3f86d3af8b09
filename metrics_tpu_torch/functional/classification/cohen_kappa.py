"""Cohen's kappa from the confusion matrix.

Counterpart of ``metrics_tpu/functional/classification/cohen_kappa.py``.
The confusion matrix is counted by K1 (``bincount_i32``) on the card. The
expected matrix, ``sum1 @ sum0`` in the JAX package, is an outer product
with one term per entry, written as a broadcast multiply: it rounds as the
float32 product does, and a TF32 matmul (``set_float32_matmul_precision``)
cannot touch it.
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _confusion_matrix_compute,
    _confusion_matrix_update,
)
from metrics_tpu_torch.utils.data import _as_tensor

Tensor = torch.Tensor

_cohen_kappa_update = _confusion_matrix_update


def _cohen_kappa_compute(confmat: Tensor, weights: Optional[str] = None) -> Tensor:
    confmat = _confusion_matrix_compute(confmat)
    confmat = confmat.to(torch.float32)
    n_classes = confmat.shape[0]
    sum0 = torch.sum(confmat, dim=0, keepdim=True)
    sum1 = torch.sum(confmat, dim=1, keepdim=True)
    expected = sum1 * sum0 / torch.sum(sum0)

    if weights is None:
        w_mat = torch.ones_like(confmat) - torch.eye(n_classes, dtype=confmat.dtype, device=confmat.device)
    elif weights in ("linear", "quadratic"):
        w_mat = torch.arange(n_classes, dtype=confmat.dtype, device=confmat.device).expand(n_classes, n_classes)
        if weights == "linear":
            w_mat = torch.abs(w_mat - w_mat.T)
        else:
            w_mat = torch.pow(w_mat - w_mat.T, 2.0)
    else:
        raise ValueError(
            f"Received {weights} for argument ``weights`` but should be either None, 'linear' or 'quadratic'"
        )

    k = torch.sum(w_mat * confmat) / torch.sum(w_mat * expected)
    return 1 - k


def cohen_kappa(
    preds: Any,
    target: Any,
    num_classes: int,
    weights: Optional[str] = None,
    threshold: float = 0.5,
    device: Optional[Any] = None,
) -> Tensor:
    """Cohen's kappa (inter-annotator agreement) of one batch. Tensors are
    counted where they lie; numpy inputs go to ``device`` (the card unless
    ``device="cpu"``).

    Example:
        >>> import torch
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> cohen_kappa(preds, target, num_classes=2)
        tensor(0.5000)
    """
    confmat = _cohen_kappa_update(_as_tensor(preds, device), _as_tensor(target, device), num_classes, threshold)
    return _cohen_kappa_compute(confmat, weights)
