"""Matthews correlation coefficient from the confusion matrix.

Counterpart of ``metrics_tpu/functional/classification/matthews_corrcoef.py``.
The confusion matrix is counted by K1 (``bincount_i32``) on the card; the
covariances are float32 as in the JAX package, so past a total count of
4096 ``s**2`` rounds and a coefficient near 0 carries that cancellation.
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update
from metrics_tpu_torch.utils.data import _as_tensor

Tensor = torch.Tensor

_matthews_corrcoef_update = _confusion_matrix_update


def _matthews_corrcoef_compute(confmat: Tensor) -> Tensor:
    tk = torch.sum(confmat, dim=1, dtype=torch.int32).to(torch.float32)
    pk = torch.sum(confmat, dim=0, dtype=torch.int32).to(torch.float32)
    c = torch.sum(torch.diagonal(confmat), dtype=torch.int32).to(torch.float32)
    s = torch.sum(confmat, dtype=torch.int32).to(torch.float32)

    cov_ytyp = c * s - torch.sum(tk * pk)
    cov_ypyp = s**2 - torch.sum(pk * pk)
    cov_ytyt = s**2 - torch.sum(tk * tk)

    denom = cov_ypyp * cov_ytyt
    return torch.where(denom == 0, 0.0, cov_ytyp / torch.sqrt(torch.where(denom == 0, 1.0, denom)))


def matthews_corrcoef(
    preds: Any,
    target: Any,
    num_classes: int,
    threshold: float = 0.5,
    device: Optional[Any] = None,
) -> Tensor:
    """Matthews correlation coefficient of one batch. Tensors are counted
    where they lie; numpy inputs go to ``device`` (the card unless
    ``device="cpu"``).

    Example:
        >>> import torch
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> matthews_corrcoef(preds, target, num_classes=2)
        tensor(0.5774)
    """
    confmat = _matthews_corrcoef_update(_as_tensor(preds, device), _as_tensor(target, device), num_classes, threshold)
    return _matthews_corrcoef_compute(confmat)
