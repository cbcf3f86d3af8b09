"""Jaccard index (intersection over union) from the confusion matrix.

Counterpart of ``metrics_tpu/functional/classification/jaccard.py``. The
confusion matrix is counted by K1 (``bincount_i32``) on the card; the
ignored class's row is zeroed in a copy, never in the state.
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update
from metrics_tpu_torch.parallel.distributed import reduce
from metrics_tpu_torch.utils.data import _as_tensor

Tensor = torch.Tensor


def _jaccard_from_confmat(
    confmat: Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
    reduction: str = "elementwise_mean",
) -> Tensor:
    if ignore_index is not None and 0 <= ignore_index < num_classes:
        confmat = confmat.clone()
        confmat[ignore_index] = 0

    intersection = torch.diagonal(confmat)
    union = torch.sum(confmat, dim=0, dtype=confmat.dtype) + torch.sum(confmat, dim=1, dtype=confmat.dtype) - intersection

    scores = intersection.to(torch.float32) / torch.where(union == 0, 1, union).to(torch.float32)
    scores = torch.where(union == 0, float(absent_score), scores)

    if ignore_index is not None and 0 <= ignore_index < num_classes:
        scores = torch.cat([scores[:ignore_index], scores[ignore_index + 1:]])

    return reduce(scores, reduction=reduction)


def jaccard_index(
    preds: Any,
    target: Any,
    num_classes: int,
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
    threshold: float = 0.5,
    reduction: str = "elementwise_mean",
    device: Optional[Any] = None,
) -> Tensor:
    """Jaccard index of one batch. Tensors are counted where they lie;
    numpy inputs go to ``device`` (the card unless ``device="cpu"``).

    Example:
        >>> import torch
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> jaccard_index(preds, target, num_classes=2)
        tensor(0.5833)
    """
    confmat = _confusion_matrix_update(_as_tensor(preds, device), _as_tensor(target, device), num_classes, threshold)
    return _jaccard_from_confmat(confmat, num_classes, ignore_index, absent_score, reduction)
