"""Confusion matrix via the index-mapped bincount.

Counterpart of ``metrics_tpu/functional/classification/confusion_matrix.py``:
``target * C + pred`` is counted by ``_bincount`` (the ``bincount_i32``
kernel on the card) into an int32 ``[C, C]`` matrix.
"""
from typing import Any, Optional, Tuple

import torch

from metrics_tpu_torch.utils.checks import (
    _check_classification_inputs,
    _input_format_classification,
    _input_squeeze,
    checks_read_nothing,
)
from metrics_tpu_torch.utils.data import _as_tensor, _bincount, _refuse_bool_labels, to_categorical
from metrics_tpu_torch.utils.enums import DataType
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _labels(preds: Tensor, target: Tensor, threshold: float, num_classes: int) -> Tuple[Tensor, Tensor, DataType]:
    """Predicted and true labels (or binary indicators) for the count.

    ``[N, C]`` float scores with ``[N]`` labels, the common multiclass case,
    are validated as ``_input_format_classification`` validates them and
    then reduced with one argmax: the label its top-1 one-hot would give
    (totalOrder, first maximum), without building the two ``[N, C]``
    one-hots. Every other input style goes through the full formatter; label
    inputs under the capture rule of ``utils/checks.py`` cannot infer the
    class count from their values, so the formatter's refusal there is
    retried with the explicit ``num_classes``, as the JAX package retries
    under jit. Eager inputs, and every eager error, are unchanged.
    """
    squeezed_preds, squeezed_target = _input_squeeze(preds, target)
    if (
        squeezed_preds.is_floating_point()
        and squeezed_preds.ndim == 2
        and squeezed_target.ndim == 1
        and squeezed_preds.shape[1] >= 2
    ):
        if squeezed_preds.dtype in (torch.float16, torch.bfloat16):
            squeezed_preds = squeezed_preds.to(torch.float32)
        mode = _check_classification_inputs(
            squeezed_preds, squeezed_target, threshold=threshold, num_classes=None, multiclass=None, top_k=None
        )
        _refuse_bool_labels(squeezed_target)  # as the target's one-hot would
        return to_categorical(squeezed_preds, 1), squeezed_target, mode
    try:
        preds, target, mode = _input_format_classification(preds, target, threshold)
    except ValueError as err:
        if "under capture" not in str(err):
            raise
        preds, target, mode = _input_format_classification(preds, target, threshold, num_classes=num_classes)
    if mode not in (DataType.BINARY, DataType.MULTILABEL):
        preds, target = preds.argmax(dim=1), target.argmax(dim=1)
    return preds, target, mode


def _confusion_matrix_update(
    preds: Tensor, target: Tensor, num_classes: int, threshold: float = 0.5, multilabel: bool = False
) -> Tensor:
    preds, target, _ = _labels(preds, target, threshold, num_classes)
    if multilabel:
        classes = torch.arange(num_classes, device=preds.device)
        unique_mapping = ((2 * target + preds) + 4 * classes).flatten()
        minlength = 4 * num_classes
    else:
        unique_mapping = target.reshape(-1).to(torch.int64) * num_classes + preds.reshape(-1)
        minlength = num_classes**2

    bins = _bincount(unique_mapping, minlength=minlength)
    if multilabel:
        return bins.reshape(num_classes, 2, 2)
    return bins.reshape(num_classes, num_classes)


def _confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    allowed_normalize = ("true", "pred", "all", "none", None)
    if normalize not in allowed_normalize:
        raise ValueError(f"Argument average needs to one of the following: {allowed_normalize}")
    if normalize is not None and normalize != "none":
        confmat = confmat.to(torch.float32)
        if normalize == "true":
            confmat = confmat / confmat.sum(dim=1, keepdim=True)
        elif normalize == "pred":
            confmat = confmat / confmat.sum(dim=0, keepdim=True)
        elif normalize == "all":
            confmat = confmat / confmat.sum()

        nan_mask = torch.isnan(confmat)
        # the warning's count is a host read: none under the capture rule,
        # as the JAX package warns on concrete values only
        n_nan = 0 if checks_read_nothing() else int(nan_mask.sum())
        if n_nan:
            rank_zero_warn(f"{n_nan} nan values found in confusion matrix have been replaced with zeros.")
        confmat = torch.where(nan_mask, torch.zeros_like(confmat), confmat)
    return confmat


def confusion_matrix(
    preds: Any,
    target: Any,
    num_classes: int,
    normalize: Optional[str] = None,
    threshold: float = 0.5,
    multilabel: bool = False,
    device: Optional[Any] = None,
) -> Tensor:
    """Computes the confusion matrix (int32 counts, or float32 when normalized).

    Tensors are counted where they lie; numpy inputs go to ``device`` (the
    card unless ``device="cpu"``).

    Example:
        >>> import torch
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> confusion_matrix(preds, target, num_classes=2)
        tensor([[2, 0],
                [1, 1]], dtype=torch.int32)
    """
    preds, target = _as_tensor(preds, device), _as_tensor(target, device)
    confmat = _confusion_matrix_update(preds, target, num_classes, threshold, multilabel)
    return _confusion_matrix_compute(confmat, normalize)
