"""Hinge loss (binary, Crammer-Singer multiclass, one-vs-all).

Counterpart of ``metrics_tpu/functional/classification/hinge.py``: plain
torch on the inputs' device (the JAX package computes it with jnp, outside
any kernel). The inputs pass through :func:`_input_squeeze` first, and the
margins are ``torch.where`` selects, so the update reads nothing back.
"""
from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _input_squeeze
from metrics_tpu_torch.utils.data import _as_tensor, to_onehot
from metrics_tpu_torch.utils.enums import DataType, EnumStr

Tensor = torch.Tensor


class MulticlassMode(EnumStr):
    """Possible multiclass modes of hinge loss."""

    CRAMMER_SINGER = "crammer-singer"
    ONE_VS_ALL = "one-vs-all"


def _check_shape_and_type_consistency_hinge(preds: Tensor, target: Tensor) -> DataType:
    if target.ndim > 1:
        raise ValueError(
            f"The `target` should be one dimensional, got `target` with shape={tuple(target.shape)}.",
        )
    if preds.ndim == 1:
        if preds.shape != target.shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,",
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}.",
            )
        return DataType.BINARY
    if preds.ndim == 2:
        if preds.shape[0] != target.shape[0]:
            raise ValueError(
                "The `preds` and `target` should have the same shape in the first dimension,",
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}.",
            )
        return DataType.MULTICLASS
    raise ValueError(f"The `preds` should be one or two dimensional, got `preds` with shape={tuple(preds.shape)}.")


def _hinge_update(
    preds: Tensor,
    target: Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
) -> Tuple[Tensor, Tensor]:
    """Summed hinge measures and the int32 sample count of one batch."""
    preds, target = _input_squeeze(preds, target)
    if preds.dtype == torch.float64:  # the JAX package's inputs are float32 with x64 off
        preds = preds.to(torch.float32)
    mode = _check_shape_and_type_consistency_hinge(preds, target)

    if mode == DataType.MULTICLASS:
        target = to_onehot(target, max(2, preds.shape[1])).to(torch.bool)

    zero = torch.zeros((), dtype=preds.dtype, device=preds.device)
    if mode == DataType.MULTICLASS and (multiclass_mode is None or multiclass_mode == MulticlassMode.CRAMMER_SINGER):
        margin = torch.where(target, preds, zero).sum(dim=1)
        margin = margin - torch.where(target, torch.full_like(preds, float("-inf")), preds).amax(dim=1)
    elif mode == DataType.BINARY or multiclass_mode == MulticlassMode.ONE_VS_ALL:
        margin = torch.where(target.to(torch.bool), preds, -preds)
    else:
        raise ValueError(
            "The `multiclass_mode` should be either None / 'crammer-singer' / MulticlassMode.CRAMMER_SINGER"
            "(default) or 'one-vs-all' / MulticlassMode.ONE_VS_ALL,"
            f" got {multiclass_mode}."
        )

    measures = torch.clamp(1 - margin, min=0)
    if squared:
        measures = measures.square()
    total = torch.full((), target.shape[0], dtype=torch.int32, device=preds.device)
    return measures.sum(dim=0), total


def _hinge_compute(measure: Tensor, total: Tensor) -> Tensor:
    return measure / total


def hinge_loss(
    preds: Tensor,
    target: Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Computes the mean hinge loss (used in SVMs). Host inputs go to
    ``device`` (the card unless ``"cpu"``); tensors stay where they are.

    Example:
        >>> import torch
        >>> target = torch.tensor([0, 1, 1])
        >>> preds = torch.tensor([-2.2, 2.4, 0.1])
        >>> hinge_loss(preds, target)
        tensor(0.3000)
    """
    preds, target = _as_tensor(preds, device), _as_tensor(target, device)
    measure, total = _hinge_update(preds, target, squared=squared, multiclass_mode=multiclass_mode)
    return _hinge_compute(measure, total)
