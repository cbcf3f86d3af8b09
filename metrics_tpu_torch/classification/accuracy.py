"""Modular Accuracy.

Counterpart of ``metrics_tpu/classification/accuracy.py``: the input mode
is locked by the first update, subset accuracy keeps int32 ``correct`` and
``total`` (and turns itself off for inputs it does not apply to). The mode
and that switch are host state (``_host_state``), carried from the JAX
package by ``state_from_jax(..., host_from=)``. Each update reads the card
once: the mode check's value stats are handed on to the formatter.
"""
from typing import Any, Mapping, Optional

import torch

from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.functional.classification.accuracy import (
    _accuracy_compute,
    _accuracy_update,
    _check_subset_validity,
    _mode,
    _subset_accuracy_compute,
    _subset_accuracy_update,
)
from metrics_tpu_torch.utils.enums import DataType

Tensor = torch.Tensor


class Accuracy(StatScores):
    """Computes accuracy for any classification input type.

    Example:
        >>> import torch
        >>> target = torch.tensor([0, 1, 2, 3])
        >>> preds = torch.tensor([0, 2, 1, 3])
        >>> accuracy = Accuracy(device="cpu")
        >>> accuracy(preds, target)
        tensor(0.5000)
    """

    is_differentiable = False
    higher_is_better = True
    _host_state = ("mode", "subset_accuracy")

    def __init__(
        self,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        average: str = "micro",
        mdmc_average: Optional[str] = "global",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        subset_accuracy: bool = False,
        **kwargs: Any,
    ) -> None:
        allowed_average = ["micro", "macro", "weighted", "samples", "none", None]
        if average not in allowed_average:
            raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")

        super().__init__(
            reduce="macro" if average in ["weighted", "none", None] else average,
            mdmc_reduce=mdmc_average,
            threshold=threshold,
            top_k=top_k,
            num_classes=num_classes,
            multiclass=multiclass,
            ignore_index=ignore_index,
            **kwargs,
        )

        if top_k is not None and (not isinstance(top_k, int) or top_k <= 0):
            raise ValueError(f"The `top_k` should be an integer larger than 0, got {top_k}")

        self.average = average
        self.subset_accuracy = subset_accuracy
        self.mode: Optional[DataType] = None

        if self.subset_accuracy:
            self.add_state("correct", default=0, dist_reduce_fx="sum")
            self.add_state("total", default=0, dist_reduce_fx="sum")

    def _set_host_state(self, values: Mapping[str, Any]) -> None:
        values = dict(values)
        if values.get("mode") is not None:
            values["mode"] = DataType(values["mode"])
        super()._set_host_state(values)

    def _update(self, preds: Tensor, target: Tensor) -> None:
        mode, stats = _mode(
            preds, target, self.threshold, self.top_k, self.num_classes, self.multiclass, self.ignore_index
        )

        if not self.mode:
            self.mode = mode
        elif self.mode != mode:
            raise ValueError(f"You can not use {mode} inputs with {self.mode} inputs.")

        if self.subset_accuracy and not _check_subset_validity(self.mode):
            self.subset_accuracy = False

        if self.subset_accuracy:
            correct, total = _subset_accuracy_update(
                preds, target, threshold=self.threshold, top_k=self.top_k, ignore_index=self.ignore_index, stats=stats
            )
            self.correct = self.correct + correct
            self.total = self.total + total
        else:
            tp, fp, tn, fn = _accuracy_update(
                preds,
                target,
                reduce=self.reduce,
                mdmc_reduce=self.mdmc_reduce,
                threshold=self.threshold,
                num_classes=self.num_classes,
                top_k=self.top_k,
                multiclass=self.multiclass,
                ignore_index=self.ignore_index,
                mode=self.mode,
                stats=stats,
            )
            self._accumulate(tp, fp, tn, fn)

    def _compute(self) -> Tensor:
        if self.subset_accuracy:
            return _subset_accuracy_compute(self.correct, self.total)
        tp, fp, tn, fn = self._get_final_stats()
        return _accuracy_compute(tp, fp, tn, fn, self.average, self.mdmc_reduce, self.mode)
