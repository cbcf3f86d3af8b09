"""Modular StatScores, the base of the classification family.

Counterpart of ``metrics_tpu/classification/stat_scores.py``: int32
tp/fp/tn/fn sums (``[]`` for micro, ``[num_classes]`` for macro) on the
metric's device, or list states (``"cat"``) when ``reduce='samples'`` or
``mdmc_reduce='samplewise'``.
"""
from typing import Any, Callable, Optional, Tuple

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.stat_scores import _stat_scores_compute, _stat_scores_update

Tensor = torch.Tensor


class StatScores(Metric):
    """Computes the number of true/false positives/negatives and the support.

    Example:
        >>> import torch
        >>> preds  = torch.tensor([1, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> stat_scores = StatScores(reduce='macro', num_classes=3, device="cpu")
        >>> stat_scores(preds, target)
        tensor([[0, 1, 2, 1, 1],
                [1, 1, 1, 1, 2],
                [1, 0, 3, 0, 1]], dtype=torch.int32)
    """

    is_differentiable = False

    def __init__(
        self,
        threshold: float = 0.5,
        top_k: Optional[int] = None,
        reduce: str = "micro",
        num_classes: Optional[int] = None,
        ignore_index: Optional[int] = None,
        mdmc_reduce: Optional[str] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        self.reduce = reduce
        self.mdmc_reduce = mdmc_reduce
        self.num_classes = num_classes
        self.threshold = threshold
        self.multiclass = multiclass
        self.ignore_index = ignore_index
        self.top_k = top_k

        if reduce not in ["micro", "macro", "samples"]:
            raise ValueError(f"The `reduce` {reduce} is not valid.")
        if mdmc_reduce not in [None, "samplewise", "global"]:
            raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")
        if reduce == "macro" and (not num_classes or num_classes < 1):
            raise ValueError("When you set `reduce` as 'macro', you have to provide the number of classes.")
        if num_classes and ignore_index is not None and (not ignore_index < num_classes or num_classes == 1):
            raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

        default: Callable = list
        reduce_fn: Optional[str] = "cat"
        if mdmc_reduce != "samplewise" and reduce != "samples":
            zeros_shape = [] if reduce == "micro" else [num_classes]
            default = lambda: torch.zeros(zeros_shape, dtype=torch.int32, device=self.device)  # noqa: E731
            reduce_fn = "sum"

        for s in ("tp", "fp", "tn", "fn"):
            self.add_state(s, default=default(), dist_reduce_fx=reduce_fn)
        if ignore_index is not None and ignore_index >= 0 and reduce == "macro":
            # every update writes the ignored class's counts as a -1
            # sentinel, not a sum of row contributions: a bucketed fused
            # update's pad correction would move it (the JAX package's does,
            # and its bucketed value then differs from its eager one)
            self.__dict__["__fused_bucket_unsafe__"] = True

    def _update(self, preds: Tensor, target: Tensor) -> None:
        tp, fp, tn, fn = _stat_scores_update(
            preds,
            target,
            reduce=self.reduce,
            mdmc_reduce=self.mdmc_reduce,
            threshold=self.threshold,
            num_classes=self.num_classes,
            top_k=self.top_k,
            multiclass=self.multiclass,
            ignore_index=self.ignore_index,
        )
        self._accumulate(tp, fp, tn, fn)

    def _accumulate(self, tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> None:
        """Add a batch's counts to the sum states, or append them to the list states."""
        if self.reduce != "samples" and self.mdmc_reduce != "samplewise":
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.tn = self.tn + tn
            self.fn = self.fn + fn
        else:
            # new lists: a state dict handed to update_state keeps its own
            self.tp = self.tp + [tp]
            self.fp = self.fp + [fp]
            self.tn = self.tn + [tn]
            self.fn = self.fn + [fn]

    def _get_final_stats(self) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """The counts, list states concatenated."""
        tp = torch.cat(self.tp) if isinstance(self.tp, list) else self.tp
        fp = torch.cat(self.fp) if isinstance(self.fp, list) else self.fp
        tn = torch.cat(self.tn) if isinstance(self.tn, list) else self.tn
        fn = torch.cat(self.fn) if isinstance(self.fn, list) else self.fn
        return tp, fp, tn, fn

    def _compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _stat_scores_compute(tp, fp, tn, fn)
