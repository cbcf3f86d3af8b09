"""Modular AUROC in the exact multiclass capacity mode.

Counterpart of ``metrics_tpu/classification/auroc.py`` for
``AUROC(num_classes>=2, capacity=N)``: ``[N, C]`` score rows and labels
accumulate in fixed buffers on the device, and ``compute`` is the masked
rank AUROC. The JAX package's other modes are later slices of the port and
raise ``NotImplementedError`` here: the sketched default and the binary
capacity mode (ROADMAP.md, queue A: 'sketches'), and ``exact=True``
(queue A: 'regression and breadth', with the curve functions).
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.classification._capacity import CapacityCurveMixin
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.auroc import auroc_rank_multiclass_masked
from metrics_tpu_torch.utils.enums import AverageMethod

Tensor = torch.Tensor


class AUROC(CapacityCurveMixin, Metric):
    """Area under the ROC curve, exact, over a fixed-capacity buffer.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.2, 0.5, 0.3], [0.1, 0.2, 0.7], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> auroc = AUROC(num_classes=3, capacity=8, device="cpu")
        >>> auroc.update(preds, target)
        >>> auroc.compute()
        tensor(1.)
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
        capacity: Optional[int] = None,
        exact: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        self.average = average
        self.max_fpr = max_fpr

        allowed_average = (None, AverageMethod.MACRO, AverageMethod.WEIGHTED, AverageMethod.MICRO, AverageMethod.NONE)
        if average not in allowed_average:
            raise ValueError(
                f"Argument `average` expected to be one of the following: {allowed_average} but got {average}"
            )
        if max_fpr is not None and (not isinstance(max_fpr, float) or not 0 < max_fpr <= 1):
            raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")
        if exact and capacity is not None:
            raise ValueError("`exact=True` and `capacity` are mutually exclusive state modes")
        if exact:
            raise NotImplementedError(
                "AUROC(exact=True) is not ported yet (ROADMAP.md, queue A: 'regression and breadth');"
                " use AUROC(num_classes=C, capacity=N)"
            )
        if capacity is None:
            raise NotImplementedError(
                "the sketched AUROC default is not ported yet (ROADMAP.md, queue A: 'sketches');"
                " use AUROC(num_classes=C, capacity=N)"
            )
        if max_fpr is not None:
            raise ValueError("`capacity` mode does not support `max_fpr`")
        if num_classes is None or num_classes < 2:
            raise NotImplementedError(
                "binary capacity-mode AUROC is not ported yet (ROADMAP.md, queue A: 'sketches');"
                " this slice ports the multiclass capacity mode (num_classes >= 2)"
            )
        if average == AverageMethod.MICRO:
            raise ValueError(
                "`capacity` multiclass mode supports average in ('macro', 'weighted', 'none'); 'micro' is not"
                " defined for the one-vs-rest rank kernel"
            )
        self._init_capacity(capacity, num_cols=num_classes)

    def _update(self, preds: Tensor, target: Tensor) -> None:
        self._capacity_update(preds, target)

    def _compute(self) -> Tensor:
        preds, target, valid = self._capacity_buffers_2d()
        return auroc_rank_multiclass_masked(preds, target, valid, self.num_classes, average=self.average)
