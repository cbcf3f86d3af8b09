"""ClasswiseWrapper: a per-class metric's value as a dict keyed by class.

Counterpart of ``metrics_tpu/wrappers/classwise.py``.
"""
from typing import Any, Dict, List, Optional

import torch

from metrics_tpu_torch.core.metric import Metric

Tensor = torch.Tensor


class ClasswiseWrapper(Metric):
    """Wraps a per-class metric (``average=None``) to return
    ``{"<metric>_<label>": value}``; runs on the wrapped metric's device.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> metric = ClasswiseWrapper(Accuracy(num_classes=3, average=None, device="cpu"), labels=["horse", "fish", "dog"])
        >>> preds = torch.tensor([0, 1, 2, 1])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> sorted(metric(preds, target).keys())
        ['accuracy_dog', 'accuracy_fish', 'accuracy_horse']
    """

    #: updates its child eagerly: a fused update sends it to the eager leg
    __jit_unsafe__ = True

    def __init__(self, metric: Metric, labels: Optional[List[str]] = None) -> None:
        if not isinstance(metric, Metric):
            raise ValueError(f"Expected argument `metric` to be an instance of `metrics_tpu.Metric` but got {metric}")
        if labels is not None and not (isinstance(labels, list) and all(isinstance(lab, str) for lab in labels)):
            raise ValueError(f"Expected argument `labels` to either be `None` or a list of strings but got {labels}")
        super().__init__(device=metric.device)
        self.metric = metric
        self.labels = labels

    def _convert(self, x: Tensor) -> Dict[str, Tensor]:
        name = self.metric.__class__.__name__.lower()
        if self.labels is None:
            return {f"{name}_{i}": val for i, val in enumerate(x)}
        return {f"{name}_{lab}": val for lab, val in zip(self.labels, x)}

    def _update(self, *args: Any, **kwargs: Any) -> None:
        self.metric.update(*args, **kwargs)

    def _compute(self) -> Dict[str, Tensor]:
        return self._convert(self.metric.compute())

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        return self._convert(self.metric(*args, **kwargs))
