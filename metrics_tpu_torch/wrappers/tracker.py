"""MetricTracker: a metric (or collection) copied afresh per step, every
step kept.

Counterpart of ``metrics_tpu/wrappers/tracker.py``. Every step's states
stay alive: :meth:`state_footprint` and :meth:`total_state_bytes` count
them per step, and with the default telemetry recorder enabled each
``increment`` records a ``tracker_increment`` event with the running total.
"""
from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.observability.recorder import _DEFAULT_RECORDER as _TELEMETRY
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor

#: what a best value that has no total order raises in torch
_NO_BEST = (ValueError, TypeError, RuntimeError)


class MetricTracker:
    """Tracks a metric (or collection) over steps or epochs.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> tracker = MetricTracker(Accuracy(num_classes=10, device="cpu"))
        >>> for epoch in range(3):
        ...     tracker.increment()
        ...     tracker.update(torch.arange(10) % 10, (torch.arange(10) * (epoch + 2)) % 10)
        >>> tracker.n_steps
        3
    """

    def __init__(self, metric: Union[Metric, MetricCollection], maximize: Union[bool, List[bool]] = True) -> None:
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(
                f"Metric arg need to be an instance of a metrics_tpu `Metric` or `MetricCollection` but got {metric}"
            )
        self._base_metric = metric
        if not isinstance(maximize, (bool, list)):
            raise ValueError("Argument `maximize` should either be a single bool or list of bool")
        if isinstance(maximize, list) and isinstance(metric, MetricCollection) and len(maximize) != len(metric):
            raise ValueError("The len of argument `maximize` should match the length of the metric collection")
        self.maximize = maximize
        self._steps: List[Union[Metric, MetricCollection]] = []
        self._increment_called = False

    @property
    def n_steps(self) -> int:
        return len(self._steps)

    def increment(self) -> None:
        """Start a step with a fresh copy of the base metric."""
        self._increment_called = True
        self._steps.append(deepcopy(self._base_metric))
        self._steps[-1].reset()
        if _TELEMETRY.enabled:
            # every increment keeps the old step: the tracker is a per-step
            # memory multiplier, so the event carries the running total
            _TELEMETRY.record_event(
                "tracker_increment", n_steps=len(self._steps), total_state_bytes=self.total_state_bytes()
            )

    def state_footprint(self) -> Dict[str, Any]:
        """Each kept step's footprint, under ``step0`` ... ``stepN``."""
        return {f"step{i}": m.state_footprint() for i, m in enumerate(self._steps)}

    def total_state_bytes(self) -> int:
        """Bytes of every kept step's states."""
        return sum(m.total_state_bytes() for m in self._steps)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self._check_for_increment("forward")
        return self._steps[-1](*args, **kwargs)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._check_for_increment("update")
        self._steps[-1].update(*args, **kwargs)

    def compute(self) -> Any:
        self._check_for_increment("compute")
        return self._steps[-1].compute()

    def compute_all(self) -> Union[Tensor, Dict[str, Tensor]]:
        """The values of every step, stacked (per key for a collection)."""
        self._check_for_increment("compute_all")
        res = [metric.compute() for metric in self._steps]
        if isinstance(self._base_metric, MetricCollection):
            keys = res[0].keys()
            return {k: torch.stack([r[k] for r in res], dim=0) for k in keys}
        return torch.stack(res, dim=0)

    def reset(self) -> None:
        """Reset the current step's metric."""
        if self._steps:
            self._steps[-1].reset()

    def reset_all(self) -> None:
        """Reset every step's metric."""
        for metric in self._steps:
            metric.reset()

    def best_metric(
        self, return_step: bool = False
    ) -> Union[
        Optional[float],
        Tuple[Optional[float], Optional[int]],
        Dict[str, Union[float, None]],
        Tuple[Dict[str, Union[float, None]], Dict[str, Union[int, None]]],
    ]:
        """The best value seen (with ``return_step``, ``(value, step)``);
        ``None`` (per key) where the values are not scalars and have no
        order."""
        res = self.compute_all()
        if isinstance(res, dict):
            maximize = self.maximize if isinstance(self.maximize, list) else [self.maximize] * len(res)
            value, idx = {}, {}
            for i, (k, v) in enumerate(res.items()):
                try:
                    f = torch.argmax if maximize[i] else torch.argmin
                    best = int(f(v))
                    value[k], idx[k] = float(v[best]), best
                except _NO_BEST:
                    rank_zero_warn(
                        f"Encountered the following error when trying to get the best metric for metric {k}:"
                        " this is probably due to the 'best' not being defined for this metric."
                        " Returning `None` instead.",
                        UserWarning,
                    )
                    value[k], idx[k] = None, None
            if return_step:
                return value, idx
            return value

        try:
            f = torch.argmax if self.maximize else torch.argmin
            idx_best = int(f(res))
            value = float(res[idx_best].reshape(()))
        except _NO_BEST:
            rank_zero_warn(
                "Encountered an error when trying to get the best metric:"
                " this is probably due to the 'best' not being defined for this metric."
                " Returning `None` instead.",
                UserWarning,
            )
            value, idx_best = None, None
        if return_step:
            return value, idx_best
        return value

    def _check_for_increment(self, method: str) -> None:
        if not self._increment_called:
            raise ValueError(f"`{method}` cannot be called before `.increment()` has been called")
