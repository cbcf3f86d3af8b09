"""Aggregation metrics: the maximum, minimum, sum, concatenation and mean
of a stream of values.

Counterpart of ``metrics_tpu/aggregation.py``, with every ``nan_strategy``
(``"error"``, ``"warn"``: remove with a warning, ``"ignore"``: remove, or a
float to impute) and the JAX package's deliberate fixes: the non-empty
guard counts elements (an all-zero update is not skipped), and
``MeanMetric`` drops a value and its weight together.

Values are cast to float32. Finding NaNs reads the card (one host read per
update); under the capture rule of ``utils/checks.py`` (a fused update's
probe and capture) nothing is read and the update takes the JAX package's
traced branch instead: a float strategy imputes, and otherwise a NaN becomes
the aggregator's identity (-inf for max, +inf for min, 0 for sum) or, in
``MeanMetric``, a zero weight. So ``compile_update`` captures these metrics
as ``jax.jit`` traces them. Max and min fold with the JAX package's
semantics (:func:`~metrics_tpu_torch.utils.data.maximum_ieee`); sums add in
a fixed order (``_tree_sum``), so the card and the CPU give the same bits.
"""
from typing import Any, Callable, List, Union

import numpy as np
import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.checks import checks_read_nothing
from metrics_tpu_torch.utils.data import _tree_sum, amax_ieee, amin_ieee, dim_zero_cat, maximum_ieee, minimum_ieee
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


#: the JAX package's message (its spelling kept)
_NAN_MESSAGE = "Encounted `nan` values in tensor"


class BaseAggregator(Metric):
    """Base class of the aggregation metrics.

    ``nan_strategy``: ``"error"``, ``"warn"`` (remove with a warning),
    ``"ignore"`` (remove silently) or a float (impute).
    """

    is_differentiable = None
    higher_is_better = None
    #: the identity imputed for NaNs under the capture rule; None (CatMetric)
    #: passes them through
    _nan_neutral: Any = None

    def __init__(
        self,
        fn: Union[Callable, str],
        default_value: Union[Tensor, List],
        nan_strategy: Union[str, float] = "error",
        device: Any = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(device=device, **kwargs)
        allowed_nan_strategy = ("error", "warn", "ignore")
        if nan_strategy not in allowed_nan_strategy and not isinstance(nan_strategy, float):
            raise ValueError(
                f"Arg `nan_strategy` should either be a float or one of {allowed_nan_strategy}"
                f" but got {nan_strategy}."
            )
        self.nan_strategy = nan_strategy
        self.add_state("value", default=default_value, dist_reduce_fx=fn)

    def _as_float32(self, x: Union[float, Tensor]) -> Tensor:
        if isinstance(x, Tensor):
            return x.to(torch.float32)
        if isinstance(x, (int, float)):
            # a host scalar is filled on the device (no synchronous copy)
            return torch.full((), float(x), dtype=torch.float32, device=self.device)
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=self.device)

    def _cast_and_nan_check_input(self, x: Union[float, Tensor]) -> Tensor:
        x = self._as_float32(x)
        if not checks_read_nothing():
            nans = torch.isnan(x)
            if bool(nans.any()):
                if self.nan_strategy == "error":
                    raise RuntimeError(_NAN_MESSAGE)
                if self.nan_strategy in ("warn", "ignore"):
                    if self.nan_strategy == "warn":
                        rank_zero_warn(f"{_NAN_MESSAGE}. Will be removed.", UserWarning)
                    x = x[~nans]
                else:
                    x = torch.where(nans, float(self.nan_strategy), x)
        elif isinstance(self.nan_strategy, float):
            x = torch.where(torch.isnan(x), float(self.nan_strategy), x)
        elif self._nan_neutral is not None:
            x = torch.where(torch.isnan(x), self._nan_neutral, x)
        return x

    def _update(self, value: Union[float, Tensor]) -> None:
        pass

    def _compute(self) -> Tensor:
        return self.value


class MaxMetric(BaseAggregator):
    """Running maximum of a stream of values.

    Example:
        >>> from metrics_tpu_torch.aggregation import MaxMetric
        >>> metric = MaxMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(3.0)
        >>> metric.update(2.0)
        >>> metric.compute()
        tensor(3.)
    """

    _nan_neutral = float("-inf")

    def __init__(self, nan_strategy: Union[str, float] = "warn", device: Any = None, **kwargs: Any) -> None:
        super().__init__("max", -float("inf"), nan_strategy, device=device, **kwargs)

    def _update(self, value: Union[float, Tensor]) -> None:
        value = self._cast_and_nan_check_input(value)
        if value.numel() > 0:
            self.value = maximum_ieee(self.value, amax_ieee(value))


class MinMetric(BaseAggregator):
    """Running minimum of a stream of values."""

    _nan_neutral = float("inf")

    def __init__(self, nan_strategy: Union[str, float] = "warn", device: Any = None, **kwargs: Any) -> None:
        super().__init__("min", float("inf"), nan_strategy, device=device, **kwargs)

    def _update(self, value: Union[float, Tensor]) -> None:
        value = self._cast_and_nan_check_input(value)
        if value.numel() > 0:
            self.value = minimum_ieee(self.value, amin_ieee(value))


class SumMetric(BaseAggregator):
    """Running sum of a stream of values."""

    _nan_neutral = 0.0

    def __init__(self, nan_strategy: Union[str, float] = "warn", device: Any = None, **kwargs: Any) -> None:
        super().__init__("sum", 0.0, nan_strategy, device=device, **kwargs)

    def _update(self, value: Union[float, Tensor]) -> None:
        value = self._cast_and_nan_check_input(value)
        if value.numel() > 0:
            self.value = self.value + _tree_sum(value.reshape(-1))


class CatMetric(BaseAggregator):
    """Concatenation of a stream of values (a list state: never fused)."""

    def __init__(self, nan_strategy: Union[str, float] = "warn", device: Any = None, **kwargs: Any) -> None:
        super().__init__("cat", [], nan_strategy, device=device, **kwargs)

    def _update(self, value: Union[float, Tensor]) -> None:
        value = self._cast_and_nan_check_input(value)
        if value.numel() > 0:
            self.value.append(value)

    def _compute(self) -> Tensor:
        if isinstance(self.value, list) and self.value:
            return dim_zero_cat([torch.atleast_1d(v) for v in self.value])
        return self.value if not isinstance(self.value, list) else torch.zeros(0, device=self.device)


class MeanMetric(BaseAggregator):
    """Weighted running mean of a stream of values.

    Example:
        >>> from metrics_tpu_torch.aggregation import MeanMetric
        >>> metric = MeanMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(2.0)
        >>> metric.compute()
        tensor(1.5000)
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", device: Any = None, **kwargs: Any) -> None:
        super().__init__("sum", 0.0, nan_strategy, device=device, **kwargs)
        self.add_state("weight", default=0.0, dist_reduce_fx="sum")

    def _update(self, value: Union[float, Tensor], weight: Union[float, Tensor] = 1.0) -> None:
        # broadcast first, then drop NaNs of either jointly, so a value and
        # its weight stay aligned
        value = self._as_float32(value)
        weight = self._as_float32(weight).broadcast_to(value.shape)
        if value.numel() == 0:
            return
        nans = torch.isnan(value) | torch.isnan(weight)
        if not checks_read_nothing():
            if bool(nans.any()):
                if self.nan_strategy == "error":
                    raise RuntimeError(_NAN_MESSAGE)
                if self.nan_strategy in ("warn", "ignore"):
                    if self.nan_strategy == "warn":
                        rank_zero_warn(f"{_NAN_MESSAGE}. Will be removed.", UserWarning)
                    value, weight = value[~nans], weight[~nans]
                else:
                    value = torch.where(torch.isnan(value), float(self.nan_strategy), value)
                    weight = torch.where(torch.isnan(weight), float(self.nan_strategy), weight)
        elif isinstance(self.nan_strategy, float):
            value = torch.where(torch.isnan(value), float(self.nan_strategy), value)
            weight = torch.where(torch.isnan(weight), float(self.nan_strategy), weight)
        else:
            # no removal without a read: a zero weight drops the sample from
            # both sums, as removal would
            value = torch.where(nans, 0.0, value)
            weight = torch.where(nans, 0.0, weight)
        self.value = self.value + _tree_sum((value * weight).reshape(-1))
        self.weight = self.weight + _tree_sum(weight.reshape(-1))

    def _compute(self) -> Tensor:
        return self.value / self.weight
