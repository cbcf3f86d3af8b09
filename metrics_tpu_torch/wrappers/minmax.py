"""MinMaxMetric: the running minimum and maximum of a scalar metric's
values over its ``compute()`` calls.

Counterpart of ``metrics_tpu/wrappers/minmax.py``. ``min_val`` and
``max_val`` live outside the state registry (they outlast ``forward``'s
snapshot and restore), so ``state_dict``/``load_state_dict`` carry them
explicitly and ``forward`` merges the extremes seen before it back in.
They fold with the JAX package's semantics (``maximum_ieee``).
"""
from typing import Any, Dict, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.data import _resolve_device, maximum_ieee, minimum_ieee

Tensor = torch.Tensor


class MinMaxMetric(Metric):
    """Tracks the minimum and maximum of a scalar base metric's values;
    runs on the base metric's device.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> minmax = MinMaxMetric(Accuracy(device="cpu"))
        >>> out = minmax(torch.tensor([1, 0, 1, 1]), torch.tensor([1, 1, 1, 1]))
        >>> sorted(out.keys())
        ['max', 'min', 'raw']
    """

    #: updates its child eagerly: a fused update sends it to the eager leg
    __jit_unsafe__ = True

    def __init__(self, base_metric: Metric, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of `metrics_tpu.Metric` but received {base_metric}"
            )
        super().__init__(device=base_metric.device, **kwargs)
        self._base_metric = base_metric
        self.min_val = self._extreme(float("inf"))
        self.max_val = self._extreme(-float("inf"))

    def _extreme(self, value: float) -> Tensor:
        return torch.full((), value, dtype=torch.float32, device=self.device)

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        # the double update resets min/max to get the batch value: the
        # extremes seen before merge back in
        prev_min, prev_max = self.min_val, self.max_val
        out = super().forward(*args, **kwargs)
        self.min_val = minimum_ieee(prev_min, out["min"])
        self.max_val = maximum_ieee(prev_max, out["max"])
        self._forward_cache = {"raw": out["raw"], "min": self.min_val, "max": self.max_val}
        return self._forward_cache

    def _update(self, *args: Any, **kwargs: Any) -> None:
        self._base_metric.update(*args, **kwargs)

    def _compute(self) -> Dict[str, Tensor]:
        val = self._base_metric.compute()
        if not self._is_suitable_val(val):
            raise RuntimeError(
                f"Returned value from base metric should be a scalar (int, float or tensor of size 1, but got {val}"
            )
        if not isinstance(val, Tensor):
            val = self._extreme(float(val))
        self.max_val = maximum_ieee(self.max_val, val)
        self.min_val = minimum_ieee(self.min_val, val)
        return {"raw": val, "max": self.max_val, "min": self.min_val}

    def reset(self) -> None:
        super().reset()
        self.min_val = self._extreme(float("inf"))
        self.max_val = self._extreme(-float("inf"))

    def to_device(self, device: Union[str, torch.device]) -> "MinMaxMetric":
        self.min_val = self.min_val.to(_resolve_device(device))
        self.max_val = self.max_val.to(_resolve_device(device))
        return super().to_device(device)

    def state_dict(self, destination: Optional[Dict] = None, prefix: str = "") -> Dict[str, Any]:
        destination = super().state_dict(destination, prefix=prefix)
        destination[prefix + "min_val"] = self.min_val.clone()
        destination[prefix + "max_val"] = self.max_val.clone()
        return destination

    def load_state_dict(self, state_dict: Dict[str, Any], prefix: str = "") -> None:
        super().load_state_dict(state_dict, prefix=prefix)
        if prefix + "min_val" in state_dict:
            self.min_val = torch.as_tensor(state_dict[prefix + "min_val"], device=self.device)
        if prefix + "max_val" in state_dict:
            self.max_val = torch.as_tensor(state_dict[prefix + "max_val"], device=self.device)

    @staticmethod
    def _is_suitable_val(val: Union[int, float, Tensor]) -> bool:
        if isinstance(val, (int, float)):
            return True
        if isinstance(val, Tensor):
            return val.numel() == 1
        return False
