"""MultioutputWrapper: one copy of a metric per output.

Counterpart of ``metrics_tpu/wrappers/multioutput.py``: output ``i`` is the
slice ``i`` of every tensor argument along ``output_dim``; with
``remove_nans`` the rows (dim 0) holding a NaN in any argument are dropped
first (one host read per output: the kept rows' count), then the output
axis is squeezed.
"""
from typing import Any, List, Tuple

import torch

from metrics_tpu_torch.core.metric import Metric, _to_device_inputs
from metrics_tpu_torch.utils.data import apply_to_collection

Tensor = torch.Tensor


def _get_nan_indices(*tensors: Tensor) -> Tensor:
    """Bool mask of the rows (dim 0) that hold a NaN in any input."""
    if len(tensors) == 0:
        raise ValueError("Must pass at least one tensor as argument")
    sentinel = tensors[0]
    nan_idxs = torch.zeros(len(sentinel), dtype=torch.bool, device=sentinel.device)
    for t in tensors:
        flattened = t.reshape(len(t), -1).to(torch.float32)
        nan_idxs = nan_idxs | torch.isnan(flattened).any(dim=1)
    return nan_idxs


class MultioutputWrapper(Metric):
    """Evaluates one copy of ``base_metric`` per output along ``output_dim``;
    runs on the base metric's device.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import R2Score
        >>> target = torch.tensor([[0.5, 1.0], [-1.0, 1.0], [7.0, -6.0]])
        >>> preds = torch.tensor([[0.0, 2.0], [-1.0, 2.0], [8.0, -5.0]])
        >>> r2score = MultioutputWrapper(R2Score(device="cpu"), 2)
        >>> [round(float(v), 4) for v in r2score(preds, target)]
        [0.9654, 0.9082]
    """

    #: updates its children eagerly: a fused update sends it to the eager leg
    __jit_unsafe__ = True

    is_differentiable = False

    def __init__(
        self,
        base_metric: Metric,
        num_outputs: int,
        output_dim: int = -1,
        remove_nans: bool = True,
        squeeze_outputs: bool = True,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of metrics_tpu.Metric but received {base_metric}"
            )
        super().__init__(device=base_metric.device)
        self.metrics = [base_metric.clone() for _ in range(num_outputs)]
        self.output_dim = output_dim
        self.remove_nans = remove_nans
        self.squeeze_outputs = squeeze_outputs

    def _get_args_kwargs_by_output(self, *args: Any, **kwargs: Any) -> List[Tuple[list, dict]]:
        # the inputs are sliced before any child's update sees them
        args = _to_device_inputs(args, self.device)
        kwargs = _to_device_inputs(kwargs, self.device)
        args_kwargs_by_output = []
        for i in range(len(self.metrics)):
            def select(x: Tensor, idx: int = i) -> Tensor:
                return x.narrow(self.output_dim, idx, 1)

            selected_args = list(apply_to_collection(args, Tensor, select))
            selected_kwargs = apply_to_collection(kwargs, Tensor, select)
            if self.remove_nans:
                nan_idxs = _get_nan_indices(*selected_args, *selected_kwargs.values())
                keep = torch.nonzero(~nan_idxs).squeeze(1)  # the one host read
                selected_args = [arg.index_select(0, keep) for arg in selected_args]
                selected_kwargs = {k: v.index_select(0, keep) for k, v in selected_kwargs.items()}
            if self.squeeze_outputs:
                selected_args = [arg.squeeze(self.output_dim) for arg in selected_args]
                selected_kwargs = {k: v.squeeze(self.output_dim) for k, v in selected_kwargs.items()}
            args_kwargs_by_output.append((selected_args, selected_kwargs))
        return args_kwargs_by_output

    def _update(self, *args: Any, **kwargs: Any) -> None:
        for metric, (selected_args, selected_kwargs) in zip(self.metrics, self._get_args_kwargs_by_output(*args, **kwargs)):
            metric.update(*selected_args, **selected_kwargs)

    def _compute(self) -> List[Tensor]:
        return [m.compute() for m in self.metrics]

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        results = [
            metric(*selected_args, **selected_kwargs)
            for metric, (selected_args, selected_kwargs) in zip(self.metrics, self._get_args_kwargs_by_output(*args, **kwargs))
        ]
        if results[0] is None:
            return None
        return results
