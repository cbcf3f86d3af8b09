"""BootStrapper: bootstrapped mean, std, quantile and raw values of a
metric, by resampling each update.

Counterpart of ``metrics_tpu/wrappers/bootstrapping.py``. The resampling
indices are drawn on the host with ``np.random.RandomState(seed)`` in the
JAX package's order (one index vector per copy, per update), so each
copy's states are bit-equal to the JAX package's. The vectors of one update
are drawn first and reach the device in one copy (pinned, asynchronous on
the card) instead of one copy per bootstrap. Each copy then updates eagerly,
so the host cost is one child update per copy.
"""
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.data import apply_to_collection

Tensor = torch.Tensor


def _bootstrap_sampler(
    size: int,
    sampling_strategy: str = "poisson",
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Host indices resampling ``[0, size)`` with replacement."""
    rng = rng or np.random
    if sampling_strategy == "poisson":
        n = rng.poisson(1, size)
        return np.repeat(np.arange(size), n)
    if sampling_strategy == "multinomial":
        return rng.randint(0, size, size)
    raise ValueError("Unknown sampling strategy")


def _indices_on(vectors: List[np.ndarray], device: torch.device) -> List[Tensor]:
    """The index vectors on ``device`` after one host-to-device copy."""
    flat = torch.from_numpy(np.concatenate(vectors).astype(np.int64, copy=False))
    if device.type == "cuda":
        flat = flat.pin_memory().to(device, non_blocking=True)
    return list(torch.split(flat, [len(v) for v in vectors]))


class BootStrapper(Metric):
    """Bootstrapped statistics of ``num_bootstraps`` copies of
    ``base_metric``, each updated on a resample of every batch; runs on the
    base metric's device.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> bootstrap = BootStrapper(Accuracy(device="cpu"), num_bootstraps=20, seed=123)
        >>> bootstrap.update(torch.arange(20) % 5, (torch.arange(20) * 3) % 5)
        >>> sorted(bootstrap.compute().keys())
        ['mean', 'std']
    """

    #: updates its children eagerly: a fused update sends it to the eager leg
    __jit_unsafe__ = True

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, Tensor]] = None,
        raw: bool = False,
        sampling_strategy: str = "poisson",
        seed: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of metrics_tpu.Metric but received {base_metric}"
            )
        super().__init__(device=base_metric.device, **kwargs)
        self.metrics = [base_metric.clone() for _ in range(num_bootstraps)]
        self.num_bootstraps = num_bootstraps

        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw
        self._rng = np.random.RandomState(seed)

        allowed_sampling = ("poisson", "multinomial")
        if sampling_strategy not in allowed_sampling:
            raise ValueError(
                f"Expected argument ``sampling_strategy`` to be one of {allowed_sampling}"
                f" but recieved {sampling_strategy}"
            )
        self.sampling_strategy = sampling_strategy

    def _update(self, *args: Any, **kwargs: Any) -> None:
        """Update every copy on a fresh resample of the batch."""
        args_sizes = apply_to_collection(args, Tensor, len)
        kwargs_sizes = list(apply_to_collection(kwargs, Tensor, len).values())
        if len(args_sizes) > 0:
            size = args_sizes[0]
        elif len(kwargs_sizes) > 0:
            size = kwargs_sizes[0]
        else:
            raise ValueError("None of the input contained tensors, so could not determine the sampling size")
        vectors = [_bootstrap_sampler(size, self.sampling_strategy, self._rng) for _ in range(self.num_bootstraps)]
        for metric, sample_idx in zip(self.metrics, _indices_on(vectors, self.device)):
            new_args = apply_to_collection(args, Tensor, lambda x: x.index_select(0, sample_idx))
            new_kwargs = apply_to_collection(kwargs, Tensor, lambda x: x.index_select(0, sample_idx))
            metric.update(*new_args, **new_kwargs)

    def _compute(self) -> Dict[str, Tensor]:
        computed_vals = torch.stack([m.compute() for m in self.metrics], dim=0)
        output_dict = {}
        if self.mean:
            output_dict["mean"] = computed_vals.mean(dim=0)
        if self.std:
            output_dict["std"] = computed_vals.std(dim=0, correction=1)
        if self.quantile is not None:
            # flattened, as jnp.quantile without an axis
            q = torch.as_tensor(self.quantile, dtype=computed_vals.dtype, device=computed_vals.device)
            output_dict["quantile"] = torch.quantile(computed_vals.flatten(), q)
        if self.raw:
            output_dict["raw"] = computed_vals
        return output_dict
