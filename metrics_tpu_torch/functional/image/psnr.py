"""Peak signal-to-noise ratio.

Counterpart of ``metrics_tpu/functional/image/psnr.py``. Sums of squared
error are taken by a fixed pairwise tree (``_tree_sum``), so the card and
the CPU give the same bits; counts are int32, as in the JAX package with
x64 off; the data range of an image batch is ``max - min`` with the JAX
package's extremum semantics (:func:`~metrics_tpu_torch.utils.data.amax_ieee`).
bfloat16 and float16 inputs are widened to float32 before the difference.
The logs of the value are taken in float64 and the result rounded once to
float32: the card's and the CPU's float32 logs differ in the last bit on a
share of inputs, their rounded float64 ones agree (the JAX package takes
them in float32, within 1e-6 relative of these).
"""
from typing import Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.parallel.distributed import reduce
from metrics_tpu_torch.utils.data import _tree_sum, _widen_half, _x64_off, amax_ieee, amin_ieee
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _psnr_compute(
    sum_squared_error: Tensor,
    n_obs: Tensor,
    data_range: Tensor,
    base: float = 10.0,
    reduction: str = "elementwise_mean",
) -> Tensor:
    # the value keeps the dtype of the states' own formula (times a 0-d
    # float32 factor)
    in_dtype = (2 * torch.log(data_range) - torch.log(sum_squared_error / n_obs)).dtype
    out_dtype = torch.promote_types(in_dtype, torch.float32) if sum_squared_error.ndim == 0 and data_range.ndim == 0 else in_dtype
    sse, n, dr = sum_squared_error.double(), n_obs.double(), data_range.double()
    psnr_base_e = 2 * torch.log(dr) - torch.log(sse / n)
    # the base's log on the host: no tensor is made from it (a read
    # captured as a CUDA graph may hold no copy from the host)
    psnr_vals = (psnr_base_e * (10 / np.log(base))).to(out_dtype)
    return reduce(psnr_vals, reduction=reduction)


def _psnr_update(
    preds: Tensor,
    target: Tensor,
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tuple[Tensor, Tensor]:
    diff = _widen_half(_x64_off(preds)) - _widen_half(_x64_off(target))
    squared = diff * diff
    if dim is None:
        return _tree_sum(squared.reshape(-1)), torch.full((), target.numel(), dtype=torch.int32, device=target.device)

    dim_list = [dim] if isinstance(dim, int) else list(dim)
    if not dim_list:  # a sum over no axis leaves every element
        return squared, torch.full((), target.numel(), dtype=torch.int32, device=target.device)
    dims = [d % squared.ndim for d in dim_list]
    kept = [d for d in range(squared.ndim) if d not in dims]
    moved = squared.permute(kept + dims)
    sum_squared_error = _tree_sum(moved.reshape(tuple(moved.shape[: len(kept)]) + (-1,)))
    n_obs = int(np.prod([target.shape[d] for d in dim_list]))
    return sum_squared_error, torch.full(sum_squared_error.shape, n_obs, dtype=torch.int32, device=target.device)


def peak_signal_noise_ratio(
    preds: Tensor,
    target: Tensor,
    data_range: Optional[float] = None,
    base: float = 10.0,
    reduction: str = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tensor:
    """Computes the peak signal-to-noise ratio.

    Example:
        >>> import torch
        >>> pred = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> peak_signal_noise_ratio(pred, target)
        tensor(2.5527)
    """
    if dim is None and reduction != "elementwise_mean":
        rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")

    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        wide = _widen_half(_x64_off(target))
        data_range_t = amax_ieee(wide) - amin_ieee(wide)
    else:
        data_range_t = torch.full((), float(data_range), dtype=torch.float32, device=target.device)
    sum_squared_error, n_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, n_obs, data_range_t, base=base, reduction=reduction)
