"""Word Information Preserved.

Counterpart of ``metrics_tpu/functional/text/wip.py``; the sums are WIL's.
"""
from typing import List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.helper import _float32_sums
from metrics_tpu_torch.functional.text.wil import _word_info_sums
from metrics_tpu_torch.utils.data import _resolve_device

Tensor = torch.Tensor


def _wip_update(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[torch.device] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """Negative hit count and word totals, as three float32 scalars."""
    sums = _float32_sums(_word_info_sums(preds, target), _resolve_device(device))
    return sums[0], sums[1], sums[2]


def _wip_compute(errors: Tensor, target_total: Tensor, preds_total: Tensor) -> Tensor:
    return (errors / target_total) * (errors / preds_total)


def word_information_preserved(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[Union[str, torch.device]] = None
) -> Tensor:
    """Word information preserved of transcription(s); 1 is perfect.

    Example:
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> word_information_preserved(preds=preds, target=target, device="cpu")
        tensor(0.3472)
    """
    errors, target_total, preds_total = _wip_update(preds, target, device)
    return _wip_compute(errors, target_total, preds_total)
