"""Match Error Rate.

Counterpart of ``metrics_tpu/functional/text/mer.py``: the edit distances
on the host, the two float32 sums on the device in one copy.
"""
from typing import List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.helper import _edit_distance, _float32_sums
from metrics_tpu_torch.utils.data import _resolve_device

Tensor = torch.Tensor


def _mer_update(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[torch.device] = None
) -> Tuple[Tensor, Tensor]:
    """Sum edit ops and max(len(ref), len(pred)) word counts."""
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    errors = 0
    total = 0
    for pred, tgt in zip(preds, target):
        pred_tokens = pred.split()
        tgt_tokens = tgt.split()
        errors += _edit_distance(pred_tokens, tgt_tokens)
        total += max(len(tgt_tokens), len(pred_tokens))
    sums = _float32_sums([errors, total], _resolve_device(device))
    return sums[0], sums[1]


def _mer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def match_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[Union[str, torch.device]] = None
) -> Tensor:
    """Match error rate of transcription(s); 0 is perfect.

    Example:
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> match_error_rate(preds=preds, target=target, device="cpu")
        tensor(0.4444)
    """
    errors, total = _mer_update(preds, target, device)
    return _mer_compute(errors, total)
