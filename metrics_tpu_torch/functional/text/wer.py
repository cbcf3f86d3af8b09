"""Word Error Rate.

Counterpart of ``metrics_tpu/functional/text/wer.py``: the edit distances
on the host, the two float32 sums on the device in one copy.
"""
from typing import List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.helper import _edit_distance, _float32_sums
from metrics_tpu_torch.utils.data import _resolve_device

Tensor = torch.Tensor


def _wer_update(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[torch.device] = None
) -> Tuple[Tensor, Tensor]:
    """Sum edit operations and reference word counts over the batch."""
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
        total += len(tgt_tokens)
    sums = _float32_sums([errors, total], _resolve_device(device))
    return sums[0], sums[1]


def _wer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def word_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[Union[str, torch.device]] = None
) -> Tensor:
    """Word error rate of transcription(s) vs reference(s); 0 is perfect.

    Example:
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> word_error_rate(preds=preds, target=target, device="cpu")
        tensor(0.5000)
    """
    errors, total = _wer_update(preds, target, device)
    return _wer_compute(errors, total)
