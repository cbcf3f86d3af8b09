"""Word Information Lost.

Counterpart of ``metrics_tpu/functional/text/wil.py``: the edit distances
on the host, the three float32 sums on the device in one copy.
"""
from typing import List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.helper import _edit_distance, _float32_sums
from metrics_tpu_torch.utils.data import _resolve_device

Tensor = torch.Tensor


def _word_info_sums(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[int, int, int]:
    """``(errors - total, target words, preds words)``: ``errors`` sums the
    edit distances and ``total`` the ``max(len(ref), len(pred))`` word
    counts, so the first is minus the number of word hits (the compute
    squares the ratio pair, so the sign cancels). Shared with WIP."""
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    errors = 0
    target_total = 0
    preds_total = 0
    total = 0
    for pred, tgt in zip(preds, target):
        pred_tokens = pred.split()
        tgt_tokens = tgt.split()
        errors += _edit_distance(pred_tokens, tgt_tokens)
        target_total += len(tgt_tokens)
        preds_total += len(pred_tokens)
        total += max(len(tgt_tokens), len(pred_tokens))
    return errors - total, target_total, preds_total


def _wil_update(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[torch.device] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """Negative hit count and word totals, as three float32 scalars."""
    sums = _float32_sums(_word_info_sums(preds, target), _resolve_device(device))
    return sums[0], sums[1], sums[2]


def _wil_compute(errors: Tensor, target_total: Tensor, preds_total: Tensor) -> Tensor:
    return 1 - ((errors / target_total) * (errors / preds_total))


def word_information_lost(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[Union[str, torch.device]] = None
) -> Tensor:
    """Word information lost of transcription(s); 0 is perfect.

    Example:
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> word_information_lost(preds=preds, target=target, device="cpu")
        tensor(0.6528)
    """
    errors, target_total, preds_total = _wil_update(preds, target, device)
    return _wil_compute(errors, target_total, preds_total)
