"""Dice score.

Counterpart of ``metrics_tpu/functional/classification/dice.py``: the
per-class counts vectorized over the class axis, plain torch on the
inputs' device.
"""
from typing import Optional, Union

import torch

from metrics_tpu_torch.parallel.distributed import reduce
from metrics_tpu_torch.utils.data import _as_tensor, to_categorical

Tensor = torch.Tensor


def dice_score(
    preds: Tensor,
    target: Tensor,
    bg: bool = False,
    nan_score: float = 0.0,
    no_fg_score: float = 0.0,
    reduction: str = "elementwise_mean",
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Computes the Dice score from prediction scores. Host inputs go to
    ``device`` (the card unless ``"cpu"``).

    Example:
        >>> import torch
        >>> pred = torch.tensor([[0.85, 0.05, 0.05, 0.05],
        ...                      [0.05, 0.85, 0.05, 0.05],
        ...                      [0.05, 0.05, 0.85, 0.05],
        ...                      [0.05, 0.05, 0.05, 0.85]])
        >>> target = torch.tensor([0, 1, 3, 2])
        >>> dice_score(pred, target)
        tensor(0.3333)
    """
    preds, target = _as_tensor(preds, device), _as_tensor(target, device)
    num_classes = preds.shape[1]
    bg_inv = 1 - int(bg)
    pred_labels = to_categorical(preds, argmax_dim=1) if preds.is_floating_point() else preds
    classes = torch.arange(bg_inv, num_classes, device=preds.device)
    pred_1h = pred_labels[:, None] == classes[None, :]  # [N, K]
    target_1h = target[:, None] == classes[None, :]
    tp = torch.sum(pred_1h & target_1h, dim=0).to(torch.float32)
    fp = torch.sum(pred_1h & ~target_1h, dim=0).to(torch.float32)
    fn = torch.sum(~pred_1h & target_1h, dim=0).to(torch.float32)
    denom = 2 * tp + fp + fn
    score = torch.where(denom == 0, nan_score, (2 * tp) / torch.where(denom == 0, 1.0, denom))
    has_fg = torch.any(target_1h, dim=0)
    scores = torch.where(has_fg, score, torch.tensor(no_fg_score, dtype=score.dtype, device=score.device))
    return reduce(scores, reduction=reduction)
