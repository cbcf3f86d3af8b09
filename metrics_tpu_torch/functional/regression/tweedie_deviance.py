"""Tweedie deviance score.

Counterpart of ``metrics_tpu/functional/regression/tweedie_deviance.py``.
The power-dependent domain checks read the inputs with one host read, and
read nothing under the capture rule of ``utils/checks.py`` (a fused
update), as the JAX package skips them for traced inputs. The deviance is
summed in a fixed order (``_tree_sum``); half-precision inputs are widened
to float32 first.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape, checks_read_nothing
from metrics_tpu_torch.utils.data import _tree_sum, _widen_half

Tensor = torch.Tensor


def _validate_domain(preds: Tensor, targets: Tensor, power: float) -> None:
    if checks_read_nothing() or preds.numel() == 0:
        return
    p_pos, t_pos, t_nonneg = torch.stack([(preds > 0).all(), (targets > 0).all(), (targets >= 0).all()]).tolist()
    if power == 1:
        if not p_pos or not t_nonneg:
            raise ValueError(f"For power={power}, 'preds' has to be strictly positive and 'targets' cannot be negative.")
    elif power == 2:
        if not p_pos or not t_pos:
            raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")
    elif power < 0:
        if not p_pos:
            raise ValueError(f"For power={power}, 'preds' has to be strictly positive.")
    elif 1 < power < 2:
        if not p_pos or not t_nonneg:
            raise ValueError(f"For power={power}, 'targets' has to be strictly positive and 'preds' cannot be negative.")
    elif power > 2:
        if not p_pos or not t_pos:
            raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")


def _tweedie_deviance_score_update(preds: Tensor, targets: Tensor, power: float = 0.0) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, targets)
    if 0 < power < 1:
        raise ValueError(f"Deviance Score is not defined for power={power}.")
    _validate_domain(preds, targets, power)
    preds, targets = _widen_half(preds), _widen_half(targets)
    if power == 0:
        deviance_score = torch.square(targets - preds)
    elif power == 1:  # Poisson
        deviance_score = 2 * (torch.xlogy(targets, targets / preds) + preds - targets)
    elif power == 2:  # Gamma
        deviance_score = 2 * (torch.log(preds / targets) + (targets / preds) - 1)
    else:
        term_1 = torch.pow(torch.clamp(targets, min=0.0), 2 - power) / ((1 - power) * (2 - power))
        term_2 = targets * torch.pow(preds, 1 - power) / (1 - power)
        term_3 = torch.pow(preds, 2 - power) / (2 - power)
        deviance_score = 2 * (term_1 - term_2 + term_3)
    n = torch.full((), deviance_score.numel(), dtype=torch.int32, device=deviance_score.device)
    return _tree_sum(deviance_score.reshape(-1)), n


def _tweedie_deviance_score_compute(sum_deviance_score: Tensor, num_observations: Tensor) -> Tensor:
    return sum_deviance_score / num_observations


def tweedie_deviance_score(preds: Tensor, targets: Tensor, power: float = 0.0) -> Tensor:
    """Computes the Tweedie deviance score.

    Example:
        >>> import torch
        >>> targets = torch.tensor([1.0, 2.0, 3.0, 4.0])
        >>> preds = torch.tensor([4.0, 3.0, 2.0, 1.0])
        >>> tweedie_deviance_score(preds, targets, power=2)
        tensor(1.2083)
    """
    sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, power=power)
    return _tweedie_deviance_score_compute(sum_deviance_score, num_observations)
