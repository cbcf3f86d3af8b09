"""Carry metric state from the JAX package into the port.

A metric of the JAX package has no weights: what it has accumulated is its
state dict, the output of ``update_state``. :func:`state_from_jax` takes
that dict with each leaf turned into a numpy array (``np.asarray``; a list
state, such as ``StatScores(reduce="samples")`` keeps, as a list of them)
and returns the port's state dict for the same metric, which
``compute_state`` and ``update_state`` of the port's metric accept, so an
epoch started in JAX can be continued and computed here.

Some metrics also keep host-side attributes that their states need to be
read: a sketched ``AUROC`` fixes its input mode (binary, multiclass,
multilabel) and its sketch's row layout at its first update, and ``ROC``,
``PrecisionRecallCurve`` and ``AveragePrecision`` fix their
``num_classes`` and ``pos_label`` there. Pass the JAX metric as
``host_from`` to carry those too (they are read from it by attribute;
nothing of JAX is imported). The capacity buffers (``overflow`` included),
the binned ``TPs``/``FPs``/``FNs`` and CalibrationError's bin sums carry as
they are.
"""
from enum import Enum
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from metrics_tpu_torch.core.metric import Metric, StateValue
from metrics_tpu_torch.utils.data import _resolve_device


def state_from_jax(
    state: Mapping[str, np.ndarray], metric: Metric, device: Optional[Any] = None, host_from: Optional[Any] = None
) -> Dict[str, StateValue]:
    """Tensors on ``device`` (default: the metric's) with the same dtypes as
    the numpy leaves (int32 stays int32). The names, shapes and dtypes must
    match ``metric.init_state()``; a mismatch raises ``ValueError``. A list
    state becomes a list of tensors, one per element, in order; it must be
    a list state of ``metric`` too.

    ``host_from`` (the JAX metric that accumulated ``state``) first sets
    ``metric``'s host-side attributes (``metric._host_state``) to its own;
    enum values arrive as their strings."""
    device = metric.device if device is None else _resolve_device(device)
    if host_from is not None:
        metric._set_host_state({name: _host_value(getattr(host_from, name)) for name in metric._host_state})
    template = metric.init_state()
    if set(state) != set(template):
        raise ValueError(f"state names {sorted(state)} do not match {type(metric).__name__}'s {sorted(template)}")
    out: Dict[str, StateValue] = {}
    for name, value in state.items():
        expected = template[name]
        if isinstance(expected, list) != isinstance(value, (list, tuple)):
            kind = "a list" if isinstance(expected, list) else "a tensor"
            raise ValueError(f"state {name!r} is {kind} state of {type(metric).__name__}")
        if isinstance(expected, list):
            out[name] = [_leaf(v, device) for v in value]
            continue
        tensor = _leaf(value, device)
        if tuple(tensor.shape) != tuple(expected.shape) or tensor.dtype != expected.dtype:
            raise ValueError(
                f"state {name!r}: got {tuple(tensor.shape)} {tensor.dtype},"
                f" expected {tuple(expected.shape)} {expected.dtype}"
            )
        out[name] = tensor
    return out


def _leaf(value: np.ndarray, device: torch.device) -> torch.Tensor:
    # a writable C-ordered copy (numpy views of JAX arrays are read-only);
    # np.ascontiguousarray would turn a 0-d leaf into shape (1,)
    return torch.from_numpy(np.array(value, order="C")).to(device)


def _host_value(value: Any) -> Any:
    return value.value if isinstance(value, Enum) else value
