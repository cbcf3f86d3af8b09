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

:func:`carry_from_jax` carries a whole metric the same way, into the port's
metric in place: its own states, every child's (wrappers and compositions,
by their ``_iter_child_metrics`` names), ``MinMaxMetric``'s extremes and
``BootStrapper``'s ``RandomState``, so an epoch started in the JAX package
continues here bit for bit.

Weights cross the other way too. The image extractors of both packages
read one ``.npz`` file, the JAX package's Flax variable tree (nested dicts
of numpy arrays, ``np.load(path, allow_pickle=True)["variables"].item()``):
:func:`inception_from_flax` and :func:`lpips_from_flax` turn that tree into
the port's ``state_dict`` (HWIO kernels to OIHW, a Dense ``[in, out]``
kernel to a Linear ``[out, in]`` weight, BatchNorm ``scale``/``bias``/
``mean``/``var`` to ``weight``/``bias``/``running_mean``/``running_var``),
and :func:`inception_to_flax` and :func:`lpips_to_flax` write the tree from
a torch-fidelity or ``lpips`` state dict (which the port's models share),
as the JAX package's converters do. ``build_fid_inception`` and
``build_lpips`` also read a torch state dict (or its ``.pth`` file)
directly (``_read_weights``).

:func:`bert_from_flax` maps a ``transformers.FlaxBertModel``'s parameter
tree onto the port's BERT (:mod:`metrics_tpu_torch.models.bert`), which
BERTScore runs.
"""
from enum import Enum
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.core.metric import Metric, StateValue
from metrics_tpu_torch.utils.data import _resolve_device


def state_from_jax(
    state: Mapping[str, np.ndarray], metric: Metric, device: Optional[Any] = None, host_from: Optional[Any] = None
) -> Dict[str, StateValue]:
    """Tensors on ``device`` (default: the metric's) with the same dtypes as
    the numpy leaves (int32 stays int32). The names, shapes and dtypes must
    match ``metric.init_state()`` (a scalar default takes any shape: it
    broadcasts into the state an update grows); a mismatch raises
    ``ValueError``. A list
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
        # a scalar default is a broadcast seed: the states of multi-output
        # updates (ExplainedVariance's sums) grow out of it
        shape_ok = tuple(tensor.shape) == tuple(expected.shape) or expected.ndim == 0
        if not shape_ok or tensor.dtype != expected.dtype:
            raise ValueError(
                f"state {name!r}: got {tuple(tensor.shape)} {tensor.dtype},"
                f" expected {tuple(expected.shape)} {expected.dtype}"
            )
        out[name] = tensor
    return out


def carry_from_jax(jax_metric: Any, metric: Metric, device: Optional[Any] = None) -> Metric:
    """Install what ``jax_metric`` accumulated into ``metric`` (the port's
    metric of the same class and configuration) and return it: the states
    through :func:`state_from_jax` (``host_from=jax_metric``), recursively
    into the children, which must have the same names; ``min_val`` and
    ``max_val`` where the metric keeps them; a ``RandomState``'s state where
    it keeps one (``BootStrapper``'s draws continue where the JAX ones
    stopped). Read from ``jax_metric`` by attribute: nothing of JAX is
    imported."""
    children = dict(metric._iter_child_metrics())
    jax_children = dict(jax_metric._iter_child_metrics())
    if children.keys() != jax_children.keys():
        raise ValueError(f"child metrics {sorted(jax_children)} do not match {type(metric).__name__}'s {sorted(children)}")
    if metric._defaults:
        state = {name: _host_leaf(getattr(jax_metric, name)) for name in jax_metric._defaults}
        for name, value in state_from_jax(state, metric, device=device, host_from=jax_metric).items():
            object.__setattr__(metric, name, value)
    for name, child in children.items():
        carry_from_jax(jax_children[name], child, device)
    for name in ("min_val", "max_val"):
        if isinstance(getattr(metric, name, None), torch.Tensor):
            setattr(metric, name, _leaf(np.asarray(getattr(jax_metric, name)), getattr(metric, name).device))
    if isinstance(getattr(metric, "_rng", None), np.random.RandomState):
        metric._rng.set_state(jax_metric._rng.get_state())
    metric._mark_state_written()
    metric._update_called = bool(jax_metric._update_called)
    return metric


def _host_leaf(value: Any) -> Any:
    """A JAX state leaf as numpy (a list state as a list of them); the
    eager update counter, a host int there, as int32."""
    if isinstance(value, (list, tuple)):
        return [np.asarray(v) for v in value]
    if isinstance(value, int):
        return np.asarray(value, dtype=np.int32)
    return np.asarray(value)


def _leaf(value: np.ndarray, device: torch.device) -> torch.Tensor:
    # a writable C-ordered copy (numpy views of JAX arrays are read-only);
    # np.ascontiguousarray would turn a 0-d leaf into shape (1,)
    return torch.from_numpy(np.array(value, order="C")).to(device)


def _host_value(value: Any) -> Any:
    return value.value if isinstance(value, Enum) else value


# ---------------------------------------------------------------------------
# extractor weights: the JAX package's Flax variable tree <-> torch
# ---------------------------------------------------------------------------


def _read_weights(weights: Any, from_torch: Any) -> Mapping[str, Any]:
    """A Flax variable tree from the JAX package's ``.npz`` file, or from a
    torch state dict (a mapping, or a ``.pth``/``.pt`` file read with
    ``torch.load(weights_only=True)``) through ``from_torch``."""
    if isinstance(weights, Mapping):
        return from_torch(weights)
    if str(weights).endswith(".npz"):
        return np.load(weights, allow_pickle=True)["variables"].item()
    return from_torch(torch.load(weights, map_location="cpu", weights_only=True))


def _weight(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


def _host(x: Any) -> np.ndarray:
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, dtype=np.float32)


def _oihw(kernel: Any) -> torch.Tensor:
    """A Flax HWIO kernel as a torch OIHW weight."""
    return _weight(np.asarray(kernel).transpose(3, 2, 0, 1))


def _hwio(weight: Any) -> np.ndarray:
    """A torch OIHW weight as a Flax HWIO kernel."""
    return _host(weight).transpose(2, 3, 1, 0)


def _inception_convs():
    """``(flax path, torch module name)`` of every BasicConv2d of the FID
    InceptionV3, in the JAX package's creation order."""
    from metrics_tpu_torch.models.inception import _BLOCK_LAYOUT, _STEM_CONVS

    for i, torch_name in enumerate(_STEM_CONVS):
        yield (f"BasicConv2d_{i}",), torch_name
    for flax_name, torch_name, branch_order in _BLOCK_LAYOUT:
        for j, branch in enumerate(branch_order):
            yield (flax_name, f"BasicConv2d_{j}"), f"{torch_name}.{branch}"


def _path_get(tree: Mapping, path: Tuple[str, ...]) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def _path_set(tree: Dict, path: Tuple[str, ...], value: Any) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def inception_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The state dict of :class:`~metrics_tpu_torch.models.inception.InceptionV3FID`
    from the JAX package's InceptionV3 variables (``{"params": ...,
    "batch_stats": ...}``). ``fc`` is there only when the tree has
    ``Dense_0``."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    for path, name in _inception_convs():
        p, s = _path_get(params, path), _path_get(stats, path)
        out[f"{name}.conv.weight"] = _oihw(p["Conv_0"]["kernel"])
        out[f"{name}.bn.weight"] = _weight(p["BatchNorm_0"]["scale"])
        out[f"{name}.bn.bias"] = _weight(p["BatchNorm_0"]["bias"])
        out[f"{name}.bn.running_mean"] = _weight(s["BatchNorm_0"]["mean"])
        out[f"{name}.bn.running_var"] = _weight(s["BatchNorm_0"]["var"])
        out[f"{name}.bn.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    if "Dense_0" in params:
        out["fc.weight"] = _weight(np.asarray(params["Dense_0"]["kernel"]).T)
        out["fc.bias"] = _weight(params["Dense_0"]["bias"])
    return out


def inception_to_flax(state_dict: Mapping[str, Any]) -> Dict[str, Dict]:
    """The JAX package's InceptionV3 variables from a torch-fidelity state
    dict (the port model's too): what its ``convert_torch_fidelity_weights``
    returns. Save with ``np.savez(path, variables=np.asarray(tree, dtype=object))``."""
    params: Dict = {}
    stats: Dict = {}
    for path, name in _inception_convs():
        _path_set(params, path, {
            "Conv_0": {"kernel": _hwio(state_dict[f"{name}.conv.weight"])},
            "BatchNorm_0": {"scale": _host(state_dict[f"{name}.bn.weight"]), "bias": _host(state_dict[f"{name}.bn.bias"])},
        })
        _path_set(stats, path, {
            "BatchNorm_0": {"mean": _host(state_dict[f"{name}.bn.running_mean"]), "var": _host(state_dict[f"{name}.bn.running_var"])},
        })
    if "fc.weight" in state_dict:
        params["Dense_0"] = {"kernel": _host(state_dict["fc.weight"]).T, "bias": _host(state_dict["fc.bias"])}
    return {"params": params, "batch_stats": stats}


def _lpips_convs(net_type: str):
    """``(flax conv name, torch module name)`` of every backbone conv of an
    LPIPS net, in order."""
    from torch import nn

    from metrics_tpu_torch.models.lpips import _backbone_layers

    convs = [(k, i) for k, i, layer in _backbone_layers(net_type) if isinstance(layer, nn.Conv2d)]
    for c, (k, i) in enumerate(convs):
        yield f"Conv_{c}", f"net.slice{k + 1}.{i}"


def lpips_from_flax(variables: Mapping[str, Any], net_type: str = "alex") -> Dict[str, torch.Tensor]:
    """The state dict of :class:`~metrics_tpu_torch.models.lpips.LPIPSNet`
    from the JAX package's LPIPS variables (``{"params": ...}``), with the
    scaling layer's constants."""
    from metrics_tpu_torch.models.lpips import _NET_STAGES, _SCALE, _SHIFT

    params = variables["params"]
    out: Dict[str, torch.Tensor] = {
        "scaling_layer.shift": _weight(np.asarray(_SHIFT).reshape(1, 3, 1, 1)),
        "scaling_layer.scale": _weight(np.asarray(_SCALE).reshape(1, 3, 1, 1)),
    }
    for flax_name, name in _lpips_convs(net_type):
        conv = params["_Backbone_0"][flax_name]
        out[f"{name}.weight"] = _oihw(conv["kernel"])
        out[f"{name}.bias"] = _weight(conv["bias"])
    for k in range(len(_NET_STAGES[net_type])):
        out[f"lin{k}.model.1.weight"] = _oihw(params[f"lin{k}"]["kernel"])
    return out


def lpips_to_flax(state_dict: Mapping[str, Any], net_type: str = "alex") -> Dict[str, Dict]:
    """The JAX package's LPIPS variables from an ``lpips`` state dict (the
    port model's too): what its ``convert_lpips_weights`` returns."""
    from metrics_tpu_torch.models.lpips import _NET_STAGES

    params: Dict = {"_Backbone_0": {}}
    for flax_name, name in _lpips_convs(net_type):
        params["_Backbone_0"][flax_name] = {"kernel": _hwio(state_dict[f"{name}.weight"]), "bias": _host(state_dict[f"{name}.bias"])}
    for k in range(len(_NET_STAGES[net_type])):
        params[f"lin{k}"] = {"kernel": _hwio(state_dict[f"lin{k}.model.1.weight"])}
    return {"params": params}


# ---------------------------------------------------------------------------
# BERT: a Flax BERT's parameter tree -> the port's BertModel
# ---------------------------------------------------------------------------

#: Flax leaf name -> torch parameter name; ``kernel`` is transposed
_BERT_LEAVES = {"kernel": "weight", "embedding": "weight", "scale": "weight", "bias": "bias"}


def bert_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The state dict of :class:`~metrics_tpu_torch.models.bert.BertModel`
    from a ``transformers.FlaxBertModel``'s ``params`` (nested dicts of
    numpy arrays; a ``{"params": ...}`` wrapper is taken off): a Dense
    ``[in, out]`` kernel becomes a Linear ``[out, in]`` weight, a LayerNorm
    ``scale`` its ``weight`` and an ``embedding`` table the Embedding's
    ``weight``. The module paths are the same in both (``embeddings``,
    ``encoder.layer.N....``, ``pooler.dense``)."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], prefix: str) -> None:
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
                continue
            array = np.asarray(value, dtype=np.float32)
            out[f"{prefix}{_BERT_LEAVES[key]}"] = _weight(array.T if key == "kernel" else array)

    walk(params, "")
    return out
