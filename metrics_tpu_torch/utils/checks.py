"""Input canonicalisation for classification and retrieval metrics.

Counterpart of ``metrics_tpu/utils/checks.py`` (the shape check and the
classification and retrieval parts):
the shape/dtype case-deduction table, the ``num_classes`` and ``top_k``
consistency rules, and ``_input_format_classification``, which turns every
supported input style into canonical int32 binary ``(N, C)`` / ``(N, C, X)``
tensors. The errors and their messages match the JAX package's.

The value checks (label ranges, implied class counts) read the data, which
on the card is a device-to-host copy that waits for the card. All of them
are taken from one small tensor of minima and maxima, read in one
``.tolist()`` call per formatted batch (:func:`_value_stats`); a
retrieval table update likewise reads its binary-target and ``ignore_index``
checks in one call (:func:`_read_retrieval_values`).

**The capture rule.** The JAX package skips its value checks on tracers,
so a jitted update reads nothing back. Here the same holds while
:func:`capturing_checks` is on (the fused update turns it on around its
probe and its captures) or the current CUDA stream is capturing a graph:
both readers then return no values and read nothing, and every decision is
taken from shapes, dtypes and static arguments, as under the JAX trace.
Outside capture nothing changes.
"""
import contextlib
import threading
from typing import Dict, Iterator, Optional, Tuple

import torch

from metrics_tpu_torch.utils.data import _is_integer, _x64_off, select_topk, to_onehot
from metrics_tpu_torch.utils.enums import DataType

Tensor = torch.Tensor


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    """Raise if predictions and targets have different shapes."""
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, but got {preds.shape} and {target.shape}."
        )


def _same_dtype_x64_off(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """``preds`` and ``target`` in the dtypes the JAX package's arrays take
    with x64 off (:func:`~metrics_tpu_torch.utils.data._x64_off`), refused
    with ``TypeError`` unless those are one dtype. The rounding comes first,
    as at the JAX package's intake: a float64/float32 pair is float32 twice,
    a float16/float32 pair raises."""
    preds, target = _x64_off(preds), _x64_off(target)
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    return preds, target


def _check_for_empty_tensors(preds: Tensor, target: Tensor) -> bool:
    return preds.numel() == 0 and target.numel() == 0


_CAPTURE = threading.local()


@contextlib.contextmanager
def capturing_checks() -> Iterator[None]:
    """Within this context (this thread only) the value checks read
    nothing: :func:`_value_stats` and :func:`_read_retrieval_values` return
    no values, as the JAX package's checks skip tracers."""
    prev = getattr(_CAPTURE, "on", False)
    _CAPTURE.on = True
    try:
        yield
    finally:
        _CAPTURE.on = prev


@contextlib.contextmanager
def building_entry() -> Iterator[None]:
    """Within this context (this thread only) a fused update is building a
    cache entry: the capture of its graph on the card, its first plain run
    on the CPU. Hooks that the JAX package fires once per trace (the
    sliced scatter's ``in_jit`` telemetry event) fire here, once per
    entry, and not in the probe, the warm-ups or later runs."""
    prev = getattr(_CAPTURE, "entry", False)
    _CAPTURE.entry = True
    try:
        yield
    finally:
        _CAPTURE.entry = prev


def in_entry_build() -> bool:
    """True inside :func:`building_entry`."""
    return getattr(_CAPTURE, "entry", False)


def checks_read_nothing() -> bool:
    """True under :func:`capturing_checks` or while the current CUDA stream
    captures a graph."""
    if getattr(_CAPTURE, "on", False):
        return True
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _value_stats(preds: Tensor, target: Tensor) -> Dict[str, int]:
    """``tmin``/``tmax`` of the target and, for integer predictions,
    ``pmin``/``pmax``: every value a check below reads, in ONE host read;
    none under the capture rule (the checks that need them are skipped)."""
    if checks_read_nothing():
        return {}
    parts: Dict[str, Tensor] = {}
    if target.numel():
        parts["tmin"], parts["tmax"] = target.min(), target.max()
    if not preds.is_floating_point() and preds.numel():
        parts["pmin"], parts["pmax"] = preds.min(), preds.max()
    if not parts:
        return {}
    values = torch.stack([v.to(torch.int64) for v in parts.values()]).tolist()
    return dict(zip(parts, values))


def _basic_input_validation(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    multiclass: Optional[bool],
    ignore_index: Optional[int],
    stats: Optional[Dict[str, int]] = None,
) -> Dict[str, int]:
    """Case-independent validation; returns the value stats it read, or
    ``stats`` when the caller already read them from the same values."""
    if _check_for_empty_tensors(preds, target):
        return {}
    if target.is_floating_point():
        raise ValueError("The `target` has to be an integer tensor.")

    preds_float = preds.is_floating_point()
    if not preds.ndim or not target.ndim:
        raise ValueError("The `preds` and `target` should be non-scalar tensors.")
    if preds.shape[0] != target.shape[0]:
        raise ValueError("The `preds` and `target` should have the same first dimension.")

    if stats is None:
        stats = _value_stats(preds, target)
    tmin = stats.get("tmin", 0)
    if ignore_index is None and tmin < 0:
        raise ValueError("The `target` has to be a non-negative tensor.")
    if ignore_index is not None and ignore_index >= 0 and tmin < 0:
        raise ValueError("The `target` has to be a non-negative tensor.")
    if not preds_float and stats.get("pmin", 0) < 0:
        raise ValueError("If `preds` are integers, they have to be non-negative.")
    if multiclass is False and stats.get("tmax", 0) > 1:
        raise ValueError("If you set `multiclass=False`, then `target` should not exceed 1.")
    if multiclass is False and not preds_float and stats.get("pmax", 0) > 1:
        raise ValueError("If you set `multiclass=False` and `preds` are integers, then `preds` should not exceed 1.")
    return stats


def _check_shape_and_type_consistency(
    preds: Tensor, target: Tensor, stats: Dict[str, int]
) -> Tuple[DataType, int]:
    """Deduce the input case from shapes/dtypes."""
    preds_float = preds.is_floating_point()

    if preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        if preds_float and target.numel() > 0 and stats.get("tmax", 0) > 1:
            raise ValueError(
                "If `preds` and `target` are of shape (N, ...) and `preds` are floats, `target` should be binary."
            )
        if preds.ndim == 1 and preds_float:
            case = DataType.BINARY
        elif preds.ndim == 1 and not preds_float:
            case = DataType.MULTICLASS
        elif preds.ndim > 1 and preds_float:
            case = DataType.MULTILABEL
        else:
            case = DataType.MULTIDIM_MULTICLASS
        implied_classes = preds[0].numel() if preds.numel() > 0 else 0

    elif preds.ndim == target.ndim + 1:
        if not preds_float:
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be"
                " (N, C, ...), and the shape of `target` should be (N, ...)."
            )
        implied_classes = preds.shape[1] if preds.numel() > 0 else 0
        case = DataType.MULTICLASS if preds.ndim == 2 else DataType.MULTIDIM_MULTICLASS
    else:
        raise ValueError(
            "Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be (N, ...)"
            " and `preds` should be (N, C, ...)."
        )

    return case, implied_classes


def _check_num_classes_binary(num_classes: int, multiclass: Optional[bool]) -> None:
    if num_classes > 2:
        raise ValueError("Your data is binary, but `num_classes` is larger than 2.")
    if num_classes == 2 and not multiclass:
        raise ValueError(
            "Your data is binary and `num_classes=2`, but `multiclass` is not True."
            " Set it to True if you want to transform binary data to multi-class format."
        )
    if num_classes == 1 and multiclass:
        raise ValueError(
            "You have binary data and have set `multiclass=True`, but `num_classes` is 1."
            " Either set `multiclass=None`(default) or set `num_classes=2`"
            " to transform binary data to multi-class format."
        )


def _check_num_classes_mc(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    multiclass: Optional[bool],
    implied_classes: int,
    stats: Dict[str, int],
) -> None:
    if num_classes == 1 and multiclass is not False:
        raise ValueError(
            "You have set `num_classes=1`, but predictions are integers."
            " If you want to convert (multi-dimensional) multi-class data with 2 classes"
            " to binary/multi-label, set `multiclass=False`."
        )
    if num_classes > 1:
        if multiclass is False and implied_classes != num_classes:
            raise ValueError(
                "You have set `multiclass=False`, but the implied number of classes "
                " (from shape of inputs) does not match `num_classes`."
            )
        if target.numel() > 0 and "tmax" in stats and num_classes <= stats["tmax"]:
            raise ValueError("The highest label in `target` should be smaller than `num_classes`.")
        if preds.shape != target.shape and num_classes != implied_classes:
            raise ValueError("The size of C dimension of `preds` does not match `num_classes`.")


def _check_num_classes_ml(num_classes: int, multiclass: Optional[bool], implied_classes: int) -> None:
    if multiclass and num_classes != 2:
        raise ValueError(
            "Your have set `multiclass=True`, but `num_classes` is not equal to 2."
            " If you are trying to transform multi-label data to 2 class multi-dimensional"
            " multi-class, you should set `num_classes` to either 2 or None."
        )
    if not multiclass and num_classes != implied_classes:
        raise ValueError("The implied number of classes (from shape of inputs) does not match num_classes.")


def _check_top_k(top_k: int, case: str, implied_classes: int, multiclass: Optional[bool], preds_float: bool) -> None:
    if case == DataType.BINARY:
        raise ValueError("You can not use `top_k` parameter with binary data.")
    if not isinstance(top_k, int) or top_k <= 0:
        raise ValueError("The `top_k` has to be an integer larger than 0.")
    if not preds_float:
        raise ValueError("You have set `top_k`, but you do not have probability predictions.")
    if multiclass is False:
        raise ValueError("If you set `multiclass=False`, you can not set `top_k`.")
    if case == DataType.MULTILABEL and multiclass:
        raise ValueError(
            "If you want to transform multi-label data to 2 class multi-dimensional"
            "multi-class data using `multiclass=True`, you can not use `top_k`."
        )
    if top_k >= implied_classes:
        raise ValueError("The `top_k` has to be strictly smaller than the `C` dimension of `preds`.")


def _check_inputs_with_stats(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    num_classes: Optional[int],
    multiclass: Optional[bool],
    top_k: Optional[int],
    ignore_index: Optional[int] = None,
    stats: Optional[Dict[str, int]] = None,
) -> Tuple[DataType, Dict[str, int]]:
    """:func:`_check_classification_inputs`, also returning the value stats
    it read so that a caller needs no second host read. Given ``stats``
    (read from the same values, squeezed or not), it reads nothing."""
    stats = _basic_input_validation(preds, target, threshold, multiclass, ignore_index, stats)
    case, implied_classes = _check_shape_and_type_consistency(preds, target, stats)

    if preds.shape != target.shape:
        if multiclass is False and implied_classes != 2:
            raise ValueError(
                "You have set `multiclass=False`, but have more than 2 classes in your data,"
                " based on the C dimension of `preds`."
            )
        if target.numel() > 0 and "tmax" in stats and stats["tmax"] >= implied_classes:
            raise ValueError(
                "The highest label in `target` should be smaller than the size of the `C` dimension of `preds`."
            )

    if num_classes:
        if case == DataType.BINARY:
            _check_num_classes_binary(num_classes, multiclass)
        elif case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
            _check_num_classes_mc(preds, target, num_classes, multiclass, implied_classes, stats)
        elif case == DataType.MULTILABEL:
            _check_num_classes_ml(num_classes, multiclass, implied_classes)

    if top_k is not None:
        _check_top_k(top_k, case, implied_classes, multiclass, preds.is_floating_point())

    return case, stats


def _check_classification_inputs(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    num_classes: Optional[int],
    multiclass: Optional[bool],
    top_k: Optional[int],
    ignore_index: Optional[int] = None,
) -> DataType:
    """Full input validation; returns the deduced case."""
    case, _ = _check_inputs_with_stats(preds, target, threshold, num_classes, multiclass, top_k, ignore_index)
    return case


def _input_squeeze(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Remove size-1 dims (keeping the batch dim)."""
    if preds.ndim and preds.shape[0] == 1:
        return preds.squeeze().unsqueeze(0), target.squeeze().unsqueeze(0)
    return preds.squeeze(), target.squeeze()


def _score_mode_static(preds: Tensor, target: Tensor) -> DataType:
    """Shape-only mode deduction for float-SCORE inputs (the curve family):
    the ``DataType`` :func:`_input_format_classification` would return,
    from the ranks alone, with no value read."""
    preds, target = _input_squeeze(preds, target)
    if preds.ndim == 1 and target.ndim == 1:
        return DataType.BINARY
    if preds.ndim == 2 and target.ndim == 1:
        return DataType.MULTICLASS
    if preds.ndim == target.ndim and preds.ndim >= 2:
        return DataType.MULTILABEL
    if preds.ndim >= 3 and target.ndim == preds.ndim - 1:
        return DataType.MULTIDIM_MULTICLASS
    raise ValueError(
        f"Could not deduce the classification mode from score shapes {tuple(preds.shape)} / {tuple(target.shape)}"
    )


def _input_format_classification(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
    stats: Optional[Dict[str, int]] = None,
) -> Tuple[Tensor, Tensor, DataType]:
    """Convert every supported input style to canonical int32 binary tensors.

    Returns ``(preds, target, case)`` with preds/target of shape ``(N, C)``
    or ``(N, C, X)``, as ``metrics_tpu``'s function of the same name does.
    ``stats`` are value stats a caller already read from these inputs
    (:func:`_check_inputs_with_stats`); the checks then read nothing.
    """
    preds, target = _input_squeeze(preds, target)

    if preds.dtype in (torch.float16, torch.bfloat16):
        preds = preds.to(torch.float32)

    case, stats = _check_inputs_with_stats(
        preds,
        target,
        threshold=threshold,
        num_classes=num_classes,
        multiclass=multiclass,
        top_k=top_k,
        ignore_index=ignore_index,
        stats=stats,
    )

    if case in (DataType.BINARY, DataType.MULTILABEL) and not top_k:
        preds = (preds >= threshold).to(torch.int32)
        num_classes = num_classes if not multiclass else 2

    if case == DataType.MULTILABEL and top_k:
        preds = select_topk(preds, top_k)

    if case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) or multiclass:
        if preds.is_floating_point():
            num_classes = preds.shape[1]
            preds = select_topk(preds, top_k or 1)
        else:
            if num_classes is None:
                if "pmax" not in stats:
                    raise ValueError(
                        "`num_classes` must be given explicitly when formatting label inputs under capture"
                    )
                # integer predictions reaching here are the caller's own, so
                # the stats read above still describe them
                num_classes = max(stats["pmax"], stats["tmax"]) + 1
            preds = to_onehot(preds, max(2, num_classes))

        target = to_onehot(target, max(2, num_classes))

        if multiclass is False:
            preds, target = preds[:, 1, ...], target[:, 1, ...]

    if not _check_for_empty_tensors(preds, target):
        if (case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) and multiclass is not False) or multiclass:
            target = target.reshape(target.shape[0], target.shape[1], -1)
            preds = preds.reshape(preds.shape[0], preds.shape[1], -1)
        else:
            target = target.reshape(target.shape[0], -1)
            preds = preds.reshape(preds.shape[0], -1)

    # some transformations above create a trailing size-1 dim for MC/binary case
    if preds.ndim > 2 and preds.shape[-1] == 1:
        preds, target = preds.squeeze(-1), target.squeeze(-1)

    return preds.to(torch.int32), target.to(torch.int32), case


# ---------------------------------------------------------------------------
# retrieval input checks
# ---------------------------------------------------------------------------


def _flat(x: Tensor, dtype: torch.dtype) -> Tensor:
    """``x`` as a flat tensor of ``dtype``; the same tensor object when it
    already is one, so metrics fed one batch keep identical state tensors
    (the retrieval pack memo is keyed on identity)."""
    x = x.to(dtype)
    return x if x.ndim == 1 else x.reshape(-1)


def _check_retrieval_target_dtypes(preds: Tensor, target: Tensor) -> None:
    if not (_is_integer(target.dtype) or target.dtype == torch.bool or target.is_floating_point()):
        raise ValueError("`target` must be a tensor of booleans, integers or floats")
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a tensor of floats")


def _read_retrieval_values(checkable: Optional[Tensor], valid: Optional[Tensor]) -> Dict[str, float]:
    """``tmax``/``tmin`` of ``checkable`` and ``any_valid`` of ``valid``
    (each part only when given), in ONE host read; none under the capture
    rule."""
    if checks_read_nothing():
        return {}
    parts: Dict[str, Tensor] = {}
    if checkable is not None:
        parts["tmax"], parts["tmin"] = checkable.max(), checkable.min()
    if valid is not None:
        parts["any_valid"] = valid.any()
    if not parts:
        return {}
    values = torch.stack([v.to(torch.float64) for v in parts.values()]).tolist()
    return dict(zip(parts, values))


def _check_binary(stats: Dict[str, float]) -> None:
    # int() truncates, as the JAX package's int(jnp.max(target)) does
    if int(stats["tmax"]) > 1 or int(stats["tmin"]) < 0:
        raise ValueError("`target` must contain `binary` values")


def _check_retrieval_target_and_prediction_types(
    preds: Tensor, target: Tensor, allow_non_binary_target: bool = False
) -> Tuple[Tensor, Tensor]:
    """Dtype and binary-value checks; float32 preds and float32 (float
    targets) or int32 targets, flattened."""
    _check_retrieval_target_dtypes(preds, target)
    if not allow_non_binary_target:
        stats = _read_retrieval_values(target, None)
        if stats:
            _check_binary(stats)
    target = _flat(target, torch.float32 if target.is_floating_point() else torch.int32)
    return _flat(preds, torch.float32), target


def _check_retrieval_functional_inputs(
    preds: Tensor, target: Tensor, allow_non_binary_target: bool = False
) -> Tuple[Tensor, Tensor]:
    """Inputs of the single-query retrieval functionals."""
    if preds.shape != target.shape:
        raise ValueError("`preds` and `target` must be of the same shape")
    if not preds.numel() or not preds.ndim:
        raise ValueError("`preds` and `target` must be non-empty and non-scalar tensors")
    return _check_retrieval_target_and_prediction_types(preds, target, allow_non_binary_target=allow_non_binary_target)


def _check_retrieval_inputs(
    indexes: Tensor,
    preds: Tensor,
    target: Tensor,
    allow_non_binary_target: bool = False,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Inputs of a retrieval metric's ``exact=True`` update: ``ignore_index``
    rows are filtered out (a data-dependent shape), indexes become int32
    (wrapping int64 ids past 2**31, as the JAX package's ``astype`` does)."""
    if indexes.shape != preds.shape or preds.shape != target.shape:
        raise ValueError("`indexes`, `preds` and `target` must be of the same shape")
    if not _is_integer(indexes.dtype):
        raise ValueError("`indexes` must be a tensor of long integers")
    if ignore_index is not None:
        keep = target != ignore_index
        indexes, preds, target = indexes[keep], preds[keep], target[keep]
    if not indexes.numel() or not indexes.ndim:
        raise ValueError("`indexes`, `preds` and `target` must be non-empty and non-scalar tensors")
    preds, target = _check_retrieval_target_and_prediction_types(
        preds, target, allow_non_binary_target=allow_non_binary_target
    )
    return _flat(indexes, torch.int32), preds, target


def _check_retrieval_inputs_static(
    indexes: Tensor,
    preds: Tensor,
    target: Tensor,
    allow_non_binary_target: bool = False,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Fixed-shape variant for the table-state update: instead of filtering
    ``ignore_index`` rows it returns a ``valid`` mask beside the flattened
    tensors. The value checks (binary target, a batch that ``ignore_index``
    erases completely) share one host read."""
    if indexes.shape != preds.shape or preds.shape != target.shape:
        raise ValueError("`indexes`, `preds` and `target` must be of the same shape")
    if not _is_integer(indexes.dtype):
        raise ValueError("`indexes` must be a tensor of long integers")
    if not indexes.numel() or not indexes.ndim:
        raise ValueError("`indexes`, `preds` and `target` must be non-empty and non-scalar tensors")
    _check_retrieval_target_dtypes(preds, target)
    target = target.reshape(-1)
    valid = (
        torch.ones(target.shape, dtype=torch.bool, device=target.device)
        if ignore_index is None
        else target != ignore_index
    )
    checkable = None
    if not allow_non_binary_target:
        checkable = target if ignore_index is None else torch.where(valid, target, torch.zeros_like(target))
    stats = _read_retrieval_values(checkable, None if ignore_index is None else valid)
    if checkable is not None and stats:
        _check_binary(stats)
    if ignore_index is not None and not stats.get("any_valid", True):
        raise ValueError("`indexes`, `preds` and `target` must be non-empty and non-scalar tensors")
    target = _flat(target, torch.float32 if target.is_floating_point() else torch.int32)
    return _flat(indexes, torch.int32), _flat(preds, torch.float32), target, valid


def _check_retrieval_k(k: Optional[int]) -> None:
    """Shared @k validation for retrieval metrics."""
    if (k is not None) and not (isinstance(k, int) and k > 0):
        raise ValueError("`k` has to be a positive integer or None")
