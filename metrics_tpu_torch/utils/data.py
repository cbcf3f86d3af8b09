"""Tensor helpers: device placement, dim-zero reducers, one-hot, top-k
selection, collection mapping, query grouping, the float32 ``linspace``
of the JAX package, the safe division, the routed bincount and the payload
sort.

Counterpart of ``metrics_tpu/utils/data.py``. The JAX package runs with
x64 off, so its integer states are int32 and its host floats become
float32; the helpers here keep those dtypes where they are part of a
metric's contract (torch would default to int64 / float64).
"""
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor

#: the floor of a normalised probability in the KL divergence, as the JAX
#: package's
METRIC_EPS = 1e-6

_INT_DTYPES = (torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64)
_SIGNED_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64)


def _resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means the card. A CUDA device without CUDA raises: the port
    never moves to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run metrics_tpu_torch on the CPU"
        )
    return dev


def _as_tensor(x: Any, device: Optional[Union[str, torch.device]] = None) -> Tensor:
    """A tensor stays where it is. Host data (numpy, lists, scalars) goes to
    ``device`` (the card by default); float64 becomes float32, as it does
    in the JAX package with x64 off. Integer arrays keep their width."""
    if isinstance(x, Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr, device=_resolve_device(device))


def _is_integer(dtype: torch.dtype) -> bool:
    return dtype in _INT_DTYPES


def dim_zero_cat(x: Union[Tensor, List[Tensor], Tuple[Tensor, ...]]) -> Tensor:
    """Concatenation along dim 0; accepts a single tensor or a list."""
    if not isinstance(x, (list, tuple)):
        return x
    x = [torch.atleast_1d(el) for el in x]
    if not x:
        raise ValueError("No samples to concatenate")
    return torch.cat(x, dim=0)


def dim_zero_sum(x: Tensor) -> Tensor:
    # integer sums keep their width (torch would widen int32 to int64)
    if x.dtype == torch.bool:
        return torch.sum(x, dim=0, dtype=torch.int32)
    return torch.sum(x, dim=0, dtype=x.dtype if _is_integer(x.dtype) else None)


def dim_zero_mean(x: Tensor) -> Tensor:
    return torch.mean(x if x.is_floating_point() else x.to(torch.float32), dim=0)


def dim_zero_max(x: Tensor) -> Tensor:
    return amax_ieee(x, 0)


def dim_zero_min(x: Tensor) -> Tensor:
    return amin_ieee(x, 0)


# ---------------------------------------------------------------------------
# extremum folds with the JAX package's semantics
# ---------------------------------------------------------------------------
# ``jnp.maximum``/``jnp.max`` propagate NaN and rank +0.0 above -0.0 (so
# max(-0.0, +0.0) is +0.0 in either order, and min is -0.0), while
# ``torch.maximum``/``torch.amax`` keep whichever zero they meet first. Every
# extremum the port folds goes through these helpers. A NaN result is the
# canonical quiet NaN, so the card and the CPU agree bit for bit.


def _extremum_ieee(a: Tensor, b: Tensor, is_max: bool) -> Tensor:
    if not (a.is_floating_point() or b.is_floating_point()):
        return torch.maximum(a, b) if is_max else torch.minimum(a, b)
    a, b = torch.broadcast_tensors(a, b)
    # of two equal values (only the zeros can differ), max keeps the one
    # without the sign bit and min the one with it
    pick_a = ((a > b) if is_max else (a < b)) | ((a == b) & (torch.signbit(a) != is_max))
    out = torch.where(pick_a, a, b)
    return torch.where(torch.isnan(a) | torch.isnan(b), torch.full_like(out, float("nan")), out)


def maximum_ieee(a: Tensor, b: Tensor) -> Tensor:
    """Elementwise max as ``jnp.maximum``: NaN wins, +0.0 over -0.0."""
    return _extremum_ieee(a, b, True)


def minimum_ieee(a: Tensor, b: Tensor) -> Tensor:
    """Elementwise min as ``jnp.minimum``: NaN wins, -0.0 over +0.0."""
    return _extremum_ieee(a, b, False)


def _reduce_extremum_ieee(x: Tensor, dim: Optional[int], is_max: bool) -> Tensor:
    reduce = torch.amax if is_max else torch.amin
    if not x.is_floating_point():
        return reduce(x) if dim is None else reduce(x, dim=dim)
    dims = () if dim is None else (dim,)
    out = reduce(x, dim=dims) if dims else reduce(x)
    # a zero result takes the sign the JAX reduction gives: max is +0.0 if
    # any +0.0 is present, min is -0.0 if any -0.0 is
    wanted = (x == 0) & (torch.signbit(x) != is_max)
    any_wanted = wanted.any(dim=dim) if dim is not None else wanted.any()
    zero = torch.where(any_wanted == is_max, torch.zeros_like(out), torch.full_like(out, -0.0))
    out = torch.where(out == 0, zero, out)
    has_nan = torch.isnan(x).any(dim=dim) if dim is not None else torch.isnan(x).any()
    return torch.where(has_nan, torch.full_like(out, float("nan")), out)


def amax_ieee(x: Tensor, dim: Optional[int] = None) -> Tensor:
    """Max over ``dim`` (all elements for ``None``) as ``jnp.max``."""
    return _reduce_extremum_ieee(x, dim, True)


def amin_ieee(x: Tensor, dim: Optional[int] = None) -> Tensor:
    """Min over ``dim`` (all elements for ``None``) as ``jnp.min``."""
    return _reduce_extremum_ieee(x, dim, False)


def _widen_half(x: Tensor) -> Tensor:
    """Floating values narrower than float32 (bfloat16, float16) as float32,
    anything else unchanged: squared errors are taken and summed in float32,
    as the JAX package does after turning a torch bfloat16 input into
    float32 (its ``torch_to_numpy``)."""
    if x.is_floating_point() and torch.finfo(x.dtype).bits < 32:
        return x.to(torch.float32)
    return x


def _x64_off(x: Tensor) -> Tensor:
    """float64 as float32 and int64 as int32, anything else unchanged: the
    dtypes the JAX package's arrays take with x64 off (``jnp.asarray``).
    Updates that accumulate in their input's dtype round here first, so a
    float64 batch leaves every state float32."""
    if x.dtype == torch.float64:
        return x.to(torch.float32)
    if x.dtype == torch.int64:
        return x.to(torch.int32)
    return x


def _host_to_device(values: np.ndarray, device: torch.device) -> Tensor:
    """``values`` (a host array) on ``device`` after one copy. On the card
    the copy goes from pinned memory without blocking the host, so an
    update that ends in it makes no host sync."""
    out = torch.from_numpy(np.ascontiguousarray(values))
    if device.type == "cuda":
        return out.pin_memory().to(device, non_blocking=True)
    return out.to(device)


def _host_float64(x: Any) -> np.ndarray:
    """A tensor (read back from its device) or a host array as a float64
    numpy array: the host DSP of STOI and PESQ works in float64, as the
    JAX package's does."""
    if isinstance(x, Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _tree_sum(x: Tensor) -> Tensor:
    """Sum over the last axis in a fixed pairwise order (zero padding to a
    power of two, then halving by elementwise adds): each addition is one
    IEEE operation, so the sum has the same bits on every device
    (``torch.sum`` adds in an order that depends on the device)."""
    n = x.shape[-1]
    width = 1
    while width < n:
        width *= 2
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _tie_runs(sorted_x: Tensor) -> Tuple[Tensor, Tensor]:
    """First and last position of the run of equal values that each
    position lies in, along the last axis of ``sorted_x`` (sorted along it);
    NaN is a run of its own, as ``!=`` says."""
    n = sorted_x.shape[-1]
    # int32 positions: half the bytes of the scans (the flagship's midranks)
    pos = torch.arange(n, dtype=torch.int32, device=sorted_x.device).expand(sorted_x.shape)
    change = sorted_x[..., 1:] != sorted_x[..., :-1]
    edge = torch.ones(sorted_x.shape[:-1] + (1,), dtype=torch.bool, device=sorted_x.device)
    start = torch.cummax(torch.where(torch.cat([edge, change], dim=-1), pos, 0), dim=-1).values
    end = torch.cummin(torch.where(torch.cat([change, edge], dim=-1), pos, n - 1).flip(-1), dim=-1).values.flip(-1)
    return start, end


def _scan_fixed(x: Tensor) -> Tensor:
    """Inclusive prefix sums along the last axis in a fixed order (doubling
    steps: ``x[i] += x[i - 2**k]`` for k = 0, 1, ...): each addition is one
    IEEE operation, so the sums have the same bits on every device
    (``torch.cumsum`` scans in an order that depends on the device)."""
    n = x.shape[-1]
    shift = 1
    while shift < n:
        x = torch.cat([x[..., :shift], x[..., shift:] + x[..., :-shift]], dim=-1)
        shift *= 2
    return x


def _total_order_key(x: Tensor) -> Tensor:
    """Integer key whose signed order is IEEE totalOrder of the floats in
    ``x`` (-NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN): the order
    ``lax.top_k`` ranks by, so argmax over the key picks what the JAX
    package's top-1 picks, NaN rows and signed zeros included."""
    if x.dtype == torch.float64:
        bits, flip = x.view(torch.int64), 0x7FFFFFFFFFFFFFFF
    else:
        bits, flip = x.to(torch.float32).view(torch.int32), 0x7FFFFFFF
    return torch.where(bits < 0, bits ^ flip, bits)


def _rank_key(x: Tensor) -> Tensor:
    """A key whose order is IEEE totalOrder of the floats in ``x``, for
    ranking (argmax, top-k): :func:`_total_order_key`'s integer bits, or,
    for a tensor batched by ``torch.func.vmap`` (whose batching of a dtype
    view some torch versions lack), an equivalent float64 key: the value,
    +-0 as +-2**-1074, +-inf as +-1e300 and NaN as +-1e301 by its sign. NaNs
    of one sign then tie (the first index wins) where totalOrder ranks them
    by payload, and a float64 input's +-0 ties with its smallest
    subnormal."""
    if not torch._C._functorch.is_batchedtensor(x):
        return _total_order_key(x)
    wide = x.to(torch.float64)
    sign = torch.where(torch.signbit(wide), -1.0, 1.0).to(torch.float64)
    key = torch.where(wide == 0, sign * 2.0**-1074, wide)
    key = torch.where(torch.isinf(wide), sign * 1e300, key)
    return torch.where(torch.isnan(wide), sign * 1e301, key)


def _refuse_bool_labels(labels: Tensor) -> None:
    """Class labels are integers: a bool tensor of them raises ``TypeError``,
    as the JAX package's one-hot and label table (an ``iota`` in bool) do."""
    if labels.dtype == torch.bool:
        raise TypeError("bool tensors are not class labels: pass integer labels (or 0/1 indicator rows)")


def to_onehot(label_tensor: Tensor, num_classes: Optional[int] = None) -> Tensor:
    """Integer labels ``(N, ...)`` to an int32 one-hot ``(N, C, ...)``.

    Labels outside ``[0, C)`` give an all-zero row, as ``jax.nn.one_hot``
    does (``torch.nn.functional.one_hot`` would raise). Bool labels raise
    ``TypeError``, as ``jax.nn.one_hot`` does."""
    if label_tensor.ndim == 2 and label_tensor.is_floating_point():
        return label_tensor
    _refuse_bool_labels(label_tensor)
    if num_classes is None:
        num_classes = int(label_tensor.max()) + 1
    classes = torch.arange(num_classes, device=label_tensor.device)
    onehot = (label_tensor.unsqueeze(-1) == classes).to(torch.int32)
    return onehot.movedim(-1, 1)


def select_topk(prob_tensor: Tensor, topk: int = 1, dim: int = 1) -> Tensor:
    """Int32 mask of the ``topk`` highest entries along ``dim``; ties go to
    the lower index and floats rank by IEEE totalOrder (``lax.top_k``)."""
    moved = prob_tensor.movedim(dim, -1)
    key = _rank_key(moved) if moved.is_floating_point() else moved
    if topk == 1:
        idx = key.argmax(dim=-1, keepdim=True)  # first maximum
    else:
        idx = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :topk]
    # out of place: ``torch.func.vmap`` batches ``scatter`` but not ``scatter_``
    mask = torch.zeros(moved.shape, dtype=torch.int32, device=moved.device).scatter(-1, idx, 1)
    return mask.movedim(-1, dim)


def to_categorical(tensor: Tensor, argmax_dim: int = 1) -> Tensor:
    """Probabilities/logits to integer labels by argmax (totalOrder, first maximum)."""
    key = _rank_key(tensor) if tensor.is_floating_point() else tensor
    return key.argmax(dim=argmax_dim)


def apply_to_collection(
    data: Any,
    dtype: Union[type, tuple],
    function: Callable,
    *args: Any,
    wrong_dtype: Optional[Union[type, tuple]] = None,
    **kwargs: Any,
) -> Any:
    """Recursively apply ``function`` to all ``dtype`` elements of a collection."""
    elem_type = type(data)
    if isinstance(data, dtype) and (wrong_dtype is None or not isinstance(data, wrong_dtype)):
        return function(data, *args, **kwargs)
    if isinstance(data, Mapping):
        return elem_type(
            {k: apply_to_collection(v, dtype, function, *args, wrong_dtype=wrong_dtype, **kwargs) for k, v in data.items()}
        )
    if isinstance(data, tuple) and hasattr(data, "_fields"):  # namedtuple
        return elem_type(*(apply_to_collection(d, dtype, function, *args, wrong_dtype=wrong_dtype, **kwargs) for d in data))
    if isinstance(data, Sequence) and not isinstance(data, str):
        return elem_type([apply_to_collection(d, dtype, function, *args, wrong_dtype=wrong_dtype, **kwargs) for d in data])
    return data


def get_group_indexes(indexes: Tensor) -> List[Tensor]:
    """Positions grouped by value: one int32 index tensor per distinct id,
    groups in ascending id order, positions in their original order (one
    stable argsort and a split, on the host). The tensors lie on
    ``indexes``' device."""
    ids = indexes.detach().cpu().numpy().reshape(-1)
    order = np.argsort(ids, kind="stable")
    boundaries = np.nonzero(np.diff(ids[order]))[0] + 1
    return [torch.as_tensor(g.astype(np.int32), device=indexes.device) for g in np.split(order, boundaries)]


def linspace_f32(num: int, device: Optional[Union[str, torch.device]] = None) -> Tensor:
    """``num`` evenly spaced float32 values from 0 to 1 (both included), bit
    for bit as the JAX package's ``jnp.linspace(0, 1, num)`` with float32
    gives them: ``i * float32(1 / (num - 1))``, the last value set to 1.
    ``torch.linspace`` rounds otherwise (at ``num = 16`` six of the values
    differ), which would put samples on a bin edge into another bin."""
    if not isinstance(num, int) or num < 1:
        raise ValueError(f"`num` must be a positive int, got {num!r}")
    device = _resolve_device(device)
    if num == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    steps = torch.arange(num - 1, dtype=torch.float32, device=device) * np.float32(1.0 / (num - 1))
    return torch.cat([steps, torch.ones(1, dtype=torch.float32, device=device)])


def _safe_divide(num: Tensor, denom: Tensor) -> Tensor:
    """``num / denom`` with ``denom`` taken as 1 where it is 0."""
    return num / torch.where(denom == 0, 1, denom)


def _bincount(x: Any, minlength: int) -> Tensor:
    """Static-length int32 bincount routed by device: the ``bincount_i32``
    kernel for a CUDA tensor, the plain version for a CPU one. See
    :func:`metrics_tpu_torch.ops.bincount_dispatch` for the input contract.
    Lazy import: this module is imported by nearly every metric."""
    from metrics_tpu_torch.ops import bincount_dispatch

    return bincount_dispatch(x, minlength)


def stable_sort_with_payloads(
    key: Tensor, *payloads: Tensor, descending: bool = False
) -> Tuple[Tensor, ...]:
    """Stable sort of ``key`` along its last axis, carrying ``payloads``
    (same shape) through the same permutation. Descending order is a key
    negation, which is the permutation of ``argsort(-key, stable=True)``;
    it requires a floating or signed-integer key. Returns
    ``(sorted_key, *sorted_payloads)``."""
    if descending and not (key.is_floating_point() or key.dtype in _SIGNED_DTYPES):
        raise ValueError(
            "stable_sort_with_payloads(descending=True) requires a floating or"
            f" signed-integer key (negation-based descending order); got dtype {key.dtype}."
            " Cast unsigned/bool keys to a signed or floating dtype first."
        )
    work_key = -key if descending else key
    sorted_key, order = torch.sort(work_key, dim=-1, stable=True)
    sorted_key = -sorted_key if descending else sorted_key
    return (sorted_key,) + tuple(p.gather(-1, order) for p in payloads)


def _squeeze_if_scalar(data: Any) -> Any:
    """Recursively squeeze single-element tensors to 0-d."""
    return apply_to_collection(data, Tensor, lambda x: x.reshape(()) if x.numel() == 1 else x)
