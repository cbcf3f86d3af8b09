"""Per-row top-k with payloads: the CUDA kernel, its plain version, and the
device-routed entry point.

Counterpart of ``metrics_tpu/ops/topk_pallas.py`` (``row_topk_tiled`` and
its ``row_topk_dispatch`` entry). For ``[R, N]`` float32 ``preds``,
``payload`` and ``valid`` it returns three ``[R, k']`` tensors,
``k' = min(k, N)``: the keys ``where(valid > 0, preds, -inf)`` of each row
in the order of a stable descending sort, and the payload and validity of
the same columns.

The order is that of ``argsort(-key, stable=True)`` (and of the JAX
package's ``_row_topk_jnp``): ties go to the lower column, ``-0.0`` and
``+0.0`` tie, and every NaN key, whatever its sign, sorts after every
number and after ``-inf``, so after the invalid slots too; NaNs keep their
column order. An invalid slot keeps its own payload and validity value.
(The JAX package's interpret-mode ``row_topk_tiled`` breaks its network on
NaN rows; the port follows ``_row_topk_jnp``, which the JAX package
computes on the CPU.)

``rows`` (optional ``[R]`` bool) restricts the work to the rows it sets:
the others come back as ``(-inf, 0, 0)``. The retrieval table passes its
overflowing rows, so that one launch per insert chunk sorts only those,
with no host read to find them.

* :func:`row_topk_f32` -- the kernel (``csrc/row_topk.cu``), CUDA tensors
  only, launches counted under ``row_topk``;
* :func:`row_topk_reference` -- the plain version: a stable sort of an
  integer key that orders as above (the same permutation as
  ``stable_sort_with_payloads(key, ..., descending=True)`` on the CPU,
  and independent of how a device sorts NaN and signed zeros);
* :func:`row_topk` -- routes by device only: CPU tensors take the plain
  version, CUDA tensors the kernel. There is no shape route (the JAX
  package took its kernel only up to 2048 padded columns; this one takes
  any width).
"""
import ctypes
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.ops.build import load
from metrics_tpu_torch.ops.dispatch import check_cuda, launch, on_card
from metrics_tpu_torch.ops.qsketch import next_pow2

Tensor = torch.Tensor

SOURCE = "row_topk.cu"

#: keys one block sorts in shared memory (must match kRun in csrc/bitonic.cuh)
_RUN = 16384

_PTR, _LL = ctypes.c_void_p, ctypes.c_longlong
#: (preds, payload, valid, rows, r, n, k, n_pad, scratch, out_k, out_p, out_v, stream)
_SIGNATURES = {
    "row_topk_f32": [_PTR, _PTR, _PTR, _PTR, _LL, _LL, _LL, _LL, _PTR, _PTR, _PTR, _PTR, _PTR],
}


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    return load(SOURCE, _SIGNATURES)


def _check_args(preds: Tensor, payload: Tensor, valid: Tensor, k: int, rows: Optional[Tensor]) -> None:
    if not isinstance(k, int) or isinstance(k, bool) or k <= 0:
        raise ValueError(f"`k` must be a positive int, got {k!r}")
    if preds.ndim != 2:
        raise ValueError(f"`preds` must be [rows, cols], got shape {tuple(preds.shape)}")
    if payload.shape != preds.shape or valid.shape != preds.shape:
        raise ValueError(
            f"`preds`, `payload` and `valid` must have one shape, got {tuple(preds.shape)},"
            f" {tuple(payload.shape)} and {tuple(valid.shape)}"
        )
    if rows is not None and (rows.dtype != torch.bool or tuple(rows.shape) != (preds.shape[0],)):
        raise ValueError(f"`rows` must be a [{preds.shape[0]}] bool mask, got {rows.dtype} {tuple(rows.shape)}")


def _empty_outputs(r: int, kk: int, device: torch.device) -> Tuple[Tensor, Tensor, Tensor]:
    return (
        torch.full((r, kk), -torch.inf, dtype=torch.float32, device=device),
        torch.zeros((r, kk), dtype=torch.float32, device=device),
        torch.zeros((r, kk), dtype=torch.float32, device=device),
    )


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def row_topk_f32(
    preds: Tensor, payload: Tensor, valid: Tensor, k: int, rows: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-row top-``k`` of float32 ``[R, N]`` card tensors (see the module
    docstring); rows not set in ``rows`` give ``(-inf, 0, 0)``."""
    check_cuda("row_topk_f32", preds, payload, valid, *(() if rows is None else (rows,)))
    _check_args(preds, payload, valid, k, rows)
    for name, x in (("preds", preds), ("payload", payload), ("valid", valid)):
        if x.dtype != torch.float32:
            raise TypeError(f"row_topk_f32 takes float32 `{name}`, got {x.dtype}")
    r, n = preds.shape
    kk = min(k, n)
    out_k, out_p, out_v = (torch.empty((r, kk), dtype=torch.float32, device=preds.device) for _ in range(3))
    if r == 0 or kk == 0:  # nothing to select: no launch
        return out_k, out_p, out_v
    preds, payload, valid = preds.contiguous(), payload.contiguous(), valid.contiguous()
    mask = None if rows is None else rows.contiguous()
    n_pad = next_pow2(max(n, 2))
    scratch = torch.empty((r, n_pad), dtype=torch.int64, device=preds.device) if n_pad > _RUN else None
    lib = load_library()
    launch(
        "row_topk",
        lib,
        preds.device,
        lib.row_topk_f32,
        preds.data_ptr(),
        payload.data_ptr(),
        valid.data_ptr(),
        None if mask is None else mask.data_ptr(),
        r,
        n,
        kk,
        n_pad,
        None if scratch is None else scratch.data_ptr(),
        out_k.data_ptr(),
        out_p.data_ptr(),
        out_v.data_ptr(),
    )
    return out_k, out_p, out_v


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def descending_order_key(keys: Tensor) -> Tensor:
    """int64 key whose ascending order is the descending order of the float32
    ``keys`` as ``argsort(-keys, stable=True)`` sees it: ``-0.0`` equals
    ``+0.0`` and every NaN equals every other and follows ``-inf``."""
    bits = torch.where(keys == 0, torch.zeros_like(keys), keys).view(torch.int32).to(torch.int64)
    ascending = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)  # signed order of the floats
    return torch.where(torch.isnan(keys), torch.full_like(ascending, 2**31), -ascending)


def row_topk_reference(
    preds: Tensor, payload: Tensor, valid: Tensor, k: int, rows: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """The kernel's plain version, on any device: a stable sort of each
    row's :func:`descending_order_key` carries keys, payload and validity,
    then the first ``min(k, N)`` columns. With ``rows``, only the rows it
    sets are sorted (gathered, sorted, scattered back; this reads the mask
    on the host) and the others give ``(-inf, 0, 0)``."""
    _check_args(preds, payload, valid, k, rows)
    preds, payload, valid = (x.to(torch.float32) for x in (preds, payload, valid))
    r, n = preds.shape
    kk = min(k, n)
    if rows is not None:
        out = _empty_outputs(r, kk, preds.device)
        active = rows.nonzero()[:, 0]
        if active.numel():
            top = row_topk_reference(preds[active], payload[active], valid[active], kk)
            for whole, part in zip(out, top):
                whole[active] = part
        return out
    keys = torch.where(valid > 0, preds, -torch.inf)
    order = torch.sort(descending_order_key(keys), dim=-1, stable=True).indices[:, :kk]
    return keys.gather(-1, order), payload.gather(-1, order), valid.gather(-1, order)


# ---------------------------------------------------------------------------
# device-routed entry point
# ---------------------------------------------------------------------------


def row_topk(
    preds: Tensor, payload: Tensor, valid: Tensor, k: int, rows: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-row top-``k`` with payload and validity (see the module
    docstring): the kernel for CUDA tensors (float32; other dtypes raise),
    the plain version for CPU tensors."""
    if not on_card(preds, payload, valid, *(() if rows is None else (rows,))):
        return row_topk_reference(preds, payload, valid, k, rows)
    return row_topk_f32(preds, payload, valid, k, rows)
