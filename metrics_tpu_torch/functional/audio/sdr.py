"""SDR / SI-SDR.

Counterpart of ``metrics_tpu/functional/audio/sdr.py``:

- correlation statistics by rFFT (``torch.fft``, one batched transform per
  signal),
- the ``[L, L]`` Toeplitz system assembled by a gather and solved with
  ``torch.linalg.solve_ex`` (``torch.linalg.solve`` reads its error flag
  back to the host on the card, a synchronisation that also breaks graph
  capture), or
- with ``use_cg_iter``, a fixed number of conjugate-gradient iterations
  whose matrix-vector products embed the Toeplitz operator in a 2L
  circulant and multiply in the Fourier domain.

**Precision.** SDR takes float32 signals and returns float32 values, as the
JAX package does with x64 off, but computes the correlation statistics, the
solve and the coherence in float64 and rounds once at the end. In float32
the result drifts from the exact one by more than the rounding of a float32
value: the 2**16-point transforms of a 4-second signal and the solve of an
ill-conditioned Toeplitz system (a voiced source's autocorrelation matrix
at 512 taps has a condition number near 3e5) each add error, and
``coh / (1 - coh)`` magnifies it as the coherence nears 1. The card's
cuFFT and cuSOLVER and the CPU's pocketfft and LAPACK round differently, so
two float32 evaluations disagree by that much; two float64 evaluations
agree to float32 rounding. The JAX package's float32 pipeline sits within
its own float32 error of the port (``ROADMAP.md`` C). No TF32 path touches
float64, so the caller's TF32 flags change no bit.

Dtypes at the boundary are the JAX package's with x64 off: SDR's inputs are
taken as float32 (integer, half-precision and float64 inputs are cast
first) and its values are float32. SI-SDR computes in float32 for
half-precision and float64 inputs too, where the JAX package computes
float16 and bfloat16 inputs in their own dtype with their own epsilon (see
``ROADMAP.md`` C, "float16 sums"); integer estimates raise ``ValueError``,
as the JAX package's ``jnp.finfo`` of an integer dtype does, and the target
takes the estimate's float dtype whatever its own.
"""
from typing import Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import _widen_half, _x64_off

Tensor = torch.Tensor


def _float_inputs(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """``preds`` as float32 (float64, bfloat16 and float16 are cast), the
    dtype the SNR family computes in, and ``target`` in that dtype. Only
    ``preds`` is checked: integer estimates raise, an integer reference is
    promoted, as the JAX package checks ``jnp.finfo(preds.dtype)`` alone."""
    preds = _widen_half(_x64_off(preds))
    if not preds.is_floating_point():
        raise ValueError(f"data type {preds.dtype} not inexact: the SNR family takes floating-point signals")
    return preds, target.to(preds.dtype)


def _l2_normalize(x: Tensor, eps: float) -> Tensor:
    """Scale to unit L2 norm along time (fast_bss_eval helpers._normalize)."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _correlation_stats(target: Tensor, preds: Tensor, length: int) -> Tuple[Tensor, Tensor]:
    """Auto-correlation of target and target-preds cross-correlation, first
    ``length`` lags, via rFFT (fast_bss_eval metrics.compute_stats semantics)."""
    n_fft = _next_pow2(target.shape[-1] + length)
    tf = torch.fft.rfft(target, n=n_fft, dim=-1)
    pf = torch.fft.rfft(preds, n=n_fft, dim=-1)
    acf = torch.fft.irfft(torch.abs(tf) ** 2, n=n_fft, dim=-1)[..., :length]
    xcorr = torch.fft.irfft(torch.conj(tf) * pf, n=n_fft, dim=-1)[..., :length]
    return acf, xcorr


def _toeplitz_solve(acf: Tensor, xcorr: Tensor) -> Tensor:
    """Direct dense solve of ``toeplitz(acf) h = xcorr`` (batched). The
    solve's error flag is not read: a singular system gives non-finite
    values, as the JAX package's ``jnp.linalg.solve`` does."""
    length = acf.shape[-1]
    lags = torch.arange(length, device=acf.device)
    r_mat = acf[..., (lags[:, None] - lags[None, :]).abs()]  # [..., L, L] symmetric Toeplitz
    rhs = xcorr.unsqueeze(-1)
    if acf.device.type == "cpu" and r_mat.dim() > 2:
        # one system at a time: oneMKL's batched LU in CPU builds of PyTorch
        # can hang on systems of 256 x 256 and up once torch.set_num_threads
        # was called; a single system takes the same LAPACK route
        flat_r, flat_rhs = r_mat.reshape(-1, length, length), rhs.reshape(-1, length, 1)
        sol = [torch.linalg.solve_ex(r, b)[0] for r, b in zip(flat_r, flat_rhs)]
        return (torch.stack(sol) if sol else flat_rhs).reshape(xcorr.shape)
    return torch.linalg.solve_ex(r_mat, rhs)[0][..., 0]


def _toeplitz_matvec(acf: Tensor, v: Tensor) -> Tensor:
    """``toeplitz(acf) @ v`` without materializing the matrix: embed the
    symmetric Toeplitz operator in a circulant of size 2L and multiply in
    the Fourier domain."""
    length = acf.shape[-1]
    # first column of the 2L circulant: [acf_0..acf_{L-1}, 0, acf_{L-1}..acf_1]
    circ = torch.cat([acf, torch.zeros_like(acf[..., :1]), torch.flip(acf[..., 1:], dims=(-1,))], dim=-1)
    n = 2 * length
    prod = torch.fft.irfft(torch.fft.rfft(circ, n=n, dim=-1) * torch.fft.rfft(v, n=n, dim=-1), n=n, dim=-1)
    return prod[..., :length]


def _toeplitz_cg(acf: Tensor, xcorr: Tensor, n_iter: int) -> Tensor:
    """Fixed-iteration conjugate gradient on the Toeplitz normal equations
    with the FFT matvec (no data-dependent stopping)."""
    x = torch.zeros_like(xcorr)
    r = xcorr - _toeplitz_matvec(acf, x)
    p = r
    rs = torch.sum(r * r, dim=-1, keepdim=True)
    for _ in range(n_iter):
        ap = _toeplitz_matvec(acf, p)
        alpha = rs / torch.clamp(torch.sum(p * ap, dim=-1, keepdim=True), min=1e-20)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.sum(r * r, dim=-1, keepdim=True)
        p = r + (rs_new / torch.clamp(rs, min=1e-20)) * p
        rs = rs_new
    return x


def _sdr_kernel(
    preds: Tensor,
    target: Tensor,
    use_cg_iter: Optional[int],
    filter_length: int,
    zero_mean: bool,
    load_diag: Optional[float],
) -> Tensor:
    # float32 signals in, float32 values out; float64 in between (see the module's docstring)
    out_dtype = preds.dtype
    eps = torch.finfo(out_dtype).eps
    preds, target = preds.to(torch.float64), target.to(torch.float64)
    if zero_mean:
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)
        target = target - torch.mean(target, dim=-1, keepdim=True)

    preds = _l2_normalize(preds, eps)
    target = _l2_normalize(target, eps)

    acf, xcorr = _correlation_stats(target, preds, filter_length)
    if load_diag is not None:
        diag = float(np.float32(load_diag))  # rounded to float32, as jnp.asarray does
        acf = torch.cat([acf[..., :1] + diag, acf[..., 1:]], dim=-1)

    if use_cg_iter is not None:
        sol = _toeplitz_cg(acf, xcorr, use_cg_iter)
    else:
        sol = _toeplitz_solve(acf, xcorr)

    # coherence = energy of preds captured by the length-L filtered target
    coh = torch.sum(xcorr * sol, dim=-1)
    ratio = coh / (1 - coh)
    return (10.0 * torch.log10(ratio)).to(out_dtype)


def signal_distortion_ratio(
    preds: Tensor,
    target: Tensor,
    use_cg_iter: Optional[int] = None,
    filter_length: int = 512,
    zero_mean: bool = False,
    load_diag: Optional[float] = None,
) -> Tensor:
    """Signal-to-distortion ratio with a length-``filter_length`` allowed
    distortion filter (BSS-eval v4 semantics).

    Args:
        preds: estimate, shape ``[..., time]``.
        target: reference, shape ``[..., time]``.
        use_cg_iter: if given, solve the filter with this many conjugate-
            gradient iterations instead of the dense solve.
        filter_length: allowed distortion-filter length (default 512).
        zero_mean: subtract time-axis means first.
        load_diag: diagonal loading to stabilize near-singular systems.

    Returns:
        SDR in dB, shape ``[...]``, float32.

    Example:
        >>> import torch
        >>> gen = torch.Generator().manual_seed(0)
        >>> target = torch.randn(8000, generator=gen)
        >>> preds = target + 0.1 * torch.randn(8000, generator=gen)
        >>> round(float(signal_distortion_ratio(preds, target)), 1)
        20.3
    """
    _check_same_shape(preds, target)
    preds = _x64_off(preds)
    if not preds.is_floating_point():
        preds = preds.to(torch.float32)
    preds = _widen_half(preds)
    target = target.to(preds.dtype)
    return _sdr_kernel(preds, target, use_cg_iter, filter_length, zero_mean, load_diag)


def scale_invariant_signal_distortion_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SI-SDR: SNR after optimal scalar rescaling of the target.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> scale_invariant_signal_distortion_ratio(preds, target)
        tensor(18.4030)
    """
    _check_same_shape(preds, target)
    preds, target = _float_inputs(preds, target)
    eps = torch.finfo(preds.dtype).eps

    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)

    alpha = (torch.sum(preds * target, dim=-1, keepdim=True) + eps) / (
        torch.sum(target**2, dim=-1, keepdim=True) + eps
    )
    target_scaled = alpha * target
    noise = target_scaled - preds
    val = (torch.sum(target_scaled**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(val)
