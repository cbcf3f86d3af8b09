"""Functional PESQ.

Counterpart of ``metrics_tpu/functional/audio/pesq.py``: the fs/mode checks,
then one score per utterance on the host, from the ``pesq`` C binding when
it is installed and otherwise from the in-repo P.862 engine
(:mod:`metrics_tpu_torch.functional.audio._pesq_engine`, a copy of the JAX
package's). A custom ``pesq_fn(ref, deg, fs, mode) -> float`` can be
injected. The scores reach the device in one copy.
"""
from typing import Callable, Optional, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.audio._pesq_engine import pesq as _engine_pesq
from metrics_tpu_torch.utils.data import _host_float64, _host_to_device, _resolve_device
from metrics_tpu_torch.utils.imports import _PESQ_AVAILABLE

Tensor = torch.Tensor

__all__ = ["perceptual_evaluation_speech_quality"]


def _default_pesq_fn() -> Callable:
    """Scorer used when no ``pesq_fn`` is injected: the external ``pesq`` C
    binding when installed (bit-exact ITU-T conformance), otherwise the
    in-repo P.862 engine so the metric computes with zero dependencies."""
    if _PESQ_AVAILABLE:
        from pesq import pesq as pesq_backend

        return lambda ref, deg, fs, mode: pesq_backend(fs, ref, deg, mode)
    return _engine_pesq


def perceptual_evaluation_speech_quality(
    preds: Tensor,
    target: Tensor,
    fs: int,
    mode: str,
    pesq_fn: Optional[Callable] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """PESQ MOS-LQO per utterance (host-side P.862 DSP, batch preserved).

    Args:
        preds: degraded speech ``[..., time]``.
        target: clean reference speech, same shape.
        fs: sampling frequency -- 8000 (narrow-band) or 16000.
        mode: ``"nb"`` or ``"wb"`` (wide-band requires fs=16000).
        pesq_fn: optional scorer override ``(ref, deg, fs, mode) -> float``.
        device: where the scores go (default: the inputs' device if they are
            tensors, else the card).

    Returns:
        float32 MOS-LQO scores with shape ``preds.shape[:-1]``.

    Example:
        >>> import torch
        >>> t = torch.arange(8000 * 2) / 8000
        >>> clean = torch.sin(2 * torch.pi * 440 * t) * (torch.sin(2 * torch.pi * 2.5 * t) > 0) * 0.1
        >>> noisy = clean + 0.01 * torch.randn(clean.shape, generator=torch.Generator().manual_seed(0))
        >>> score = perceptual_evaluation_speech_quality(noisy, clean, 8000, "nb")
        >>> score.dtype, bool(1.0 <= score <= 4.6)
        (torch.float32, True)
    """
    # validate unconditionally (the default engine re-checks, but a custom
    # scorer must not silently receive an invalid fs/mode combination)
    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
    if mode not in ("nb", "wb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
    if mode == "wb" and fs == 8000:
        raise ValueError("Wide-band PESQ ('wb') requires fs=16000")
    if device is None:
        device = preds.device if isinstance(preds, Tensor) else None
    device = _resolve_device(device)
    scorer = pesq_fn or _default_pesq_fn()
    preds_np = _host_float64(preds)
    target_np = _host_float64(target)
    if preds_np.shape != target_np.shape:
        raise ValueError(
            f"preds and target must have the same shape, got {preds_np.shape} and {target_np.shape}"
        )
    batch_shape = preds_np.shape[:-1]
    preds_np = preds_np.reshape(-1, preds_np.shape[-1])
    target_np = target_np.reshape(-1, target_np.shape[-1])
    scores = np.array([scorer(ref, deg, fs, mode) for ref, deg in zip(target_np, preds_np)], np.float32)
    return _host_to_device(scores, device).reshape(batch_shape)
