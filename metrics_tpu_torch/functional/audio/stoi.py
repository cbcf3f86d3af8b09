"""Short-Time Objective Intelligibility (STOI / extended STOI).

Counterpart of ``metrics_tpu/functional/audio/stoi.py``, the published
algorithm (Taal et al. 2011; eSTOI: Jensen & Taal 2016):

1. resample both signals to 10 kHz (host, ``scipy.signal.resample_poly``);
2. remove silent frames (256-sample Hann frames, 50% overlap, 40 dB below
   the loudest frame, pystoi's exclusive frame count; host: the length
   depends on the data);
3. STFT magnitudes (256-sample frames, 512-point FFT), 15 one-third-octave
   bands from 150 Hz;
4. 30-frame sliding segments; STOI: per-band scale and clip, then the
   band-row correlation; eSTOI: row and column normalisation and the
   spectrogram correlation;
5. the average over segments (and bands).

Steps 3-5 run on the device in float32, the JAX package's dtype with x64
off. The segment count is rounded up to a multiple of 32 and the segments
past the real count are masked out, so the sums see the padded shapes of
the JAX package's kernel. The utterances of a call that share that rounded
count run as one batch, and all of them reach the device in one copy. The
band sums are masked sums over the 0/1 band matrix, not a matrix product,
so the caller's TF32 flags change no bit.
"""
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.utils.data import _host_float64, _host_to_device, _resolve_device

Tensor = torch.Tensor

_FS = 10000  # internal rate
_N_FRAME = 256
_NFFT = 512
_NUM_BANDS = 15
_MIN_FREQ = 150.0
_SEG_LEN = 30  # frames per intelligibility segment
_BETA = -15.0  # clipping threshold (dB)
_DYN_RANGE = 40.0  # silent-frame energy range (dB)
_EPS = np.finfo(np.float64).eps
_BUCKET = 32  # segment counts are rounded up to a multiple of this


def _hann(n: int) -> np.ndarray:
    """Periodic-style Hann used by the STOI reference code: hanning(n+2)[1:-1]."""
    return np.hanning(n + 2)[1:-1]


def _third_octave_matrix(fs: int, nfft: int, num_bands: int, min_freq: float) -> np.ndarray:
    """[num_bands, nfft//2+1] 0/1 matrix mapping FFT bins to 1/3-octave bands."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=np.float64)
    center = min_freq * 2 ** (k / 3)
    lo = center * 2 ** (-1 / 6)
    hi = center * 2 ** (1 / 6)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo_idx = np.argmin((f - lo[i]) ** 2)
        hi_idx = np.argmin((f - hi[i]) ** 2)
        obm[i, lo_idx:hi_idx] = 1
    return obm


def _resample(x: np.ndarray, fs_in: int, fs_out: int) -> np.ndarray:
    if fs_in == fs_out:
        return x
    from scipy.signal import resample_poly

    g = np.gcd(int(fs_in), int(fs_out))
    return resample_poly(x, fs_out // g, fs_in // g)


def _remove_silent_frames(
    x: np.ndarray, y: np.ndarray, dyn_range: float, framelen: int, hop: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Drop frames of x more than ``dyn_range`` dB below its loudest frame,
    rebuilding both signals by windowed overlap-add (host: output length is
    data-dependent)."""
    window = _hann(framelen)
    # pystoi's exclusive range(0, len - framelen, hop): the frame starting
    # exactly at len - framelen is dropped
    n_frames = max(-(-(len(x) - framelen) // hop), 0) if len(x) > framelen else 0
    if n_frames == 0:
        return x, y
    idx = np.arange(framelen)[None, :] + hop * np.arange(n_frames)[:, None]
    x_frames = window * x[idx]
    y_frames = window * y[idx]

    energies = 20 * np.log10(np.linalg.norm(x_frames, axis=1) + _EPS)
    keep = (np.max(energies) - dyn_range - energies) < 0
    x_frames, y_frames = x_frames[keep], y_frames[keep]

    n_kept = len(x_frames)
    out_len = (n_kept - 1) * hop + framelen if n_kept else 0
    x_out = np.zeros(out_len)
    y_out = np.zeros(out_len)
    for i in range(n_kept):  # overlap-add
        sl = slice(i * hop, i * hop + framelen)
        x_out[sl] += x_frames[i]
        y_out[sl] += y_frames[i]
    return x_out, y_out


def _prepare(preds: np.ndarray, target: np.ndarray, fs: int) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """One utterance's host part: ``(x, y, bucket, num_segments)``, the
    clean and degraded signals at 10 kHz without their silent frames,
    zero-padded to the frames of ``bucket`` segments."""
    x = _resample(target, fs, _FS)  # clean
    y = _resample(preds, fs, _FS)  # degraded
    x, y = _remove_silent_frames(x, y, _DYN_RANGE, _N_FRAME, _N_FRAME // 2)

    hop = _N_FRAME // 2
    # exclusive frame count (pystoi convention, see _remove_silent_frames)
    n_frames = max(-(-(len(x) - _N_FRAME) // hop), 0) if len(x) > _N_FRAME else 0
    num_segments = n_frames - _SEG_LEN + 1
    if num_segments < 1:
        raise ValueError(
            "Not enough non-silent signal for STOI: need more than"
            f" {_SEG_LEN * hop + _N_FRAME} samples at {_FS} Hz after silent-frame removal"
        )
    # bucket the segment count, as the JAX package does for its compilations
    bucket = -(-num_segments // _BUCKET) * _BUCKET
    needed = (bucket + _SEG_LEN - 2) * hop + _N_FRAME
    # the frames of ``bucket`` segments read exactly ``needed`` samples
    x = np.pad(x, (0, max(0, needed - len(x))))[:needed]
    y = np.pad(y, (0, max(0, needed - len(y))))[:needed]
    return x, y, bucket, num_segments


def _stoi_kernel(
    x: Tensor, y: Tensor, obm: Tensor, window: Tensor, num_segments: int, extended: bool, n_valid: Tensor
) -> Tensor:
    """Band spectrograms -> sliding segments -> correlation for ``[U, n]``
    utterances that share the rounded segment count ``num_segments``;
    segments past each row's ``n_valid`` are masked out of its average."""
    n_frames = num_segments + _SEG_LEN - 1
    dev = x.device
    idx = torch.arange(_N_FRAME, device=dev)[None, :] + (_N_FRAME // 2) * torch.arange(n_frames, device=dev)[:, None]
    x_spec = torch.abs(torch.fft.rfft(x[:, idx] * window, n=_NFFT, dim=-1))  # [U, M, F]
    y_spec = torch.abs(torch.fft.rfft(y[:, idx] * window, n=_NFFT, dim=-1))

    # obm @ spec.T**2 as a masked sum over the 0/1 band matrix: [U, bands, M]
    x_tob = torch.sqrt(torch.sum(obm[None, :, None, :] * (x_spec**2)[:, None, :, :], dim=-1))
    y_tob = torch.sqrt(torch.sum(obm[None, :, None, :] * (y_spec**2)[:, None, :, :], dim=-1))

    seg_idx = torch.arange(_SEG_LEN, device=dev)[None, :] + torch.arange(num_segments, device=dev)[:, None]
    x_seg = torch.movedim(x_tob[:, :, seg_idx], 2, 1)  # [U, segments, bands, SEG_LEN]
    y_seg = torch.movedim(y_tob[:, :, seg_idx], 2, 1)
    seg_mask = torch.arange(num_segments, device=dev)[None, :] < n_valid[:, None]  # [U, segments]

    if extended:

        def _row_col_normalize(seg: Tensor) -> Tensor:
            seg = seg - seg.mean(dim=-1, keepdim=True)
            seg = seg / (torch.linalg.vector_norm(seg, dim=-1, keepdim=True) + _EPS)
            seg = seg - seg.mean(dim=-2, keepdim=True)
            return seg / (torch.linalg.vector_norm(seg, dim=-2, keepdim=True) + _EPS)

        x_n = _row_col_normalize(x_seg)
        y_n = _row_col_normalize(y_seg)
        per_seg = torch.sum(x_n * y_n / _SEG_LEN, dim=(2, 3))
        return torch.sum(per_seg * seg_mask, dim=1) / n_valid

    # per band-row scaling of the degraded segment + clipping
    alpha = torch.sqrt(
        torch.sum(x_seg**2, dim=-1, keepdim=True) / (torch.sum(y_seg**2, dim=-1, keepdim=True) + _EPS)
    )
    y_scaled = alpha * y_seg
    y_prime = torch.minimum(y_scaled, x_seg * (1 + 10 ** (-_BETA / 20)))

    xn = x_seg - x_seg.mean(dim=-1, keepdim=True)
    yn = y_prime - y_prime.mean(dim=-1, keepdim=True)
    corr = torch.sum(xn * yn, dim=-1) / (
        torch.linalg.vector_norm(xn, dim=-1) * torch.linalg.vector_norm(yn, dim=-1) + _EPS
    )
    return torch.sum(corr * seg_mask[:, :, None], dim=(1, 2)) / (n_valid * corr.shape[2])


def short_time_objective_intelligibility(
    preds: Tensor,
    target: Tensor,
    fs: int,
    extended: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """STOI of a degraded signal vs its clean reference (about [0, 1],
    higher is more intelligible; eSTOI may go slightly negative).

    ``preds``/``target`` are 1-D waveforms (or ``[..., time]`` batches)
    at sample rate ``fs``; the result has shape ``preds.shape[:-1]``,
    float32, on ``device`` (default: the inputs' device if they are
    tensors, else the card).

    Example:
        >>> import torch
        >>> t = torch.arange(16000) / 16000
        >>> target = torch.sin(2 * torch.pi * 440 * t) * (torch.sin(2 * torch.pi * 3 * t) > 0)
        >>> preds = target + 0.1 * torch.randn(16000, generator=torch.Generator().manual_seed(0))
        >>> stoi = short_time_objective_intelligibility(preds, target, 16000)
        >>> bool(0.5 < stoi < 1.0)
        True
    """
    if device is None:
        device = preds.device if isinstance(preds, Tensor) else None
    device = _resolve_device(device)
    preds_np = _host_float64(preds)
    target_np = _host_float64(target)
    if preds_np.shape != target_np.shape:
        raise ValueError("preds and target must have the same shape")
    batch_shape = preds_np.shape[:-1]
    flat = [
        _prepare(p, t, fs)
        for p, t in zip(preds_np.reshape(-1, preds_np.shape[-1]), target_np.reshape(-1, target_np.shape[-1]))
    ]
    # utterances that share a rounded segment count run as one batch
    groups: Dict[int, List[int]] = {}
    for i, (_, _, bucket, _) in enumerate(flat):
        groups.setdefault(bucket, []).append(i)
    order = [i for members in groups.values() for i in members]
    n_utt = len(flat)

    # one copy: the segment counts and the inverse order, the band matrix,
    # the window and every utterance's clean and degraded signals (grouped)
    obm = _third_octave_matrix(_FS, _NFFT, _NUM_BANDS, _MIN_FREQ)
    head = [
        np.asarray([flat[i][3] for i in order], np.float64),
        np.argsort(order).astype(np.float64),
        obm.reshape(-1),
        _hann(_N_FRAME),
    ]
    packed = np.concatenate(head + [np.concatenate(flat[i][:2]) for i in order]).astype(np.float32)
    buf = _host_to_device(packed, device)
    n_valid = buf[:n_utt]
    inverse = buf[n_utt : 2 * n_utt].to(torch.int64)
    at = 2 * n_utt
    obm_dev = buf[at : at + obm.size].reshape(obm.shape)
    at += obm.size
    window = buf[at : at + _N_FRAME]
    at += _N_FRAME

    values = []
    done = 0
    for bucket, members in groups.items():
        n = len(flat[members[0]][0])
        block = buf[at : at + len(members) * 2 * n].reshape(len(members), 2, n)
        at += len(members) * 2 * n
        values.append(_stoi_kernel(block[:, 0], block[:, 1], obm_dev, window, bucket, extended, n_valid[done : done + len(members)]))
        done += len(members)
    return torch.cat(values)[inverse].reshape(batch_shape)
