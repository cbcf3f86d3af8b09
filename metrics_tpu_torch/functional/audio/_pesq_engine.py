"""In-repo ITU-T P.862 (PESQ) engine -- host-side numpy DSP.

A copy of ``metrics_tpu/functional/audio/_pesq_engine.py`` (the port
imports nothing of the JAX package), so both packages score an utterance
with the same numpy operations and the same bits. It implements the P.862
pipeline so the metric computes without the external ``pesq`` binding:

1.  **Level alignment** — both signals are scaled so their 350–3250 Hz
    band-filtered power equals the P.862 target level (1e7 in the 16-bit
    internal domain).
2.  **Input filtering** — narrow-band mode applies the standard IRS receive
    characteristic (piecewise log-frequency gain curve, applied in the FFT
    domain); wide-band mode applies the P.862.2 100 Hz high-pass only.
3.  **Time alignment** — crude delay from the cross-correlation of 4 ms
    log-energy envelopes, refined per detected utterance by a windowed
    full-band cross-correlation (handles constant and piecewise-constant
    delay; sample-level jitter within an utterance is not re-split).
4.  **Perceptual model** — Hann-windowed 32 ms frames with 50 % overlap,
    power spectra binned into Bark bands, partial frequency compensation of
    the reference and short-term gain compensation of the degraded signal,
    Zwicker-law loudness mapping above a frequency-dependent hearing
    threshold.
5.  **Disturbance aggregation** — per-frame symmetric (L2 over bands) and
    asymmetric (L1 over bands, asymmetry factor with the P.862 3/12 clamps)
    disturbances, deadzone of 0.25·min(loudness), L6-within / L2-across
    320 ms chunks, silent-frame down-weighting, raw score
    ``4.5 − 0.1·D − 0.0309·DA`` and the P.862.1 (NB) / P.862.2 (WB)
    MOS-LQO mappings.

Parity note: the algorithmic structure, constants, and mappings above follow
the published P.862 family of recommendations. The Bark band layout and the
absolute hearing threshold are DERIVED from the published psychoacoustic
formulas (Zwicker band-rate transform, Terhardt threshold) rather than
transcribed from the ITU reference tables, so scores track the official
implementation closely but are not guaranteed bit-exact; the gated test in
``tests/audio/test_pesq_engine.py`` asserts agreement against the ``pesq``
binding wherever that package is installed.
"""
from typing import Tuple

import numpy as np

_EPS = 1e-12

# P.862 internal domain: inputs in [-1, 1] are scaled to 16-bit, then level-
# aligned so the band-filtered power hits TARGET_POWER (≈ −20 dBFS RMS),
# which the model equates with a 79 dB SPL listening level.
_TARGET_POWER = 1e7
_LISTENING_LEVEL_DB = 79.0

# standard IRS receive characteristic (frequency Hz -> gain dB), applied in
# narrow-band mode to both signals; piecewise-linear in log-frequency
_IRS_FREQ_HZ = np.array(
    [0.0, 50.0, 100.0, 125.0, 160.0, 200.0, 250.0, 300.0, 350.0, 400.0, 500.0,
     600.0, 700.0, 800.0, 1000.0, 1300.0, 1600.0, 2000.0, 2500.0, 3000.0,
     3250.0, 3500.0, 4000.0, 5000.0, 6300.0, 8000.0]
)
_IRS_GAIN_DB = np.array(
    [-200.0, -40.0, -20.0, -12.0, -6.0, 0.0, 4.0, 6.0, 8.0, 10.0, 11.0,
     12.0, 12.0, 12.0, 12.0, 12.0, 12.0, 12.0, 12.0, 12.0,
     12.0, 4.0, -200.0, -200.0, -200.0, -200.0]
)


def _bark(f_hz: np.ndarray) -> np.ndarray:
    """Zwicker critical-band rate transform (Hz -> Bark)."""
    f = np.asarray(f_hz, np.float64)
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _hearing_threshold_db(f_hz: np.ndarray) -> np.ndarray:
    """Terhardt absolute threshold of hearing (dB SPL)."""
    f_khz = np.maximum(np.asarray(f_hz, np.float64), 20.0) / 1000.0
    return (
        3.64 * f_khz ** -0.8
        - 6.5 * np.exp(-0.6 * (f_khz - 3.3) ** 2)
        + 1e-3 * f_khz ** 4
    )


def _frame_params(fs: int) -> Tuple[int, int, int]:
    """(frame length, hop, number of Bark bands) — 32 ms Hann frames with
    50% overlap (256/128 samples at 8 kHz, 512/256 at 16 kHz), the P.862
    frame grid; 20-frame disturbance chunks then span 320 ms."""
    if fs == 8000:
        return 256, 128, 42
    return 512, 256, 49


def _band_edges(fs: int, n_fft: int, n_bands: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """FFT-bin -> Bark-band layout: (bin band index, band centre Hz, band width Bark).

    Bands are uniform on the Bark axis between 100 Hz and the model bandwidth
    (4 kHz narrow-band domain, 8 kHz wide-band domain) — the formula-derived
    counterpart of the ITU band tables (42/49 bands, see module docstring).
    """
    f_max = min(fs / 2.0, 8000.0) if n_bands == 49 else min(fs / 2.0, 4000.0)
    z_lo, z_hi = _bark(100.0), _bark(f_max)
    edges_z = np.linspace(z_lo, z_hi, n_bands + 1)
    freqs = np.fft.rfftfreq(n_fft, 1.0 / fs)
    z = _bark(freqs)
    band_of_bin = np.searchsorted(edges_z, z, side="right") - 1
    band_of_bin[(z < z_lo) | (z >= z_hi)] = -1
    centre_z = 0.5 * (edges_z[:-1] + edges_z[1:])
    # invert the Bark transform numerically for the band centre frequencies
    grid_f = np.linspace(20.0, fs / 2.0, 4096)
    centre_hz = np.interp(centre_z, _bark(grid_f), grid_f)
    width_z = np.diff(edges_z)
    return band_of_bin, centre_hz, width_z


def _stft_power(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """[frames, bins] Hann-windowed power spectra."""
    n_frames = max((len(x) - n_fft) // hop + 1, 0)
    if n_frames == 0:
        return np.zeros((0, n_fft // 2 + 1))
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    window = np.hanning(n_fft)
    spec = np.fft.rfft(x[idx] * window, axis=1)
    # normalize so a full-scale tone's band power matches its time power
    return (np.abs(spec) ** 2) / (np.sum(window ** 2) / 2.0) / (n_fft / 2.0)


def _band_powers(power_spec: np.ndarray, band_of_bin: np.ndarray, n_bands: int) -> np.ndarray:
    """[frames, bands] mean bin power per Bark band."""
    out = np.zeros((power_spec.shape[0], n_bands))
    counts = np.zeros(n_bands)
    for b in range(n_bands):
        sel = band_of_bin == b
        counts[b] = max(int(sel.sum()), 1)
        out[:, b] = power_spec[:, sel].sum(axis=1)
    return out / counts


def _fft_filter(x: np.ndarray, fs: int, freqs_hz: np.ndarray, gains_db: np.ndarray) -> np.ndarray:
    """Zero-phase FFT-domain filter with a piecewise response (log-f interp)."""
    n = len(x)
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(n, 1.0 / fs)
    log_f = np.log10(np.maximum(f, 1.0))
    gain_db = np.interp(log_f, np.log10(np.maximum(freqs_hz, 1.0)), gains_db)
    spec *= 10.0 ** (gain_db / 20.0)
    return np.fft.irfft(spec, n=n)


def _bandpass_power(x: np.ndarray, fs: int, lo: float = 350.0, hi: float = 3250.0) -> float:
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(len(x), 1.0 / fs)
    band = (f >= lo) & (f <= hi)
    return float(np.sum(np.abs(spec[band]) ** 2) / (len(x) ** 2) * 2.0)


def _level_align(x: np.ndarray, fs: int) -> np.ndarray:
    power = _bandpass_power(x, fs)
    return x * np.sqrt(_TARGET_POWER / max(power, _EPS))


# ---------------------------------------------------------------------------
# time alignment
# ---------------------------------------------------------------------------


def _log_envelope(x: np.ndarray, sub: int) -> np.ndarray:
    n = len(x) // sub
    frames = x[: n * sub].reshape(n, sub)
    return np.log10(np.maximum(np.sum(frames ** 2, axis=1), 1.0))


def _crude_delay(ref: np.ndarray, deg: np.ndarray, fs: int) -> int:
    """Whole-file delay estimate (samples) from 4 ms log-energy envelopes."""
    sub = fs // 250  # 4 ms subframes
    er = _log_envelope(ref, sub)
    ed = _log_envelope(deg, sub)
    er = er - er.mean()
    ed = ed - ed.mean()
    corr = np.correlate(ed, er, mode="full")
    return (int(np.argmax(np.abs(corr))) - (len(er) - 1)) * sub


def _utterances(ref: np.ndarray, fs: int) -> list:
    """Active (start, end) sample ranges: VAD on the 4 ms envelope with
    200 ms gap joining and a 300 ms minimum utterance length."""
    sub = fs // 250
    env = _log_envelope(ref, sub)
    threshold = env.max() - 3.0  # 30 dB below peak energy
    active = env > threshold
    join = int(0.2 * 250)  # 200 ms in subframes
    min_len = int(0.3 * 250)
    spans, start = [], None
    gap = 0
    for i, a in enumerate(active):
        if a:
            if start is None:
                start = i
            gap = 0
        elif start is not None:
            gap += 1
            if gap > join:
                spans.append((start, i - gap + 1))
                start, gap = None, 0
    if start is not None:
        spans.append((start, len(active)))
    spans = [(s * sub, e * sub) for s, e in spans if e - s >= min_len]
    return spans or [(0, len(ref))]


def _fine_delay(ref_seg: np.ndarray, deg: np.ndarray, seg_start: int, crude: int, fs: int) -> int:
    """Refine the delay for one utterance: windowed cross-correlation of the
    raw waveforms around the crude estimate (±25 ms)."""
    radius = fs // 40
    lo = seg_start + crude - radius
    hi = seg_start + crude + len(ref_seg) + radius
    window = _shifted(deg, 0, lo, hi)
    corr = np.correlate(window, ref_seg, mode="valid")
    return crude - radius + int(np.argmax(np.abs(corr)))


def _shifted(deg: np.ndarray, delay: int, start: int, end: int) -> np.ndarray:
    """``deg[start+delay : end+delay]`` zero-padded where outside the file.

    Both slice bounds are clamped into ``[0, len(deg)]`` — a negative stop
    must not re-index from the file end — so the result always has exactly
    ``end - start`` samples even when the window lies entirely outside.
    """
    n = end - start
    src_lo, src_hi = start + delay, end + delay
    lo = min(max(src_lo, 0), len(deg))
    hi = min(max(src_hi, lo), len(deg))
    core = deg[lo:hi]
    pad_lo = min(max(0, -src_lo), n)
    return np.pad(core, (pad_lo, n - pad_lo - len(core)))


def _align(ref: np.ndarray, deg: np.ndarray, fs: int) -> np.ndarray:
    """Return the degraded signal re-timed onto the reference's clock.

    Crude whole-file delay everywhere as the baseline (so inter-utterance
    regions stay aligned rather than zero-filled), refined per detected
    utterance.
    """
    crude = _crude_delay(ref, deg, fs)
    aligned = _shifted(deg, crude, 0, len(ref))
    for start, end in _utterances(ref, fs):
        delay = _fine_delay(ref[start:end], deg, start, crude, fs)
        aligned[start:end] = _shifted(deg, delay, start, end)
    return aligned


# ---------------------------------------------------------------------------
# perceptual model
# ---------------------------------------------------------------------------


def _loudness(band_power: np.ndarray, threshold: np.ndarray) -> np.ndarray:
    """Zwicker-law specific loudness per Bark band (P.862 §10.2.2.5 form)."""
    gamma = 0.23
    ratio = band_power / threshold
    loud = (threshold / 0.5) ** gamma * ((0.5 + 0.5 * ratio) ** gamma - 1.0)
    return np.where(band_power > threshold, loud, 0.0)


def _raw_pesq(ref: np.ndarray, deg: np.ndarray, fs: int, mode: str) -> float:
    n_fft, hop, n_bands = _frame_params(fs)
    band_of_bin, centre_hz, width_z = _band_edges(fs, n_fft, n_bands)

    # hearing threshold in internal power units: TARGET_POWER <-> 79 dB SPL
    thr_db = _hearing_threshold_db(centre_hz)
    threshold = _TARGET_POWER * 10.0 ** ((thr_db - _LISTENING_LEVEL_DB) / 10.0)

    ref_bp = _band_powers(_stft_power(ref, n_fft, hop), band_of_bin, n_bands)
    deg_bp = _band_powers(_stft_power(deg, n_fft, hop), band_of_bin, n_bands)
    n_frames = min(len(ref_bp), len(deg_bp))
    if n_frames == 0:
        raise ValueError(f"Signals too short for PESQ: need at least {n_fft} samples, got {len(ref)}")
    ref_bp, deg_bp = ref_bp[:n_frames], deg_bp[:n_frames]

    # partial frequency compensation: move the REFERENCE through the system's
    # linear response, estimated from speech-active frames, clipped to ±20 dB
    active = ref_bp.sum(axis=1) > 1e4
    if not active.any():
        active = np.ones(n_frames, bool)
    band_ratio = (deg_bp[active].mean(axis=0) + 1e3) / (ref_bp[active].mean(axis=0) + 1e3)
    ref_eq = ref_bp * np.clip(band_ratio, 0.01, 100.0)

    # short-term gain compensation of the degraded signal (smoothed frame
    # audible-power ratio, clipped to [3e-4, 5])
    aud_ref = np.sum(np.maximum(ref_eq - threshold, 0.0), axis=1)
    aud_deg = np.sum(np.maximum(deg_bp - threshold, 0.0), axis=1)
    gain = (aud_ref + 5e3) / (aud_deg + 5e3)
    smoothed = np.empty_like(gain)
    prev = 1.0
    for i, g in enumerate(gain):  # first-order smoothing, P.862 β = 0.8
        prev = 0.8 * prev + 0.2 * g
        smoothed[i] = prev
    deg_eq = deg_bp * np.clip(smoothed, 3e-4, 5.0)[:, None]

    loud_ref = _loudness(ref_eq, threshold)
    loud_deg = _loudness(deg_eq, threshold)

    # disturbance with 0.25·min deadzone
    diff = loud_deg - loud_ref
    dead = 0.25 * np.minimum(loud_deg, loud_ref)
    disturbance = np.sign(diff) * np.maximum(np.abs(diff) - dead, 0.0)

    # asymmetry factor: additive distortions count, removals mostly don't
    asym = ((deg_eq + 50.0) / (ref_eq + 50.0)) ** 1.2
    asym = np.where(asym < 3.0, 0.0, np.minimum(asym, 12.0))

    w = width_z / width_z.sum()
    frame_d = np.sqrt(np.sum(w * disturbance ** 2, axis=1))
    frame_da = np.sum(w * np.abs(disturbance) * asym, axis=1)

    # silent frames carry less weight (audible-power based, exponent 0.04)
    weight = ((aud_ref + 1e5) / _TARGET_POWER) ** 0.04
    frame_d = np.minimum(frame_d / weight, 45.0)
    frame_da = np.minimum(frame_da / weight, 45.0)

    def _lpq(values: np.ndarray, p: float, chunk: int = 20) -> float:
        """L_p within 320 ms chunks, L2 across chunks (P.862 (p, 2) norm)."""
        n_chunks = int(np.ceil(len(values) / chunk))
        chunks = np.zeros(n_chunks)
        for c in range(n_chunks):
            part = values[c * chunk: (c + 1) * chunk]
            chunks[c] = np.mean(part ** p) ** (1.0 / p)
        return float(np.sqrt(np.mean(chunks ** 2)))

    d_sym = _lpq(frame_d, 6.0)
    d_asym = _lpq(frame_da, 1.0)
    return 4.5 - 0.1 * d_sym - 0.0309 * d_asym


def _mos_lqo(raw: float, mode: str) -> float:
    if mode == "wb":  # P.862.2 mapping
        return 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224))
    # P.862.1 narrow-band mapping
    return 0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607))


def pesq(ref: np.ndarray, deg: np.ndarray, fs: int, mode: str) -> float:
    """ITU-T P.862 PESQ MOS-LQO of ``deg`` against clean ``ref``.

    Args:
        ref: clean reference utterance, 1-D float array (any consistent scale).
        deg: degraded utterance, same sampling rate.
        fs: 8000 or 16000.
        mode: ``"nb"`` (IRS-filtered narrow-band, P.862.1 mapping) or
            ``"wb"`` (100 Hz high-pass, P.862.2 mapping; fs must be 16000).
    """
    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
    if mode not in ("nb", "wb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
    if mode == "wb" and fs == 8000:
        raise ValueError("Wide-band PESQ ('wb') requires fs=16000")
    ref = np.asarray(ref, np.float64).reshape(-1)
    deg = np.asarray(deg, np.float64).reshape(-1)
    n_fft = _frame_params(fs)[0]
    if len(ref) < 2 * n_fft or len(deg) < 2 * n_fft:
        raise ValueError(
            f"Signals too short for PESQ at fs={fs}: need at least {2 * n_fft} samples"
        )

    # 16-bit internal domain + level alignment
    ref = _level_align(ref * 32768.0, fs)
    deg = _level_align(deg * 32768.0, fs)

    # input filtering
    if mode == "nb":
        ref = _fft_filter(ref, fs, _IRS_FREQ_HZ, _IRS_GAIN_DB)
        deg = _fft_filter(deg, fs, _IRS_FREQ_HZ, _IRS_GAIN_DB)
    else:
        hp_f = np.array([0.0, 50.0, 100.0, 150.0, fs / 2.0])
        hp_g = np.array([-200.0, -24.0, -3.0, 0.0, 0.0])
        ref = _fft_filter(ref, fs, hp_f, hp_g)
        deg = _fft_filter(deg, fs, hp_f, hp_g)

    deg = _align(ref, deg, fs)
    raw = _raw_pesq(ref, deg, fs, mode)
    return float(_mos_lqo(raw, mode))
