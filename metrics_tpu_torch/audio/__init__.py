"""Audio metrics: SNR, SI-SNR, SDR, SI-SDR and PIT on the device; STOI and
eSTOI with a host front end (resampling, silent-frame removal) and their
spectrogram correlations on the device; PESQ scored on the host by the
``pesq`` binding when installed, else the in-repo P.862 engine.

Counterpart of ``metrics_tpu/audio/``.
"""
from metrics_tpu_torch.audio.pesq import PerceptualEvaluationSpeechQuality  # noqa: F401
from metrics_tpu_torch.audio.pit import PermutationInvariantTraining  # noqa: F401
from metrics_tpu_torch.audio.sdr import ScaleInvariantSignalDistortionRatio, SignalDistortionRatio  # noqa: F401
from metrics_tpu_torch.audio.snr import ScaleInvariantSignalNoiseRatio, SignalNoiseRatio  # noqa: F401
from metrics_tpu_torch.audio.stoi import ShortTimeObjectiveIntelligibility  # noqa: F401
