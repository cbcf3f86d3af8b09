from metrics_tpu_torch.image.psnr import PeakSignalNoiseRatio  # noqa: F401
