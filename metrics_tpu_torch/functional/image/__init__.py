from metrics_tpu_torch.functional.image.psnr import peak_signal_noise_ratio  # noqa: F401
