from metrics_tpu_torch.regression.mse import MeanSquaredError  # noqa: F401
