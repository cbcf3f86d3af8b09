from metrics_tpu_torch.functional.regression.mse import mean_squared_error  # noqa: F401
