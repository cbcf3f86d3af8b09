from metrics_tpu_torch.functional.image.gradients import image_gradients  # noqa: F401
from metrics_tpu_torch.functional.image.psnr import peak_signal_noise_ratio  # noqa: F401
from metrics_tpu_torch.functional.image.ssim import (  # noqa: F401
    multiscale_structural_similarity_index_measure,
    structural_similarity_index_measure,
)
from metrics_tpu_torch.functional.image.uqi import universal_image_quality_index  # noqa: F401
