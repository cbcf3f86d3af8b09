from metrics_tpu_torch.image.psnr import PeakSignalNoiseRatio  # noqa: F401
from metrics_tpu_torch.image.ssim import (  # noqa: F401
    MultiScaleStructuralSimilarityIndexMeasure,
    StructuralSimilarityIndexMeasure,
)
from metrics_tpu_torch.image.uqi import UniversalImageQualityIndex  # noqa: F401
from metrics_tpu_torch.image.fid import FrechetInceptionDistance  # noqa: F401
from metrics_tpu_torch.image.inception import InceptionScore  # noqa: F401
from metrics_tpu_torch.image.kid import KernelInceptionDistance  # noqa: F401
from metrics_tpu_torch.image.lpip import LearnedPerceptualImagePatchSimilarity  # noqa: F401
