from metrics_tpu_torch.functional.classification.auroc import (  # noqa: F401
    auroc_rank_multiclass,
    auroc_rank_multiclass_masked,
)
from metrics_tpu_torch.functional.classification.confusion_matrix import confusion_matrix  # noqa: F401
