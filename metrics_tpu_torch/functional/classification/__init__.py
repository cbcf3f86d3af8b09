from metrics_tpu_torch.functional.classification.auc import auc  # noqa: F401
from metrics_tpu_torch.functional.classification.auroc import (  # noqa: F401
    auroc,
    auroc_rank_multiclass,
    auroc_rank_multiclass_masked,
)
from metrics_tpu_torch.functional.classification.confusion_matrix import confusion_matrix  # noqa: F401
from metrics_tpu_torch.functional.classification.roc import roc  # noqa: F401
