from metrics_tpu_torch.functional.classification import (  # noqa: F401
    auc,
    auroc,
    auroc_rank_multiclass,
    auroc_rank_multiclass_masked,
    confusion_matrix,
    roc,
)
