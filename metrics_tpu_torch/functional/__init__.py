from metrics_tpu_torch.functional.classification import (  # noqa: F401
    auc,
    auroc,
    auroc_rank_multiclass,
    auroc_rank_multiclass_masked,
    confusion_matrix,
    roc,
)
from metrics_tpu_torch.functional.image import peak_signal_noise_ratio  # noqa: F401
from metrics_tpu_torch.functional.regression import mean_squared_error  # noqa: F401
from metrics_tpu_torch.functional.retrieval import (  # noqa: F401
    retrieval_average_precision,
    retrieval_fall_out,
    retrieval_hit_rate,
    retrieval_normalized_dcg,
    retrieval_precision,
    retrieval_r_precision,
    retrieval_recall,
    retrieval_reciprocal_rank,
)
