from metrics_tpu_torch.functional.classification import (  # noqa: F401
    accuracy,
    auc,
    auroc,
    auroc_rank_multiclass,
    auroc_rank_multiclass_masked,
    cohen_kappa,
    confusion_matrix,
    f1_score,
    fbeta_score,
    hamming_distance,
    jaccard_index,
    matthews_corrcoef,
    precision,
    precision_recall,
    recall,
    roc,
    specificity,
    stat_scores,
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
