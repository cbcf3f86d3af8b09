from metrics_tpu_torch.functional.classification.accuracy import accuracy  # noqa: F401
from metrics_tpu_torch.functional.classification.auc import auc  # noqa: F401
from metrics_tpu_torch.functional.classification.auroc import (  # noqa: F401
    auroc,
    auroc_rank_multiclass,
    auroc_rank_multiclass_masked,
)
from metrics_tpu_torch.functional.classification.average_precision import average_precision  # noqa: F401
from metrics_tpu_torch.functional.classification.calibration_error import calibration_error  # noqa: F401
from metrics_tpu_torch.functional.classification.cohen_kappa import cohen_kappa  # noqa: F401
from metrics_tpu_torch.functional.classification.confusion_matrix import confusion_matrix  # noqa: F401
from metrics_tpu_torch.functional.classification.f_beta import f1_score, fbeta_score  # noqa: F401
from metrics_tpu_torch.functional.classification.hamming import hamming_distance  # noqa: F401
from metrics_tpu_torch.functional.classification.jaccard import jaccard_index  # noqa: F401
from metrics_tpu_torch.functional.classification.matthews_corrcoef import matthews_corrcoef  # noqa: F401
from metrics_tpu_torch.functional.classification.precision_recall import (  # noqa: F401
    precision,
    precision_recall,
    recall,
)
from metrics_tpu_torch.functional.classification.precision_recall_curve import precision_recall_curve  # noqa: F401
from metrics_tpu_torch.functional.classification.roc import roc  # noqa: F401
from metrics_tpu_torch.functional.classification.specificity import specificity  # noqa: F401
from metrics_tpu_torch.functional.classification.stat_scores import stat_scores  # noqa: F401
