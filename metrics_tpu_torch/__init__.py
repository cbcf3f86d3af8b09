"""metrics_tpu_torch: the PyTorch/CUDA port of metrics_tpu.

It imports ``torch`` and ``numpy``, never ``jax`` and nothing of
``metrics_tpu``. Metrics run on the card unless ``device="cpu"`` is passed;
their kernels are hand-written CUDA, built from ``csrc/`` at first use (see
:mod:`metrics_tpu_torch.ops`). Ported so far: the stat-scores family
(``StatScores``, ``Accuracy``, ``Precision``, ``Recall``, ``FBetaScore``,
``F1Score``, ``Specificity``, ``HammingDistance``), the confusion-matrix
family (``ConfusionMatrix``, ``CohenKappa``, ``JaccardIndex``,
``MatthewsCorrCoef``) and their functionals, the exact rank AUROC, the
curve family (``AUROC``, ``ROC``, ``PrecisionRecallCurve``,
``AveragePrecision``: the sketched streaming default for binary,
one-vs-rest and multilabel inputs, ``exact=True`` and the capacity modes;
``AUC``; the binned curves; ``CalibrationError``) and its functionals,
the losses ``HingeLoss`` and ``KLDivergence`` and ``dice_score``,
``MeanAveragePrecision`` (COCO mAP/mAR, its reservoir
table and its exact mode), the eight retrieval metrics (their per-query
table and their exact mode), the regression family
(``MeanSquaredError``, ``MeanAbsoluteError``, ``MeanAbsolutePercentageError``,
``SymmetricMeanAbsolutePercentageError``, ``MeanSquaredLogError``,
``TweedieDevianceScore``, ``CosineSimilarity``, ``ExplainedVariance``,
``R2Score``, ``PearsonCorrCoef``, ``SpearmanCorrCoef`` with its rank
sketch) and its functionals, the image family (``PeakSignalNoiseRatio``,
``StructuralSimilarityIndexMeasure``, ``MultiScaleStructuralSimilarityIndexMeasure``,
``UniversalImageQualityIndex``, ``FrechetInceptionDistance``,
``KernelInceptionDistance``, ``InceptionScore`` on the InceptionV3 of
:mod:`metrics_tpu_torch.models`, ``LearnedPerceptualImagePatchSimilarity``,
``image_gradients``), the per-slice and windowed wrappers
``SlicedMetric`` (:mod:`metrics_tpu_torch.sliced`) and ``WindowedMetric``
(:mod:`metrics_tpu_torch.windowed`), the quantile sketch, the keyed
and Gumbel reservoirs, the rank sketch and the streaming moments (:mod:`metrics_tpu_torch.sketches`)
``MetricCollection`` with its fused update on CUDA graphs
(``compile_update``) and the async update pipeline
(``compile_update_async``), the aggregators (``MaxMetric``, ``MinMetric``,
``SumMetric``, ``CatMetric``, ``MeanMetric``), ``CompositionalMetric`` and
the operator algebra of ``Metric``, the pairwise functionals
(:mod:`metrics_tpu_torch.functional.pairwise`) and the wrappers
(``BootStrapper``, ``ClasswiseWrapper``, ``MinMaxMetric``,
``MultioutputWrapper``, ``MetricTracker``).
"""
from metrics_tpu_torch.aggregation import CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric  # noqa: F401
from metrics_tpu_torch.classification import (  # noqa: F401
    AUC,
    AUROC,
    ROC,
    Accuracy,
    AveragePrecision,
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedRecallAtFixedPrecision,
    CalibrationError,
    CohenKappa,
    ConfusionMatrix,
    F1Score,
    FBetaScore,
    HammingDistance,
    HingeLoss,
    JaccardIndex,
    KLDivergence,
    MatthewsCorrCoef,
    Precision,
    PrecisionRecallCurve,
    Recall,
    Specificity,
    StatScores,
)
from metrics_tpu_torch.collections import MetricCollection  # noqa: F401
from metrics_tpu_torch.core.metric import CompositionalMetric, Metric  # noqa: F401
from metrics_tpu_torch.detection import MeanAveragePrecision  # noqa: F401
from metrics_tpu_torch.image import (  # noqa: F401
    FrechetInceptionDistance,
    InceptionScore,
    KernelInceptionDistance,
    LearnedPerceptualImagePatchSimilarity,
    MultiScaleStructuralSimilarityIndexMeasure,
    PeakSignalNoiseRatio,
    StructuralSimilarityIndexMeasure,
    UniversalImageQualityIndex,
)
from metrics_tpu_torch.regression import (  # noqa: F401
    CosineSimilarity,
    ExplainedVariance,
    MeanAbsoluteError,
    MeanAbsolutePercentageError,
    MeanSquaredError,
    MeanSquaredLogError,
    PearsonCorrCoef,
    R2Score,
    SpearmanCorrCoef,
    SymmetricMeanAbsolutePercentageError,
    TweedieDevianceScore,
)
from metrics_tpu_torch.retrieval import (  # noqa: F401
    RetrievalFallOut,
    RetrievalHitRate,
    RetrievalMAP,
    RetrievalMRR,
    RetrievalNormalizedDCG,
    RetrievalPrecision,
    RetrievalRecall,
    RetrievalRPrecision,
)
from metrics_tpu_torch.sliced import SlicedMetric  # noqa: F401
from metrics_tpu_torch.windowed import WindowedMetric  # noqa: F401
from metrics_tpu_torch.wrappers import (  # noqa: F401
    BootStrapper,
    ClasswiseWrapper,
    MetricTracker,
    MinMaxMetric,
    MultioutputWrapper,
)

__version__ = "0.1.0"
