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
``MultioutputWrapper``, ``MetricTracker``), and the text family
(``BLEUScore``, ``SacreBLEUScore``, ``CHRFScore``, ``TranslationEditRate``,
``ExtendedEditDistance``, ``WordErrorRate``, ``CharErrorRate``,
``MatchErrorRate``, ``WordInfoLost``, ``WordInfoPreserved``,
``ROUGEScore``, ``SQuAD``, ``BERTScore`` on the BERT encoder of
:mod:`metrics_tpu_torch.models.bert`) and its functionals: host string
handling with float32 count states on the card. ``nltk`` (ROUGE's stemmer
and sentence splitter), ``regex`` (SacreBLEU's ``intl`` tokenizer) and
``transformers`` (BERTScore's ``model_name_or_path``) are imported only
where they are used. The audio family (``SignalNoiseRatio``,
``ScaleInvariantSignalNoiseRatio``, ``SignalDistortionRatio``,
``ScaleInvariantSignalDistortionRatio``, ``PermutationInvariantTraining``
with its C++ Hungarian solver past six speakers, built with ``g++`` at
first use (:mod:`metrics_tpu_torch.native`); and in
:mod:`metrics_tpu_torch.audio`, as in the JAX package,
``ShortTimeObjectiveIntelligibility`` and
``PerceptualEvaluationSpeechQuality`` on the in-repo P.862 engine) and its
functionals.
"""
from metrics_tpu_torch.aggregation import CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric  # noqa: F401
from metrics_tpu_torch.audio import (  # noqa: F401
    PermutationInvariantTraining,
    ScaleInvariantSignalDistortionRatio,
    ScaleInvariantSignalNoiseRatio,
    SignalDistortionRatio,
    SignalNoiseRatio,
)
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
from metrics_tpu_torch.text import (  # noqa: F401
    BERTScore,
    BLEUScore,
    CharErrorRate,
    CHRFScore,
    ExtendedEditDistance,
    MatchErrorRate,
    ROUGEScore,
    SacreBLEUScore,
    SQuAD,
    TranslationEditRate,
    WordErrorRate,
    WordInfoLost,
    WordInfoPreserved,
)
from metrics_tpu_torch.windowed import WindowedMetric  # noqa: F401
from metrics_tpu_torch.wrappers import (  # noqa: F401
    BootStrapper,
    ClasswiseWrapper,
    MetricTracker,
    MinMaxMetric,
    MultioutputWrapper,
)
from metrics_tpu_torch import functional  # noqa: F401,E402
from metrics_tpu_torch.observability import MetricRecorder, get_recorder  # noqa: F401,E402

__version__ = "0.1.0"

__all__ = [
    "Accuracy",
    "AUC",
    "AUROC",
    "AveragePrecision",
    "BERTScore",
    "BinnedAveragePrecision",
    "BinnedPrecisionRecallCurve",
    "BinnedRecallAtFixedPrecision",
    "BLEUScore",
    "BootStrapper",
    "CalibrationError",
    "CatMetric",
    "CharErrorRate",
    "CHRFScore",
    "ClasswiseWrapper",
    "CohenKappa",
    "CompositionalMetric",
    "ConfusionMatrix",
    "CosineSimilarity",
    "ExplainedVariance",
    "ExtendedEditDistance",
    "F1Score",
    "FBetaScore",
    "FrechetInceptionDistance",
    "functional",
    "get_recorder",
    "HammingDistance",
    "HingeLoss",
    "InceptionScore",
    "JaccardIndex",
    "KernelInceptionDistance",
    "KLDivergence",
    "LearnedPerceptualImagePatchSimilarity",
    "MatchErrorRate",
    "MatthewsCorrCoef",
    "MaxMetric",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanAveragePrecision",
    "MeanMetric",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "Metric",
    "MetricCollection",
    "MetricRecorder",
    "MetricTracker",
    "MinMaxMetric",
    "MinMetric",
    "MultioutputWrapper",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "PearsonCorrCoef",
    "PermutationInvariantTraining",
    "Precision",
    "PrecisionRecallCurve",
    "R2Score",
    "Recall",
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalRecall",
    "RetrievalRPrecision",
    "ROC",
    "ROUGEScore",
    "SacreBLEUScore",
    "ScaleInvariantSignalDistortionRatio",
    "ScaleInvariantSignalNoiseRatio",
    "SignalDistortionRatio",
    "SignalNoiseRatio",
    "SlicedMetric",
    "SpearmanCorrCoef",
    "Specificity",
    "SQuAD",
    "StatScores",
    "StructuralSimilarityIndexMeasure",
    "SumMetric",
    "SymmetricMeanAbsolutePercentageError",
    "TranslationEditRate",
    "TweedieDevianceScore",
    "UniversalImageQualityIndex",
    "WindowedMetric",
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
]
