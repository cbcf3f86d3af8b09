"""Fixed-shape, mergeable stream sketches (counterpart of ``metrics_tpu/sketches``).

Ported so far: the weighted quantile sketch that backs the sketched curve
metrics (``AUROC()``'s default mode), the reservoir (Gumbel priorities
from the JAX package's random stream, or keyed ones, as behind the mAP
metric's per-image table), the rank sketch behind ``SpearmanCorrCoef``,
the exact streaming moments, the fixed-edge histogram behind
``CalibrationError``, and the exact-mode helpers.
"""
from metrics_tpu_torch.sketches.compat import register_exact_list_states, warn_exact_buffer  # noqa: F401
from metrics_tpu_torch.sketches.histogram import hist_bin_index, hist_init, hist_insert, hist_merge  # noqa: F401
from metrics_tpu_torch.sketches.moments import (  # noqa: F401
    mean_cov_from_moments,
    moments_init,
    moments_merge_fx,
    moments_update,
)
from metrics_tpu_torch.sketches.quantile import (  # noqa: F401
    QSKETCH_RANK_EPS,
    fill_bound,
    qsketch_absorb_rows,
    qsketch_cdf,
    qsketch_fill,
    qsketch_histogram,
    qsketch_init,
    qsketch_insert,
    qsketch_merge,
    qsketch_merge_into,
    qsketch_quantile,
    qsketch_rank,
    qsketch_total_weight,
    rank_error_bound,
    sketch_merge_fx,
)
from metrics_tpu_torch.sketches.rank import (  # noqa: F401
    ranksketch_init,
    ranksketch_insert,
    ranksketch_merge,
    ranksketch_merge_fx,
    ranksketch_spearman,
)
from metrics_tpu_torch.sketches.reservoir import (  # noqa: F401
    detection_table_init,
    reservoir_fill,
    reservoir_init,
    reservoir_insert,
    reservoir_insert_keyed,
    reservoir_key,
    reservoir_merge,
    reservoir_merge_fx,
    reservoir_rows,
)

__all__ = [
    "detection_table_init",
    "fill_bound",
    "hist_bin_index",
    "hist_init",
    "hist_insert",
    "hist_merge",
    "mean_cov_from_moments",
    "moments_init",
    "moments_merge_fx",
    "moments_update",
    "qsketch_absorb_rows",
    "qsketch_cdf",
    "qsketch_fill",
    "qsketch_histogram",
    "qsketch_init",
    "qsketch_insert",
    "qsketch_merge",
    "qsketch_merge_into",
    "qsketch_quantile",
    "qsketch_rank",
    "QSKETCH_RANK_EPS",
    "qsketch_total_weight",
    "rank_error_bound",
    "ranksketch_init",
    "ranksketch_insert",
    "ranksketch_merge",
    "ranksketch_merge_fx",
    "ranksketch_spearman",
    "register_exact_list_states",
    "reservoir_fill",
    "reservoir_init",
    "reservoir_insert",
    "reservoir_insert_keyed",
    "reservoir_key",
    "reservoir_merge",
    "reservoir_merge_fx",
    "reservoir_rows",
    "sketch_merge_fx",
    "warn_exact_buffer",
]
