"""Fixed-shape, mergeable stream sketches (counterpart of ``metrics_tpu/sketches``).

This slice ports the weighted quantile sketch that backs the sketched
curve metrics (``AUROC()``'s default mode).
"""
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
