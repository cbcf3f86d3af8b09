"""Hand-written CUDA kernels for the port's hot ops, each beside its plain
PyTorch version and behind a device-routed entry point (see
:mod:`metrics_tpu_torch.ops.dispatch`)."""
from metrics_tpu_torch.ops.box_iou import (  # noqa: F401
    box_iou,
    box_iou_batched,
    box_iou_broadcast,
    box_iou_pairwise,
    box_iou_reference,
)
from metrics_tpu_torch.ops.dispatch import (  # noqa: F401
    BATCHED,
    batched_launch_counts,
    count_launch,
    launch_counts,
    on_card,
    recording_launches,
    reset_launch_counts,
    route,
)
from metrics_tpu_torch.ops.qsketch import (  # noqa: F401
    compact_rows_reference,
    qsketch_compact_dispatch,
    qsketch_sort_bucket,
    qsketch_sort_bucket_reference,
)
from metrics_tpu_torch.ops.row_topk import row_topk, row_topk_f32, row_topk_reference  # noqa: F401
from metrics_tpu_torch.ops.segment_extremum import (  # noqa: F401
    segment_extremum_reference,
    segment_max,
    segment_max_dispatch,
    segment_max_f32,
    segment_min,
    segment_min_dispatch,
    segment_min_f32,
)
from metrics_tpu_torch.ops.segment_sum import (  # noqa: F401
    bincount_dispatch,
    bincount_i32,
    bincount_reference,
    segment_sum,
    segment_sum_dispatch,
    segment_sum_f32,
    segment_sum_i32,
    segment_sum_reference,
)
from metrics_tpu_torch.ops.sqrtm import NEWTON_SCHULZ_ITERS  # noqa: F401
