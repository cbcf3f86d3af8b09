from metrics_tpu_torch.parallel.distributed import (  # noqa: F401
    class_reduce,
    collective_counts,
    distributed_available,
    gather_all_arrays,
    reset_collective_counts,
    sync_pytree,
    world_size,
)
