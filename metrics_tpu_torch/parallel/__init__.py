from metrics_tpu_torch.parallel.distributed import (  # noqa: F401
    check_single_process,
    distributed_available,
    world_size,
)
