"""Rank-zero-only warnings and info logs, keyed on the ``torch.distributed`` rank (0 when
no process group is initialised)."""
import logging
import warnings
from functools import partial, wraps
from typing import Any, Callable

# a module import: the distributed module imports (through the sketches)
# modules that warn, so it may still be initialising here
import metrics_tpu_torch.parallel.distributed as _distributed

log = logging.getLogger("metrics_tpu_torch")


def rank_zero_only(fn: Callable) -> Callable:
    @wraps(fn)
    def wrapped_fn(*args: Any, **kwargs: Any) -> Any:
        if _distributed.process_index() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped_fn


@rank_zero_only
def rank_zero_warn(message: str, *args: Any, **kwargs: Any) -> None:
    warnings.warn(message, *args, stacklevel=kwargs.pop("stacklevel", 3), **kwargs)


@rank_zero_only
def rank_zero_info(message: str, *args: Any, **kwargs: Any) -> None:
    log.info(message, *args, **kwargs)


@rank_zero_only
def rank_zero_debug(message: str, *args: Any, **kwargs: Any) -> None:
    log.debug(message, *args, **kwargs)


rank_zero_print = rank_zero_only(partial(print, flush=True))
