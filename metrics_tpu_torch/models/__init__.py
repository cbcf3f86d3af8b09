"""Feature extractors and encoders: the FID InceptionV3
(:mod:`metrics_tpu_torch.models.inception`), the LPIPS nets
(:mod:`metrics_tpu_torch.models.lpips`) and BERTScore's BERT encoder
(:mod:`metrics_tpu_torch.models.bert`).

**Full float32 convolutions and products.** The JAX package runs its
extractors and encoders at full float32 precision. On the card a float32
cuDNN convolution runs in TF32 whenever ``torch.backends.cudnn.allow_tf32``
is set, which is PyTorch's default, and a disabled cuDNN or its benchmark
mode would change the algorithm and so the rounding; a float32 matmul runs
in TF32 whenever ``torch.backends.cuda.matmul.allow_tf32`` is set.
:func:`full_float32_convs` sets cuDNN on, deterministic, without benchmark
and without TF32, and turns matmul TF32 off, while a model launches its
convolutions and products, and puts the caller's values back afterwards,
so features do not depend on those flags.

The flags are process-wide, and the async update pipeline
(``core/pipeline.py``) runs updates on a worker thread while the caller's
thread goes on. So the flags are set under a lock with a count of the
extractor calls inside: the first call in saves the caller's values, the
last call out restores them. Two threads therefore never restore each
other's values, and none leaves TF32 off. What the lock cannot stop is
another thread's own convolution issued during an extractor call: it runs
at full float32 too, never at less precision than it asked for. A
replayed CUDA graph reads no flag at all (the algorithm was chosen at its
capture, under this context).
"""
import contextlib
import threading
from typing import Any, Iterator, Optional

import torch

_FLAGS_LOCK = threading.Lock()
_flags_depth = 0
_flags_ctx: Optional[Any] = None
_matmul_tf32: bool = False


@contextlib.contextmanager
def full_float32_convs(device: torch.device) -> Iterator[None]:
    """cuDNN at full float32 (no TF32, deterministic, no benchmark) and
    matmuls without TF32 while the block runs on a CUDA ``device``; nothing
    changes for the CPU."""
    global _flags_depth, _flags_ctx, _matmul_tf32
    if device.type != "cuda":
        yield
        return
    with _FLAGS_LOCK:
        if _flags_depth == 0:
            ctx = torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False)
            ctx.__enter__()
            _flags_ctx = ctx
            _matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
        _flags_depth += 1
    try:
        yield
    finally:
        with _FLAGS_LOCK:
            _flags_depth -= 1
            if _flags_depth == 0:
                ctx, _flags_ctx = _flags_ctx, None
                ctx.__exit__(None, None, None)
                torch.backends.cuda.matmul.allow_tf32 = _matmul_tf32


from metrics_tpu_torch.models.bert import BertConfig, BertModel, build_bert  # noqa: E402,F401
