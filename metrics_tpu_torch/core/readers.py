"""Shape buckets for read paths.

The part of ``metrics_tpu/core/readers.py`` that the port needs: reads
whose row count varies (a sketch's fill) are padded up to a small family of
sizes. The JAX package does this so that its ahead-of-time compiled readers
see few shapes; the port runs eagerly, and keeps the padding so that the
weighted curve kernels see the same rows as the JAX package's.
"""
from typing import Optional, Tuple

#: the bucket family read shapes round up into; reads larger than the last
#: entry double from there (and every bucket is capped at the axis size)
DEFAULT_ID_BUCKETS: Tuple[int, ...] = (8, 64, 512, 4096)


def round_up_bucket(n: int, cap: Optional[int] = None, buckets: Tuple[int, ...] = DEFAULT_ID_BUCKETS) -> int:
    """Smallest bucket ``>= n`` from the family (doubling past the last
    entry), capped at ``cap`` (the axis size: a full-axis read is its own
    exact bucket)."""
    n = max(int(n), 1)
    if cap is not None and n >= cap:
        return cap
    for b in buckets:
        if b >= n:
            return min(b, cap) if cap is not None else b
    b = buckets[-1]
    while b < n:
        b *= 2
    return min(b, cap) if cap is not None else b
