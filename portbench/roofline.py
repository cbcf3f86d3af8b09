"""Peaks of the card and the bytes each kernel's work needs, frozen here so
that a change to a kernel cannot move its yardstick.

A kernel's share of its roofline is the least time the card could take for
the work (bytes over the peak bandwidth: every kernel measured here reads
and writes far more than it computes) over the device time the trace shows.
Each input byte is counted once and each output byte once, at the shapes
the timed path hands the kernel, whatever the kernel reads again; where the
work depends on the data (the bins a bincount touches) the count is what
these inputs need.
"""
import math

#: published peaks of one NVIDIA H100 SXM (data sheet; dense rates at the
#: full 700 W power limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "fp32_flops": 67e12},
}


def next_pow2(n: int) -> int:
    return 1 << max(1, (n - 1).bit_length())


def bincount_i32_bytes(ids: int, id_bytes: int, bins_touched: int) -> int:
    """K1's count form: the ids read once, each touched int32 bin written
    once (the zeroed output is the wrapper's memset, not the kernel's)."""
    return ids * id_bytes + bins_touched * 4


def segment_sum_f32_bytes(rows: int, cols: int, id_bytes: int, segments: int) -> int:
    """K1's float form ``[rows, cols] x [rows] -> [segments, cols]``: values
    and ids read once, every output written once."""
    return rows * cols * 4 + rows * id_bytes + segments * cols * 4


def qsketch_sort_bucket_bytes(rows: int, cols: int) -> int:
    """K3: ``[rows, cols]`` float32 rows read once; out the weighted rows
    ``[n_pad, cols]``, the int32 bucket ids and sorted row indices
    ``[n_pad]`` each, ``n_pad`` the next power of two."""
    n_pad = next_pow2(max(rows, 2))
    return rows * cols * 4 + n_pad * cols * 4 + 2 * n_pad * 4


def roofline_pct(bytes_moved: float, device_s: float, kind: str) -> float:
    """Least time for ``bytes_moved`` at the card's peak over ``device_s``, in %."""
    if device_s <= 0 or not math.isfinite(device_s):
        raise ValueError(f"roofline share needs a positive device time, got {device_s}")
    return 100.0 * bytes_moved / PEAKS[kind]["bytes_per_s"] / device_s
