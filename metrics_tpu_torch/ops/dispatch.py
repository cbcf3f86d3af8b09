"""Device routing and launch counters for the port's kernels.

Counterpart of ``metrics_tpu/ops/dispatch.py``, reduced to what a card
needs: each op's entry point looks at where its tensors live. CPU tensors
take the op's plain PyTorch version; CUDA tensors launch the hand-written
kernel or raise. There is no environment switch to the plain version and
no shape-based route: either would be a fallback that hides the kernel.

Every kernel wrapper adds one to its launch counter each time it launches
its kernel (and nowhere else), so a run can show that a path really went
through the kernels: reset the counters, drive the path, read them.

A CUDA graph replays kernels without calling their wrappers. The fused
update (``core/fused.py``) therefore records the launches of each capture
(:func:`recording_launches`: this thread's launches go to a dict instead of
the counters) and adds them to the counters at every replay
(:func:`add_launches`); the launches of its warm-up and probe runs are
recorded and dropped.

A launch that serves every row of a ``torch.func.vmap`` (the vmap rules of
:mod:`metrics_tpu_torch.ops.segment_sum`) also counts as a batched launch
of its kernel (:func:`batched_launch_counts`), recorded and replayed with
the rest.
"""
import contextlib
import ctypes
import threading
from typing import Any, Dict, Iterator

import torch

__all__ = [
    "on_card",
    "route",
    "check_cuda",
    "launch",
    "count_launch",
    "launch_counts",
    "batched_launch_counts",
    "reset_launch_counts",
    "recording_launches",
    "add_launches",
]

_LAUNCHES: Dict[str, int] = {}
#: the suffix of a kernel's batched-launch counter in ``_LAUNCHES`` and in
#: the dicts :func:`recording_launches` yields
BATCHED = "@vmap"
_LOCK = threading.Lock()
_RECORDING = threading.local()


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device, False when every
    tensor is on the CPU; anything else raises."""
    device = tensors[0].device
    if any(t.device != device for t in tensors[1:]):
        raise ValueError(f"expected tensors on one device, got {sorted({str(t.device) for t in tensors})}")
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"metrics_tpu_torch kernels run on CUDA or CPU tensors, got device {device}")


_RECORDER: Any = None


def route(op: str, *tensors: torch.Tensor) -> bool:
    """:func:`on_card`, counted per op and backend (``cuda`` or ``plain``)
    in the default telemetry recorder when it is enabled (the
    ``metrics_tpu_ops_dispatch_total`` family). A captured graph replays
    its kernels without routing, so a fused update's traffic counts once
    per capture."""
    card = on_card(*tensors)
    global _RECORDER
    if _RECORDER is None:
        # imported at the first route: the recorder's package imports the
        # sketches, which import this module
        from metrics_tpu_torch.observability.recorder import _DEFAULT_RECORDER

        _RECORDER = _DEFAULT_RECORDER
    if _RECORDER.enabled:
        _RECORDER.record_ops_dispatch(op, "cuda" if card else "plain")
    return card


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device (a kernel wrapper's guard)."""
    if not on_card(*tensors):
        raise ValueError(f"{name} is a CUDA kernel; it takes CUDA tensors (the CPU takes the plain version)")


def launch(kernel: str, lib: ctypes.CDLL, device: torch.device, fn: Any, *args: Any, batched: bool = False) -> None:
    """Call the C launcher ``fn`` of ``lib`` with ``device``'s current
    stream, raise on the CUDA error it returns, and count the launch (a
    ``batched`` one too: it serves a whole ``torch.func.vmap``). The device
    and its stream are looked up once."""
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        code = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            code = fn(*args, stream)
    if code != 0:
        reason = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} ({reason})")
    count_launch(kernel, batched)


def count_launch(name: str, batched: bool = False) -> None:
    names = (name, name + BATCHED) if batched else (name,)
    recording = getattr(_RECORDING, "counts", None)
    if recording is not None:
        for key in names:
            recording[key] = recording.get(key, 0) + 1
        return
    with _LOCK:
        for key in names:
            _LAUNCHES[key] = _LAUNCHES.get(key, 0) + 1


@contextlib.contextmanager
def recording_launches() -> Iterator[Dict[str, int]]:
    """Within this context, this thread's launches are counted in the
    yielded dict and not in :func:`launch_counts`."""
    prev = getattr(_RECORDING, "counts", None)
    counts: Dict[str, int] = {}
    _RECORDING.counts = counts
    try:
        yield counts
    finally:
        _RECORDING.counts = prev


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` to the launch counters (a graph replay's launches)."""
    with _LOCK:
        for name, n in counts.items():
            _LAUNCHES[name] = _LAUNCHES.get(name, 0) + n


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    with _LOCK:
        return {k: n for k, n in _LAUNCHES.items() if not k.endswith(BATCHED)}


def batched_launch_counts() -> Dict[str, int]:
    """Of :func:`launch_counts`, the launches per kernel that each served
    every row of a ``torch.func.vmap``."""
    with _LOCK:
        return {k[: -len(BATCHED)]: n for k, n in _LAUNCHES.items() if k.endswith(BATCHED)}


def reset_launch_counts() -> None:
    with _LOCK:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0
