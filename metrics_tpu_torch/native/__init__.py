"""Native (C++) host components of the port.

Counterpart of ``metrics_tpu/native/__init__.py``. The port keeps its own
copy of the source (``native/lsap.cpp``), compiles it with the system's
``g++`` at first use into ``metrics_tpu_torch/_build/`` (the directory the
CUDA kernels are built into), and binds it with ``ctypes``. The library is
named by a hash of the source and the flags, and is built under a private
name and renamed into place, so concurrent first uses never load a
half-written library and an edited source builds anew.

A failed build raises with the compiler's output. Unlike the JAX package,
there is no fallback to scipy: a machine that runs PIT past six speakers
needs ``g++``.

Current components:

- ``lsap``: batched linear sum assignment (shortest-augmenting-path
  Hungarian), used by PIT's large-speaker path.
"""
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().with_name("lsap.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIBS: Dict[Tuple[Path, Path], ctypes.CDLL] = {}
_LIBS_LOCK = threading.Lock()


def library_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Where the library built from ``source`` lives (keyed on its content
    and the flags)."""
    digest = hashlib.sha256(Path(source).read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return Path(build_dir) / f"{Path(source).stem}-{digest}.so"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` with ``g++`` unless its library exists; return the
    library's path. A failed build raises ``RuntimeError`` with the
    compiler's output."""
    lib = library_path(source, build_dir)
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(source), "-o", str(tmp)], capture_output=True, text=True)
    except FileNotFoundError as err:
        raise RuntimeError(f"g++ was not found: the Hungarian solver is built from {source} at first use") from err
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {source} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic under concurrent builds
    return lib


def load_library(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """Build (at first use) and load the solver; loaded once per process
    for each source and build directory."""
    key = (Path(source), Path(build_dir))
    with _LIBS_LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build(source, build_dir)))
            lib.lsap_batch.restype = ctypes.c_int
            lib.lsap_batch.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),
            ]
            _LIBS[key] = lib
        return lib


def native_lsap_available() -> bool:
    """Whether the solver builds and loads here (a probe: :func:`lsap`
    itself raises the build's error)."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def lsap(costs: np.ndarray, maximize: bool = False) -> np.ndarray:
    """Batched square linear sum assignment: ``[B, N, N] -> [B, N]`` int32
    columns, one per row, from the in-repo C++ solver."""
    costs = np.ascontiguousarray(costs, dtype=np.float64)
    if costs.ndim == 2:
        costs = costs[None]
    if costs.ndim != 3 or costs.shape[1] != costs.shape[2]:
        raise ValueError(f"Expected [batch, n, n] square cost matrices, got {costs.shape}")
    if not np.isfinite(costs).all():
        # non-finite costs hang the augmenting-path solver / poison potentials
        raise ValueError("cost matrix contains invalid numeric entries (inf or nan)")
    batch, n = costs.shape[0], costs.shape[1]
    lib = load_library()
    work = np.ascontiguousarray(-costs) if maximize else costs
    out = np.empty((batch, n), dtype=np.int32)
    rc = lib.lsap_batch(
        work.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        batch,
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f"native lsap_batch failed with code {rc}")
    return out
