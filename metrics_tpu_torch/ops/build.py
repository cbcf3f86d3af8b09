"""Build the CUDA sources under ``metrics_tpu_torch/csrc`` at first use.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds) and loaded with
``ctypes``. Libraries go to ``metrics_tpu_torch/_build/``, named by a hash
of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header builds anew and an unchanged one is loaded as it
is. A failed build raises with the
compiler's output: there is no fallback.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

#: Hopper only: the ``a`` target keeps wgmma/setmaxnreg available to later kernels
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME`` (default ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc was not found on PATH or under $CUDA_HOME/bin: the CUDA kernels of"
        " metrics_tpu_torch are built from csrc/ at first use and need the CUDA toolkit"
    )


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives (keyed on its
    content, every header under ``csrc/`` and the flags)."""
    src = CSRC_DIR / source
    headers = b"".join(path.name.encode() + path.read_bytes() for path in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(source: str) -> Tuple[Path, float, str]:
    """Compile ``csrc/<source>`` unless its library exists.

    Returns ``(library path, build seconds, compiler output)``; seconds and
    output are ``0.0`` and ``""`` when the library was already built.
    """
    lib = library_path(source)
    if lib.is_file():
        return lib, 0.0, ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name and rename: concurrent first uses never
    # load a half-written library
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)],
        capture_output=True,
        text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {source} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, seconds, proc.stdout + proc.stderr


_LIBS: Dict[str, ctypes.CDLL] = {}
_LIBS_LOCK = threading.Lock()


def load(source: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<source>``; declare each C
    launcher's ``argtypes`` from ``signatures`` (each returns its CUDA error
    code as an int) and ``cuda_error_string``. Loaded once per process."""
    lib = _LIBS.get(source)
    if lib is not None:
        return lib
    with _LIBS_LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            path, _, _ = build(source)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _LIBS[source] = lib
        return lib
