"""Build the port's CUDA kernels with nvcc at first use; load with ctypes.

The sources in this directory compile into one shared library with a
plain C interface (``kernels.cu``), for ``sm_90a`` (Hopper).  The library
lands in ``build/vgen_tpu_torch/`` at the repository root, named by a hash
of the sources and flags, so an edit rebuilds and an unchanged tree loads
the cached file.  A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC.parents[1] / "build" / "vgen_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_stamp() -> str:
    """Hash of every kernel source and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libvgen_tpu_torch-{source_stamp()}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def build() -> Path:
    """Compile kernels.cu into the cached library unless it exists.  The
    compiler's output (``-Xptxas -v``: registers, spills) is kept beside it
    as ``.log``."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / "kernels.cu")]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    path.with_suffix(".log").write_text(
        f"# {' '.join(cmd)}\n# {time.time() - t0:.1f} s\n"
        f"{proc.stdout}{proc.stderr}"
    )
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


def build_log() -> str:
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with its C signatures set."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vgen_batch_inverse_dx.argtypes = [p, p, p, p, i, i, i, p]
        lib.vgen_batch_inverse_dx.restype = i
        for name in ("vgen_range_glv_match", "vgen_range_match"):
            getattr(lib, name).argtypes = [p, p, p, p, p, p, p, i, p, p, i, i,
                                           p]
            getattr(lib, name).restype = i
        for name in ("vgen_dfa_match", "vgen_glv_dfa_match"):
            getattr(lib, name).argtypes = [p, p, p, p, p, p, p, i, i, i, p, p,
                                           i, i, p]
            getattr(lib, name).restype = i
        _lib = lib
        return lib
