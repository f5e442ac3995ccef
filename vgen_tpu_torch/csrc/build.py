"""Build the port's CUDA kernels with nvcc at first use; load with ctypes.

Each ``.cu`` file in this directory (a "unit": ``kernels`` holds kernels A
to E, ``p2tr`` kernels F to I) compiles into its own shared library with a
plain C interface, for ``sm_90a`` (Hopper).  The first ``load`` starts one
nvcc per unit, all at once, and waits for them.  The libraries land in
``build/vgen_tpu_torch/`` at the repository root, named by the unit and a
hash of the sources and flags, so an edit rebuilds and an unchanged tree
loads the cached files.  A failed build raises: there is no fallback.
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
from typing import Dict

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC.parents[1] / "build" / "vgen_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
UNITS = ("kernels", "p2tr")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_stamp() -> str:
    """Hash of every kernel source and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(unit: str = "kernels") -> Path:
    return BUILD_DIR / f"libvgen_tpu_torch_{unit}-{source_stamp()}.so"


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


def build() -> Dict[str, Path]:
    """Compile every unit that is not cached, one nvcc per unit started
    together; -> {unit: library path}.  The compiler's output
    (``-Xptxas -v``: registers, spills) is kept beside each library as
    ``.log``."""
    paths = {u: library_path(u) for u in UNITS}
    todo = [u for u in UNITS if not paths[u].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    procs = {}
    for u in todo:
        tmp = paths[u].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{u}.cu")]
        procs[u] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for u, (cmd, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}")
            continue
        paths[u].with_suffix(".log").write_text(
            f"# {' '.join(cmd)}\n# {time.time() - t0:.1f} s\n{out}")
        os.replace(tmp, paths[u])  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build_log() -> str:
    """The compiler output of every unit's last build."""
    logs = [library_path(u).with_suffix(".log") for u in UNITS]
    return "".join(p.read_text() for p in logs if p.exists())


def load(unit: str = "kernels") -> ctypes.CDLL:
    """The kernel library of ``unit``, every unit built if needed, with its
    C signatures set."""
    with _lock:
        if unit in _libs:
            return _libs[unit]
        if unit not in UNITS:
            raise ValueError(f"unknown kernel unit {unit!r}")
        paths = build()
        p, i = ctypes.c_void_p, ctypes.c_int
        signatures = {
            "kernels": {
                "vgen_batch_inverse_dx": [p, p, p, p, i, i, i, p],
                "vgen_range_glv_match": [p, p, p, p, p, p, p, i, p, p, i, i, p],
                "vgen_range_match": [p, p, p, p, p, p, p, i, p, p, i, i, p],
                "vgen_dfa_match": [p, p, p, p, p, p, p, i, i, i, p, p, i, i, p],
                "vgen_glv_dfa_match": [p, p, p, p, p, p, p, i, i, i, p, p, i,
                                       i, p],
            },
            "p2tr": {
                "vgen_p2tr_ladder": [p, p, p, p, p, p, p, p, p, i, i, p],
                "vgen_p2tr_ladder_affine": [p, p, p, p, p, p, i, p],
                "vgen_batch_inverse_chain": [p, p, p, i, i, p],
                "vgen_p2tr_finish_range": [p, p, p, p, p, p, i, p, p, i, i, p],
                "vgen_p2tr_finish_match": [p, p, p, p, p, p, i, i, p, p, i, i,
                                           p],
            },
        }
        for u in UNITS:
            lib = ctypes.CDLL(str(paths[u]))
            for name, argtypes in signatures[u].items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, i
            _libs[u] = lib
        return _libs[unit]
