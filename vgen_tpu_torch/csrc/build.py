"""Build the port's CUDA kernels with nvcc at first use; load with ctypes.

Each ``.cu`` file in this directory (a "unit": ``kernels`` holds kernel A,
kernels B to E for the five hash formats and kernel J, ``p2tr`` kernels F
to I, ``tables`` the table kernels T1 and T2 that build the i*G and ladder
tables) compiles into its own shared library with a plain C interface, for
``sm_90a`` (Hopper).  The first ``load`` of a product unit starts one
nvcc per product unit, all at once, and waits for them.  The probe unit
(``../probes/probes.cu``, the measurement tools' kernels, which include
these headers) builds only when it is loaded or named in ``build``.  The
libraries land in ``build/vgen_tpu_torch/`` at the repository root, named
by the unit and a hash of its sources and flags (the product's: every
``.cu``/``.cuh`` here; the probes': those and ``../probes/``), so an edit
rebuilds what it touches and an unchanged tree loads the cached files.  A
failed build raises: there is no fallback.
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
PROBES = CSRC.parent / "probes"
BUILD_DIR = CSRC.parents[1] / "build" / "vgen_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
UNITS = ("kernels", "p2tr", "tables")
PROBE_UNITS = ("probes",)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _source_dirs(unit: str):
    return (CSRC, PROBES) if unit in PROBE_UNITS else (CSRC,)


def _flags(unit: str):
    return NVCC_FLAGS + (("-I", str(CSRC)) if unit in PROBE_UNITS else ())


def source_stamp(unit: str = "kernels") -> str:
    """Hash of the unit's sources (every .cu/.cuh of its directories) and
    its compiler flags."""
    # the include path is the checkout's own, so it is left out of the hash
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for d in _source_dirs(unit):
        for p in sorted(p for p in d.iterdir() if p.suffix in (".cu", ".cuh")):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(unit: str = "kernels") -> Path:
    return BUILD_DIR / f"libvgen_tpu_torch_{unit}-{source_stamp(unit)}.so"


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


def build(units=UNITS) -> Dict[str, Path]:
    """Compile every unit of ``units`` that is not cached, one nvcc per
    unit started together; -> {unit: library path}.  The compiler's output
    (``-Xptxas -v``: registers, spills) is kept beside each library as
    ``.log``."""
    paths = {u: library_path(u) for u in units}
    todo = [u for u in units if not paths[u].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    procs = {}
    for u in todo:
        tmp = paths[u].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(u), "-o", str(tmp),
               str(_source_dirs(u)[-1] / f"{u}.cu")]
        procs[u] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    results = {}

    def finish(u, proc):  # drain the output; note this unit's own seconds
        out, _ = proc.communicate()
        results[u] = (out, time.time() - t0)

    waiters = [threading.Thread(target=finish, args=(u, proc))
               for u, (_, _, proc) in procs.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    failed = []
    for u, (cmd, tmp, proc) in procs.items():
        out, secs = results[u]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}")
            continue
        paths[u].with_suffix(".log").write_text(
            f"# {' '.join(cmd)}\n# {secs:.1f} s\n{out}")
        os.replace(tmp, paths[u])  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build_log(units=UNITS) -> str:
    """The compiler output of the last build of each unit of ``units``."""
    logs = [library_path(u).with_suffix(".log") for u in units]
    return "".join(p.read_text() for p in logs if p.exists())


def load(unit: str = "kernels") -> ctypes.CDLL:
    """The kernel library of ``unit`` with its C signatures set; a product
    unit builds every product unit if needed, the probe unit itself."""
    with _lock:
        if unit in _libs:
            return _libs[unit]
        if unit not in UNITS + PROBE_UNITS:
            raise ValueError(f"unknown kernel unit {unit!r}")
        group = UNITS if unit in UNITS else (unit,)
        from vgen_tpu_torch import tracing

        # the product group's first load: the build check and the dlopen
        stage = (tracing.stage("start.kernels") if group == UNITS
                 else tracing.NOOP)
        stage.begin()
        paths = build(group)
        p, i = ctypes.c_void_p, ctypes.c_int
        signatures = {
            "kernels": {
                "vgen_batch_inverse_dx": [p, p, p, p, i, i, i, i, p],
                "vgen_base_advance": [p, p, p, p, i, i, p],
                "vgen_range_glv_match": [i, p, p, p, p, p, p, p, i, p, p, i, i,
                                         p],
                "vgen_range_match": [i, p, p, p, p, p, p, p, i, p, p, i, i, p],
                "vgen_dfa_match": [i, p, p, p, p, p, p, p, i, i, i, i, p, p,
                                   i, i, p],
                "vgen_glv_dfa_match": [p, p, p, p, p, p, p, i, i, i, p, p, i,
                                       i, p],
            },
            "p2tr": {
                "vgen_p2tr_ladder": [p, p, p, p, p, p, p, p, p, i, i, i, i,
                                     p],
                "vgen_p2tr_ladder_affine": [p, p, p, p, p, p, i, i, i, p],
                "vgen_batch_inverse_chain": [p, p, p, i, i, i, p],
                "vgen_p2tr_finish_range": [p, p, p, p, p, p, i, p, p, i, i, p],
                "vgen_p2tr_finish_match": [i, p, p, p, p, p, p, i, i, i, p, p,
                                           i, i, p],
            },
            "tables": {
                "vgen_table_grow": [p, p, p, p, p, i, i, i, i, i, i, p],
                "vgen_table_affine": [p, p, p, p, p, i, i, i, p],
            },
            "probes": {
                "vgen_probe_primitive": [i, p, p, p, p, i, i, p],
                "vgen_probe_issue": [i, i, p, p, p, i, i, p],
                "vgen_probe_fieldmul": [i, p, p, p, i, i, p],
                "vgen_probe_glv_stage": [i, p, p, p, p, p, p, p, i, p, p, i,
                                         i, p],
                "vgen_probe_vtile": [i, i, p, p, p, p, p, p, p, i, p, p, i, i,
                                     p],
                "vgen_probe_rows": [i, i, p, p, i, i, i, p],
                "vgen_probe_rows_blocks_per_sm": [i, i, i],
                "vgen_probe_layout": [i, p, p, p, i, i, p],
                "vgen_probe_single_key": [i, i, i, p, p, p, p, p, p, p, i, p, p,
                                          i, i, i, p, p, i, i, p],
                "vgen_probe_p2tr_match": [i, i, p, p, p, p, p, p, i, i, i, p,
                                          p, i, i, p],
                "vgen_probe_dfa_blocks_per_sm": [i, i],
                "vgen_probe_inv_stage": [i, p, p, p, p, p, i, i, i, i, p],
                "vgen_probe_inv_lane": [p, p, i, p],
                "vgen_probe_ladder_stage": [i, p, p, p, p, p, p, p, p, p, i,
                                            i, p],
            },
        }
        for u in group:
            lib = ctypes.CDLL(str(paths[u]))
            for name, argtypes in signatures[u].items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, i
            _libs[u] = lib
        stage.end()
        return _libs[unit]
