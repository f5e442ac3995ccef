"""Native C++ CPU scanner: build-on-demand + ctypes binding.

The port's own copy of ``vgen_tpu/native`` (the counterpart of the
reference's rayon CPU path, reference src/scanner.rs:76-330):
incremental-EC batch adds with one Montgomery inversion per batch,
std::thread over sub-ranges.  Used as the CPU scanner (--no-device), for
`estimate` calibration and for the bulk re-derivation of device-reported
keys; the pure-Python oracle remains the correctness ground truth.

g++ builds ``src/scanner.cc`` at first use into ``build/vgen_tpu_torch/
native/`` at the repository root (gitignored), named by a hash of the
sources.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
_LIB_NAME = "libvgen_native.so"

FMT_CODES = {
    "p2pkh": 0,
    "p2pkh-uncompressed": 1,
    "p2wpkh": 2,
    "p2sh-p2wpkh": 3,
    "p2tr": 4,
    "ethereum": 5,
}

_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None


def _cache_dir() -> str:
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                     os.pardir, "build", "vgen_tpu_torch", "native")
    os.makedirs(d, exist_ok=True)
    return os.path.normpath(d)


def _build(lib_path: str) -> None:
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-o", tmp,
        os.path.join(_SRC_DIR, "scanner.cc"),
        "-lpthread",
    ]
    subprocess.run(
        cmd, check=True, capture_output=True, text=True, timeout=300
    )
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing


def _source_stamp() -> str:
    import hashlib

    h = hashlib.sha256()
    for name in sorted(os.listdir(_SRC_DIR)):
        with open(os.path.join(_SRC_DIR, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        lib_path = os.path.join(
            _cache_dir(), f"{_source_stamp()}-{_LIB_NAME}"
        )
        try:
            if not os.path.exists(lib_path):
                _build(lib_path)
            lib = ctypes.CDLL(lib_path)
        except Exception as e:  # toolchain missing, build failure, ...
            _build_error = str(e)
            return None
        lib.vgen_tables_new.restype = ctypes.c_void_p
        lib.vgen_tables_new.argtypes = [ctypes.c_int]
        lib.vgen_tables_free.argtypes = [ctypes.c_void_p]
        lib.vgen_scan.restype = ctypes.c_longlong
        lib.vgen_scan.argtypes = [
            ctypes.c_char_p,  # start_key32
            ctypes.c_ulonglong,  # count
            ctypes.c_int,  # fmt
            ctypes.POINTER(ctypes.c_int32),  # dfa_table
            ctypes.c_int,  # n_states
            ctypes.c_int,  # n_classes
            ctypes.POINTER(ctypes.c_int32),  # classes258
            ctypes.POINTER(ctypes.c_uint8),  # accept
            ctypes.c_int,  # dfa_start
            ctypes.c_void_p,  # tables
            ctypes.c_int,  # n_threads
            ctypes.POINTER(ctypes.c_ulonglong),  # match_offsets
            ctypes.c_int,  # max_matches
            ctypes.POINTER(ctypes.c_ulonglong),  # ops_out
            ctypes.POINTER(ctypes.c_int),  # stop_flag (volatile int*)
        ]
        lib.vgen_derive_address.restype = ctypes.c_longlong
        lib.vgen_derive_address.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int
        ]
        lib.vgen_derive_addresses.restype = None
        lib.vgen_derive_addresses.argtypes = [
            ctypes.c_char_p,  # keys (n*32 bytes)
            ctypes.c_longlong,  # n
            ctypes.c_int,  # fmt
            ctypes.c_char_p,  # out (n*stride chars)
            ctypes.c_int,  # stride
            ctypes.c_int,  # n_threads (0 = hw concurrency)
        ]
        lib.vgen_pubkey.restype = None
        lib.vgen_pubkey.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    get_lib()
    return _build_error


class NativeScanner:
    """Holds the shared i*G table + compiled DFA arrays for repeated scans."""

    def __init__(self, batch: int = 1024):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native scanner unavailable: {_build_error}")
        self._lib = lib
        self._tables = lib.vgen_tables_new(batch)
        self.batch = batch

    def __del__(self):
        try:
            if getattr(self, "_tables", None):
                self._lib.vgen_tables_free(self._tables)
        except Exception:
            pass

    def scan(
        self,
        start_key: int,
        count: int,
        fmt_value: str,
        dfa,
        n_threads: int = 0,
        max_matches: int = 256,
        stop_buf: Optional["ctypes.Array"] = None,
    ) -> Tuple[List[int], int]:
        """Scan [start_key, start_key+count) -> (matching keys, ops)."""
        fmt_code = FMT_CODES[fmt_value]
        table = np.ascontiguousarray(dfa.table, dtype=np.int32)
        classes = np.ascontiguousarray(dfa.classes, dtype=np.int32)
        accept = np.ascontiguousarray(
            dfa.accept.astype(np.uint8), dtype=np.uint8
        )
        out = (ctypes.c_ulonglong * max_matches)()
        ops = ctypes.c_ulonglong(0)
        stop_ptr = (
            ctypes.cast(stop_buf, ctypes.POINTER(ctypes.c_int))
            if stop_buf is not None
            else ctypes.POINTER(ctypes.c_int)()
        )
        n = self._lib.vgen_scan(
            start_key.to_bytes(32, "big"),
            count,
            fmt_code,
            table.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            table.shape[0],
            table.shape[1],
            classes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            accept.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            dfa.start,
            self._tables,
            n_threads,
            out,
            max_matches,
            ctypes.byref(ops),
            stop_ptr,
        )
        keys = sorted(start_key + int(out[i]) for i in range(n))
        return keys, int(ops.value)


def pubkey_point(key: int) -> Optional[Tuple[int, int]]:
    """k*G via the native code (~10us vs ~30ms for the pure-Python ladder).

    Used by the device scan loop, which needs one base point per dispatched
    window -- with pure Python this dominated the whole scan."""
    lib = get_lib()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(64)
    lib.vgen_pubkey(key.to_bytes(32, "big"), buf)
    raw = buf.raw
    return int.from_bytes(raw[:32], "big"), int.from_bytes(raw[32:], "big")


def derive_addresses(
    keys: List[int], fmt_value: str, n_threads: int = 0
) -> Optional[List[Optional[str]]]:
    """Bulk key -> address derivation (one C call, std::thread inside).

    Returns a list aligned with `keys` (None where derivation failed, e.g.
    P2TR tweak overflow), or None if the native library is unavailable.
    ~20us/key single-threaded; the scan loop's winner re-derivation uses
    this so easy patterns don't serialize one ctypes round trip per
    candidate."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(keys)
    if n == 0:
        return []
    stride = 96
    buf = ctypes.create_string_buffer(n * stride)
    blob = b"".join(k.to_bytes(32, "big") for k in keys)
    lib.vgen_derive_addresses(
        blob, n, FMT_CODES[fmt_value], buf, stride, n_threads
    )
    raw = buf.raw
    out: List[Optional[str]] = []
    for i in range(n):
        chunk = raw[i * stride:(i + 1) * stride]
        end = chunk.find(b"\0")
        out.append(chunk[:end].decode() if end > 0 else None)
    return out


def derive_address(key: int, fmt_value: str) -> Optional[str]:
    """Single-key derivation through the native code (self-test helper)."""
    lib = get_lib()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(96)
    n = lib.vgen_derive_address(
        key.to_bytes(32, "big"), FMT_CODES[fmt_value], buf, 96
    )
    if n < 0:
        return None
    return buf.value.decode()
