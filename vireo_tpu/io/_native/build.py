"""Compile-on-first-use loader for the native VCF/mtx parser.

Builds `vcfio.cpp` with the system g++ (no pybind11 — plain C ABI +
ctypes) into `_vcfio-<hash>.so` next to the source, where <hash> is
the source's content hash: a library built from other source is never
loaded, whatever its mtime. A library that exists but does not load
(built on another system) is rebuilt once. If no toolchain is present,
`lib()` returns None and the pure-Python readers take over.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "vcfio.cpp")

_lock = threading.Lock()
_lib = None
_tried = False


def so_path():
    """Where the library built from the current source lives."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_HERE, "_vcfio-%s.so" % digest)


class CellVcfView(ctypes.Structure):
    _fields_ = [
        ("n_var", ctypes.c_int64),
        ("n_samp", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("n_tags", ctypes.c_int32),
        ("variants", ctypes.c_char_p),
        ("samples", ctypes.c_char_p),
        ("fixed", ctypes.c_char_p),
        ("comments", ctypes.c_char_p),
        ("indptr", ctypes.POINTER(ctypes.c_int64)),
        ("indices", ctypes.POINTER(ctypes.c_int32)),
        ("values", ctypes.POINTER(ctypes.c_double)),
        ("error", ctypes.c_char_p),
        ("impl", ctypes.c_void_p),
    ]


def _compile(so):
    tmp = so + ".%d.tmp" % os.getpid()
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
           _SRC, "-o", tmp, "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic vs concurrent builders
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def _build():
    if os.environ.get("VIREO_NO_NATIVE"):
        return None
    so = so_path()
    if not os.path.exists(so) and not _compile(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        if not _compile(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
    lib.cellvcf_load.restype = ctypes.POINTER(CellVcfView)
    lib.cellvcf_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_char_p, ctypes.c_int]
    lib.cellvcf_free.restype = None
    lib.cellvcf_free.argtypes = [ctypes.POINTER(CellVcfView)]
    lib.mmread_coo.restype = ctypes.c_int64
    lib.mmread_coo.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_int64),
                               ctypes.POINTER(ctypes.c_int32),
                               ctypes.POINTER(ctypes.c_int32),
                               ctypes.POINTER(ctypes.c_double)]
    lib.mmread_csc.restype = ctypes.c_int64
    lib.mmread_csc.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_int64),
                               ctypes.POINTER(ctypes.c_int64),
                               ctypes.POINTER(ctypes.c_int32),
                               ctypes.POINTER(ctypes.c_double)]
    lib.write_matrix_tsv.restype = ctypes.c_int64
    lib.write_matrix_tsv.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_double),
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_char_p, ctypes.c_int32]
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.union_csr.restype = ctypes.c_int64
    lib.union_csr.argtypes = [ctypes.c_int64, i64p, i32p, f64p,
                              i64p, i32p, f64p, i32p, i32p, f64p, f64p]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.encode_counts_stats.restype = ctypes.c_int64
    lib.encode_counts_stats.argtypes = [ctypes.c_int64, i64p, i32p, f64p,
                                        i64p, i32p, f64p, i64p]
    lib.encode_counts_fill.restype = ctypes.c_int64
    lib.encode_counts_fill.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                       i64p, i32p, f64p, i64p, i32p, f64p,
                                       ctypes.c_int64, ctypes.c_int64,
                                       i32p, i32p, u8p, i32p, i8p, i8p]
    lib.delta_encode_cols.restype = ctypes.c_int64
    lib.delta_encode_cols.argtypes = [i32p, ctypes.c_int64, u8p, i32p,
                                      i32p, ctypes.c_int64]
    lib.collect_overflow_csc.restype = ctypes.c_int64
    lib.collect_overflow_csc.argtypes = [ctypes.c_int64, i64p, i32p,
                                         f64p, i64p, i32p, f64p, i32p,
                                         i32p, f64p, f64p,
                                         ctypes.c_int64]
    return lib


def lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            _lib = _build()
            _tried = True
    return _lib


def available():
    return lib() is not None
