"""ctypes bindings for the native (C++) components.

The shared library builds with `make -C native` (g++, no external deps) and
is loaded lazily; every user has a pure-Python fallback, so the framework
works without a toolchain and accelerates when the library is present.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libdcp_native.so")

_lib = None
_lib_tried = False


def _configure(lib) -> None:
    lib.dcp_h3_open.restype = ctypes.c_void_p
    lib.dcp_h3_open.argtypes = [ctypes.c_char_p]
    lib.dcp_h3_close.argtypes = [ctypes.c_void_p]
    lib.dcp_h3_next.restype = ctypes.c_int
    lib.dcp_h3_next.argtypes = [ctypes.c_void_p]
    for fn in ("dcp_h3_error", "dcp_h3_name", "dcp_h3_accession",
               "dcp_h3_residues", "dcp_h3_consensus"):
        getattr(lib, fn).restype = ctypes.c_char_p
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ("dcp_h3_match", "dcp_h3_insert", "dcp_h3_trans"):
        getattr(lib, fn).restype = ctypes.POINTER(ctypes.c_double)
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.dcp_h3_count.restype = ctypes.c_long
    lib.dcp_h3_count.argtypes = [ctypes.c_char_p]
    lib.dcp_xxh3_64.restype = ctypes.c_uint64
    lib.dcp_xxh3_64.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.dcp_xxh3_64_file.restype = ctypes.c_uint64
    lib.dcp_xxh3_64_file.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)
    ]


def build() -> bool:
    """Build the native library, or bring it up to date with its sources
    (make rebuilds only what changed); returns True if it exists after."""
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR],
            check=True, capture_output=True, timeout=120,
        )
    except Exception:  # noqa: BLE001 — fallback path exists
        pass
    return os.path.exists(_LIB_PATH)


def load():
    """Load (building if needed) the native library, or None."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    if not build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        _configure(lib)
        _lib = lib
    except (OSError, AttributeError):  # unbuildable or stale library
        _lib = None
    return _lib


def available() -> bool:
    return load() is not None
