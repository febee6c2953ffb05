"""ctypes bindings for the native LMDB reader (`native/lmdb_reader.cpp`;
port of `udifftext_tpu/data/lmdb_native.py`).

The reference's LMDB hot path is the C liblmdb behind the `lmdb` package
(src/parseq/strhub/data/dataset.py:31-137); `data/lmdb.py` implements the
format in Python. This module is the native read path: the C++ reader is
compiled at first use with the system g++ into `udifftext_tpu_torch/_build/`
(named by a hash of the source, ~1 s, no dependencies) and exposed as
`NativeLMDBReader` with `LMDBReader`'s interface (get / items / __len__ /
context manager).

`available()` is False when there is no compiler or the build fails;
`open_lmdb` then uses the Python reader, unless UDIFFTEXT_LMDB=native asks
for this one, which then raises.

`get` returns `bytes` copied out of the mmap at the Python boundary (the
C++ side reads straight from the mapping; the copy is the cost of a safe
Python object, as python-lmdb's default buffers=False).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "native" / "lmdb_reader.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> Path:
    """Where the library for the current source lives (built or not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libulmdb_{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> Optional[str]:
    """Compile the shared library; returns an error string or None."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{type(e).__name__}: {e}"
    if proc.returncode != 0:
        return proc.stderr[-2000:]
    os.replace(tmp, lib)  # atomic against concurrent builders
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        path = library_path()
        if not path.exists():
            err = _build(path)
            if err is not None:
                _build_error = err
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _build_error = str(e)
            return None
        lib.ulmdb_open.restype = ctypes.c_void_p
        lib.ulmdb_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t]
        lib.ulmdb_close.restype = None
        lib.ulmdb_close.argtypes = [ctypes.c_void_p]
        lib.ulmdb_entries.restype = ctypes.c_uint64
        lib.ulmdb_entries.argtypes = [ctypes.c_void_p]
        lib.ulmdb_get.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.ulmdb_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int),
        ]
        lib.ulmdb_cursor.restype = ctypes.c_void_p
        lib.ulmdb_cursor.argtypes = [ctypes.c_void_p]
        lib.ulmdb_cursor_next.restype = ctypes.c_int
        lib.ulmdb_cursor_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.ulmdb_cursor_close.restype = None
        lib.ulmdb_cursor_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


class NativeLMDBReader:
    """LMDBReader's interface over the C++ reader."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native LMDB reader unavailable: {_build_error}")
        self._lib = lib
        self.path = path
        err = ctypes.create_string_buffer(512)
        self._h = lib.ulmdb_open(path.encode(), err, len(err))
        if not self._h:
            raise ValueError(err.value.decode() or f"{path}: open failed")
        self.entries = int(lib.ulmdb_entries(self._h))

    def get(self, key: bytes) -> Optional[bytes]:
        vlen = ctypes.c_uint64()
        rc = ctypes.c_int()
        ptr = self._lib.ulmdb_get(self._h, key, len(key), ctypes.byref(vlen), ctypes.byref(rc))
        if rc.value == 2:
            raise ValueError(f"{self.path}: malformed page during get")
        if not ptr:
            return None
        return ctypes.string_at(ptr, vlen.value)

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        cur = self._lib.ulmdb_cursor(self._h)
        try:
            k = ctypes.POINTER(ctypes.c_uint8)()
            v = ctypes.POINTER(ctypes.c_uint8)()
            klen = ctypes.c_uint64()
            vlen = ctypes.c_uint64()
            while True:
                r = self._lib.ulmdb_cursor_next(cur, ctypes.byref(k), ctypes.byref(klen),
                                                ctypes.byref(v), ctypes.byref(vlen))
                if r == 0:
                    return
                if r < 0:
                    raise ValueError(f"{self.path}: malformed page during scan")
                yield ctypes.string_at(k, klen.value), ctypes.string_at(v, vlen.value)
        finally:
            self._lib.ulmdb_cursor_close(cur)

    def __len__(self) -> int:
        return self.entries

    def close(self):
        if self._h:
            self._lib.ulmdb_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # close() is the contract; this frees a forgotten handle
        try:
            self.close()
        except Exception:
            pass
