"""ctypes bindings for the native host IO library (native/repkiller_io.cpp).

The reference's C/C++ is its readers/writers/codec (SURVEY.md §2.1, §2.2);
this module is the framework's equivalent native layer. Every entry
point has a numpy fallback with identical output, so the package works
without a toolchain; when g++ is available the library is built once on
demand (a few hundred ms) and kept next to its source (git-ignored).

Public surface:
  available() -> bool
  parse_fasta(data: bytes) -> (codes, offsets, lengths)      # no names
  pack_2bit(codes) -> (packed, nmask, length)
  revcomp(codes) -> codes
  write_frags_csv(path, header, frag, self_cmp) -> n_rows
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "repkiller_io.cpp")


def _so_path() -> str:
    """Build target inside the checkout, next to the source, keyed by
    source mtime so a changed .cpp never collides with a stale build."""
    tag = int(os.path.getmtime(_SRC)) if os.path.exists(_SRC) else 0
    return os.path.join(os.path.dirname(_SRC), f"librepkiller_io-{tag}.so")


_SO = None   # resolved lazily in _load (depends on source mtime)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i64 = ctypes.c_int64
_p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_p_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _SO
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        _SO = _so_path()
        if not os.path.exists(_SO):
            try:
                tmp = _SO + f".tmp{os.getpid()}"
                subprocess.run(
                    ["g++", "-O3", "-fPIC", "-shared", "-pthread",
                     "-std=c++17", "-o", tmp, _SRC],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, _SO)     # atomic: concurrent builds race safely
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.rk_fasta_sizes.restype = _i64
        lib.rk_fasta_sizes.argtypes = [ctypes.c_char_p, _i64, _i64,
                                       ctypes.POINTER(_i64)]
        lib.rk_fasta_parse.restype = _i64
        lib.rk_fasta_parse.argtypes = [ctypes.c_char_p, _i64, _i64, _p_u8,
                                       _p_i64, _p_i64]
        lib.rk_pack_2bit.restype = None
        lib.rk_pack_2bit.argtypes = [_p_u8, _i64, _p_u32, _p_u32,
                                     ctypes.c_int32]
        lib.rk_revcomp.restype = None
        lib.rk_revcomp.argtypes = [_p_u8, _i64, _p_u8]
        lib.rk_write_frags_csv.restype = _i64
        lib.rk_write_frags_csv.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, _i64,
            _p_i32, _p_i32, _p_i32, _p_i32, _p_i32, _p_i32, _p_i32, _p_i32,
            _p_i32, ctypes.c_int32]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def parse_fasta(data: bytes, spacer: int = 1
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """FASTA bytes -> (codes uint8 with N spacers, offsets i64, lengths i64).
    Matches io.fasta.read_fasta bit-identically (names parsed separately)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    nrec = _i64(0)
    total = lib.rk_fasta_sizes(data, len(data), spacer, ctypes.byref(nrec))
    nrec = nrec.value
    codes = np.empty(total, np.uint8)
    offsets = np.empty(max(nrec, 1), np.int64)
    lengths = np.empty(max(nrec, 1), np.int64)
    got = lib.rk_fasta_parse(data, len(data), spacer, codes, offsets, lengths)
    assert got == nrec, (got, nrec)
    return codes, offsets[:nrec], lengths[:nrec]


def pack_2bit(codes: np.ndarray, n_threads: int = 0):
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    codes = np.ascontiguousarray(codes, np.uint8)
    n = codes.shape[0]
    packed = np.empty((n + 15) // 16, np.uint32)
    nmask = np.empty((n + 31) // 32, np.uint32)
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    lib.rk_pack_2bit(codes, n, packed, nmask, n_threads)
    return packed, nmask, n


def revcomp(codes: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    codes = np.ascontiguousarray(codes, np.uint8)
    out = np.empty_like(codes)
    lib.rk_revcomp(codes, codes.shape[0], out)
    return out


def write_frags_csv(path: str, header: str, frag: Dict[str, np.ndarray],
                    self_cmp: bool) -> int:
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    n = int(frag["xStart"].shape[0])
    cols = {}
    for f in ("xStart", "yStart", "xEnd", "yEnd", "strand", "length",
              "score", "idents"):
        cols[f] = np.ascontiguousarray(frag[f], np.int32)
    group = np.ascontiguousarray(
        frag.get("group", np.zeros(n, np.int32)), np.int32)
    got = lib.rk_write_frags_csv(
        path.encode(), header.encode(), n,
        cols["xStart"], cols["yStart"], cols["xEnd"], cols["yEnd"],
        cols["strand"], group, cols["length"], cols["score"],
        cols["idents"], 1 if self_cmp else 0)
    if got != n:
        raise IOError(f"native CSV writer failed for {path!r}")
    return got
