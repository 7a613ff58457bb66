"""ctypes bridge to the C++ host builders (``native/gnntf_native.cc``, the
JAX package's native runtime ops): the negative sampler of link prediction
(:func:`available`, :func:`_edge_hashes`, :func:`negative_sample_native`),
the radix argsort of edges by (row, col) (:func:`lexsort_edges`, which
``graph/coo.py::from_edges`` takes at or above 100,000 edges) and the
one-pass row-split ELL build (:func:`build_ell_native`, which
``ops/spmm.py::build_ell`` takes without deduplication).  The source is
compiled with ``g++ -O3 -std=c++17 -fPIC -shared`` (the flags of
``native/Makefile``) into the port's ``gnntf_tpu_torch/build/
libgnntf_native.so`` on first use, and again when the source is newer than
the library; nothing is written into ``native/``.  When the library cannot
be built or loaded, each function returns None and its caller takes its
numpy or Python path, as in the JAX package; :data:`error` then says why.
The two builders count the calls that the library served (``runs``).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "gnntf_native.cc"
LIBRARY = Path(__file__).resolve().parents[1] / "build" / "libgnntf_native.so"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib = None
_tried = False
error: Optional[str] = None  # why the library is missing, once tried


def _build() -> None:
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", str(tmp),
           str(SOURCE)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=300)
        os.replace(tmp, LIBRARY)
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if SOURCE.exists() and (
                    not LIBRARY.exists()
                    or SOURCE.stat().st_mtime > LIBRARY.stat().st_mtime):
                _build()
            lib = ctypes.CDLL(str(LIBRARY))
        except subprocess.CalledProcessError as exc:
            error = f"g++ failed on {SOURCE}: {exc.stderr}"
            return None
        except (OSError, subprocess.SubprocessError) as exc:
            error = f"{type(exc).__name__}: {exc}"
            return None
        i64 = ctypes.c_int64
        p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        pu64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.gnntf_negative_sample.restype = i64
        lib.gnntf_negative_sample.argtypes = [
            p64, i64, p64, i64, pu64, i64, i64, ctypes.c_uint64, p64]
        lib.gnntf_sort_unique_u64.restype = i64
        lib.gnntf_sort_unique_u64.argtypes = [pu64, i64]
        lib.gnntf_lexsort_edges.restype = None
        lib.gnntf_lexsort_edges.argtypes = [p32, p32, i64, p64]
        lib.gnntf_build_ell.restype = i64
        lib.gnntf_build_ell.argtypes = [p32, p32, i64, i64, i64, i64, p32,
                                        p32, p32]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _edge_hashes(sampler) -> np.ndarray:
    """The sampler's symmetric edge set as sorted unique ``u << 32 | v``
    keys, made once per sampler."""
    cached = getattr(sampler, "_native_hashes", None)
    if cached is not None:
        return cached
    arcs = sampler.arcs
    keys = np.concatenate([
        (arcs[:, 0].astype(np.uint64) << np.uint64(32))
        | arcs[:, 1].astype(np.uint64),
        (arcs[:, 1].astype(np.uint64) << np.uint64(32))
        | arcs[:, 0].astype(np.uint64)])
    n = _load().gnntf_sort_unique_u64(keys, len(keys))
    keys = keys[:n].copy()
    sampler._native_hashes = keys
    return keys


def negative_sample_native(sampler, out: np.ndarray,
                           seed: int) -> Optional[bool]:
    """Fill ``out`` (positives and negatives, interleaved) in C++ from
    ``seed``.  Returns True when filled, None to send the caller to its
    Python path (library missing, or the sampler has a custom ``pool``).
    The ctypes call releases the GIL, so a prefetch thread sampling the next
    epoch overlaps the device step of this one."""
    lib = _load()
    if lib is None or sampler._negative_pool is not None:
        return None
    pos = np.ascontiguousarray(sampler.positive_edges, np.int64)
    neg_nodes = np.ascontiguousarray(sampler.negative_nodes, np.int64)
    hashes = _edge_hashes(sampler)
    if out.dtype != np.int64 or not out.flags.c_contiguous:
        raise ValueError("negative_sample_native fills a C-contiguous "
                         "int64 buffer")
    rc = lib.gnntf_negative_sample(
        pos.reshape(-1), len(pos), neg_nodes, len(neg_nodes), hashes,
        len(hashes), sampler.samples, int(seed), out.reshape(-1))
    if rc != 0:
        return None
    return True


def lexsort_edges(row: np.ndarray, col: np.ndarray) -> Optional[np.ndarray]:
    """The stable argsort of the edges by (row, col), ``np.lexsort((col,
    row))``, as int64, by an LSD radix sort in C++ (ids non-negative and
    below 2**31); None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    row = np.ascontiguousarray(row, np.int32)
    col = np.ascontiguousarray(col, np.int32)
    order = np.empty(len(row), np.int64)
    lib.gnntf_lexsort_edges(row, col, len(row), order)
    lexsort_edges.runs += 1
    return order


lexsort_edges.runs = 0


def build_ell_native(row: np.ndarray, col: np.ndarray, n_nodes: int,
                     k: int, n_vrows: int):
    """The row-split ELL layout of ``ops/spmm.py::build_ell`` without
    deduplication in one C++ pass over the edges in any order: int32
    ``idx`` (``n_vrows``, k), ``slot`` (E,) and ``vrow_row``
    (``n_vrows``,), where ``n_vrows`` is the sum over rows of
    ``ceil(degree / k)``.  None when the library is unavailable or a row id
    is out of range."""
    lib = _load()
    if lib is None:
        return None
    row = np.ascontiguousarray(row, np.int32)
    col = np.ascontiguousarray(col, np.int32)
    idx = np.empty(n_vrows * k, np.int32)
    slot = np.empty(len(row), np.int32)
    vrow_row = np.empty(n_vrows, np.int32)
    if lib.gnntf_build_ell(row, col, len(row), n_nodes, k, n_vrows, idx,
                           slot, vrow_row) != 0:
        return None
    build_ell_native.runs += 1
    return idx.reshape(n_vrows, k), slot, vrow_row


build_ell_native.runs = 0
