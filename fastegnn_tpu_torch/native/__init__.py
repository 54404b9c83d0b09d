"""Host-side graph construction in C++ (counterpart of ``fastegnn_tpu/native``).

``graphcore.cpp`` is compiled with g++ on first use into
``_build/graphcore-<hash of the source>.so`` (``ops/_cuda_build.py``) and
bound with ctypes.  A failed build or load raises with the compiler's
output; there is no fallback.  Beside each entry point stands its plain
numpy version (``*_plain``), which the tests hold it against.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from fastegnn_tpu_torch.ops import _cuda_build

_LIB: Optional[ctypes.CDLL] = None
_F32 = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _cuda_build.load("graphcore")
        lib.radius_graph.restype = ctypes.c_int64
        lib.radius_graph.argtypes = [_F32, ctypes.c_int64, ctypes.c_float, _I32, _I32,
                                     ctypes.c_int64]
        lib.counting_argsort.restype = None
        lib.counting_argsort.argtypes = [_I32, ctypes.c_int64, ctypes.c_int64, _I32]
        lib.bincount.restype = None
        lib.bincount.argtypes = [_I32, ctypes.c_int64, ctypes.c_int64, _F32]
        _LIB = lib
    return _LIB


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_F32)


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(_I32)


def radius_graph(loc: np.ndarray, r: float) -> Tuple[np.ndarray, np.ndarray]:
    """``(dst, src)`` int32: both directions of every pair of points with
    ``0 < d^2 < r^2`` in f32 (no self loops, coincident points left out),
    from a cell list, in its walk's order (the JAX package's
    ``native.radius_graph``)."""
    lib = _lib()
    loc32 = np.ascontiguousarray(loc, np.float32)
    n = loc32.shape[0]
    count = lib.radius_graph(_fptr(loc32), n, r, None, None, 0)
    dst = np.empty(count, np.int32)
    src = np.empty(count, np.int32)
    got = lib.radius_graph(_fptr(loc32), n, r, _iptr(dst), _iptr(src), count)
    if got != count:
        raise RuntimeError(f"radius_graph emitted {got} edges, counted {count}")
    return dst, src


def counting_argsort(keys: np.ndarray, n_bins: int) -> np.ndarray:
    """The stable argsort (int32) of int keys in ``[0, n_bins)``, O(n +
    n_bins); out-of-range keys sort last, in their own order."""
    k = np.ascontiguousarray(keys, np.int32)
    out = np.empty(k.shape[0], np.int32)
    _lib().counting_argsort(_iptr(k), k.shape[0], n_bins, _iptr(out))
    return out


def bincount_f32(keys: np.ndarray, n_bins: int) -> np.ndarray:
    """``[n_bins]`` f32 counts of the keys in ``[0, n_bins)``; other keys
    are dropped."""
    k = np.ascontiguousarray(keys, np.int32)
    out = np.empty(n_bins, np.float32)
    _lib().bincount(_iptr(k), k.shape[0], n_bins, _fptr(out))
    return out


# plain versions, for the tests


def radius_graph_plain(loc: np.ndarray, r: float) -> Tuple[np.ndarray, np.ndarray]:
    """The pairs of :func:`radius_graph` by brute force over all pairs, in
    (dst, src) order; ``d^2`` in f64, so pairs within rounding of ``r``
    may differ."""
    loc = np.asarray(loc, np.float64)
    d2 = ((loc[:, None] - loc[None]) ** 2).sum(-1)
    dst, src = np.nonzero((d2 < np.float64(np.float32(r)) ** 2) & (d2 > 0))
    return dst.astype(np.int32), src.astype(np.int32)


def counting_argsort_plain(keys: np.ndarray, n_bins: int) -> np.ndarray:
    k = np.asarray(keys, np.int32)
    return np.argsort(np.where((k >= 0) & (k < n_bins), k, n_bins),
                      kind="stable").astype(np.int32)


def bincount_f32_plain(keys: np.ndarray, n_bins: int) -> np.ndarray:
    k = np.asarray(keys, np.int32)
    return np.bincount(k[(k >= 0) & (k < n_bins)], minlength=n_bins).astype(np.float32)
