"""ctypes bindings for the native host engine (zt_host.cc).

The shared library is built on demand (g++ is part of the toolchain); the
result is cached under zopfli_tpu_torch/_build/.  All entry points take
numpy buffers.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libzt_host.so")
_SRC_PATH = os.path.join(_HERE, "src", "zt_host.cc")

_lock = threading.Lock()
_lib = None


def _build() -> None:
    # Several processes (pytest workers) may build at once: each writes
    # its own temporary file and renames it into place atomically.
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-fPIC", "-shared",
         "-o", tmp, _SRC_PATH],
        check=True,
    )
    os.replace(tmp, _LIB_PATH)


def lib() -> ctypes.CDLL:
    """Load (building if needed) the native library."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB_PATH)
                or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC_PATH)):
            _build()
        l = ctypes.CDLL(_LIB_PATH)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        f64p = ctypes.POINTER(ctypes.c_double)
        l.zt_greedy.restype = ctypes.c_int64
        l.zt_greedy.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, u16p, u16p]
        l.zt_png_unfilter.restype = ctypes.c_int64
        l.zt_png_unfilter.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, u8p]
        l.zt_block_new.restype = ctypes.c_void_p
        l.zt_block_new.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64]
        l.zt_block_free.restype = None
        l.zt_block_free.argtypes = [ctypes.c_void_p]
        l.zt_squeeze_run.restype = ctypes.c_int64
        l.zt_squeeze_run.argtypes = [ctypes.c_void_p, f64p, f64p, u16p, u16p]
        i32p = ctypes.POINTER(ctypes.c_int32)
        l.zt_cost_new.restype = ctypes.c_void_p
        l.zt_cost_new.argtypes = [u16p, u16p, ctypes.c_int64]
        l.zt_cost_free.restype = None
        l.zt_cost_free.argtypes = [ctypes.c_void_p]
        l.zt_cost_block.restype = ctypes.c_double
        l.zt_cost_block.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_int32]
        l.zt_split_costs.restype = None
        l.zt_split_costs.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_int64),
                                     ctypes.c_int64, f64p]
        l.zt_cost_dynamic_lengths.restype = ctypes.c_double
        l.zt_cost_dynamic_lengths.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                              ctypes.c_int64, i32p, i32p]
        i64p = ctypes.POINTER(ctypes.c_int64)
        i16p = ctypes.POINTER(ctypes.c_int16)
        l.zt_hist_dynamic_cost.restype = ctypes.c_double
        l.zt_hist_dynamic_cost.argtypes = [i64p, i64p, i32p, i32p]
        l.zt_traceback_tiles.restype = ctypes.c_int64
        l.zt_traceback_tiles.argtypes = [i16p, i16p, u8p, i64p,
                                         ctypes.c_int64, ctypes.c_int64,
                                         u16p, u16p]
        l.zt_crc32.restype = ctypes.c_uint32
        l.zt_crc32.argtypes = [ctypes.c_uint32, u8p, ctypes.c_int64]
        l.zt_adler32.restype = ctypes.c_uint32
        l.zt_adler32.argtypes = [ctypes.c_uint32, u8p, ctypes.c_int64]
        _lib = l
        return _lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u16ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))


def greedy(data: np.ndarray, instart: int, inend: int):
    """Greedy+lazy LZ77 parse; returns (litlens, dists) uint16 arrays."""
    l = lib()
    cap = max(inend - instart, 1)
    litlens = np.empty(cap, dtype=np.uint16)
    dists = np.empty(cap, dtype=np.uint16)
    n = l.zt_greedy(_u8ptr(data), instart, inend, _u16ptr(litlens),
                    _u16ptr(dists))
    return litlens[:n].copy(), dists[:n].copy()


def png_unfilter(raw: np.ndarray, height: int, stride: int,
                 bpp_bytes: int) -> np.ndarray:
    """PNG scanline unfilter; returns (height, stride) uint8."""
    l = lib()
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    out = np.empty((height, stride), dtype=np.uint8)
    rc = l.zt_png_unfilter(_u8ptr(raw), height, stride, bpp_bytes,
                           _u8ptr(out.reshape(-1)))
    if rc != 0:
        raise ValueError(f"bad filter type on line {rc - 1}")
    return out


class BlockEngine:
    """Native per-block squeeze engine with memoized match candidates.

    The `data` array must stay alive (and unmoved) for the lifetime of
    this object.
    """

    def __init__(self, data: np.ndarray, instart: int, inend: int):
        self._data = np.ascontiguousarray(data, dtype=np.uint8)
        self._l = lib()
        self._h = self._l.zt_block_new(_u8ptr(self._data), instart, inend)
        self._cap = max(inend - instart, 1)

    def close(self):
        if self._h:
            self._l.zt_block_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def squeeze_run(self, ll_cost=None, d_cost=None):
        """One optimal-parse run.  None cost arrays select the fixed model."""
        litlens = np.empty(self._cap, dtype=np.uint16)
        dists = np.empty(self._cap, dtype=np.uint16)
        if ll_cost is None:
            llp = dp = None
        else:
            ll_cost = np.ascontiguousarray(ll_cost, dtype=np.float64)
            d_cost = np.ascontiguousarray(d_cost, dtype=np.float64)
            llp = ll_cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
            dp = d_cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        n = self._l.zt_squeeze_run(self._h, llp, dp, _u16ptr(litlens),
                                   _u16ptr(dists))
        return litlens[:n].copy(), dists[:n].copy()


class CostContext:
    """Native exact block-cost evaluator over an LZ77 symbol sequence."""

    def __init__(self, litlens: np.ndarray, dists: np.ndarray):
        self._lit = np.ascontiguousarray(litlens, dtype=np.uint16)
        self._dst = np.ascontiguousarray(dists, dtype=np.uint16)
        self._l = lib()
        self._h = self._l.zt_cost_new(_u16ptr(self._lit), _u16ptr(self._dst),
                                      len(self._lit))

    def close(self):
        if self._h:
            self._l.zt_cost_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def block_cost(self, lstart: int, lend: int, btype: int) -> float:
        """Exact bits for one block; btype=-1 selects auto-type."""
        return float(self._l.zt_cost_block(self._h, lstart, lend, btype))

    def split_costs(self, lstart: int, lend: int,
                    idx: np.ndarray) -> np.ndarray:
        """Batched two-sided auto-type costs for candidate split points."""
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        out = np.empty(len(idx), dtype=np.float64)
        self._l.zt_split_costs(
            self._h, lstart, lend,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return out

    def dynamic_lengths(self, lstart: int, lend: int):
        """(cost_bits, ll_lengths[288], d_lengths[32]) for a dynamic block."""
        ll = np.zeros(288, dtype=np.int32)
        d = np.zeros(32, dtype=np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        cost = self._l.zt_cost_dynamic_lengths(
            self._h, lstart, lend, ll.ctypes.data_as(i32p),
            d.ctypes.data_as(i32p))
        return float(cost), ll, d


def hist_dynamic_cost(ll_counts: np.ndarray, d_counts: np.ndarray,
                      want_lengths: bool = False):
    """Exact dynamic-block tree+data bits from histograms alone.

    Returns cost, or (cost, ll_lengths, d_lengths) when want_lengths.
    """
    l = lib()
    ll_c = np.ascontiguousarray(ll_counts, dtype=np.int64)
    d_c = np.ascontiguousarray(d_counts, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    if want_lengths:
        ll_l = np.zeros(288, dtype=np.int32)
        d_l = np.zeros(32, dtype=np.int32)
        cost = l.zt_hist_dynamic_cost(
            ll_c.ctypes.data_as(i64p), d_c.ctypes.data_as(i64p),
            ll_l.ctypes.data_as(i32p), d_l.ctypes.data_as(i32p))
        return float(cost), ll_l, d_l
    cost = l.zt_hist_dynamic_cost(
        ll_c.ctypes.data_as(i64p), d_c.ctypes.data_as(i64p), None, None)
    return float(cost)


def traceback_tiles(cl: np.ndarray, cd: np.ndarray, data_tile: np.ndarray,
                    tile_nbytes: np.ndarray):
    """Batch traceback of parse tiles -> (litlens, dists) uint16 arrays."""
    l = lib()
    cl = np.ascontiguousarray(cl, dtype=np.int16)
    cd = np.ascontiguousarray(cd, dtype=np.int16)
    data_tile = np.ascontiguousarray(data_tile, dtype=np.uint8)
    tile_nbytes = np.ascontiguousarray(tile_nbytes, dtype=np.int64)
    ntiles, tl1 = cl.shape
    tile_len = tl1 - 1
    assert data_tile.shape == (ntiles, tile_len), (data_tile.shape, cl.shape)
    cap = int(tile_nbytes.sum())
    litlens = np.empty(max(cap, 1), dtype=np.uint16)
    dists = np.empty(max(cap, 1), dtype=np.uint16)
    i16p = ctypes.POINTER(ctypes.c_int16)
    i64p = ctypes.POINTER(ctypes.c_int64)
    n = l.zt_traceback_tiles(
        cl.ctypes.data_as(i16p), cd.ctypes.data_as(i16p), _u8ptr(data_tile),
        tile_nbytes.ctypes.data_as(i64p), ntiles, tile_len,
        _u16ptr(litlens), _u16ptr(dists))
    if n < 0:
        raise ValueError("malformed DP path in traceback_tiles")
    return litlens[:n].copy(), dists[:n].copy()


def crc32(data: np.ndarray, value: int = 0) -> int:
    return int(lib().zt_crc32(value, _u8ptr(data), len(data)))


def adler32(data: np.ndarray, value: int = 1) -> int:
    return int(lib().zt_adler32(value, _u8ptr(data), len(data)))
