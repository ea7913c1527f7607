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

from .. import spec

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libzt_host.so")
_SRC_PATH = os.path.join(_HERE, "src", "zt_host.cc")

_lock = threading.Lock()
_lib = None

# parse_index writes a cumulative-histogram checkpoint every this many
# symbols.
INDEX_CHUNK = 1024


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
        vp = ctypes.c_void_p
        l.zt_put_fields.restype = ctypes.c_int64
        l.zt_put_fields.argtypes = [vp, ctypes.c_int64, ctypes.c_int64, vp,
                                    vp, ctypes.c_int64]
        l.zt_put_lz77.restype = ctypes.c_int64
        l.zt_put_lz77.argtypes = [vp, ctypes.c_int64, ctypes.c_int64, vp, vp,
                                  ctypes.c_int64, vp, vp, vp, vp]
        l.zt_parse_index.restype = ctypes.c_int64
        l.zt_parse_index.argtypes = [vp, vp, vp] + [ctypes.c_int64] * 5 + [
            ctypes.c_int32, vp, vp, vp, vp, vp]
        l.zt_tree_sizes.restype = None
        l.zt_tree_sizes.argtypes = [i32p, i32p, i64p]
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


def tree_sizes(ll_lengths: np.ndarray, d_lengths: np.ndarray) -> np.ndarray:
    """Bits of the 8 tree-header encodings of a dynamic block (variant i
    uses code 16 if i & 1, 17 if i & 2, 18 if i & 4)."""
    ll = np.ascontiguousarray(ll_lengths, dtype=np.int32)
    d = np.ascontiguousarray(d_lengths, dtype=np.int32)
    if ll.shape != (288,) or d.shape != (32,):
        raise ValueError("tree_sizes takes 288 and 32 code lengths")
    out = np.empty(8, dtype=np.int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib().zt_tree_sizes(ll.ctypes.data_as(i32p), d.ctypes.data_as(i32p),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


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


def _writable_u8(buf: np.ndarray) -> None:
    if (buf.dtype != np.uint8 or buf.ndim != 1
            or not buf.flags.c_contiguous or not buf.flags.writeable):
        raise ValueError("the bit writer needs a writable 1-D uint8 buffer")


def put_fields(buf: np.ndarray, bit: int, values: np.ndarray,
               nbits: np.ndarray) -> int:
    """Write LSB-first fields into `buf` (zero past bit offset `bit`, with
    8 spare bytes past the fields) and return the bit offset after them."""
    _writable_u8(buf)
    values = np.ascontiguousarray(values, dtype=np.uint64)
    nbits = np.ascontiguousarray(nbits, dtype=np.int64)
    if values.shape != nbits.shape:
        raise ValueError("put_fields: values and nbits differ in shape")
    end = lib().zt_put_fields(buf.ctypes.data, buf.size, bit,
                              values.ctypes.data, nbits.ctypes.data,
                              values.size)
    if end < 0:
        raise ValueError("put_fields: a width outside 0..64, or the fields"
                         " run past the buffer")
    return end


def put_lz77(buf: np.ndarray, bit: int, litlens: np.ndarray,
             dists: np.ndarray, ll_codes: np.ndarray, ll_lengths: np.ndarray,
             d_codes: np.ndarray, d_lengths: np.ndarray) -> int:
    """Write a block's symbol payload into `buf` (zero past bit offset
    `bit`, with 8 spare bytes past the payload) and return the bit offset
    after it.

    litlens/dists: the block's symbols (int32); ll_codes/ll_lengths (288)
    and d_codes/d_lengths (32): its bit-reversed codes and their lengths.
    """
    _writable_u8(buf)
    litlens = np.ascontiguousarray(litlens, dtype=np.int32)
    dists = np.ascontiguousarray(dists, dtype=np.int32)
    if litlens.shape != dists.shape:
        raise ValueError("put_lz77: litlens and dists differ in shape")
    ll_codes = np.ascontiguousarray(ll_codes, dtype=np.uint32)
    ll_lengths = np.ascontiguousarray(ll_lengths, dtype=np.int32)
    d_codes = np.ascontiguousarray(d_codes, dtype=np.uint32)
    d_lengths = np.ascontiguousarray(d_lengths, dtype=np.int32)
    for a, n in ((ll_codes, 288), (ll_lengths, 288), (d_codes, 32),
                 (d_lengths, 32)):
        if a.shape != (n,):
            raise ValueError(f"put_lz77: a code table of shape {a.shape},"
                             f" not ({n},)")
    if (ll_lengths.min() < 0 or ll_lengths.max() > 15 or d_lengths.min() < 0
            or d_lengths.max() > 15):
        raise ValueError("put_lz77: a code length outside 0..15")
    end = lib().zt_put_lz77(buf.ctypes.data, buf.size, bit,
                            litlens.ctypes.data, dists.ctypes.data,
                            litlens.size, ll_codes.ctypes.data,
                            ll_lengths.ctypes.data, d_codes.ctypes.data,
                            d_lengths.ctypes.data)
    if end == -2:
        raise ValueError("put_lz77: a symbol outside DEFLATE's ranges")
    if end < 0:
        raise ValueError("put_lz77: the payload runs past the buffer")
    return end


def parse_index(data: np.ndarray, litlens: np.ndarray, dists: np.ndarray,
                instart: int, check=None):
    """An LZ77 store's index of the parse (litlens, dists) from byte
    `instart` of `data`, in one native pass: (pos, ll_symbol, d_symbol,
    cum_ll, cum_d, compared), as `lz77.LZ77Store` keeps them.

    check: None, or (inend, wstart) to hold the parse to data[instart,
    inend) with matches reaching back no further than wstart (steps
    summing to the range, distances 1..min(pos - wstart, 32768), every
    matched byte equal to its source).  `compared` is the matched bytes
    compared (0 without a check), or -1 when the check fails; the index
    is then partial.

    litlens/dists: int32, one dimension, of one length.
    """
    for a in (litlens, dists):
        if (a.dtype != np.int32 or a.ndim != 1
                or not a.flags.c_contiguous):
            raise ValueError("parse_index takes contiguous 1-D int32 symbols")
    if litlens.shape != dists.shape:
        raise ValueError("parse_index: litlens and dists differ in shape")
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = litlens.size
    inend, wstart = check if check is not None else (instart, instart)
    if check is not None and not 0 <= wstart <= instart <= inend <= data.size:
        raise ValueError("parse_index: the checked range lies outside the"
                         " data")
    pos = np.empty(max(n, 1), np.int64)
    ll_symbol = np.empty(n, np.int32)
    d_symbol = np.empty(n, np.int32)
    cum_ll = np.empty((n // INDEX_CHUNK + 1, spec.NUM_LL), np.int64)
    cum_d = np.empty((n // INDEX_CHUNK + 1, spec.NUM_D), np.int64)
    compared = lib().zt_parse_index(
        data.ctypes.data, litlens.ctypes.data, dists.ctypes.data, n,
        INDEX_CHUNK, instart, inend, wstart, check is not None,
        pos.ctypes.data, ll_symbol.ctypes.data, d_symbol.ctypes.data,
        cum_ll.ctypes.data, cum_d.ctypes.data)
    if compared == -2:
        raise ValueError("parse_index: a symbol outside the store's"
                         " alphabets")
    return pos, ll_symbol, d_symbol, cum_ll, cum_d, compared
