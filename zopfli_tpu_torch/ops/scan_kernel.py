"""Squeeze DP scan (K1) and traceback (K2): CUDA kernels + plain versions.

Port of zopfli_tpu/ops/scan_kernel.py (`make_scan`, `make_traceback`).
The forward DP of reference GetBestLengths (src/zopfli/squeeze.c:217-309)
runs over many independent parse tiles ("chains", one per group x lane);
the traceback walks each chain's path back from its tile end and counts
the path's symbols into 320 histogram bins.

The chosen edge is carried as ONE packed int32 per position:
`len | dist << 9` (a literal edge is the value 1).  The distance MUST be
captured during the relaxation -- it is a function of the edge's SOURCE
position (p - len), which only the forward scan has in hand.

Each kernel has a plain PyTorch version of the same contract in this
module (a loop over positions, vectorised over groups x lanes).  The
wrappers `scan` / `traceback` take the plain version for a tensor on the
CPU, launch the hand-written CUDA kernel (csrc/scan.cu,
csrc/traceback.cu) for a CUDA tensor, and raise for anything else.
There is no fallback from one to the other.

The kernels are compiled with nvcc for sm_90a into zopfli_tpu_torch/_build/
on first use (one nvcc per source, run in parallel) and bound through a
plain C interface with ctypes.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from .. import spec
from ..utils.counters import bump

BIG = 1e30       # cost of an unreachable position / padded literal
W = 256          # match lengths 3..258
SHIFT = 272      # carried window rows of the TPU kernel (>= 258)
LEN_BITS = 9     # packed edge: len | dist << LEN_BITS
LEN_MASK = (1 << LEN_BITS) - 1
HBINS = 320      # 288 litlen rows + 32 dist rows
MAX_KBP = 16     # breakpoints per position the CUDA scan supports

# Kernel launches, counted by the wrappers where they launch a kernel
# (hist_cost's wrapper is costmodel.hist_dynamic_cost, autotype_cost's
# devsplit.autotype_costs, both kernels in csrc/hist_cost.cu;
# split_search's is devsplit.split_search).
LAUNCHES = {"scan": 0, "traceback": 0, "traceback_large": 0,
            "hist_cost": 0, "autotype_cost": 0, "dp_scan": 0,
            "split_search": 0}

# What each kernel replaces, for reports.
REPLACES = {
    "scan": "zopfli_tpu/ops/scan_kernel.py:163",
    "traceback": "zopfli_tpu/ops/scan_kernel.py:289",
    "traceback_large": "zopfli_tpu/ops/scan_kernel.py:289",
    "hist_cost": "no TPU counterpart: XLA ops at "
                 "zopfli_tpu/ops/costmodel.py:354",
    "autotype_cost": "no TPU counterpart: XLA ops at "
                     "zopfli_tpu/ops/devsplit.py:104",
    "dp_scan": "no TPU counterpart: XLA lax.scan at "
               "zopfli_tpu/ops/dp.py:68",
    "split_search": "no TPU counterpart: XLA lax.while_loop/lax.cond at "
                    "zopfli_tpu/ops/devsplit.py:134-336",
}


def pack_edge(length, dist):
    """Pack an edge as the kernels carry it (numpy / torch int32)."""
    return length | (dist << LEN_BITS)


def compact_lanes(pe: torch.Tensor, *others: torch.Tensor):
    """Each lane's path rows to the front, empty rows (0) after them.

    pe: (G, TILE, LANES) packed path rows as the traceback writes them.
    A stable sort by emptiness keeps each lane's rows in position order;
    each of `others` (pe's shape) is gathered in the same order.
    Returns (nsym (G, LANES), compacted pe, *compacted others).
    """
    empty = (pe == 0).to(torch.int32)
    order = torch.sort(empty, dim=1, stable=True).indices
    gathered = [torch.gather(x, 1, order) for x in (pe, *others)]
    return ((1 - empty).sum(dim=1), *gathered)


def symbol_range_table() -> np.ndarray:
    """(HBINS, 8) int32 range table for the in-kernel histogram.

    Row r matches a path edge when:
      r < 256: literal edge with byte == r (compared directly, not here)
      257..285: match edge with length in [col0, col1)
      288..317: match edge with distance in [col2, col3)
    Sentinel -1 ranges never match.
    """
    tab = np.full((HBINS, 8), -1, dtype=np.int32)
    tab[:, 1] = -2  # empty [lo, hi)
    tab[:, 3] = -2
    for l in range(spec.MIN_MATCH, spec.MAX_MATCH + 1):
        s = int(spec.LENGTH_SYMBOL[l])
        if tab[s, 0] == -1:
            tab[s, 0] = l
        tab[s, 1] = l + 1
    base = spec.DIST_SYM_BASE
    for s in range(30):
        hi = int(base[s + 1]) if s + 1 < 30 else spec.WINDOW_SIZE + 1
        tab[288 + s, 2] = int(base[s])
        tab[288 + s, 3] = hi
    return tab


DIST_TABLE = spec.WINDOW_SIZE + 2   # distances 0..32769 have a table entry


def bin_tables(symtab) -> tuple[np.ndarray, np.ndarray]:
    """Length -> bin (512,) and distance -> bin (DIST_TABLE,) int32 maps.

    Derived from a symbol_range_table()-style table; -1 = not counted.
    Both kernel versions count one bin per column pair, so the ranges
    must be disjoint (they are for symbol_range_table()).
    """
    tab = np.asarray(symtab, dtype=np.int64)
    len_bin = np.full(LEN_MASK + 1, -1, np.int32)
    dist_bin = np.full(DIST_TABLE, -1, np.int32)
    for r in range(tab.shape[0]):
        for dst, lo, hi in ((len_bin, tab[r, 0], tab[r, 1]),
                            (dist_bin, tab[r, 2], tab[r, 3])):
            lo, hi = max(int(lo), 0), min(int(hi), len(dst))
            if lo >= hi:
                continue
            if (dst[lo:hi] != -1).any():
                raise ValueError("symbol range table rows overlap")
            dst[lo:hi] = r
    return len_bin, dist_bin


# ---------------------------------------------------------------------------
# Plain PyTorch versions.
# ---------------------------------------------------------------------------

def _fold(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(groups*rows, ..., lanes) -> (rows, ..., groups*lanes)."""
    rows = x.shape[0] // groups
    x = x.reshape(groups, rows, *x.shape[1:])
    x = x.movedim(0, -2)
    return x.reshape(*x.shape[:-2], -1)


def _unfold(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(rows, ..., groups*lanes) -> (groups*rows, ..., lanes)."""
    x = x.reshape(*x.shape[:-1], groups, -1).movedim(-2, 0)
    return x.reshape(-1, *x.shape[2:])


_CHUNK = 64  # positions whose breakpoints the plain scan expands at once


def scan_plain(bp_len, bp_dist, bp_dcost, litcost, lcost_vec, groups=1):
    """Plain version of the scan kernel; contract of make_scan.

    bp_len, bp_dist: (groups*tile, kbp, nt) int32; bp_dcost the same in
    float32; litcost (groups*tile, nt) float32 (BIG pads); lcost_vec
    (groups*W, nt) float32.  Returns (ce, cost), (groups*tile, nt) int32
    packed edges and float32 costs; row j = position j+1 of its tile.
    """
    dev = bp_len.device
    rows, kbp, nt = bp_len.shape
    tile = rows // groups
    bl, bd, bc = (_fold(t, groups) for t in (bp_len, bp_dist, bp_dcost))
    lit = _fold(litcost, groups)
    lcost = _fold(lcost_vec, groups)                      # (W, N)
    n = bl.shape[-1]
    # Rows past the tile end (up to tile + 258) absorb dropped relaxations.
    cost = torch.full((tile + W + 3, n), BIG, dtype=torch.float32,
                      device=dev)
    cost[0] = 0.0
    ce = torch.zeros((tile + W + 3, n), dtype=torch.int32, device=dev)
    liota = torch.arange(3, W + 3, dtype=torch.int32, device=dev)[:, None]
    one = torch.ones((), dtype=torch.int32, device=dev)
    for c0 in range(0, tile, _CHUNK):
        c1 = min(c0 + _CHUNK, tile)
        # Breakpoint expansion is independent of the DP state: do it for
        # the whole chunk at once, descending k (lowest covering k wins).
        dcost = torch.full((c1 - c0, W, n), BIG, dtype=torch.float32,
                           device=dev)
        dedge = liota.expand(c1 - c0, W, n).clone()
        for k in range(kbp - 1, -1, -1):
            sel = liota[None] <= bl[c0:c1, k][:, None, :]
            dcost = torch.where(sel, bc[c0:c1, k][:, None, :], dcost)
            dedge = torch.where(
                sel, liota[None] | (bd[c0:c1, k][:, None, :] << LEN_BITS),
                dedge)
        for j in range(c0, c1):
            cj = cost[j]
            lt = cj + lit[j]
            upd = lt < cost[j + 1]
            cost[j + 1] = torch.where(upd, lt, cost[j + 1])
            ce[j + 1] = torch.where(upd, one, ce[j + 1])
            new = (cj[None, :] + lcost) + dcost[j - c0]
            old = cost[j + 3:j + 3 + W]
            upd = new < old
            cost[j + 3:j + 3 + W] = torch.where(upd, new, old)
            ce[j + 3:j + 3 + W] = torch.where(upd, dedge[j - c0],
                                              ce[j + 3:j + 3 + W])
    return (_unfold(ce[1:tile + 1], groups).contiguous(),
            _unfold(cost[1:tile + 1], groups).contiguous())


def traceback_plain(ce, lit, tile_nbytes, symtab, groups=1):
    """Plain version of the traceback kernel; contract of make_traceback.

    ce, lit: (groups*tile, nt) int32; tile_nbytes (groups, nt) int32.
    Returns (hist (groups*HBINS, nt) float32, pe (groups*tile, nt) int32):
    pe[j] = the packed edge into position j+1 if on the path, else 0.
    """
    dev = ce.device
    rows, nt = ce.shape
    tile = rows // groups
    cef = _fold(ce, groups)
    litf = _fold(lit, groups)
    n = cef.shape[-1]
    cursor = tile_nbytes.reshape(n).to(torch.int32).clone()
    pe = torch.zeros_like(cef)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for p in range(tile, 0, -1):
        # A row whose edge has length 0 is unreachable: the cursor stays
        # put and never matches a later (smaller) position again.
        active = cursor == p
        v = cef[p - 1]
        pe[p - 1] = torch.where(active, v, zero)
        cursor = torch.where(active, p - (v & LEN_MASK), cursor)

    # Path edges are exactly the non-zero pe rows: count them.
    len_bin, dist_bin = (torch.as_tensor(t, device=dev).long()
                         for t in bin_tables(symtab))
    pl = (pe & LEN_MASK).long()
    pd = (pe >> LEN_BITS).long()
    lane = torch.arange(n, device=dev).expand_as(pl)
    lb = litf.long()
    is_lit = (pl == 1) & (lb >= 0) & (lb < HBINS)
    is_match = pl >= 3
    lbin = len_bin[pl]
    dbin = torch.where((pd >= 0) & (pd < DIST_TABLE),
                       dist_bin[pd.clamp(0, DIST_TABLE - 1)],
                       torch.full_like(pd, -1))
    hist = torch.zeros((n, HBINS), dtype=torch.int64, device=dev)
    ones = torch.ones_like(pl)
    for m, b in ((is_lit, lb), (is_match & (lbin >= 0), lbin),
                 (is_match & (dbin >= 0), dbin)):
        hist.index_put_((lane[m], b[m]), ones[m], accumulate=True)
    hist = _unfold(hist.T.contiguous(), groups).to(torch.float32)
    return hist.contiguous(), _unfold(pe, groups).contiguous()


# ---------------------------------------------------------------------------
# CUDA kernels: build, bind, launch.
# ---------------------------------------------------------------------------

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
SOURCES = {"scan": "csrc/scan.cu", "traceback": "csrc/traceback.cu",
           "hist_cost": "csrc/hist_cost.cu", "dp_scan": "csrc/dp_scan.cu",
           "split_search": "csrc/split_search.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]
BUILD_LOG: dict[str, str] = {}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _bind(name: str, lib: ctypes.CDLL) -> None:
    vp, ci, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    i64 = ctypes.c_longlong
    if name == "scan":
        lib.zt_scan.restype = ci
        lib.zt_scan.argtypes = [vp] * 7 + [ci] * 4 + [vp]
        lib.zt_scan_smem_bytes.restype = sz
        lib.zt_scan_smem_bytes.argtypes = [ci]
    elif name == "hist_cost":
        lib.zt_hist_cost.restype = ci
        lib.zt_hist_cost.argtypes = [vp] * 3 + [ci, vp]
        lib.zt_hist_cost_smem_bytes.restype = sz
        lib.zt_hist_cost_smem_bytes.argtypes = []
        lib.zt_autotype_cost.restype = ci
        lib.zt_autotype_cost.argtypes = [vp] * 9 + [ci, i64, ci, vp]
    elif name == "split_search":
        lib.zt_split_search.restype = ci
        lib.zt_split_search.argtypes = [vp] * 12 + [i64, ci, i64, vp]
        lib.zt_split_search_clusters.restype = ci
        lib.zt_split_search_clusters.argtypes = [ctypes.POINTER(ci)]
    elif name == "dp_scan":
        lib.zt_dp_scan.restype = ci
        lib.zt_dp_scan.argtypes = [vp] * 9 + [ci] * 3 + [vp]
    else:
        lib.zt_traceback.restype = ci
        lib.zt_traceback.argtypes = [vp] * 7 + [ci] * 4 + [vp]
        lib.zt_traceback_large.restype = ci
        lib.zt_traceback_large.argtypes = [vp] * 7 + [ci] * 4 + [vp]
        lib.zt_traceback_lanes_per_block.restype = ci
        lib.zt_traceback_lanes_per_block.argtypes = [ci]
        lib.zt_traceback_smem_bytes.restype = sz
        lib.zt_traceback_smem_bytes.argtypes = [ci]


def _newest_source(src: str) -> float:
    """mtime of a source or of the newest header beside it (the sources
    include csrc/*.cuh)."""
    heads = [os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
             if f.endswith(".cuh")]
    return max(os.path.getmtime(f) for f in [src] + heads)


def build_kernels() -> dict[str, ctypes.CDLL]:
    """Compile (if stale) and load every kernel library; returns them.

    One nvcc per source, all started together; each writes a temporary
    file renamed into place, so concurrent builds never leave a torn
    library.
    """
    with _lock:
        missing = [n for n in SOURCES if n not in _libs]
        if not missing:
            return _libs
        os.makedirs(_BUILD, exist_ok=True)
        procs = {}
        for name in missing:
            src = os.path.join(_PKG, SOURCES[name])
            so = os.path.join(_BUILD, f"libzt_{name}.so")
            if (os.path.exists(so)
                    and os.path.getmtime(so) >= _newest_source(src)):
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            procs[name] = (subprocess.Popen(
                [_nvcc()] + NVCC_FLAGS + ["-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, so)
        errors = []
        for name, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOG[name] = out
            if proc.returncode:
                errors.append(f"{SOURCES[name]}:\n{out}")
            else:
                os.replace(tmp, so)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        for name in missing:
            lib = ctypes.CDLL(os.path.join(_BUILD, f"libzt_{name}.so"))
            _bind(name, lib)
            _libs[name] = lib
        return _libs


def check(t: torch.Tensor, dtype, shape, what: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{what}: expected contiguous {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def scan(bp_len, bp_dist, bp_dcost, litcost, lcost_vec, groups=1):
    """The DP scan: CUDA kernel on a CUDA tensor, plain version on CPU."""
    if device_kind(bp_len) == "cpu":
        return scan_plain(bp_len, bp_dist, bp_dcost, litcost, lcost_vec,
                          groups)
    rows, kbp, nt = bp_len.shape
    if rows % groups or kbp > MAX_KBP:
        raise ValueError(f"scan: rows={rows} groups={groups} kbp={kbp}")
    check(bp_len, torch.int32, (rows, kbp, nt), "bp_len")
    check(bp_dist, torch.int32, (rows, kbp, nt), "bp_dist")
    check(bp_dcost, torch.float32, (rows, kbp, nt), "bp_dcost")
    check(litcost, torch.float32, (rows, nt), "litcost")
    check(lcost_vec, torch.float32, (groups * W, nt), "lcost_vec")
    for t in (bp_dist, bp_dcost, litcost, lcost_vec):
        if t.device != bp_len.device:
            raise ValueError("scan: inputs on different devices")
    lib = build_kernels()["scan"]
    ce = torch.empty((rows, nt), dtype=torch.int32, device=bp_len.device)
    cost = torch.empty((rows, nt), dtype=torch.float32, device=bp_len.device)
    with torch.cuda.device(bp_len.device):
        stream = torch.cuda.current_stream(bp_len.device).cuda_stream
        raise_on(lib.zt_scan(
            bp_len.data_ptr(), bp_dist.data_ptr(), bp_dcost.data_ptr(),
            litcost.data_ptr(), lcost_vec.data_ptr(), ce.data_ptr(),
            cost.data_ptr(), groups, rows // groups, kbp, nt, stream),
            "scan")
    bump(LAUNCHES, "scan")
    return ce, cost


_TABLES: dict = {}


def _device_bin_tables(symtab, device):
    key = (np.asarray(symtab).tobytes(), str(device))
    if key not in _TABLES:
        _TABLES[key] = tuple(torch.as_tensor(t, device=device)
                             for t in bin_tables(symtab))
    return _TABLES[key]


def traceback(ce, lit, tile_nbytes, symtab, groups=1):
    """The traceback: CUDA kernel on a CUDA tensor, plain version on CPU.

    symtab is a host table (numpy, or a CPU tensor): reading a device
    copy would sync the stream on every call.
    """
    if isinstance(symtab, torch.Tensor) and symtab.device.type != "cpu":
        raise ValueError("traceback: symtab must be a host table, got a "
                         f"tensor on {symtab.device}")
    symtab_h = np.asarray(symtab)
    if device_kind(ce) == "cpu":
        return traceback_plain(ce, lit, tile_nbytes, symtab_h, groups)
    rows, nt = ce.shape
    if rows % groups:
        raise ValueError(f"traceback: rows={rows} groups={groups}")
    check(ce, torch.int32, (rows, nt), "ce")
    check(lit, torch.int32, (rows, nt), "lit")
    check(tile_nbytes, torch.int32, (groups, nt), "tile_nbytes")
    for t in (lit, tile_nbytes):
        if t.device != ce.device:
            raise ValueError("traceback: inputs on different devices")
    len_bin, dist_bin = _device_bin_tables(symtab_h, ce.device)
    lib = build_kernels()["traceback"]
    # A tile that fits one block's shared memory takes the staged kernel;
    # a larger one the entry that streams the tile in chunks.
    name = ("traceback" if lib.zt_traceback_lanes_per_block(rows // groups)
            else "traceback_large")
    # Either entry writes every element of both outputs.
    hist = torch.empty((groups * HBINS, nt), dtype=torch.float32,
                       device=ce.device)
    pe = torch.empty((rows, nt), dtype=torch.int32, device=ce.device)
    with torch.cuda.device(ce.device):
        stream = torch.cuda.current_stream(ce.device).cuda_stream
        raise_on(getattr(lib, f"zt_{name}")(
            ce.data_ptr(), lit.data_ptr(), tile_nbytes.data_ptr(),
            len_bin.data_ptr(), dist_bin.data_ptr(), hist.data_ptr(),
            pe.data_ptr(), groups, rows // groups, nt, DIST_TABLE, stream),
            name)
    bump(LAUNCHES, name)
    return hist, pe


# ---------------------------------------------------------------------------
# Numpy oracles (tests).
# ---------------------------------------------------------------------------

def traceback_reference(ce, lit, tile_nbytes):
    """Numpy oracle for the traceback (same contract, minus symtab)."""
    tile, nt = ce.shape
    hist = np.zeros((HBINS, nt), np.float32)
    pe_o = np.zeros((tile, nt), np.int32)
    for lane in range(nt):
        p = int(tile_nbytes[0, lane])
        while p > 0:
            v = int(ce[p - 1, lane])
            l = v & LEN_MASK
            d = v >> LEN_BITS
            pe_o[p - 1, lane] = v
            if l >= 3:
                hist[spec.LENGTH_SYMBOL[l], lane] += 1
                hist[288 + spec.dist_symbol(max(d, 1)), lane] += 1
            else:
                hist[int(lit[p - 1, lane]), lane] += 1
            p -= l
    return hist, pe_o


def scan_reference(bp_len, bp_dist, bp_dcost, litcost, lcost_vec):
    """Pure-numpy oracle for the scan kernel (tests): same contract.

    Shapes as in scan_plain with groups=1; returns (ce (tile, nt) packed
    edges, cost (tile, nt)) -- row j = pos j+1.
    """
    tile, kbp, nt = bp_len.shape
    cost = np.full((tile + 1, nt), 1e30, np.float32)
    cost[0] = 0.0
    ce = np.zeros((tile + 1, nt), np.int32)
    lengths = np.arange(3, 259)[:, None]
    for j in range(tile):
        cj = cost[j]
        lt = (cj + litcost[j]).astype(np.float32)
        upd = lt < cost[j + 1]
        cost[j + 1] = np.where(upd, lt, cost[j + 1])
        ce[j + 1] = np.where(upd, 1, ce[j + 1])

        dcost = np.full((W, nt), 1e30, np.float32)
        dedge = np.broadcast_to(lengths, (W, nt)).astype(np.int32)
        for k in range(kbp - 1, -1, -1):
            sel = lengths <= bp_len[j, k][None, :]
            dcost = np.where(sel, bp_dcost[j, k][None, :], dcost)
            dedge = np.where(sel,
                             lengths | (bp_dist[j, k][None, :] << LEN_BITS),
                             dedge)
        new = (cj[None, :] + lcost_vec + dcost).astype(np.float32)
        hi = min(j + 259, tile + 1)
        n = hi - (j + 3)
        if n <= 0:
            continue
        old = cost[j + 3:hi]
        upd = new[:n] < old
        cost[j + 3:hi] = np.where(upd, new[:n], old)
        ce[j + 3:hi] = np.where(upd, dedge[:n], ce[j + 3:hi])
    return ce[1:], cost[1:]
