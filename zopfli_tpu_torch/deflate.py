"""DEFLATE stream orchestration: master blocks, splitting, emission.

Semantics mirror the reference driver (src/zopfli/deflate.c:625-931):
master blocks processed with the previous bytes visible as LZ77
dictionary, two-phase block splitting, per-block btype choice with the
optional fixed-tree re-parse, and the empty-block / stored-block rules.

Two parse engines.  "device" has one route at btype 2, deflate_device,
for compress and compress_many alike: masters in chunks, each chunk
through the seed pipeline (squeeze_batched: the device seed program
ops.seed -- a fixed-cost parse and the first split -- then the fused
squeeze ops.fused_engine on Options.device), then emit_results and
finish_part (the second split on the device, ops.devsplit, and the
bitstream).  "native" is the C++ host engine, master by master through
deflate_part.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from . import blocks, spec, squeeze, tree_encode
from .emit import BitStream, reverse_bits
from .entropy import lengths_to_symbols
from .lz77 import LZ77Store, concat_stores
from .utils.logging import Tracer, span

ENGINES = ("device", "native")


@dataclass
class Options:
    """Encoder options (reference src/zopfli/zopfli.h:33-64, util.c:28-35)."""
    verbose: bool = False
    verbose_more: bool = False
    numiterations: int = 15
    blocksplitting: bool = True
    blocksplittingmax: int = 15
    # Framework extensions (no reference counterpart):
    # "device" -- fused squeeze pipeline on `device`
    # "native" -- C++ host engine (serial, bit-identical to reference)
    engine: str = "device"
    tracer: Optional[Tracer] = None
    # Master blocks compress in parallel across host threads (and local
    # CUDA devices) for the native engine and for forced btype 0 and 1;
    # the device engine at btype 2 runs all masters through one fused
    # pipeline and ignores it.  0 = auto.
    workers: int = 1
    # Torch device of the "device" engine: "cuda" (default) or "cpu".
    device: str = "cuda"


def resolve_device(options: Options):
    """The torch device of the device engine; raises if it is missing.

    The device engine never quietly runs somewhere else: a CUDA device
    without CUDA is an error, and the CPU is used only when asked for.
    """
    import torch

    dev = torch.device(options.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"Options(device={options.device!r}) but CUDA is not available;"
            " pass Options(device='cpu') to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {options.device!r}")
    return dev


def local_devices(options: Options):
    """Every CUDA device, to shard the fused loop's lane groups over, when
    the device engine runs on CUDA and there is more than one; else None
    (the counterpart of the reference's local_mesh)."""
    import torch

    if (options.engine != "device"
            or torch.device(options.device).type != "cuda"
            or torch.cuda.device_count() <= 1):
        return None
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def default_engine_factory(options: Options) -> Callable:
    # Auxiliary per-block engines (fixed-tree re-parse probes) run on
    # the host.
    from . import native
    return native.BlockEngine


def default_greedy(options: Options) -> Callable:
    from . import native
    return native.greedy


def add_non_compressed_block(final: bool, data: np.ndarray, instart: int,
                             inend: int, out: BitStream) -> None:
    """Stored blocks, chunked at 65535 bytes (deflate.c:625-663)."""
    pos = instart
    while True:
        blocksize = min(65535, inend - pos)
        currentfinal = pos + blocksize >= inend
        nlen = (~blocksize) & 0xFFFF
        out.bits(1 if (final and currentfinal) else 0, 1)
        out.bits(0, 2)  # btype 00
        out.align_byte()
        header = bytes([blocksize & 0xFF, (blocksize >> 8) & 0xFF,
                        nlen & 0xFF, (nlen >> 8) & 0xFF])
        out.raw_bytes(header + data[pos : pos + blocksize].tobytes())
        if currentfinal:
            break
        pos += blocksize


def _emit_lz77_data(store: LZ77Store, lstart: int, lend: int,
                    ll_lengths, d_lengths, out: BitStream) -> None:
    """Stage a block's symbol payload (reference AddLZ77Data) as one
    segment, sized from the block's histogram; the native writer packs it."""
    ll_lengths = np.asarray(ll_lengths, dtype=np.int32)
    d_lengths = np.asarray(d_lengths, dtype=np.int32)
    ll_counts, d_counts = store.histogram(lstart, lend)
    # block_symbol_size charges the end symbol, which is staged apart.
    nbits = (blocks.block_symbol_size(ll_counts, d_counts, ll_lengths,
                                      d_lengths) - int(ll_lengths[256]))
    out.lz77(store.litlens[lstart:lend], store.dists[lstart:lend],
             reverse_bits(lengths_to_symbols(ll_lengths, 15), ll_lengths),
             ll_lengths,
             reverse_bits(lengths_to_symbols(d_lengths, 15), d_lengths),
             d_lengths, nbits)


def add_lz77_block(options: Options, btype: int, final: bool,
                   store: LZ77Store, lstart: int, lend: int,
                   out: BitStream) -> None:
    """Emit one fixed or dynamic block (deflate.c:682-745)."""
    if btype == 0:
        length = store.byte_range(lstart, lend)
        pos = 0 if lstart == lend else int(store.pos[lstart])
        add_non_compressed_block(final, store.data, pos, pos + length, out)
        return

    out.bits(1 if final else 0, 1)
    out.bits(btype & 1, 1)
    out.bits((btype & 2) >> 1, 1)

    if btype == 1:
        ll_lengths, d_lengths = spec.fixed_tree_lengths()
    else:
        _, ll_lengths, d_lengths = blocks.get_dynamic_lengths(store, lstart,
                                                              lend)
        tree_encode.add_dynamic_tree(ll_lengths, d_lengths, out)

    _emit_lz77_data(store, lstart, lend, ll_lengths, d_lengths, out)
    # End symbol.
    ll_syms = lengths_to_symbols(ll_lengths, 15)
    out.bits(int(reverse_bits([ll_syms[256]], [int(ll_lengths[256])])[0]),
             int(ll_lengths[256]))


def add_lz77_block_auto_type(options: Options, final: bool, store: LZ77Store,
                             lstart: int, lend: int, out: BitStream,
                             engine_factory) -> None:
    """Choose btype by exact cost, with fixed re-parse probe (deflate.c:747)."""
    uncompressedcost = blocks.calculate_block_size(store, lstart, lend, 0)
    fixedcost = blocks.calculate_block_size(store, lstart, lend, 1)
    dyncost = blocks.calculate_block_size(store, lstart, lend, 2)

    # Re-parse under the fixed-tree cost model when it might win.
    expensivefixed = (store.size < 1000) or fixedcost <= dyncost * 1.1

    if lstart == lend:
        # Smallest empty block: fixed block with only the end symbol.
        out.bits(1 if final else 0, 1)
        out.bits(1, 2)
        out.bits(0, 7)
        return

    fixedstore = None
    if expensivefixed:
        with span("zt.finish.fixed"):
            instart = int(store.pos[lstart])
            inend = instart + store.byte_range(lstart, lend)
            engine = engine_factory(store.data, instart, inend)
            fixedstore = squeeze.lz77_optimal_fixed(engine, store.data,
                                                    instart, inend)
            fixedcost = blocks.calculate_block_size(fixedstore, 0,
                                                    fixedstore.size, 1)
            if hasattr(engine, "close"):
                engine.close()

    if uncompressedcost < fixedcost and uncompressedcost < dyncost:
        add_lz77_block(options, 0, final, store, lstart, lend, out)
    elif fixedcost < dyncost:
        if fixedstore is not None:
            add_lz77_block(options, 1, final, fixedstore, 0, fixedstore.size,
                           out)
        else:
            add_lz77_block(options, 1, final, store, lstart, lend, out)
    else:
        add_lz77_block(options, 2, final, store, lstart, lend, out)


def tpu_master_size() -> int:
    """Master-block size of the device engine (bytes, ZT_MASTER_SIZE).

    A power of two, so masters tile the kernel lane geometry exactly
    (TILE | master size) and the common 1 MiB input is ONE master.
    """
    return int(os.environ.get("ZT_MASTER_SIZE", str(1 << 20)))


def scaled_maxblocks(options: Options, nbytes: int) -> int:
    """blocksplittingmax scaled to preserve the reference's split
    density (15 blocks per 1e6-byte part, deflate.c:811-906) when masters
    are larger than the reference's."""
    if not options.blocksplitting:
        return 1
    mb = options.blocksplittingmax
    if nbytes > spec.MASTER_BLOCK_SIZE:
        mb = -(-mb * nbytes // spec.MASTER_BLOCK_SIZE)
    return mb


def _devseed_trace(tracer, entry):
    """Per-block iteration hook factory over a devseed entry."""
    if tracer is None or entry[2] is None:
        return None
    fs = entry[2]
    hooks = [tracer.block_iteration_hook(bs, be)
             for (bs, be) in fs.block_bounds]
    return lambda b, i, cost: hooks[b](i, cost)


def split_master(options: Options, data: np.ndarray, instart: int,
                 inend: int, greedy_fn) -> list[int]:
    """Host block-split of one master's greedy parse -> bounds incl.
    endpoints (the native engine's first split)."""
    if not options.blocksplitting or inend <= instart:
        return [instart, inend]
    maxblocks = scaled_maxblocks(options, inend - instart)
    with span("zt.split"):
        pts = blocks.block_split(data, instart, inend, maxblocks, greedy_fn)
    return [instart] + pts + [inend]


def deflate_part(options: Options, btype: int, final: bool, data: np.ndarray,
                 instart: int, inend: int, out: BitStream,
                 engine_factory=None, greedy_fn=None) -> None:
    """Compress one master block (deflate.c:811-906).

    The device engine at btype 2 hands the master to deflate_device as a
    chunk of one.
    """
    engine_factory = engine_factory or default_engine_factory(options)
    if btype == 0:
        add_non_compressed_block(final, data, instart, inend, out)
        return
    if btype == 1:
        engine = engine_factory(data, instart, inend)
        store = squeeze.lz77_optimal_fixed(engine, data, instart, inend)
        add_lz77_block(options, 1, final, store, 0, store.size, out)
        if hasattr(engine, "close"):
            engine.close()
        return
    if options.engine == "device":
        deflate_device(options, data, [(instart, inend, final)],
                       lambda m: out, lambda m: engine_factory)
        return

    greedy_fn = greedy_fn or default_greedy(options)
    tracer = options.tracer
    bounds = split_master(options, data, instart, inend, greedy_fn)
    stores = []
    for i in range(len(bounds) - 1):
        start, end = bounds[i], bounds[i + 1]
        engine = engine_factory(data, start, end)
        trace = None
        if tracer is not None:
            trace = tracer.block_iteration_hook(start, end)
        st = squeeze.lz77_optimal(engine, data, start, end,
                                  options.numiterations, greedy_fn,
                                  trace=trace)
        if hasattr(engine, "close"):
            engine.close()
        stores.append(st)

    finish_part(options, final, stores, out, engine_factory)


def prepare_second_split(options: Options, stores: list):
    """First half of the device engine's second split, finish_part's
    presplit: the concatenated store and its stream uploaded to the
    device (the pow2 capacity floor only bounds the shape set; results
    are capacity-independent)."""
    from .ops import devsplit

    with span("zt.presplit"):
        lz77 = concat_stores(stores)
        handle = None
        if options.blocksplitting and len(stores) > 2:
            handle = devsplit.block_split_lz77_device_dispatch(
                lz77.litlens.astype(np.int32), lz77.dists.astype(np.int32),
                scaled_maxblocks(options, lz77.byte_range(0, lz77.size)),
                floor=1024, device=resolve_device(options))
        return lz77, handle


def emit_results(options: Options, data: np.ndarray, chunk, results,
                 out_for, factory_for) -> None:
    """Emit one devseed chunk's results.

    chunk: [(start, end, fin, ...)]; results from devseed_collect.
    out_for(i) -> BitStream; factory_for(i) -> engine factory.
    """
    def presplit_for(res):
        if res[0] != "stores":
            return None
        if len(res) > 2 and res[2] is not None:
            # Megafused masters computed the whole second-split attempt
            # (search + both cost totals) on the device.
            return ("decision", res[2])
        return prepare_second_split(options, res[1])

    presplits = [presplit_for(res) for res in results]
    for i, (m, res, ps) in enumerate(zip(chunk, results, presplits)):
        start, end, fin = m[0], m[1], m[2]
        if res[0] == "stored":
            add_non_compressed_block(fin, data, start, end, out_for(i))
        else:
            finish_part(options, fin, res[1], out_for(i), factory_for(i),
                        presplit=ps)


def finish_part(options: Options, final: bool, stores: list,
                out: BitStream, engine_factory, presplit=None) -> None:
    """Second split attempt + emission for one master's parsed blocks.

    presplit: optional (lz77, handle) from prepare_second_split, or
    ("decision", (sp2, tc1, tc2)) from the megafused program.
    """
    with span("zt.finish"):
        _finish_part(options, final, stores, out, engine_factory, presplit)


def _finish_part(options: Options, final: bool, stores: list,
                 out: BitStream, engine_factory, presplit) -> None:
    from .ops import devsplit

    splitpoints = [int(x) for x in np.cumsum([st.size
                                              for st in stores[:-1]])]

    if presplit is not None and presplit[0] == "decision":
        # Megafused path: the second split's search and the exact cost
        # totals of both bound sets came from the device, so the host
        # cost pass below is not needed.
        sp2, tc1, tc2 = presplit[1]
        lz77 = concat_stores(stores)
        if options.blocksplitting and len(splitpoints) > 1 and tc2 < tc1:
            splitpoints = sp2
        _emit_bounds(options, final, lz77, [0] + splitpoints + [lz77.size],
                     out, engine_factory)
        return

    totalcost = 0.0
    with span("zt.finish.cost"):
        for st in stores:
            totalcost += blocks.calculate_block_size_auto_type(st, 0,
                                                               st.size)

    if presplit is None and options.engine == "device":
        presplit = prepare_second_split(options, stores)
    lz77 = presplit[0] if presplit is not None else concat_stores(stores)

    # Second splitting attempt on the optimal parse (deflate.c:872-893).
    # The device engine splits on the device, with its block budget
    # scaled as for the first split (its masters may exceed the
    # reference's).
    if options.blocksplitting and len(splitpoints) > 1:
        if presplit is not None:
            splitpoints2 = devsplit.block_split_lz77_device_collect(
                presplit[1])
        else:
            splitpoints2 = blocks.block_split_lz77(
                lz77, options.blocksplittingmax)
        totalcost2 = 0.0
        bounds2 = [0] + splitpoints2 + [lz77.size]
        with span("zt.finish.cost"):
            for i in range(len(bounds2) - 1):
                totalcost2 += blocks.calculate_block_size_auto_type(
                    lz77, bounds2[i], bounds2[i + 1])
        if totalcost2 < totalcost:
            splitpoints = splitpoints2

    _emit_bounds(options, final, lz77, [0] + splitpoints + [lz77.size], out,
                 engine_factory)


def _emit_bounds(options: Options, final: bool, lz77: LZ77Store, bounds,
                 out: BitStream, engine_factory) -> None:
    """One auto-type block per [bounds[i], bounds[i+1]) of the store."""
    tracer = options.tracer
    for i in range(len(bounds) - 1):
        add_lz77_block_auto_type(options, (i == len(bounds) - 2) and final,
                                 lz77, bounds[i], bounds[i + 1], out,
                                 engine_factory)
        if tracer is not None:
            tracer.block_done(bounds[i], bounds[i + 1], out.nbits)


def deflate(options: Options, btype: int, final: bool, data: np.ndarray,
            out: BitStream, engine_factory=None, greedy_fn=None) -> None:
    """Full DEFLATE stream over master blocks (deflate.c:908-931).

    Master blocks are mutually independent here (each sees the previous
    bytes only as its LZ77 window halo).  The device engine at btype 2
    takes them all to deflate_device; otherwise, with options.workers !=
    1, they compress on host threads (on a host with several CUDA
    devices, master i on local_devices()[i % n]) and their bitstreams
    are spliced in order.
    """
    if options.engine not in ENGINES:
        raise ValueError(f"unknown engine {options.engine!r}; expected one "
                         f"of {ENGINES}")
    if options.engine == "device":
        resolve_device(options)
    data = np.ascontiguousarray(np.frombuffer(bytes(data), dtype=np.uint8)
                                if not isinstance(data, np.ndarray) else data)
    insize = len(data)
    msize = (tpu_master_size() if options.engine == "device"
             else spec.MASTER_BLOCK_SIZE)
    masters = []
    i = 0
    while True:
        masterfinal = i + msize >= insize
        size = insize - i if masterfinal else msize
        masters.append((i, i + size, final and masterfinal))
        i += size
        if i >= insize:
            break

    if options.engine == "device" and btype == 2:
        factory = engine_factory or default_engine_factory(options)
        deflate_device(options, data, masters, lambda m: out,
                       lambda m: factory)
        return

    workers = options.workers
    if workers == 0:
        workers = min(len(masters), os.cpu_count() or 1)
    if workers <= 1 or len(masters) <= 1:
        for (start, end, fin) in masters:
            deflate_part(options, btype, fin, data, start, end, out,
                         engine_factory, greedy_fn)
        return

    from concurrent.futures import ThreadPoolExecutor

    # On a host with several CUDA devices (None otherwise, and for the
    # native engine), round-robin masters over them: master i runs with
    # devices[i % n] as its worker thread's current device (CUDA's
    # current device is per host thread), so its device work lands on
    # that card; no collectives are needed.
    devices = local_devices(options)

    def work(im):
        i, (start, end, fin) = im
        part = BitStream()
        if devices is None:
            pin = contextlib.nullcontext()
        else:
            import torch
            pin = torch.cuda.device(devices[i % len(devices)])
        with pin:
            deflate_part(options, btype, fin, data, start, end, part,
                         engine_factory, greedy_fn)
        return part

    with ThreadPoolExecutor(max_workers=workers) as ex:
        parts = list(ex.map(work, enumerate(masters)))
    for part in parts:
        out.extend(part)


def deflate_device(options: Options, data: np.ndarray, masters, out_for,
                   factory_for, window_start=lambda m: 0) -> None:
    """The device engine at btype 2: compress's masters, compress_many's,
    and each master deflate_part is handed.

    masters: [(start, end, final, ...)]; out_for(m), factory_for(m) and
    window_start(m): a master's BitStream, engine factory and first
    window byte.  Masters go through the seed pipeline in chunks
    (_chunk_masters); the free lanes, and so the replicas, depend on
    this chunking.  An empty master (an empty input) is one empty store.
    """
    device = resolve_device(options)
    live = []
    for m in masters:
        if m[1] > m[0]:
            live.append(m)
            continue
        empty = np.zeros(0, np.uint16)
        finish_part(options, m[2], [LZ77Store(data, empty, empty, m[0])],
                    out_for(m), factory_for(m))
    if live:
        _devseed_pipeline(options, data, _chunk_masters(options, live),
                          window_start, out_for, factory_for, device,
                          local_devices(options))


def _chunk_masters(options: Options, masters) -> list[list]:
    """Masters grouped by estimated tile count (ZT_TILE_BUDGET)."""
    from .ops import fused_engine

    budget = int(os.environ.get(
        "ZT_TILE_BUDGET", str(4 * fused_engine.LANES)))
    chunks: list[list] = [[]]
    acc = 0
    for m in masters:
        start, end = m[0], m[1]
        # Upper bound: block splitting adds at most blocksplittingmax-1
        # partial tiles on top of the unsplit tile count.
        est = (-(-(end - start) // fused_engine.TILE)
               + scaled_maxblocks(options, end - start) + 1)
        if chunks[-1] and acc + est > budget:
            chunks.append([])
            acc = 0
        chunks[-1].append(m)
        acc += est
    return chunks


def _devseed_pipeline(options: Options, data, chunks, window_start,
                      out_for, factory_for, device, devices) -> None:
    """Software pipeline over chunks of masters: queue chunk N's seed
    parses, emit chunk N-1 (host) while the device runs them, then
    finish chunk N's seeds and queue its squeeze.

    window_start(m), out_for(m), factory_for(m): a master's first
    window byte, BitStream and engine factory.
    """
    from .squeeze_batched import (devseed_collect, devseed_dispatch,
                                  devseed_fire)

    def emit(chunk, entry):
        results = devseed_collect(entry, options.numiterations,
                                  trace=_devseed_trace(options.tracer,
                                                       entry))
        emit_results(options, data, chunk, results,
                     lambda i: out_for(chunk[i]),
                     lambda i: factory_for(chunk[i]))

    pending = None  # (chunk, entry)
    for chunk in chunks:
        ranges = [(m[0], m[1]) for m in chunk]
        wstarts = [window_start(m) for m in chunk]
        mb = max(scaled_maxblocks(options, end - start)
                 for (start, end) in ranges)
        fired = devseed_fire(data, ranges, mb, window_starts=wstarts,
                             device=device,
                             numiterations=options.numiterations,
                             devices=devices)
        if pending is not None:
            emit(*pending)
        entry = devseed_dispatch(data, ranges, options.numiterations, mb,
                                 window_starts=wstarts, fired=fired,
                                 device=device, devices=devices)
        pending = (chunk, entry)
    emit(*pending)


def deflate_many(options: Options, data: np.ndarray, blob_ranges,
                 outs: list[BitStream]) -> None:
    """Compress many independent inputs in shared fused device batches.

    data concatenates the inputs; blob_ranges[i] = (start, end) of input
    i, whose raw DEFLATE stream is emitted into outs[i].  All inputs'
    masters share the fused engine's lane groups (one device loop covers
    many small files -- the reference's only analog is the CLI's
    sequential per-file loop, zopfli_bin.c:191-211), with the LZ77 window
    clamped at each input's start.
    """
    engine_factory = default_engine_factory(options)
    msize = tpu_master_size()
    masters = []            # (start, end, final, blob_idx)
    for bi, (bs, be) in enumerate(blob_ranges):
        i = bs
        while True:
            fin = i + msize >= be
            size = (be - i) if fin else msize
            masters.append((i, i + size, fin, bi))
            i += size
            if i >= be:
                break
    blob_start = [bs for (bs, _be) in blob_ranges]

    def blob_factory(bi):
        """Auxiliary host engines (fixed re-parse probes) must not see
        bytes before this input's start -- clamp via a view."""
        bs = blob_start[bi]
        if bs == 0:
            return engine_factory
        return lambda d, s, e: engine_factory(d[bs:], s - bs, e - bs)

    deflate_device(options, data, masters, lambda m: outs[m[3]],
                   lambda m: blob_factory(m[3]),
                   window_start=lambda m: blob_start[m[3]])
