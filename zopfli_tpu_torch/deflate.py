"""DEFLATE stream orchestration: master blocks, splitting, emission.

Semantics mirror the reference driver (src/zopfli/deflate.c:625-931):
master blocks processed with the previous bytes visible as LZ77
dictionary, two-phase block splitting, per-block btype choice with the
optional fixed-tree re-parse, and the empty-block / stored-block rules.

Two parse engines: "device" -- the device seed program (ops.seed: a
fixed-cost parse and the first split) and the fused squeeze
(ops.fused_engine) on Options.device, the second split on the device
(ops.devsplit) -- and "native", the C++ host engine.  ZT_SEED=greedy
keeps the greedy-seeded device path: the host greedy parse seeds the
stats and feeds the first split.
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
    # CUDA devices) where the fused loop does not take them all; 0 = auto.
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
    """Vectorized symbol payload emission (reference AddLZ77Data)."""
    ll_syms = lengths_to_symbols(ll_lengths, 15)
    d_syms = lengths_to_symbols(d_lengths, 15)
    ll_lengths = np.asarray(ll_lengths, dtype=np.int64)
    d_lengths = np.asarray(d_lengths, dtype=np.int64)

    lit = store.litlens[lstart:lend]
    dist = store.dists[lstart:lend]
    lsym = store.ll_symbol[lstart:lend]
    dsym = store.d_symbol[lstart:lend]
    is_match = dist != 0
    n = len(lit)

    f_vals = np.zeros((n, 4), dtype=np.uint64)
    f_bits = np.zeros((n, 4), dtype=np.int64)

    # Field 0: litlen huffman code.
    code_len = ll_lengths[lsym]
    f_vals[:, 0] = reverse_bits(ll_syms[lsym], code_len.astype(np.uint32))
    f_bits[:, 0] = code_len
    # Field 1: length extra bits (matches only).
    lit_clip = np.minimum(lit, 258)
    f_vals[:, 1] = np.where(is_match, spec.LENGTH_EXTRA_VALUE[lit_clip], 0)
    f_bits[:, 1] = np.where(is_match, spec.LENGTH_EXTRA_BITS[lit_clip], 0)
    # Field 2: dist huffman code (matches only).
    dlen = np.where(is_match, d_lengths[dsym], 0)
    f_vals[:, 2] = np.where(is_match,
                            reverse_bits(d_syms[dsym], dlen.astype(np.uint32)),
                            0)
    f_bits[:, 2] = dlen
    # Field 3: dist extra bits (matches only).
    dist_clip = np.maximum(dist, 1)
    f_vals[:, 3] = np.where(is_match, spec.dist_extra_value(dist_clip), 0)
    f_bits[:, 3] = np.where(is_match, spec.dist_extra_bits(dist_clip), 0)

    out.bits(f_vals.reshape(-1), f_bits.reshape(-1))


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


def _use_devseed() -> bool:
    """The device engine seeds and splits on the device by default
    (ZT_SEED=greedy restores the host-greedy seed for A/B comparison)."""
    return os.environ.get("ZT_SEED", "device") == "device"


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
    """Block-split of one master's greedy parse -> bounds incl. endpoints.

    The device engine runs the split search on the device (ops.devsplit,
    an exact reproduction of ZopfliBlockSplitLZ77); the native engine
    uses the host splitter.  ZT_DEVICE_SPLIT=0/1 overrides.
    """
    if not options.blocksplitting or inend <= instart:
        return [instart, inend]
    maxblocks = scaled_maxblocks(options, inend - instart)
    use_dev = os.environ.get("ZT_DEVICE_SPLIT")
    if use_dev is None:
        use_dev = "1" if options.engine == "device" else "0"
    with span("zt.split"):
        if use_dev == "1":
            from .ops.devsplit import block_split_lz77_device

            litlens, dists = greedy_fn(data, instart, inend)
            store = LZ77Store(data, litlens, dists, instart)
            lz77_points = block_split_lz77_device(
                litlens.astype(np.int32), dists.astype(np.int32), maxblocks,
                device=resolve_device(options))
            pts = [int(store.pos[p]) for p in lz77_points]
        else:
            pts = blocks.block_split(data, instart, inend, maxblocks,
                                     greedy_fn)
    return [instart] + pts + [inend]


def deflate_part(options: Options, btype: int, final: bool, data: np.ndarray,
                 instart: int, inend: int, out: BitStream,
                 engine_factory=None, greedy_fn=None) -> None:
    """Compress one master block (deflate.c:811-906)."""
    engine_factory = engine_factory or default_engine_factory(options)
    greedy_fn = greedy_fn or default_greedy(options)
    tracer = options.tracer

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

    if options.engine == "device" and inend > instart and _use_devseed():
        from .squeeze_batched import devseed_collect, devseed_dispatch
        entry = devseed_dispatch(data, [(instart, inend)],
                                 options.numiterations,
                                 scaled_maxblocks(options, inend - instart),
                                 device=resolve_device(options),
                                 devices=local_devices(options))
        results = devseed_collect(entry, options.numiterations,
                                  trace=_devseed_trace(tracer, entry))
        emit_results(options, data, [(instart, inend, final)], results,
                     lambda i: out, lambda i: engine_factory)
        return

    bounds = split_master(options, data, instart, inend, greedy_fn)
    if options.engine == "device":
        from .squeeze_batched import lz77_optimal_fused
        trace = None
        if tracer is not None:
            hooks = [tracer.block_iteration_hook(bounds[i], bounds[i + 1])
                     for i in range(len(bounds) - 1)]
            trace = lambda b, i, cost: hooks[b](i, cost)
        if inend > instart:
            stores = lz77_optimal_fused(
                data, [(instart, inend, bounds)], options.numiterations,
                greedy_fn, device=resolve_device(options), trace=trace,
                devices=local_devices(options))[0]
        else:
            stores = [LZ77Store(data, np.zeros(0, np.uint16),
                                np.zeros(0, np.uint16), instart)]
    else:
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
    bytes only as its LZ77 window halo).  With the device engine at
    btype 2, all masters' tiles share the fused loop's lane groups;
    otherwise, with options.workers != 1, they compress on host threads
    (on a host with several CUDA devices, master i on local_devices()[i
    % n]) and their bitstreams are spliced in order.
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

    if options.engine == "device" and btype == 2 and len(masters) > 1:
        _deflate_fused_masters(options, data, masters, out,
                               engine_factory or
                               default_engine_factory(options),
                               greedy_fn or default_greedy(options))
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


def _deflate_fused_masters(options: Options, data: np.ndarray, masters,
                           out: BitStream, engine_factory,
                           greedy_fn) -> None:
    """All masters' tiles share the fused device loop, in chunks.

    Masters are chunked by estimated tile count (ZT_TILE_BUDGET) so
    chunks fill the bucketed lane-group geometry; the free lanes, and so
    the replicas, depend on this chunking.  While the device runs chunk
    N, the host emits chunk N-1.
    """
    from .squeeze_batched import fused_collect, fused_dispatch

    device = resolve_device(options)
    devices = local_devices(options)
    chunks = _chunk_masters(options, masters)
    if _use_devseed():
        _devseed_pipeline(options, data, chunks, lambda m: 0,
                          lambda m: out, lambda m: engine_factory, device,
                          devices)
        return

    pending = None  # (chunk, fs, handle)

    def emit(entry):
        chunk, fs, handle = entry
        all_stores = fused_collect(fs, handle, options.numiterations)
        for (start, end, fin), stores in zip(chunk, all_stores):
            finish_part(options, fin, stores, out, engine_factory)

    for chunk in chunks:
        specs = [(start, end,
                  split_master(options, data, start, end, greedy_fn))
                 for (start, end, _fin) in chunk]
        fs, handle = fused_dispatch(data, specs, options.numiterations,
                                    greedy_fn, device=device,
                                    devices=devices)
        if pending is not None:
            emit(pending)
        pending = (chunk, fs, handle)
    emit(pending)


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
                      out_for, factory_for, device, devices=None) -> None:
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
    device = resolve_device(options)
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

    _devseed_pipeline(options, data, _chunk_masters(options, masters),
                      lambda m: blob_start[m[3]], lambda m: outs[m[3]],
                      lambda m: blob_factory(m[3]), device,
                      local_devices(options))
