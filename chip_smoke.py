#!/usr/bin/env python3
"""Smoke run of zopfli_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py                # every phase
    python3 chip_smoke.py --only kernels # build + kernel checks only
    python3 chip_smoke.py --only oracle  # build + phase 8 only
    python3 chip_smoke.py --only parallel  # build + phase 9 only
    python3 chip_smoke.py --only mega      # build + phase mega only
    python3 chip_smoke.py --only split     # build + the split search only
    python3 chip_smoke.py --only workers   # build + phase 10 only
    python3 chip_smoke.py --only i500      # build + phase i500 only

Phases, each printed as one JSON line:
  1. environment: the card's name and power limit, the kernels' build.
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, on real inputs at production shapes (TILE=8192, LANES=256,
     KBP=12) for the phase-3 input:
       - scan and traceback on the first squeeze iteration's inputs
         (the port's candidate tables, costs from the greedy seed stats)
         and on the device seed program's fixed-cost inputs;
       - hist_cost on the seed's per-block histograms, on one batch of
         split-probe histograms, and on seeded random batches of 1, 18
         and 2048 rows with edge rows;
       - autotype_cost on the first rounds of the seed's device split
         and its largest round, and on seeded random ranges with edge
         cases (ends on and beside checkpoints, ends at ncap, empty and
         reversed ranges, ranges inside one checkpoint) under each
         fixed-cost gate (the whole store's, true and false, and one per
         range);
       - where a K3 row's cycles go, phase by phase, in the kernel the
         port runs (experiments/exp_hist_cost_phases.py, which measures
         the first design with `--variants first`);
       - then the CASES shapes on seeded random inputs (ties, unsorted
         breakpoints, odd tiles and lane counts, cut paths).
     Outputs must be bit-equal, and one warm scan + traceback pair must
     not sync the stream.  The device split of the seed parse must equal
     the host splitter on the same stream.  The split_search kernel (a
     whole search in one launch) must equal its plain version on the
     seed parse, a squeeze's output stream and synthetic streams (under
     10 and under 1000 symbols, linear rounds only, 200,000 random
     symbols): at steps = 1, 2, ... against one plain step each (state,
     ranges, gates; the rounds' costs against autotype_cost), the whole
     search 5 times against the plain search on CPU copies, capped at
     half its steps (S_OVERFLOW), queued under
     torch.cuda.set_sync_debug_mode("error"); one search under
     torch.profiler must be one kernel.  Times are CUDA-event means
     over warm launches (for the two cost kernels, `ms` is of launches
     captured in a CUDA graph, so that their Python wrapper is out of
     the time, and `ms_eager` of eager calls back to back).
  3. main path: zopfli_tpu_torch.compress(1 MiB, "gzip", --i15) on the
     card at the defaults (device seed); the input is the corpus
     (corpus_paths: zopfli_tpu/**/*.py and FROZEN_DOCS) repeated to 2^20
     bytes, its length and CRC-32 printed on the phase's line.  It must
     round-trip through zlib, launch scan and traceback 15 + (seed
     programs) times, hist_cost at least once, split_search twice (the
     two splits, one pull each; each equal to the plain search on CPU
     copies of its stream) and autotype_cost never, call no host greedy
     parse, fall back to the host engine for no block, and stay within
     2% of the native engine's size.
  mega: ZT_MEGA=1 at 1 MiB (G=1, nb_pad 64) and 2 MiB at
     ZT_MASTER_SIZE=2097152 (MB 32, G=2, nb_pad 128), each beside the
     default two-phase path in turns: bytes equal, zlib round trip, no
     verify fallback, per-block best costs equal to FusedSqueeze's on the
     same seed, mega_dispatch under set_sync_debug_mode("error"), K1/K2
     15 + 1 launches, split_search 2, autotype_cost 2 (the cost totals),
     no host read of a split; warm walls of both paths.
  4. profile: one more default compress under torch.profiler -- host
     time per pipeline stage, device time per kernel, the device's idle
     share.  It fails only if the profiler fails or sees no device time.
  5. many: compress_many on the corpus files as separate inputs and on
     two identical adjacent inputs; each output must round-trip alone.
  6. png: zopfli_tpu_torch.png.optimize_many at the defaults on 44
     web-asset-like PNGs made without PIL (png_corpus.py's 14 classes at
     its 3 sizes, a 1024x768 photo, a 512x512 RGBA image with alpha
     bands; 4.8 MB of raw scanlines), its IDAT jobs in two compress_many
     calls (42 at 15 iterations, 2 large images at 5), twice on the
     device engine and once on the native one (which compresses the
     jobs one after another; its slowest jobs are printed): every
     output must decode to its input's pixels, K1 == K2 > 0 launches,
     hist_cost > 0, split_search == searches > 0, autotype_cost 0, no
     verify
     fallback, no host greedy parse, eight probe trials and one winner
     handed on an image in every run (`optimize.PROBE`, with the probe
     pool's width), and the batch's bytes within 2% of the native
     engine's.  The fused loop's K1 inputs at the most lane groups of
     the batch are kept from the first run, and K1 and K2 are held
     bit-equal to their plain versions on them and timed.
  i500: zopflipng's "really good" example (the benchmark's
     zopflipng-i500-all-filters configuration: 500 iterations, all nine
     filter strategies, lossy_transparent, lossy_8bit) on one call of
     the android-launcher mix (ten seeded RGBA launcher icons, 48-192
     px; 90 zlib jobs in one compress_many), twice: every output passes
     the benchmark's alpha-aware check and is smaller than its zlib-9
     yardstick, the two runs' bytes are equal, a block row drew more
     than 48 randomization events (`fused_engine.RANDOM`), the second
     run built no maps (the first grows them to its loops' events), and
     no verify fallback.  Its line names each of these conditions with
     its outcome, and each run's output digest.
  7. cli: `zopfli_tpu_torch.cli.main(["--i15", file])` in process on
     phase 3's input (bytes equal to phase 3's compress, launches as in
     phase 3), `python3 -m zopfli_tpu_torch.cli -c --i15 file` in a fresh
     process (stdout equal to the same bytes), and
     `zopfli_tpu_torch.png.cli.main(["--prefix=zopfli_", "-y", ...])` on
     six of phase 6's images (pixels equal, K1 launched).
  8. oracle: the oracle block engine (ops.dp, ops.engine): dp_scan held
     bit-equal to its plain version (a real 2 x 4096 batch, a seeded
     random case, the 16 KiB bucket, costs on the 1/4-bit grid, zero
     costs of both signs, phase 3's largest block in its bucket and 8
     rows of 2^17 with different masks, the last two against the plain
     version on the host) and timed at 16 KiB, at the largest block's
     bucket and at 8 x 2^17, the plain version timed at 16 KiB; block_pipeline on
     8 rows of 2^17 bytes (also sharded over two entries of this card);
     deflate of phase 3's input through DeviceBlockEngine at
     ORACLE_ITERATIONS (round trip, <= 1.02 x native, no verify
     fallback); K2's large-tile entry bit-equal at a tile of 32,768 rows
     (random paths at the loop's 256 lanes) and of 70,000 rows (2 groups
     of 32 lanes), and compress() at
     ZT_TILE=32768 in a fresh process launching only that entry, which
     is held bit-equal and timed there on the loop's own K2 inputs.
  9. parallel: compress of 4 MiB of repo text (fused loop at
     G=4; K1/K2 held bit-equal on its inputs and timed), the same with
     the loop sharded over [cuda:0, cuda:0] (bytes equal),
     compress_multihost in a world-size-1 gloo group (bytes equal to
     compress), two processes on this card in a gloo group (2.1 MB,
     --i2; rank 0's bytes equal to the single-process ones), and two
     such processes calling compress_many on 1.3 MB, 200 KB and an
     empty input (rank 0's list equal to the single-process
     compress_multihost of each, rank 1's None for each).
  10. workers: masters on host threads (Options.workers) over 4 MiB of
     repo text, four 2^20-byte masters: forced btype 1 through
     DeviceBlockEngine (one dp_scan launch a master) at workers=1, then
     at workers=4 with deflate.local_devices patched to [cuda:0, cuda:0]
     (the round-robin of masters over local devices): bytes equal, zlib
     round trip, 4 dp_scan launches each, no fallback, master i's engine
     on devices[i % 2]; dp_scan held bit-equal to its plain version (on
     the host) on one master's row and timed there; btype 0 at workers=4
     spliced equal to workers=1; the default path (btype 2) at workers=4
     still on the fused loop, launches and bytes equal to workers=1's.
     Each run's seconds are printed beside the card's name and power
     limit.
Then a `kernels` JSON line (with phase 3's launches, phase mega's in
`launches_mega`, phase 6's in `launches_png`, for K1 and K2 phase 6's
check at its shape in `png_shape` and phase 9's at G=4 in `g4_shape`;
split_search's cooperative grid in `grid_clusters`; dp_scan with the
launches of phase 8's deflate, those of phase 10's threaded run in
`launches_workers` and its time at the 2^20 bucket in `master_shape`,
the large-tile traceback entry with those of its ZT_TILE=32768 run), and
last {"ok": true, "device": {...}}.
Exits non-zero, printing no result, if any phase fails or no GPU is
present.  Imports nothing of JAX.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import subprocess
import sys
import time
import traceback
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
MIB = 1 << 20
ITERATIONS = 15
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores.  int32 operations: 64 INT32 lanes per SM
# (Hopper architecture white paper) x 132 SMs x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
INT32_OPS = 64 * 132 * 1.98e9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# Root documents that predate the port and, like zopfli_tpu/, are never
# edited.  Python source alone is too uniform: its 1 MiB splits into two
# blocks, so the second split (which needs three) would never run.
FROZEN_DOCS = ("ADVICE.md", "BASELINE.md", "COVERAGE.md", "PAPER.md",
               "PAPERS.md", "PARITY.md", "PARITY_CORPUS.md",
               "PARITY_PNG.md", "PROFILE.md", "SCALE.md", "SNIPPETS.md",
               "SURVEY.md", "VERDICT.md")


def corpus_paths() -> list[str]:
    """Text that does not change from one commit to the next, so the
    inputs do not drift: zopfli_tpu/**/*.py and FROZEN_DOCS, sorted by
    path."""
    return sorted(glob.glob(os.path.join(HERE, "zopfli_tpu", "**", "*.py"),
                            recursive=True)
                  + [os.path.join(HERE, f) for f in FROZEN_DOCS])


def corpus_1mib() -> bytes:
    """2^20 bytes of the corpus files, concatenated, repeated or cut."""
    blob = b"".join(open(p, "rb").read() for p in corpus_paths())
    if not blob:
        raise RuntimeError("no repo text found beside chip_smoke.py")
    return (blob * (MIB // len(blob) + 1))[:MIB]


PNG_SIZES = ((48, 48), (96, 128), (200, 150))


def _smooth(rng, h, w, ch):
    """Photo-like: random walk smoothed (png_corpus.py's generator)."""
    import numpy as np

    a = rng.standard_normal((h, w, ch))
    for _ in range(3):
        a = (a + np.roll(a, 1, 0) + np.roll(a, 1, 1)
             + np.roll(a, -1, 0) + np.roll(a, -1, 1)) / 5.0
    a = np.cumsum(a, axis=1)
    a -= a.min()
    a *= 255.0 / max(a.max(), 1e-9)
    return a.astype(np.uint8)


def png_inputs() -> list[tuple[str, bytes]]:
    """Web-asset-like PNGs, made without PIL: png_corpus.py's 14 classes
    at its three sizes from its seed, then a 1024x768 photo-like RGB
    image and a 512x512 RGBA image with a transparent and a partial-alpha
    band.  Each is encoded by the port's codec with minsum filters and
    zlib level 6; palette and sub-byte classes set their header fields."""
    import numpy as np

    from zopfli_tpu_torch.png import codec, filters

    out = []

    def enc(name, scan, h, w, bd, ct, palette=None):
        scan = np.ascontiguousarray(scan.reshape(h, -1), dtype=np.uint8)
        cand = filters.filter_all_types(scan, codec._bpp_bytes(ct, bd))
        spec = codec.EncodeSpec(scan, w, h, bd, ct, palette)
        out.append((name, codec.encode(
            spec, filters.strategy_minsum(cand),
            deflater=lambda b: zlib.compress(b, 6))))

    def packed(values, bd):
        bits = np.unpackbits(values.astype(np.uint8)[..., None],
                             axis=-1)[..., 8 - bd:]
        return np.packbits(bits.reshape(values.shape[0], -1), axis=1)

    rng = np.random.default_rng(20260817)
    for i, (h, w) in enumerate(PNG_SIZES):
        flat = np.full((h, w, 3), [30 + 40 * i, 90, 200 - 50 * i], np.uint8)
        enc(f"flat_{i}", flat, h, w, 8, 2)
        gx = np.linspace(0, 255, w, dtype=np.uint8)
        grad = np.stack([np.tile(gx, (h, 1))] * 3, axis=2)
        grad[:, :, 1] = grad[:, :, 1][::-1]
        enc(f"gradient_{i}", grad, h, w, 8, 2)
        pal = rng.integers(0, 256, (8, 3), np.uint8)
        enc(f"palette8_{i}", pal[rng.integers(0, 8, (h, w))], h, w, 8, 2)
        enc(f"gray_{i}", _smooth(rng, h, w, 1), h, w, 8, 0)
        enc(f"photo_{i}", _smooth(rng, h, w, 3), h, w, 8, 2)
        enc(f"noise_{i}", rng.integers(0, 256, (h, w, 3), np.uint8), h, w,
            8, 2)
        rgba = _smooth(rng, h, w, 4)
        rgba[:, :, 3] = 255
        rgba[: h // 3, :, 3] = 0          # transparent band w/ junk RGB
        rgba[h // 3: h // 2, :, 3] = 128  # partial alpha
        enc(f"alpha_{i}", rgba, h, w, 8, 6)
        binalpha = rgba.copy()
        binalpha[:, :, 3] = np.where(rgba[:, :, 3] > 100, 255, 0)
        enc(f"binalpha_{i}", binalpha, h, w, 8, 6)
        checker = ((np.add.outer(np.arange(h), np.arange(w)) // 4) % 2)
        enc(f"checker_{i}", checker * 255, h, w, 8, 0)
        text = np.zeros((h, w), np.uint8)
        for _ in range(h * w // 128):
            y, x = rng.integers(0, h - 4), rng.integers(0, w - 4)
            text[y:y + rng.integers(1, 4), x:x + rng.integers(1, 4)] = 255
        enc(f"textish_{i}", text, h, w, 8, 0)
        gray16 = _smooth(rng, h, w, 1)[:, :, 0].astype(np.uint16) * 257
        enc(f"gray16_{i}", gray16.astype(">u2").view(np.uint8), h, w, 16, 0)
        bit1 = (checker ^ (rng.random((h, w)) < 0.02)).astype(np.uint8)
        enc(f"bit1_{i}", packed(bit1, 1), h, w, 1, 0)
        few = rng.integers(0, 4, (h, w))
        pal4 = np.array([[0, 0, 0], [255, 0, 0], [0, 255, 0], [40, 40, 255]],
                        np.uint8)
        enc(f"pal4_{i}", packed(few, 2), h, w, 2, 3, palette=pal4)
        stripes = np.zeros((h, w, 3), np.uint8)
        stripes[::3] = [200, 0, 0]
        stripes[1::3] = [0, 200, 0]
        enc(f"stripes_{i}", stripes, h, w, 8, 2)
    enc("photo_1024x768", _smooth(rng, 768, 1024, 3), 768, 1024, 8, 2)
    big = _smooth(rng, 512, 512, 4)
    big[:, :, 3] = 255
    big[:128, :, 3] = 0
    big[128:192, :, 3] = 128
    enc("alpha_512x512", big, 512, 512, 8, 6)
    return out


def cuda_time_ms(fn, reps: int, warm: int = 1) -> float:
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi failed: {smi.stderr.strip()}")


def phase_env(zt_scan):
    print(card_line(), flush=True)
    t0 = time.time()
    zt_scan.build_kernels()
    secs = time.time() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln or "smem" in ln]
             for name, log in zt_scan.BUILD_LOG.items()}
    emit({"phase": "build", "ok": True, "seconds": round(secs, 3),
          "ptxas": ptxas})


def bytes_bound(nbytes: float, ops: float,
                int_ops: float = 0) -> tuple[float, str]:
    """(least ms, what bounds it) for the bytes a kernel must move, its
    f32 operations and its int32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOPS + int_ops / INT32_OPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def graph_time_ms(fn, reps: int) -> float:
    """Device ms per call of fn: `reps` calls captured in one CUDA graph,
    replayed between CUDA events, so the host's launch cost is out of
    the time (for kernels shorter than their Python wrapper)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _scan_bound(inputs, ce, cost, G) -> tuple[float, str]:
    """Least time of a scan: every input read once and both outputs
    written once; its operations are 2 f32 adds + 1 compare per
    relaxation that lands inside the tile, and 2 per literal."""
    import numpy as np

    from zopfli_tpu_torch.ops import scan_kernel as sk

    rows, _, nt = inputs[0].shape
    tile = rows // G
    nbytes = (sum(t.numel() * t.element_size() for t in inputs)
              + ce.numel() * 4 + cost.numel() * 4)
    relax = int(np.clip(tile - np.arange(tile) - 2, 0, sk.W).sum())
    return bytes_bound(nbytes, G * nt * (3 * relax + 2 * tile))


def _traceback_bound(hist, pe, G, symtab) -> tuple[float, str]:
    """Least time of a traceback: the path rows it must read (ce, and lit
    at literals), tile_nbytes and the symbol tables, and both outputs
    written once."""
    from zopfli_tpu_torch.ops import scan_kernel as sk

    npath = int((pe != 0).sum())
    nlit = int(((pe & sk.LEN_MASK) == 1).sum())
    nbytes = (4 * npath + 4 * nlit + 4 * G * pe.shape[1] + symtab.nbytes
              + hist.numel() * 4 + pe.numel() * 4)
    return bytes_bound(nbytes, 4 * npath)


def _hold_k1k2(inputs, lit, nbytes, symtab, G, plain_reps):
    """K1 on `inputs` and K2 on K1's output against their plain versions:
    bit-equality, largest differences, CUDA-event times of warm launches
    (the plain versions over `plain_reps` calls), and bounds.  Returns
    (report, K2's pe)."""
    import torch

    from zopfli_tpu_torch.ops import scan_kernel as sk

    ce_k, cost_k = sk.scan(*inputs, groups=G)
    ce_p, cost_p = sk.scan_plain(*inputs, groups=G)
    hist_k, pe_k = sk.traceback(ce_k, lit, nbytes, symtab, groups=G)
    hist_p, pe_p = sk.traceback_plain(ce_k, lit, nbytes, symtab, groups=G)
    torch.cuda.synchronize()
    r = {"bit_equal": {
        "ce": torch.equal(ce_k, ce_p),
        "cost": torch.equal(cost_k.view(torch.int32),
                            cost_p.view(torch.int32)),
        "hist": torch.equal(hist_k, hist_p),
        "pe": torch.equal(pe_k, pe_p)},
        "scan_err": max(
            float((cost_k.double() - cost_p.double()).abs().max()),
            float((ce_k.long() - ce_p.long()).abs().max())),
        "traceback_err": max(float((hist_k - hist_p).abs().max()),
                             float((pe_k.long() - pe_p.long()).abs().max()))}
    del ce_p, cost_p, hist_p, pe_p
    r["scan_ms"] = cuda_time_ms(lambda: sk.scan(*inputs, groups=G), reps=10)
    r["traceback_ms"] = cuda_time_ms(lambda: sk.traceback(
        ce_k, lit, nbytes, symtab, groups=G), reps=20)
    r["scan_plain_ms"] = cuda_time_ms(
        lambda: sk.scan_plain(*inputs, groups=G), reps=plain_reps, warm=0)
    r["traceback_plain_ms"] = cuda_time_ms(lambda: sk.traceback_plain(
        ce_k, lit, nbytes, symtab, groups=G), reps=plain_reps, warm=0)
    r["scan_bound_ms"], r["scan_bound_by"] = _scan_bound(inputs, ce_k,
                                                         cost_k, G)
    r["traceback_bound_ms"], r["traceback_bound_by"] = _traceback_bound(
        hist_k, pe_k, G, symtab)
    return r, pe_k


def phase_kernels(data, dev="cuda"):
    """Each kernel against its plain version at production shapes."""
    import numpy as np
    import torch

    from zopfli_tpu_torch import native
    from zopfli_tpu_torch.deflate import Options, split_master
    from zopfli_tpu_torch.ops import fused_engine, scan_kernel as sk
    from zopfli_tpu_torch.squeeze_batched import greedy_seed_stats

    dev = torch.device(dev)
    n = len(data)
    bounds = split_master(Options(numiterations=ITERATIONS, engine="native"),
                          data, 0, n, native.greedy)
    fs = fused_engine.FusedSqueeze(data, [(0, n, bounds)], device=dev)
    seed_ll, seed_d = greedy_seed_stats(data, fs.block_bounds, native.greedy)
    sll, sd, _ = fs.initial_stats(seed_ll, seed_d)
    inputs = fs.scan_inputs(torch.from_numpy(sll).to(dev),
                            torch.from_numpy(sd).to(dev))
    G = fs.ngroups
    rows, kbp, nt = inputs[0].shape
    tile = rows // G
    symtab = fs.symtab

    sh = fs.shards[0]
    k12, pe_k = _hold_k1k2(inputs, sh.lit_t, sh.tile_nbytes_d, symtab, G,
                           plain_reps=2)
    checks = dict(k12["bit_equal"])
    path = pe_k != 0
    npath = int(path.sum())
    npath_max = int(path.sum(dim=0).max())  # the longest walk of a lane

    # One warm scan + traceback pair, with symtab as FusedSqueeze holds
    # it, must not sync the stream.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ce_s, _ = sk.scan(*inputs, groups=G)
        sk.traceback(ce_s, sh.lit_t, sh.tile_nbytes_d, symtab, groups=G)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    checks["no_sync"] = True

    checks.update(_case_checks(dev))
    # A second split's stream: the squeeze's parse after two iterations.
    parses = fs.run(seed_ll, seed_d, 2)[0]
    second = tuple(np.concatenate([p[i] for p in parses]) for i in (0, 1))
    seed_report, seed_checks, k3s = _seed_checks(data, dev, second)
    checks.update(seed_checks)
    ok = all(checks.values())
    emit({"phase": "kernels", "ok": ok, "bit_equal": checks,
          "shape": {"groups": G, "tile": tile, "lanes": nt, "kbp": kbp},
          "smem_bytes": {
              "scan": sk.build_kernels()["scan"].zt_scan_smem_bytes(kbp),
              "traceback": sk.build_kernels()[
                  "traceback"].zt_traceback_smem_bytes(tile),
              "hist_cost": sk.build_kernels()[
                  "hist_cost"].zt_hist_cost_smem_bytes()},
          "path_rows": npath, "path_rows_max_lane": npath_max,
          **{k: k12[k] for k in ("scan_ms", "scan_plain_ms", "traceback_ms",
                                 "traceback_plain_ms")},
          "seed": seed_report})
    if not ok:
        raise RuntimeError(f"kernel disagrees with its plain version: "
                           f"{checks}")
    return {
        "scan": {"name": "scan", "route": "cuda",
                 "source": "zopfli_tpu_torch/csrc/scan.cu",
                 "replaces": sk.REPLACES["scan"],
                 "max_abs_err": k12["scan_err"], "ms": k12["scan_ms"],
                 "plain_ms": k12["scan_plain_ms"],
                 "bound_ms": k12["scan_bound_ms"],
                 "bound_by": k12["scan_bound_by"], "library_ms": None},
        "traceback": {"name": "traceback", "route": "cuda",
                      "source": "zopfli_tpu_torch/csrc/traceback.cu",
                      "replaces": sk.REPLACES["traceback"],
                      "max_abs_err": k12["traceback_err"],
                      "ms": k12["traceback_ms"],
                      "plain_ms": k12["traceback_plain_ms"],
                      "bound_ms": k12["traceback_bound_ms"],
                      "bound_by": k12["traceback_bound_by"],
                      "library_ms": None},
        **k3s,
    }


def _hist_edge_batch(rng, B):
    """Seeded random (B, 288) / (B, 32) counts with edge rows: all zero,
    one symbol, two symbols, all 288 nonzero, long equal runs (the RLE
    path), counts near 2^24."""
    import numpy as np

    ll = rng.integers(0, 3000, (B, 288)) * (rng.random((B, 288)) < 0.5)
    d = rng.integers(0, 500, (B, 32)) * (rng.random((B, 32)) < 0.6)
    edges = [(np.zeros(288, np.int64), np.zeros(32, np.int64))]  # zero
    one = np.zeros(288, np.int64)
    one[65] = 9
    edges.append((one, np.eye(32, dtype=np.int64)[3]))     # one symbol
    two = np.zeros(288, np.int64)
    two[[1, 270]] = [4, 5]
    edges.append((two, np.zeros(32, np.int64)))            # two symbols
    edges.append((rng.integers(1, 100, 288),
                  rng.integers(1, 100, 32)))               # all nonzero
    runs = np.full(288, 7)
    runs[100:140] = 0
    runs[200:230] = 12
    edges.append((runs, np.full(32, 3)))                   # long runs
    edges.append((rng.integers((1 << 24) - 1000, 1 << 24, 288),
                  rng.integers((1 << 24) - 100, 1 << 24, 32)))  # ~2^24
    for i, (a, b) in enumerate(edges[:B]):
        ll[i], d[i] = a, b
    ll[:, 286:] = 0
    d[:, 30:] = 0
    return ll, d


def _seed_checks(data, dev, second):
    """The seed program's kernels on its real inputs, hist_cost, the
    device split against the host splitter on the seed parse, and the
    split under device control on it, on `second` (a squeeze's output
    stream, what the second split searches) and on synthetic streams."""
    import numpy as np
    import torch

    from zopfli_tpu_torch import blocks
    from zopfli_tpu_torch.deflate import Options, scaled_maxblocks
    from zopfli_tpu_torch.lz77 import LZ77Store
    from zopfli_tpu_torch.ops import costmodel as cm
    from zopfli_tpu_torch.ops import devsplit, hashmatch, seed
    from zopfli_tpu_torch.ops import scan_kernel as sk

    n = len(data)
    mb = scaled_maxblocks(Options(), n)
    buf, cap, min_pos, inend_real = seed.master_buffer(data, 0, n)
    core = seed.make_seed_core(
        cap, mb, tuple(sorted(hashmatch.current_knobs().items())))
    bufd = torch.from_numpy(buf).to(dev)
    scan_args, lit_t, nbytes_g, _bl, _bd = core.scan_inputs(
        bufd, min_pos, inend_real)
    G = core.G
    checks, report = {}, {"groups": G, "lanes_used": int(
        (nbytes_g > 0).sum())}

    # K1 / K2 on the fixed-cost inputs (integer costs, many exact ties).
    ce, cost = sk.scan(*scan_args, groups=G)
    pce, pcost = sk.scan_plain(*scan_args, groups=G)
    hist, pe = sk.traceback(ce, lit_t, nbytes_g, core.symtab, groups=G)
    phist, ppe = sk.traceback_plain(ce, lit_t, nbytes_g, core.symtab,
                                    groups=G)
    checks["seed_scan"] = torch.equal(ce, pce) and torch.equal(
        cost.view(torch.int32), pcost.view(torch.int32))
    checks["seed_traceback"] = torch.equal(hist, phist) and torch.equal(
        pe, ppe)
    report["scan_ms"] = cuda_time_ms(lambda: sk.scan(*scan_args, groups=G),
                                     reps=10)
    report["traceback_ms"] = cuda_time_ms(lambda: sk.traceback(
        ce, lit_t, nbytes_g, core.symtab, groups=G), reps=20)
    report["scan_plain_ms"] = cuda_time_ms(
        lambda: sk.scan_plain(*scan_args, groups=G), reps=1, warm=0)
    report["traceback_plain_ms"] = cuda_time_ms(lambda: sk.traceback_plain(
        ce, lit_t, nbytes_g, core.symtab, groups=G), reps=1, warm=0)

    # The whole parse, then the device split against the host splitter
    # on the same symbol stream.
    t0 = time.time()
    parsed = core.parse(bufd, min_pos, inend_real)
    nsym = int(parsed[3])
    report["parse_s"] = time.time() - t0
    lit_s, dist_s = (t[:nsym].cpu().numpy().astype(np.uint16)
                     for t in parsed[:2])
    # The device split: one split_search launch, one pull.
    before = dict(devsplit.STATS)
    t0 = time.time()
    sp, npts = devsplit.split_lz77_device(parsed[0], parsed[1], core.DCAP,
                                          mb, nsym)
    report["device_split_s"] = time.time() - t0
    report["device_split_rounds"] = (devsplit.STATS["rounds"]
                                     - before["rounds"])
    report["device_split_syncs"] = devsplit.STATS["syncs"] - before["syncs"]
    t0 = time.time()
    host = blocks.block_split_lz77(LZ77Store(data, lit_s, dist_s, 0), mb)
    report["host_split_s"] = time.time() - t0
    report["symbols"] = nsym
    report["split_points"] = sp[:npts]
    checks["device_split_vs_host"] = sp[:npts] == host


    # K3 on the seed's per-block histograms, one batch of split-probe
    # histograms (FindMinimum's first round over the whole stream, with
    # the segment's own cost), and seeded random batches.
    out = core.finish(parsed)
    k3_sets = {"seed_blocks": (out[3], out[4])}
    ll_sym, d_sym, nbytes = devsplit.stream_symbols(
        parsed[0], parsed[1], core.DCAP, nsym)
    ll_ck, d_ck, bcum = devsplit.checkpoints(ll_sym, d_sym, nbytes,
                                             core.DCAP, nsym)
    tabs = (ll_ck, d_ck, ll_sym, d_sym, bcum)
    step = (nsym - 1) // (devsplit.NUM + 1)
    p = [1 + (k + 1) * step for k in range(devsplit.NUM)]
    a = [0] * devsplit.NUM + p + [0]
    b = p + [nsym] * devsplit.NUM + [nsym]
    k3_sets["probe_batch"] = _range_hists(devsplit, tabs, a, b, core.DCAP)
    rng = np.random.default_rng(11)
    for rows in (1, 18, 2048):
        ll, d = _hist_edge_batch(rng, rows)
        k3_sets[f"random_{rows}"] = (torch.from_numpy(ll).to(dev),
                                     torch.from_numpy(d).to(dev))
    k3_err = 0.0
    for name, (ll, d) in k3_sets.items():
        got = cm.hist_dynamic_cost(ll, d)
        want = cm.hist_dynamic_cost_plain(ll, d)
        checks[f"hist_cost_{name}"] = torch.equal(got, want)
        k3_err = max(k3_err, float((got - want).abs().max()))
    ll, d = k3_sets["probe_batch"]
    B = ll.shape[0]
    k3_ms = graph_time_ms(lambda: cm.hist_dynamic_cost(ll, d), reps=50)
    k3_plain = cuda_time_ms(lambda: cm.hist_dynamic_cost_plain(ll, d),
                            reps=2)
    report["hist_cost_ms_by_rows"] = {
        str(ll_.shape[0]): graph_time_ms(
            lambda: cm.hist_dynamic_cost(ll_, d_),
            reps=50 if ll_.shape[0] < 100 else 10)
        for ll_, d_ in (k3_sets["probe_batch"], k3_sets["seed_blocks"],
                        k3_sets["random_2048"])}
    k3_eager = cuda_time_ms(lambda: cm.hist_dynamic_cost(ll, d), reps=50)
    # Least time: each row's 320 int64 counts read once, one int64
    # written; the integer operations of the algorithm on these rows.
    bound, by = bytes_bound(B * (320 + 1) * 8, 0, _k3_ops(ll, d))
    k3 = {"name": "hist_cost", "route": "cuda",
          "source": "zopfli_tpu_torch/csrc/hist_cost.cu",
          "replaces": sk.REPLACES["hist_cost"], "max_abs_err": k3_err,
          "ms": k3_ms, "ms_eager": k3_eager, "plain_ms": k3_plain,
          "bound_ms": bound, "bound_by": by, "library_ms": None, "rows": B}
    # The split search (one kernel a search) on the seed parse, on a
    # second split's stream and on synthetic streams; the seed parse's
    # rounds then serve the autotype_cost checks.
    streams = {"seed_parse": (parsed[0], parsed[1], core.DCAP, nsym)}
    streams.update(_split_streams(second, dev))
    search_checks, search = _split_search_checks(streams, mb, dev)
    checks.update(search_checks)
    report["split_search"] = search["report"]
    at, at_checks, at_report = _autotype_checks(
        devsplit, sk, tabs, search["rounds"], core.DCAP, nsym, dev)
    checks.update(at_checks)
    report["autotype_cost"] = at_report
    report["hist_cost_phases"] = _phase_breakdowns(
        {"probe_19": k3_sets["probe_batch"],
         "seed_blocks": k3_sets["seed_blocks"],
         "random_2048": k3_sets["random_2048"]}, sk, checks)
    return report, checks, {"hist_cost": k3, "autotype_cost": at,
                            "split_search": search["entry"]}


def _split_streams(second, dev) -> dict:
    """A second split's stream (a squeeze's parse) and the synthetic
    streams, padded as the device split pads them, on `dev`."""
    import numpy as np
    import torch

    streams = {}
    for name, (lit, dist) in [("second_split", second)] + list(
            _synthetic_streams(np.random.default_rng(17)).items()):
        ll, dd, ncap, n = _pad_stream(lit, dist)
        streams[name] = (torch.from_numpy(ll).to(dev),
                         torch.from_numpy(dd).to(dev), ncap, n)
    return streams


def _range_hists(devsplit, tabs, a, b, ncap):
    """(ll, d) histograms of the ranges [a[i], b[i]) of a stream."""
    import torch

    ll_ck, d_ck, ll_sym, d_sym, _ = tabs
    pts = torch.tensor(list(a) + list(b), dtype=torch.int64,
                       device=ll_ck.device)
    pll, pd = devsplit.prefix_hist_at(ll_ck, d_ck, ll_sym, d_sym, pts, ncap)
    B = len(a)
    return pll[B:] - pll[:B], pd[B:] - pd[:B]


def _k3_ops(ll, d) -> int:
    """Integer operations of the exact dynamic cost on these rows, counted
    from the algorithm, not from a kernel: for each of the two code-length
    sets and both alphabets a sort of the m used symbols (m log2 m
    compares) and one compare per item of every package-merge level;
    RleOptimize's pass (4 per symbol); 8 tree-header variants (2 per code
    length) per set; the payload (2 per symbol) per set."""
    import numpy as np

    ops = 0
    for m in np.concatenate([
            (ll.cpu().numpy() != 0).sum(axis=1) + (ll.cpu().numpy()[:, 256]
                                                   == 0),
            (d.cpu().numpy() != 0).sum(axis=1)]):
        m = int(m)
        size, merged = m, 0
        for _ in range(1, min(m - 1, 15)):
            size = size // 2 + m
            merged += size
        ops += 2 * (m * max(1, int(np.ceil(np.log2(max(m, 2))))) + merged)
    return ops + ll.shape[0] * (4 * 320 + 2 * 8 * 2 * 316 + 2 * 2 * 320)


def _autotype_checks(devsplit, sk, tabs, rounds, ncap, nsym, dev):
    """The autotype_cost kernel against autotype_costs_plain on the
    split's first probe rounds and its largest one, and on seeded random
    ranges with edge cases under each fixed-cost gate; its time and
    bound."""
    import numpy as np
    import torch

    checks, report = {}, {}
    big = max(range(len(rounds)), key=lambda i: len(rounds[i][0]))
    sets = {f"round_{i}": rounds[i] for i in sorted({0, 1, 2, 3, big})
            if i < len(rounds)}
    edges = [0, 1, 255, 256, 257, 511, 512, 513, nsym - 1, nsym,
             ncap - 1, ncap]
    rng = np.random.default_rng(13)
    ea = np.repeat(edges, len(edges))
    eb = np.tile(edges, len(edges))
    ra = rng.integers(0, nsym + 1, 400)
    rb = np.minimum(ra + rng.integers(-50, 4000, 400), ncap)
    inside = rng.integers(0, nsym // 256, 20) * 256 + 3   # one checkpoint
    pa = np.concatenate([ea, ra, inside])
    pb = np.concatenate([eb, rb, inside + rng.integers(1, 250, 20)])
    for small in (True, False):
        sets[f"random_small_{small}"] = (pa, pb, small)
    sets["random_per_block"] = (pa, pb, torch.from_numpy(
        rng.random(len(pa)) < 0.5).to(dev))     # the per-block-store rule
    err = 0.0
    for name, (a, b, small) in sets.items():
        ab = torch.from_numpy(np.stack([a, b]).astype(np.int64)).to(dev)
        got = devsplit.autotype_costs(*tabs, ab[0], ab[1], ncap, small)
        want = devsplit.autotype_costs_plain(*tabs, ab[0], ab[1], ncap,
                                             small)
        checks[f"autotype_cost_{name}"] = torch.equal(got, want)
        err = max(err, float((got - want).abs().max()))

    a, b, small = rounds[0]
    ab = torch.from_numpy(np.stack([a, b]).astype(np.int64)).to(dev)
    call = lambda: devsplit.autotype_costs(*tabs, ab[0], ab[1], ncap, small)
    ms = graph_time_ms(call, reps=50)
    plain_ms = cuda_time_ms(lambda: devsplit.autotype_costs_plain(
        *tabs, ab[0], ab[1], ncap, small), reps=2)
    a2, b2, small2 = rounds[big]
    ab2 = torch.from_numpy(np.stack([a2, b2]).astype(np.int64)).to(dev)
    abr = torch.from_numpy(np.stack([pa, pb]).astype(np.int64)).to(dev)
    report["ms_by_rows"] = {
        str(len(a)): ms,
        str(len(a2)): graph_time_ms(lambda: devsplit.autotype_costs(
            *tabs, ab2[0], ab2[1], ncap, small2), reps=10),
        str(len(pa)): graph_time_ms(lambda: devsplit.autotype_costs(
            *tabs, abr[0], abr[1], ncap, False), reps=10)}
    ms_eager = cuda_time_ms(call, reps=50)
    bound, by = _autotype_bound(devsplit, tabs, a, b, ncap)

    report["rows"] = len(a)
    report["rounds_checked"] = [k for k in sets if k.startswith("round_")]
    entry = {"name": "autotype_cost", "route": "cuda",
             "source": "zopfli_tpu_torch/csrc/hist_cost.cu",
             "replaces": sk.REPLACES["autotype_cost"], "max_abs_err": err,
             "ms": ms, "ms_eager": ms_eager, "plain_ms": plain_ms,
             "bound_ms": bound, "bound_by": by, "library_ms": None,
             "rows": len(a)}
    return entry, checks, report


def _pad_stream(lit, dist, floor: int = 1024):
    """(litlens, dists, ncap, nsym) of a host stream, as the device split
    pads it (block_split_lz77_device_dispatch)."""
    import numpy as np

    n = len(lit)
    ncap = floor
    while ncap < n + 1:
        ncap *= 2
    ll = np.zeros(ncap, np.int32)
    dd = np.zeros(ncap, np.int32)
    ll[:n] = lit
    dd[:n] = dist
    return ll, dd, ncap, n


def _synthetic_streams(rng) -> dict:
    """Host (litlens, dists) streams for the split search: fewer than 10
    symbols, at most 1000 (the fixed-cost gate on), segments short enough
    for linear rounds only, and a long stream of random matches and
    literals (probe rounds)."""
    import numpy as np

    def stream(n, p_match, max_len=258):
        is_m = rng.random(n) < p_match
        lit = np.where(is_m, rng.integers(3, max_len + 1, n),
                       rng.integers(0, 256, n))
        dist = np.where(is_m, rng.integers(1, 32769, n), 0)
        return lit.astype(np.uint16), dist.astype(np.uint16)

    blocks_ = [stream(300, 0.05), stream(400, 0.6, 20), stream(300, 0.2)]
    short = tuple(np.concatenate(p) for p in zip(*blocks_))
    return {"under_10": stream(7, 0.3), "under_1000": stream(900, 0.3),
            "linear_only": short,
            "long_random": stream(200_000, 0.35)}


def _split_search_checks(streams: dict, mb: int, dev) -> tuple[dict, dict]:
    """The split_search kernel (a whole search in one launch) on each
    stream, held bit-equal to its plain version:
      - step by step: the kernel at steps = k (k = 1 up to one past the
        step that finishes the search) against one plain step
        (split_step_plain) applied to the kernel's state after k - 1
        steps and that run's last round's costs: the state (overflow flag
        included) and the round's ranges and gates; the round's costs
        against the autotype_cost kernel's host-count entry on the same
        ranges (held against the plain cost stack in _autotype_checks);
      - the whole search, 5 times, against the plain search
        (split_search_plain) on CPU copies of the stream: the final state
        bit-equal every time (an ordering race would show as a run that
        differs);
      - a cap of half the steps a search needs sets S_OVERFLOW, equal to
        the plain search capped alike, and the pull raises;
      - split_lz77_resident queued under set_sync_debug_mode("error");
      - one search under torch.profiler is one kernel (and the state's
        upload, the sync words' memset and the pull).
    Times on the first stream (the seed parse): the kernel's device time
    (torch.profiler), the wrapper's (CUDA events), the wall of a search
    with its pull, the plain search on the host; the bound sums each
    round's autotype_cost bound and each step's bytes.  Returns the
    checks and {"report", "entry", "rounds"}: the first stream's rounds
    as (starts, ends, small) host arrays."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from zopfli_tpu_torch.ops import devsplit
    from zopfli_tpu_torch.ops import scan_kernel as sk

    d = devsplit
    checks, report, seed_rounds = {}, {}, []
    first = next(iter(streams))
    for name, (lit_t, dist_t, ncap, nsym) in streams.items():
        nsym_t = torch.full((), nsym, dtype=torch.int64, device=dev)
        tabs = _split_tabs(devsplit, lit_t, dist_t, ncap, nsym_t)
        cpu_tabs = tuple(t.cpu() for t in tabs)
        t0 = time.time()
        plain = d.split_search_plain(cpu_tabs, nsym, ncap, mb)[0]
        plain_s = time.time() - t0
        rounds = int(plain[d.S_ROUNDS])
        # Step by step.
        same, sizes, step_bytes, bounds = True, [], [], []
        prev = d.split_state(mb, ncap, "cpu")
        prev_costs = torch.zeros(d.MAX_RANGES, dtype=torch.int64)
        for k in range(1, rounds + 3):
            got = [x.cpu() for x in d.split_search(
                tabs, nsym_t, ncap, mb, steps=k, return_round=True)]
            want = prev.clone()
            want[d.S_OVERFLOW] = 0   # the cap of the run at k - 1
            before = want.clone()
            ps, pe = (torch.zeros(d.MAX_RANGES, dtype=torch.int64)
                      for _ in range(2))
            pr = torch.zeros(d.MAX_RANGES, dtype=torch.bool)
            d.split_step_plain(want, nsym, prev_costs, ps, pe, pr, mb, ncap,
                               True)
            step_bytes.append(_split_step_bytes(devsplit, before, want))
            c = int(want[d.S_COUNT])
            same &= (torch.equal(got[0], want)
                     and torch.equal(got[2][:c], ps[:c])
                     and torch.equal(got[3][:c], pe[:c])
                     and torch.equal(got[4][:c], pr[:c]))
            if c:
                sizes.append(c)
                a, b = ps[:c].numpy(), pe[:c].numpy()
                ab = torch.from_numpy(np.stack([a, b])).to(dev)
                host_entry = d.autotype_costs(*tabs, ab[0], ab[1], ncap,
                                              nsym <= 1000).cpu()
                same &= torch.equal(got[1][:c], host_entry)
                if name == first:
                    seed_rounds.append((a, b, nsym <= 1000))
                    bounds.append(_autotype_bound(devsplit, tabs, a, b,
                                                  ncap))
            prev, prev_costs = got[0], got[1]
        checks[f"split_search_steps_{name}"] = bool(
            same and bool(prev[d.S_FINISHED]) and len(sizes) == rounds)
        # The whole search, 5 times, against the plain search.
        runs = [d.split_search(tabs, nsym_t, ncap, mb).cpu()
                for _ in range(5)]
        checks[f"split_search_vs_plain_{name}"] = (
            all(torch.equal(r, plain) for r in runs)
            and int(plain[d.S_OVERFLOW]) == 0
            and int(plain[d.S_FINISHED]) == 1)
        # No sync inside the mega path's call.
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _sp, _npts, fin = d.split_lz77_resident(
                lit_t, dist_t, ncap, mb, nsym_t, return_state=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        checks[f"split_resident_no_sync_{name}"] = torch.equal(fin.cpu(),
                                                               plain)
        npts = int(plain[d.S_NPTS])
        report[name] = {
            "symbols": nsym, "ncap": ncap, "rounds": rounds,
            "split_points": plain[d.S_HEAD:d.S_HEAD + npts].tolist(),
            "round_sizes": sizes, "steps_checked": len(step_bytes),
            "plain_search_host_s": plain_s}
        if name != first:
            continue
        # The overflow cap.
        cap = max(1, (rounds + 1) // 2)
        capped = d.split_search(tabs, nsym_t, ncap, mb, steps=cap).cpu()
        pcap = d.split_search_plain(cpu_tabs, nsym, ncap, mb, cap)[0]
        try:
            d.pull_split(capped, mb)
            raised = False
        except RuntimeError:
            raised = True
        checks["split_search_overflow_cap"] = (
            torch.equal(capped, pcap) and int(capped[d.S_OVERFLOW]) == 1
            and raised)
        # Times.
        search = lambda: d.split_search(tabs, nsym_t, ncap, mb)
        events_ms = cuda_time_ms(search, reps=10)
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.time()
            d.pull_split(search(), mb)
            walls.append((time.time() - t0) * 1e3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                d.pull_split(search(), mb)
            torch.cuda.synchronize()
        # A span (zt.split_wait) also shows as its projection on the
        # device timeline, which is no device work.
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("zt.")]
        kern_us = [e.time_range.elapsed_us() for e in events
                   if "split_search" in e.name]
        names = [e.name for e in events]
        copies = [n for n in names if "emcpy" in n]
        fills = [n for n in names if "emset" in n]
        kernels = [n for n in names if n not in copies + fills]
        checks["search_one_kernel"] = (
            len(kernels) == 3 and len(kern_us) == 3 and len(copies) == 6)
        bound_ops = sum(b for b, by in bounds if by == "operations")
        bound = (sum(b for b, _ in bounds)
                 + bytes_bound(sum(step_bytes), 0)[0])
        report[name].update({
            "search_device_ms": [u / 1e3 for u in kern_us],
            "search_events_ms": events_ms, "search_wall_ms": walls,
            "device_work_per_search": names[:len(names) // 3],
            "grid_clusters": d.search_clusters(dev),
            "bound_ms": bound, "step_bytes": sum(step_bytes)})
        entry = {"name": "split_search", "route": "cuda",
                 "source": "zopfli_tpu_torch/csrc/split_search.cu",
                 "replaces": sk.REPLACES["split_search"],
                 "max_abs_err": 0.0,
                 "ms": sum(kern_us) / max(len(kern_us), 1) / 1e3,
                 "ms_events": events_ms, "wall_ms": min(walls),
                 "plain_ms": plain_s * 1e3,
                 "plain_where": "host CPU, split_search_plain",
                 "bound_ms": bound,
                 "bound_by": ("operations" if bound_ops > bound / 2
                              else "bytes"),
                 "library_ms": None, "rounds": rounds,
                 "grid_clusters": report[name]["grid_clusters"]}
    if not all(checks.values()):
        entry["max_abs_err"] = None
    return checks, {"report": report, "entry": entry, "rounds": seed_rounds}


def phase_split(data, dev="cuda") -> None:
    """The split search alone (--only split): the seed parse of phase 3's
    input, a squeeze's parse of it after two iterations and the
    synthetic streams, through _split_search_checks."""
    import numpy as np
    import torch

    from zopfli_tpu_torch import native
    from zopfli_tpu_torch.deflate import (Options, scaled_maxblocks,
                                          split_master)
    from zopfli_tpu_torch.ops import fused_engine, hashmatch, seed
    from zopfli_tpu_torch.squeeze_batched import greedy_seed_stats

    n = len(data)
    mb = scaled_maxblocks(Options(), n)
    bounds = split_master(Options(numiterations=ITERATIONS, engine="native"),
                          data, 0, n, native.greedy)
    fs = fused_engine.FusedSqueeze(data, [(0, n, bounds)], device=dev)
    seed_ll, seed_d = greedy_seed_stats(data, fs.block_bounds, native.greedy)
    parses = fs.run(seed_ll, seed_d, 2)[0]
    second = tuple(np.concatenate([p[i] for p in parses]) for i in (0, 1))
    buf, cap, min_pos, inend_real = seed.master_buffer(data, 0, n)
    core = seed.make_seed_core(
        cap, mb, tuple(sorted(hashmatch.current_knobs().items())))
    parsed = core.parse(torch.from_numpy(buf).to(dev), min_pos, inend_real)
    streams = {"seed_parse": (parsed[0], parsed[1], core.DCAP,
                              int(parsed[3]))}
    streams.update(_split_streams(second, dev))
    checks, search = _split_search_checks(streams, mb, dev)
    ok = all(checks.values())
    emit({"phase": "split", "ok": ok, "checks": checks,
          "entry": search["entry"], **search["report"]})
    if not ok:
        raise RuntimeError(f"split search check failed: {checks}")


def _split_step_bytes(devsplit, before, after) -> int:
    """Least bytes one split step moves, from the plain step's input and
    output state: nsym, the head fields whose old values the step needs,
    sp[:npts] and done[:ndone] where it picks the next segment, the
    costs of the round it consumes, the state entries it changes (each
    written once) and the next round's ranges (int64 start and end, a
    bool gate).  A step after the search finished reads its flag alone.
    Where the trace cannot tell whether a field was read (S_POS after a
    probe round that did not improve), it is not counted."""
    d = devsplit
    b, a = before.tolist(), after.tolist()
    if b[d.S_FINISHED]:
        return 8
    mode = b[d.S_MODE]
    decided = a[d.S_IT] > b[d.S_IT]      # FindMinimum ended this step
    reads = {d.S_FINISHED, d.S_MODE}
    ncost = 0
    if mode == d.M_LINEAR:
        reads |= {d.S_NLIN, d.S_LSTART, d.S_LEND}
        ncost = 2 * b[d.S_NLIN] + 1
    elif mode == d.M_PROBE:
        reads |= {d.S_START, d.S_END, d.S_NLIN, d.S_LASTBEST, d.S_LSTART,
                  d.S_LEND}
        ncost = 2 * d.NUM + (b[d.S_NLIN] == 0)
        if decided and b[d.S_NLIN]:
            reads.add(d.S_ORIG)
    listed = 0
    if decided:
        reads.add(d.S_IT)
        reads |= ({d.S_NPTS, d.S_NUMBLOCKS} if a[d.S_NPTS] > b[d.S_NPTS]
                  else {d.S_NDONE})
    if decided or mode == d.M_SELECT:   # the next segment is picked
        reads |= {d.S_IT, d.S_NPTS, d.S_NDONE}
        if not a[d.S_FINISHED]:
            reads.add(d.S_NUMBLOCKS)
        listed = b[d.S_NPTS] + b[d.S_NDONE]
    if a[d.S_COUNT]:
        reads.add(d.S_ROUNDS)
    changed = sum(x != y for x, y in zip(b, a))
    return (8 + 8 * (len(reads) + listed + ncost + changed)
            + 17 * a[d.S_COUNT])


def _split_tabs(devsplit, lit_t, dist_t, ncap, nsym_t):
    """(ll_ck, d_ck, ll_sym, d_sym, bcum) of a padded stream."""
    ll_sym, d_sym, nb = devsplit.stream_symbols(lit_t, dist_t, ncap, nsym_t)
    ll_ck, d_ck, bcum = devsplit.checkpoints(ll_sym, d_sym, nb, ncap, nsym_t)
    return ll_ck, d_ck, ll_sym, d_sym, bcum


def _autotype_bound(devsplit, tabs, a, b, ncap) -> tuple[float, str]:
    """Least time of one probe round [a[i], b[i]).  Bytes: each distinct
    checkpoint row (288 + 32 int64) and each distinct stream symbol
    (ll_sym and d_sym) read once -- the ranges of a round share their
    ends -- plus a range's two ends, two byte offsets and its int64 out.
    Operations, per range: the histogram (320 differences and one add per
    stream symbol), the fixed cost (2 per symbol) and the dynamic cost."""
    import numpy as np

    ck = devsplit.CKPT
    live = b > a
    a, b = a[live], b[live]
    ends = np.concatenate([a, b])
    rows = np.unique(ends // ck)
    # The symbols [j*ck, e) of every end e in checkpoint j, as a union.
    last = {}
    for e in ends:
        j = int(e) // ck
        last[j] = max(last.get(j, 0), int(e) - j * ck)
    nbytes_ = (len(rows) * 320 * 8 + sum(last.values()) * 16
               + len(a) * 40)
    part = (a - (a // ck) * ck) + (b - (b // ck) * ck)
    ll_h, d_h = _range_hists(devsplit, tabs, a, b, ncap)
    ops = int((320 * 3 + part).sum()) + _k3_ops(ll_h, d_h)
    return bytes_bound(float(nbytes_), 0, ops)


def _phase_breakdowns(sets, sk, checks) -> dict:
    """Where a K3 row's cycles go in the kernel the port runs
    (experiments/exp_hist_cost_phases.py: a debug build that stamps
    clock64() around each phase; `--variants first` there measures the
    first design)."""
    sys.path.insert(0, os.path.join(HERE, "experiments"))
    import exp_hist_cost_phases as ehp

    res = ehp.breakdowns(sets, sk, variants=("new",))
    out = {}
    for variant, per in res.items():
        for batch, r in per.items():
            checks[f"phases_{variant}_{batch}_equal"] = r["equal_to_plain"]
            out[f"{variant}/{batch}"] = {
                k: r[k] for k in ("rows", "ms", "row_cycles_mean",
                                  "row_cycles_max", "categories_cycles")}
            if batch == "probe_19":
                out[f"{variant}/{batch}"]["phases"] = r["phases"]
    return out


# Card checks beside the production shapes: (groups, tile, lanes, kbp,
# unsorted breakpoints, costs on the 1/128-bit grid).  The scan works in
# 32-row chunks of 8 lanes and the traceback in blocks of 4 lanes (2 past
# a tile of ~14k rows), so tiles and lane counts that divide neither are
# here.
CASES = {
    "groups2": (2, 2048, 64, 12, False, False),
    "grid_ties": (1, 2048, 64, 12, False, True),
    "unsorted": (1, 2048, 64, 12, True, False),
    "kbp1": (1, 1024, 32, 1, True, True),
    "kbp16": (1, 1024, 32, 16, True, True),
    "lanes60_tile1000": (2, 1000, 60, 12, True, True),
    "lanes13_tile333": (1, 333, 13, 5, False, True),
}
TRACEBACK_ONLY_TILE = 15000   # two lanes per traceback block


def _case_inputs(rng, G, T, L, K, unsorted, grid):
    import numpy as np

    def costs(shape, lo, hi):
        if grid:
            return (rng.integers(lo * 4, hi * 4, shape) * 32 / 128).astype(
                np.float32)
        return rng.uniform(lo, hi, shape).astype(np.float32)

    if unsorted:
        bl = rng.integers(0, 300, (G * T, K, L))
        bl = np.where(rng.random(bl.shape) < 0.3, 0, bl)
        bl = np.where(rng.random(bl.shape) < 0.2, bl[:, :1], bl)
    else:
        bl = np.sort(rng.integers(0, 200, (G * T, K, L)), axis=1)
        bl = np.where(bl < 3, 0, bl)
    return [bl.astype(np.int32),
            rng.integers(1, 32769, (G * T, K, L)).astype(np.int32),
            costs((G * T, K, L), 1, 15), costs((G * T, L), 1, 12),
            costs((G * 256, L), 1, 10)]


def _traceback_cases(sk, ce, lit, tile, rng, G):
    """Both traceback versions on ce, then on ce with its paths cut: rows
    of length 0 and 2 on the path, tile_nbytes of 0, of tile and past it."""
    import numpy as np
    import torch

    L = ce.shape[1]
    symtab = sk.symbol_range_table()
    nbytes = rng.integers(0, tile + 1, (G, L)).astype(np.int32)
    nbytes[:, 0], nbytes[:, 1] = tile, 0
    if L > 2:
        nbytes[:, 2] = tile + 5
    nbytes = torch.from_numpy(nbytes).to(ce.device)
    ok = True
    for cut in (False, True):
        if cut:
            pe_h = pe.cpu().numpy()
            ce_h = ce.cpu().numpy()
            for g in range(G):
                for lane in range(3, L):
                    on = np.nonzero(pe_h[g * tile:(g + 1) * tile, lane])[0]
                    if len(on):
                        ce_h[g * tile + on[len(on) // 2], lane] = (
                            0 if lane % 2 else sk.pack_edge(2, 9))
            ce = torch.from_numpy(ce_h).to(ce.device)
        hist, pe = sk.traceback(ce, lit, nbytes, symtab, groups=G)
        phist, ppe = sk.traceback_plain(ce, lit, nbytes, symtab, groups=G)
        ok = ok and torch.equal(hist, phist) and torch.equal(pe, ppe)
    return ok


def _case_checks(dev) -> dict:
    """Both kernels against their plain versions on seeded random inputs
    at the CASES shapes (the main path at 1 MiB runs one group of 256
    lanes; larger inputs run several groups)."""
    import numpy as np
    import torch

    from zopfli_tpu_torch.ops import scan_kernel as sk

    checks = {}
    rng = np.random.default_rng(7)
    for name, (G, T, L, K, unsorted, grid) in CASES.items():
        ins = [torch.from_numpy(a).to(dev)
               for a in _case_inputs(rng, G, T, L, K, unsorted, grid)]
        lit = torch.from_numpy(rng.integers(0, 256, (G * T, L)).astype(
            np.int32)).to(dev)
        ce, cost = sk.scan(*ins, groups=G)
        pce, pcost = sk.scan_plain(*ins, groups=G)
        checks[f"{name}_scan"] = torch.equal(ce, pce) and torch.equal(
            cost.view(torch.int32), pcost.view(torch.int32))
        checks[f"{name}_traceback"] = _traceback_cases(sk, ce, lit, T, rng,
                                                       G)
    # A large tile for the traceback alone: random edges that fit.
    T, L = TRACEBACK_ONLY_TILE, 6
    pos = np.arange(1, T + 1)[:, None]
    ln = rng.integers(3, 259, (T, L))
    ce = np.where((rng.random((T, L)) < 0.7) | (ln > pos), 1,
                  ln | (rng.integers(1, 32769, (T, L)) << 9))
    lit = rng.integers(0, 256, (T, L)).astype(np.int32)
    checks[f"tile{T}_traceback"] = _traceback_cases(
        sk, torch.from_numpy(ce.astype(np.int32)).to(dev),
        torch.from_numpy(lit).to(dev), T, rng, 1)
    return checks


def _reset_counters():
    from zopfli_tpu_torch import squeeze_batched
    from zopfli_tpu_torch.ops import devsplit, engine, fused_engine, seed
    from zopfli_tpu_torch.ops import scan_kernel as sk

    for k in sk.LAUNCHES:
        sk.LAUNCHES[k] = 0
    for k in devsplit.STATS:
        devsplit.STATS[k] = 0
    squeeze_batched.VERIFY_FAILS[0] = 0
    for k in fused_engine.VERIFY:
        fused_engine.VERIFY[k] = 0
    fused_engine.FETCH_RETRIES[0] = 0
    fused_engine.RANDOM["events_max"] = 0
    seed.PROGRAMS[0] = 0
    engine.FALLBACKS[0] = 0


def _counters() -> dict:
    from zopfli_tpu_torch import squeeze_batched
    from zopfli_tpu_torch.ops import devsplit, engine, fused_engine, seed
    from zopfli_tpu_torch.ops import scan_kernel as sk

    return {"launches": dict(sk.LAUNCHES), "split": dict(devsplit.STATS),
            "seed_programs": seed.PROGRAMS[0],
            "verify_fails": squeeze_batched.VERIFY_FAILS[0],
            "verify": dict(fused_engine.VERIFY),
            "engine_fallbacks": engine.FALLBACKS[0],
            "fetch_retries": fused_engine.FETCH_RETRIES[0],
            "random": dict(fused_engine.RANDOM)}


def _compress_run(raw: bytes, label: str, dev) -> tuple[dict, bytes]:
    """One compress with every count set to 0 just before it and read
    just after; host greedy parses are counted."""
    import torch

    import zopfli_tpu_torch as zt

    _reset_counters()
    calls, restore = _counted_greedy()
    try:
        t0 = time.time()
        out = zt.compress(raw, "gzip", zt.Options(numiterations=ITERATIONS,
                                                  device=dev))
        torch.cuda.synchronize()
        secs = time.time() - t0
    finally:
        restore()
    run = {"run": label, "seconds": secs, "bytes": len(out),
           "greedy_calls": calls[0], **_counters(),
           "roundtrip": zlib.decompress(out, 31) == raw}
    return run, out


def _launches_ok(r) -> bool:
    """K1/K2 once per iteration and once for the seed program, K3
    `hist_cost` at least once; the splits: one `split_search` launch a
    search, two on one master (the first split and the second), rounds
    read from their states, one pull a search (and the seed's symbol
    count), no `autotype_cost` launch (no host-controlled round)."""
    ln, sp = r["launches"], r["split"]
    return (ln["scan"] == ln["traceback"] == ITERATIONS + 1
            and ln["hist_cost"] > 0
            and ln["split_search"] == sp["searches"] == 2
            and sp["rounds"] > 0 and sp["syncs"] == 3
            and ln["autotype_cost"] == 0)


def _default_path_ok(r) -> bool:
    """One compress of one master on the default path: one seed program,
    no host greedy parse, every block's parse through the native check
    and none falling back."""
    return (r["verify_fails"] == 0 and r["greedy_calls"] == 0
            and r["verify"]["blocks"] > 0 and r["verify"]["match_bytes"] > 0
            and r["seed_programs"] == 1 and _launches_ok(r))


def _counted_greedy():
    """Count host greedy parses: (calls, restore)."""
    from zopfli_tpu_torch import native

    greedy = native.greedy
    calls = [0]

    def counted(*a, **k):
        calls[0] += 1
        return greedy(*a, **k)

    native.greedy = counted

    def restore():
        native.greedy = greedy
    return calls, restore


def _recorded_searches():
    """Record every split search of a run: (calls, restore); a call is
    (tabs, nsym, ncap, maxblocks, final state)."""
    from zopfli_tpu_torch.ops import devsplit

    search = devsplit.split_search
    calls = []

    def recording(tabs, nsym, ncap, maxblocks, *a, **k):
        out = search(tabs, nsym, ncap, maxblocks, *a, **k)
        calls.append((tabs, nsym, ncap, maxblocks, out))
        return out

    devsplit.split_search = recording

    def restore():
        devsplit.split_search = search
    return calls, restore


def _searches_vs_plain(calls) -> list[bool]:
    """Each recorded search's final state against the plain search
    (split_search_plain) on CPU copies of its stream."""
    import torch

    from zopfli_tpu_torch.ops import devsplit

    return [torch.equal(state.cpu(), devsplit.split_search_plain(
        tuple(t.cpu() for t in tabs), int(nsym), ncap, mb)[0])
        for tabs, nsym, ncap, mb, state in calls]


def phase_main(data, dev="cuda"):
    """compress() on the card at the defaults: round trip, launches,
    greedy calls, fallbacks, size."""
    import torch

    import zopfli_tpu_torch as zt

    raw = data.tobytes()
    runs, outs = [], []
    for label in ("cold", "warm"):
        calls, restore = _recorded_searches()
        try:
            run, out = _compress_run(raw, label, dev)
        finally:
            restore()
        runs.append(run)
        outs.append(out)
    # The warm run's two searches (the seed's split and the second split)
    # against the plain search on CPU copies of their streams.
    searches_vs_plain = _searches_vs_plain(calls)
    t0 = time.time()
    native_out = zt.compress(raw, "gzip", zt.Options(
        engine="native", numiterations=ITERATIONS))
    native_secs = time.time() - t0
    ratio = len(outs[0]) / len(native_out)

    ok = (all(r["roundtrip"] and _default_path_ok(r) for r in runs)
          and outs[1] == outs[0] and ratio <= 1.02
          and len(searches_vs_plain) == 2 and all(searches_vs_plain)
          and zlib.decompress(native_out, 31) == raw)
    emit({"phase": "main", "ok": ok, "input_bytes": len(raw),
          "input_crc32": zlib.crc32(raw),
          "iterations": ITERATIONS, "runs": runs,
          "cold_seconds": runs[0]["seconds"],
          "warm_seconds": runs[1]["seconds"],
          "output_bytes": len(outs[0]), "native_bytes": len(native_out),
          "searches_vs_plain": searches_vs_plain,
          "native_seconds": native_secs, "size_vs_native": ratio,
          "fetch_retries": runs[0]["fetch_retries"],
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    if not ok:
        raise RuntimeError("main path check failed")
    return runs[1]["launches"], outs[0]


# (name, input, ZT_MASTER_SIZE, ZT_REPLICAS): "wide" is 84,000 bytes in
# 15 blocks of one tile each, so 5 replicas a block give 90 lane blocks:
# rows past the 64 the JAX program's stream key holds (some blocks' best
# parse comes from one), at a shape where the two-phase path has the
# same lane count.
MEGA_CASES = (("1mib", MIB, None, None), ("2mib", 2 * MIB, str(2 * MIB), None),
              ("wide", 84_000, None, "5"))


def _wide_bytes(pieces: int = 14, size: int = 6000) -> bytes:
    """Slices of the JAX package's source (which does not change) between
    runs of small alphabets, one piece per block of the seed split."""
    import numpy as np

    rng = np.random.default_rng(64)
    paths = [p for p in corpus_paths() if not p.endswith(".md")]
    blob = b"".join(open(p, "rb").read() for p in paths)
    text = np.frombuffer(blob[:pieces * size], np.uint8)
    out = []
    for i in range(pieces):
        if i % 2 == 0:
            out.append(text[i * size:(i + 1) * size])
        else:
            out.append((16 * (i % 16) + rng.integers(0, 4 + i % 5, size))
                       .astype(np.uint8))
    return np.concatenate(out).tobytes()


def _env(name: str, value):
    """Set (or with None, unset) an environment variable; returns a
    function that restores it."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value

    def restore():
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old
    return restore


def _mega_case(raw: bytes, dev) -> dict:
    """One input through the two-phase path and the megafused one: bytes,
    launches, per-block costs, the sync check, warm walls in turns."""
    import numpy as np
    import torch

    from zopfli_tpu_torch import squeeze_batched
    from zopfli_tpu_torch.deflate import Options, scaled_maxblocks
    from zopfli_tpu_torch.ops import devsplit, fused_engine, mega, seed

    arr = np.frombuffer(raw, np.uint8)
    n = len(arr)
    mb = scaled_maxblocks(Options(), n)
    runs, outs = {}, {}
    for label, flag in (("two_phase_cold", "0"), ("mega_cold", "1"),
                        ("mega", "1"), ("two_phase", "0"),
                        ("mega_2", "1"), ("two_phase_2", "0")):
        restore = _env("ZT_MEGA", flag)
        try:
            runs[label], outs[label] = _compress_run(raw, label, dev)
        finally:
            restore()
    m = runs["mega"]
    cap = 16384
    while cap < n:
        cap *= 2
    steps = devsplit.n_max(mb, cap + devsplit.CKPT)
    ln = m["launches"]
    launches_ok = (ln["scan"] == ln["traceback"] == ITERATIONS + 1
                   and ln["hist_cost"] > 0
                   and ln["split_search"] == m["split"]["searches"] == 2
                   and ln["autotype_cost"] == 2
                   and m["split"]["rounds"] > 0
                   and m["split"]["syncs"] == 0
                   and m["seed_programs"] == 1)

    # Per-block best costs against the two-phase FusedSqueeze's on the
    # same seed (tests_tpu/test_on_tpu.py's check).
    sr = seed.seed_master(arr, 0, n, mb, device=dev)
    fs = fused_engine.FusedSqueeze(arr, [(0, n, sr.bounds)], device=dev,
                                   cand=[(sr.bp_len, sr.bp_dist)])
    _, cost_two, _, _ = fs.collect(fs.dispatch(sr.seed_ll, sr.seed_d,
                                               ITERATIONS))
    # The dispatch must not read the device.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.time()
        handle = mega.mega_dispatch(arr, 0, n, mb, ITERATIONS, device=dev)
        enqueue = time.time() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    t0 = time.time()
    mr = mega.mega_finish(handle)
    pull = time.time() - t0
    _, cost_mega, _, _ = mr.collect()
    G, nb_pad = mega.lane_geometry(cap, mb, int(os.environ.get(
        "ZT_REPLICAS", "2")))
    # Lane blocks past 64 that carry tiles, and blocks whose best parse
    # came from one of them.
    used = mr.tile_block[mr.tile_nbytes > 0]
    best = list(range(mr.nb))
    for rb in range(mr.nb, mr.nb_total):
        b = int(mr.replica_of[rb])
        if mr._cost[rb] < mr._cost[best[b]]:
            best[b] = rb
    checks = {
        "bytes_equal": (outs["mega"] == outs["two_phase"]
                        == outs["mega_cold"] == outs["mega_2"]),
        "roundtrip": all(r["roundtrip"] for r in runs.values()),
        "no_verify_fallback": all(r["verify_fails"] == 0
                                  for r in runs.values()),
        "launches": launches_ok,
        "bounds_equal": mr.bounds == sr.bounds,
        "block_costs_equal": bool(np.array_equal(cost_two, cost_mega)),
        "dispatch_no_sync": True,
        "fs_same_geometry": fs.ngroups == G,
    }
    return {
        "input_bytes": n, "maxblocks": mb, "groups": G, "nb_pad": nb_pad,
        "nb": mr.nb, "nb_total": mr.nb_total, "n_max": steps,
        "rows_used_max": int(used.max()),
        "blocks_best_past_64": sum(rb >= 64 for rb in best),
        "search_rounds": mr.search_rounds, "output_bytes": len(outs["mega"]),
        "split2": mr.split2, "checks": checks,
        "warm_seconds": {"mega": [runs["mega"]["seconds"],
                                  runs["mega_2"]["seconds"]],
                         "two_phase": [runs["two_phase"]["seconds"],
                                       runs["two_phase_2"]["seconds"]]},
        "cold_seconds": {"mega": runs["mega_cold"]["seconds"],
                         "two_phase": runs["two_phase_cold"]["seconds"]},
        "dispatch_enqueue_s": enqueue, "result_pull_s": pull,
        "mega_run": m, "two_phase_run": runs["two_phase"],
        "verify_fails_total": squeeze_batched.VERIFY_FAILS[0]}


def phase_mega(data, dev="cuda") -> dict:
    """ZT_MEGA=1 (MEGA_MIN: 512 KiB) at the production geometry: 1 MiB of
    repo text (one master: G=1, nb_pad 64), 2 MiB at
    ZT_MASTER_SIZE=2097152 (MB 32, G=2, nb_pad 128), and 84,000 bytes at
    ZT_REPLICAS=5 (MEGA_MIN lowered for it; G=1, nb_pad 128, 90 lane
    blocks: rows past 64 carry tiles).  Bytes equal to the two-phase
    path's in the same call, zlib round trip, no verify fallback,
    per-block costs equal to FusedSqueeze's, no sync inside
    mega_dispatch, launches as predicted (K1/K2 15 + 1; split_search 2;
    autotype_cost 2; no host read of a split).
    Returns the 1 MiB mega run's launches."""
    from zopfli_tpu_torch.ops import mega

    cases = {}
    for name, nbytes, msize, replicas in MEGA_CASES:
        raw = (data.tobytes() if nbytes == MIB else _wide_bytes()
               if name == "wide" else corpus_bytes(nbytes))
        restores = [_env("ZT_MASTER_SIZE", msize),
                    _env("ZT_REPLICAS", replicas)]
        mega_min = mega.MEGA_MIN
        if name == "wide":
            mega.MEGA_MIN = 1000
        try:
            cases[name] = c = _mega_case(raw, dev)
        finally:
            mega.MEGA_MIN = mega_min
            for restore in restores:
                restore()
        if name == "wide":
            c["checks"]["rows_past_64"] = (c["nb_total"] > 64
                                           and c["rows_used_max"] >= 64
                                           and c["blocks_best_past_64"] > 0)
    ok = all(all(c["checks"].values()) for c in cases.values())
    emit({"phase": "mega", "ok": ok, "iterations": ITERATIONS, **cases})
    if not ok:
        raise RuntimeError("mega check failed: " + json.dumps(
            {k: c["checks"] for k, c in cases.items()}))
    return cases["1mib"]["mega_run"]["launches"]


def phase_many(dev="cuda") -> None:
    """compress_many on the corpus files as separate inputs, then on two
    identical adjacent inputs: every output must round-trip alone."""
    import torch

    import zopfli_tpu_torch as zt

    blobs = [open(p, "rb").read() for p in corpus_paths()]
    base = max(blobs, key=len)
    results = {}
    for label, batch in (("corpus_files", blobs), ("identical_pair",
                                                   [base, base])):
        _reset_counters()
        t0 = time.time()
        outs = zt.compress_many(batch, "gzip", zt.Options(
            numiterations=ITERATIONS, device=dev))
        torch.cuda.synchronize()
        secs = time.time() - t0
        results[label] = {
            "inputs": len(batch), "input_bytes": sum(map(len, batch)),
            "output_bytes": sum(map(len, outs)), "seconds": secs,
            **_counters(),
            "roundtrip": all(zlib.decompress(o, 31) == b
                             for b, o in zip(batch, outs))}
    ok = all(r["roundtrip"] and r["verify_fails"] == 0
             and r["launches"]["scan"] > 0 and r["launches"]["traceback"] > 0
             and r["launches"]["hist_cost"] > 0
             and r["launches"]["split_search"] > 0
             for r in results.values())
    emit({"phase": "many", "ok": ok, **results})
    if not ok:
        raise RuntimeError("compress_many check failed")


FUSED_MODULE = "zopfli_tpu_torch.ops.fused_engine"


def _capture_fused_k1k2():
    """Keep the inputs of the fused loop's first K1 launch at the most
    lane groups seen, and K2's lit, tile_nbytes and symtab from the
    launch after it: (kept, restore).  Every launch runs and counts as
    before; the seed program's are not kept."""
    from zopfli_tpu_torch.ops import scan_kernel as sk

    scan, tb = sk.scan, sk.traceback
    kept = {"groups": 0}

    def scan_kept(*args, groups=1):
        if (groups > kept["groups"] and sys._getframe(1).f_globals.get(
                "__name__") == FUSED_MODULE):
            kept.update(groups=groups, scan=args, pending=True)
        return scan(*args, groups=groups)

    def traceback_kept(ce, *args, groups=1):
        if kept.pop("pending", False):
            kept["traceback"] = args
        return tb(ce, *args, groups=groups)

    sk.scan, sk.traceback = scan_kept, traceback_kept

    def restore():
        sk.scan, sk.traceback = scan, tb
    return kept, restore


def phase_png(inputs, dev="cuda") -> tuple[dict, dict]:
    """optimize_many on the PNG batch at the defaults (auto filter
    strategy, 15 iterations, 5 for IDATs of >= 200,000 B), twice on the
    device engine and once on the native one: pixels, counts and the
    batch's bytes against the native engine's; the seconds inside each
    compress_many call (the rest is the PNG layer's host work), and the
    native engine's per job, since it compresses the jobs one after
    another.  K1 and K2 are then held against their plain versions on
    the fused loop's inputs at the most lane groups of the first run.
    Returns (the warm run's launches, that check)."""
    import torch

    from zopfli_tpu_torch.png import PNGOptions, codec
    from zopfli_tpu_torch.png.optimize import PROBE, optimize_many

    import zopfli_tpu_torch as zt

    pngs = [p for _, p in inputs]
    want = [codec.decode(p)[0] for p in pngs]
    compress_many, compress = zt.compress_many, zt.compress
    calls, jobs = {}, []

    def timed_many(blobs, fmt, options):
        # optimize_many imports compress_many from the package at call time.
        t0 = time.time()
        try:
            return compress_many(blobs, fmt, options)
        finally:
            calls[str(options.numiterations)] = {
                "jobs": len(blobs), "bytes": sum(map(len, blobs)),
                "seconds": time.time() - t0}

    def timed_job(blob, *a, **k):
        # The native engine's compress_many calls compress once a job.
        t0 = time.time()
        try:
            return compress(blob, *a, **k)
        finally:
            jobs.append((len(blob), time.time() - t0))

    runs, outs, batch = {}, {}, None
    for label, opts in (("device_cold", PNGOptions(device=dev)),
                        ("device_warm", PNGOptions(device=dev)),
                        ("native", PNGOptions(engine="native"))):
        if label == "device_warm":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        _reset_counters()
        for k in ("trials", "line_jobs", "reused"):
            PROBE[k] = 0
        greedy_calls, restore = _counted_greedy()
        kept, restore_k12 = _capture_fused_k1k2()
        calls.clear()
        jobs.clear()
        zt.compress_many = timed_many
        if label == "native":
            zt.compress = timed_job
        try:
            t0 = time.time()
            out = optimize_many(pngs, opts)
            torch.cuda.synchronize()
            secs = time.time() - t0
        finally:
            restore()
            restore_k12()
            zt.compress_many, zt.compress = compress_many, compress
        outs[label] = out
        runs[label] = {"seconds": secs, "compress_many": dict(calls),
                       "bytes": sum(map(len, out)),
                       "greedy_calls": greedy_calls[0], **_counters(),
                       "probe": dict(PROBE),
                       "pixels_equal": all(
                           (codec.decode(o)[0] == w).all()
                           for o, w in zip(out, want))}
        if label == "device_warm":
            runs[label]["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        if label == "native":
            top = sorted(jobs, key=lambda j: -j[1])[:6]
            runs[label]["job_seconds_top"] = [
                {"bytes": n, "seconds": t} for n, t in top]
        if label == "device_cold" and kept["groups"]:
            G = kept["groups"]
            scan_in = kept["scan"]
            rows, kbp, nt = scan_in[0].shape
            k12, _ = _hold_k1k2(scan_in, *kept["traceback"], G, plain_reps=1)
            batch = {"groups": G, "tile": rows // G, "lanes": nt, "kbp": kbp,
                     **k12}
        del kept
    dev_runs = [runs["device_cold"], runs["device_warm"]]
    ratio = runs["device_cold"]["bytes"] / runs["native"]["bytes"]
    ok = (all(r["pixels_equal"] for r in runs.values())
          and all(r["probe"]["trials"] == 8 * len(pngs)
                  and r["probe"]["reused"] == len(pngs)
                  and r["probe"]["workers"] >= 1 for r in runs.values())
          and all(r["launches"]["scan"] == r["launches"]["traceback"] > 0
                  and r["launches"]["hist_cost"] > 0
                  and r["launches"]["split_search"]
                  == r["split"]["searches"] > 0
                  and r["split"]["rounds"] > 0
                  and r["launches"]["autotype_cost"] == 0
                  and r["verify_fails"] == 0 and r["greedy_calls"] == 0
                  for r in dev_runs)
          and outs["device_warm"] == outs["device_cold"]
          and batch is not None and all(batch["bit_equal"].values())
          and ratio <= 1.02)
    emit({"phase": "png", "ok": ok, "images": len(pngs),
          "input_png_bytes": sum(map(len, pngs)),
          "rgba_bytes": sum(w.size for w in want), "runs": runs,
          "size_vs_native": ratio, "fused_k1k2_at_most_groups": batch})
    if not ok:
        raise RuntimeError("PNG batch check failed")
    return runs["device_warm"]["launches"], batch


def phase_i500(dev="cuda") -> None:
    """One call of the benchmark's zopflipng-i500-all-filters cell, twice
    (see the module docstring)."""
    import torch

    from portbench import gen
    from portbench.manifest import Manifest
    from zopfli_tpu_torch.ops import fused_engine
    from zopfli_tpu_torch.png.optimize import PNGOptions, optimize_many

    man = Manifest()
    cell = man.cell("zopflipng-i500-all-filters.android-launcher")
    config = man.config(cell["config"])
    fmt = man.module("reference/formats", config["format"])
    items = gen.make_pool(man.traffic(cell["traffic"]), 3190023999,
                          man).calls[0]
    opts = PNGOptions(**config["options"], device=dev)
    runs, outs = [], []
    for _ in range(2):
        _reset_counters()
        built = fused_engine.RANDOM["maps_built"]
        t0 = time.time()
        out = optimize_many([i.raw for i in items], opts)
        torch.cuda.synchronize()
        secs = time.time() - t0
        outs.append(out)
        runs.append({"seconds": secs, **_counters(),
                     "maps_built": fused_engine.RANDOM["maps_built"] - built,
                     "judged": [fmt.judge(o, i) for o, i in zip(out, items)],
                     "smaller": [len(o) < fmt.zlib9_size(i)
                                 for o, i in zip(out, items)],
                     "bytes": sum(map(len, out)),
                     "digest": hashlib.sha256(b"".join(out)).hexdigest()})
    checks = {
        "judged": all(r["judged"] == [None] * len(items) for r in runs),
        "smaller": all(all(r["smaller"]) for r in runs),
        "no_verify_fails": all(r["verify_fails"] == 0 for r in runs),
        "past_48_events": all(r["random"]["events_max"] > 48 for r in runs),
        "warm_built_no_maps": runs[1]["maps_built"] == 0,
        "bytes_equal": outs[0] == outs[1]}
    ok = all(checks.values())
    emit({"phase": "i500", "ok": ok, "checks": checks, "card": card_line(),
          "images": len(items), "pixel_bytes": sum(i.nbytes for i in items),
          "runs": runs})
    if not ok:
        raise RuntimeError("i500 check failed")


def phase_cli(raw: bytes, want_gz: bytes, inputs) -> None:
    """Both command-line tools on the card: `zopfli --i15` in process and
    as `python3 -m zopfli_tpu_torch.cli -c` in a fresh process (bytes
    equal to compress()), then the PNG tool in process on six images."""
    import contextlib
    import io
    import tempfile

    import torch

    from zopfli_tpu_torch import cli
    from zopfli_tpu_torch.png import cli as pcli
    from zopfli_tpu_torch.png import codec

    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "input.bin")
        with open(path, "wb") as f:
            f.write(raw)
        _reset_counters()
        calls, restore = _counted_greedy()
        try:
            t0 = time.time()
            rc = cli.main([f"--i{ITERATIONS}", path])
            torch.cuda.synchronize()
            secs = time.time() - t0
        finally:
            restore()
        with open(path + ".gz", "rb") as f:
            gz = f.read()
        run = {"greedy_calls": calls[0], **_counters()}
        report["zopfli_in_process"] = {
            "rc": rc, "seconds": secs, "bytes": len(gz),
            "equal_to_compress": gz == want_gz, **run,
            "path_ok": _default_path_ok(run)}

        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "zopfli_tpu_torch.cli", "-c",
             f"--i{ITERATIONS}", path], cwd=HERE, capture_output=True,
            env=dict(os.environ, PYTHONPATH=HERE), timeout=600)
        report["zopfli_subprocess"] = {
            "rc": proc.returncode, "seconds": time.time() - t0,
            "bytes": len(proc.stdout),
            "equal_to_compress": proc.stdout == want_gz,
            "stderr_tail": proc.stderr.decode(errors="replace")[-2000:]}

        picked = {"photo_1", "alpha_1", "palette8_1", "gray16_1", "bit1_2",
                  "textish_2"}
        files = {}
        for name, png in inputs:
            if name in picked:
                files[os.path.join(tmp, name + ".png")] = png
                with open(os.path.join(tmp, name + ".png"), "wb") as f:
                    f.write(png)
        _reset_counters()
        text = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(text):
            rc = pcli.main(["--prefix=zopfli_", "-y", *files])
        torch.cuda.synchronize()
        secs = time.time() - t0
        equal = []
        for p, png in files.items():
            out = os.path.join(tmp, "zopfli_" + os.path.basename(p))
            with open(out, "rb") as f:
                equal.append(bool((codec.decode(f.read())[0]
                                   == codec.decode(png)[0]).all()))
        report["zopflipng_in_process"] = {
            "rc": rc, "seconds": secs, "files": len(files),
            "pixels_equal": equal, **_counters(),
            "output": text.getvalue().splitlines()[-1:]}
    z, s, p = (report["zopfli_in_process"], report["zopfli_subprocess"],
               report["zopflipng_in_process"])
    ok = (z["rc"] == 0 and z["equal_to_compress"] and z["path_ok"]
          and s["rc"] == 0 and s["equal_to_compress"]
          and p["rc"] == 0 and len(files) == len(picked)
          and all(p["pixels_equal"]) and p["launches"]["scan"] > 0)
    emit({"phase": "cli", "ok": ok, **report})
    if not ok:
        raise RuntimeError("CLI check failed")


def phase_profile(data) -> None:
    """One more compress under torch.profiler: where the time goes.

    It checks only that the profiler saw the device: the host time inside
    each of the pipeline's named ranges (zopfli_tpu_torch.utils.logging
    .span), the device time by kernel, and the device's busy share of the
    wall time.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import zopfli_tpu_torch as zt

    raw = data.tobytes()
    _reset_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        zt.compress(raw, "gzip", zt.Options(numiterations=ITERATIONS))
        torch.cuda.synchronize()
        wall = time.time() - t0
    ranges, kernels = {}, []
    for evt in prof.key_averages():
        # A named range shows twice: as a host range and as its
        # projection on the device timeline, which is no kernel.
        if evt.key.startswith("zt."):
            if evt.device_type == DeviceType.CPU:
                ranges[evt.key] = evt.cpu_time_total / 1e3
        elif evt.device_type == DeviceType.CUDA:
            kernels.append((evt.self_device_time_total / 1e3, evt.count,
                            evt.key))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    if not kernels:
        raise RuntimeError("the profiler saw no device time")
    emit({"phase": "profile", "ok": True, "wall_ms": wall * 1e3,
          "device_busy_ms": busy,
          "device_idle_share": 1.0 - busy / (wall * 1e3),
          "device_launches": sum(k[1] for k in kernels),
          "ranges_ms": ranges, **_counters(),
          "top_device_ms": [{"ms": ms, "count": n, "name": name[:80]}
                            for ms, n, name in kernels[:12]]})

ORACLE_ITERATIONS = 8   # the oracle engine's deflate of 1 MiB (~30 s)
LARGE_TILE = 32768      # past the staged traceback entry's 17,611 rows
PIPELINE_ROW = 1 << 17  # block_pipeline's row capacity (8 rows)


def _dp_bound(bl, ins_bytes, out_bytes) -> tuple[float, str]:
    """Least time of a dp_scan: every input read once, the three outputs
    written once; 3 f32 operations per match relaxation (two adds and a
    compare) and 2 per literal, at the rows' real positions."""
    B, L, _ = bl.shape
    return bytes_bound(ins_bytes + out_bytes, B * L * (3 * 256 + 2))


def _dp_inputs(engine, data, s, e, dev, ll=None, dd=None):
    """dp_scan's inputs for block [s, e) as the oracle engine builds
    them, under the fixed model or the given costs."""
    import numpy as np
    import torch

    from zopfli_tpu_torch.ops import dp

    eng = engine.DeviceBlockEngine(data, s, e, device=dev)
    eng._prepare()
    if ll is None:
        ll, dd = engine._FIXED_LL, engine._FIXED_D
    lcost, dcost, lit = dp.edge_cost_tables(
        torch.from_numpy(np.asarray(ll, np.float32)).to(dev)[None],
        torch.from_numpy(np.asarray(dd, np.float32)).to(dev)[None],
        eng._bp_dsym, eng._bp_dextra, eng._data_block)
    return (eng._bp_len, eng._bp_dist, dcost.contiguous(), lit.contiguous(),
            lcost.contiguous(), eng._mask)


def _dp_hold(dp, ins, plain_device=None) -> tuple[bool, float]:
    """dp_scan against its plain version on the same inputs (copied to
    `plain_device` first, if given: on the host the plain version's
    per-position loop is several times faster for a long row)."""
    import torch

    k = dp.squeeze_scan(*ins)
    if plain_device is not None:
        ins = [t.to(plain_device) for t in ins]
        k = [t.to(plain_device) for t in k]
    p = dp.squeeze_scan_plain(*ins)
    torch.cuda.synchronize()
    eq = (torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
          and torch.equal(k[2].view(torch.int32), p[2].view(torch.int32)))
    err = max(float((k[0] - p[0]).abs().max()),
              float((k[1] - p[1]).abs().max()),
              float((k[2].double() - p[2].double()).abs().max()))
    return eq, err


def _large_tile_run(path: str) -> dict:
    """compress() of the file at `path`, in a process started with
    ZT_TILE=32768, where every traceback launch takes the large-tile
    entry: the counts of that run, then K2 held against traceback_plain
    on the fused loop's own inputs (K1's output on its first launch at
    the most lane groups), timed there, with its bound."""
    import torch

    import zopfli_tpu_torch as zt
    from zopfli_tpu_torch.ops import scan_kernel as sk

    raw = open(path, "rb").read()
    _reset_counters()
    kept, restore = _capture_fused_k1k2()
    try:
        out = zt.compress(raw, "gzip", zt.Options(numiterations=ITERATIONS))
    finally:
        restore()
    r = {**_counters(), "bytes": len(out),
         "roundtrip": zlib.decompress(out, 31) == raw}
    G = kept["groups"]
    lit, nbytes, symtab = kept["traceback"]
    ce, _ = sk.scan(*kept["scan"], groups=G)
    del kept
    before = sk.LAUNCHES["traceback_large"]
    hist_k, pe_k = sk.traceback(ce, lit, nbytes, symtab, groups=G)
    r["entry_taken"] = sk.LAUNCHES["traceback_large"] - before == 1
    hist_p, pe_p = sk.traceback_plain(ce, lit, nbytes, symtab, groups=G)
    r["bit_equal"] = torch.equal(hist_k, hist_p) and torch.equal(pe_k, pe_p)
    r["max_abs_err"] = max(float((hist_k - hist_p).abs().max()),
                           float((pe_k.long() - pe_p.long()).abs().max()))
    del hist_p, pe_p
    r["shape"] = {"groups": G, "tile": ce.shape[0] // G,
                  "lanes": ce.shape[1]}
    r["ms"] = cuda_time_ms(
        lambda: sk.traceback(ce, lit, nbytes, symtab, groups=G), 10)
    r["plain_ms"] = cuda_time_ms(lambda: sk.traceback_plain(
        ce, lit, nbytes, symtab, groups=G), 1, warm=0)
    r["bound_ms"], r["bound_by"] = _traceback_bound(hist_k, pe_k, G, symtab)
    return r


def _large_tile_subprocess(raw: bytes) -> dict:
    """_large_tile_run in a fresh process at ZT_TILE=32768 (the tile is
    fixed when the fused loop's module is imported)."""
    import tempfile

    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {HERE!r})\n"
        "import chip_smoke\n"
        "print(json.dumps(chip_smoke._large_tile_run(sys.argv[1])))\n")
    with tempfile.NamedTemporaryFile(suffix=".bin") as f:
        f.write(raw)
        f.flush()
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-c", code, f.name], cwd=HERE,
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, ZT_TILE=str(LARGE_TILE)))
    if proc.returncode:
        raise RuntimeError(f"ZT_TILE={LARGE_TILE} compress failed:\n"
                           f"{proc.stderr[-3000:]}")
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    r["seconds"] = time.time() - t0
    return r


def phase_oracle(data, dev="cuda") -> dict:
    """The oracle block engine (ops.engine, ops.dp) and K2's large-tile
    entry on the card: dp_scan against its plain version (a real 2 x 4096
    batch under the fixed model, a seeded random case, the 16 KiB
    bucket, 1/4-bit-grid and signed-zero costs, phase 3's largest block
    in its bucket, 8 rows of 2^17 with different masks), its times at 16
    KiB, at the largest block's bucket and at 8 x 2^17, and the plain
    version's at 16 KiB; block_pipeline on 8 rows of 2^17 bytes (and
    sharded over two entries of this card); deflate of the 1 MiB input
    through DeviceBlockEngine (engine_factory of Options(engine="native"),
    ORACLE_ITERATIONS iterations): round trip, <= 1.02 x the native
    engine at the same iterations, no verify fallback, dp_scan launched;
    K2's large-tile entry against traceback_plain at a tile of 32,768
    rows and 256 lanes and at a tile of 70,000 rows in 2 groups of 32
    lanes, on random paths, and compress() at ZT_TILE=32768
    in a fresh process, with the entry held and timed there on that
    run's own K2 inputs."""
    import functools
    import importlib

    import numpy as np
    import torch

    import zopfli_tpu_torch as zt
    from zopfli_tpu_torch import native
    from zopfli_tpu_torch.deflate import Options, split_master
    from zopfli_tpu_torch.emit import BitStream
    from zopfli_tpu_torch.ops import dp, engine, fused_engine
    from zopfli_tpu_torch.ops import scan_kernel as sk
    from zopfli_tpu_torch.parallel import dist

    tdeflate = importlib.import_module("zopfli_tpu_torch.deflate")
    dev = torch.device(dev)
    checks, report = {}, {}

    # dp_scan: a real batch of two 4096-byte rows, and a random case.
    n = len(data)
    rows = []
    for s in (0, 300_000):
        ins = _dp_inputs(engine, data, s, s + 4096, dev)
        rows.append([t[:, :4096].contiguous() for t in ins[:4]]
                    + [ins[4], ins[5][:, :4096].contiguous()])
    batch = [torch.cat([r[i] for r in rows]) for i in range(6)]
    checks["dp_real_b2_l4096"], err_a = _dp_hold(dp, batch)
    rng = np.random.default_rng(31)
    B, L, K = 3, 3000, 12
    bl = rng.integers(0, 300, (B, L, K))
    bl = np.where(rng.random(bl.shape) < 0.3, 0, bl)
    bl = np.where(rng.random(bl.shape) < 0.2, bl[:, :, :1], bl)
    rnd = [bl.astype(np.int32),
           rng.integers(1, 32769, (B, L, K)).astype(np.int32),
           rng.uniform(1, 20, (B, L, K)).astype(np.float32),
           rng.uniform(1, 12, (B, L)).astype(np.float32),
           rng.uniform(1, 10, (B, 256)).astype(np.float32),
           np.arange(L)[None, :] < np.array([L, 2000, 0])[:, None]]
    checks["dp_random"], err_b = _dp_hold(
        dp, [torch.from_numpy(a).to(dev) for a in rnd])
    # Costs on the 1/4-bit grid (many ties), and zero costs of both signs
    # (-0.0 + -0.0 keeps its sign, -0.0 + 0.0 does not) on a 4096-byte
    # block in its 16 KiB bucket (a masked tail of 12,288 positions).
    ins_grid = _dp_inputs(
        engine, data, 0, 16384, dev,
        np.round(rng.uniform(1, 15, 288) * 4).astype(np.float32) / 4,
        np.round(rng.uniform(1, 12, 32) * 4).astype(np.float32) / 4)
    checks["dp_grid16k"], err_d = _dp_hold(dp, ins_grid)
    ins_zero = _dp_inputs(
        engine, data, 100_000, 104_096, dev,
        np.where(rng.random(288) < 0.5, -0.0, 0.0).astype(np.float32),
        np.where(rng.random(32) < 0.5, -0.0, 0.0).astype(np.float32))
    checks["dp_signed_zeros"], err_e = _dp_hold(dp, ins_zero)

    # The 16 KiB bucket: bit-equality and the plain version's time.
    bounds = split_master(Options(engine="native"), data, 0, n,
                          native.greedy)
    ins16 = _dp_inputs(engine, data, 0, 16384, dev)
    checks["dp_bucket16k"], err_c = _dp_hold(dp, ins16)
    report["dp_ms_16k"] = cuda_time_ms(lambda: dp.squeeze_scan(*ins16), 5)
    report["dp_plain_ms_16k"] = cuda_time_ms(
        lambda: dp.squeeze_scan_plain(*ins16), 1, warm=0)
    # Phase 3's largest block, in its bucket.
    sizes = np.diff(bounds)
    b = int(np.argmax(sizes))
    insb = _dp_inputs(engine, data, int(bounds[b]), int(bounds[b + 1]), dev)
    outb = dp.squeeze_scan(*insb)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    report["largest_block"] = {"bytes": int(sizes[b]),
                               "bucket": int(insb[0].shape[1])}
    report["dp_ms_largest"] = cuda_time_ms(lambda: dp.squeeze_scan(*insb),
                                           3)
    # The whole largest row held (its masked tail included), the plain
    # version on the host.
    t0 = time.time()
    checks["dp_largest_row"], err_f = _dp_hold(dp, insb, "cpu")
    report["dp_plain_host_seconds_largest"] = time.time() - t0
    # block_pipeline's shape, 8 rows of 2^17, with different masks (cut
    # rows, all in the 2^17 bucket) and models (fixed, statistical).
    rows8 = []
    for i, cut in enumerate((PIPELINE_ROW, PIPELINE_ROW - 1, 126_000,
                             110_000, 97_000, 80_000, 70_000, 65_537)):
        model = (() if i % 2 == 0 else
                 (rng.uniform(1, 15, 288).astype(np.float32),
                  rng.uniform(1, 12, 32).astype(np.float32)))
        rows8.append(_dp_inputs(engine, data, i * PIPELINE_ROW,
                                i * PIPELINE_ROW + cut, dev, *model))
    ins8 = [torch.cat([r[i] for r in rows8]) for i in range(6)]
    del rows8
    t0 = time.time()
    checks["dp_b8_rows"], err_g = _dp_hold(dp, ins8, "cpu")
    report["dp_plain_host_seconds_b8"] = time.time() - t0
    report["dp_ms_b8"] = cuda_time_ms(lambda: dp.squeeze_scan(*ins8), 3)
    report["dp_bound_ms_b8"], report["dp_bound_by_b8"] = _dp_bound(
        ins8[0], nbytes(ins8), nbytes(dp.squeeze_scan(*ins8)))
    del ins8
    report["dp_bound_ms_largest"], report["dp_bound_by_largest"] = \
        _dp_bound(insb[0], nbytes(insb), nbytes(outb))
    report["dp_bound_ms_16k"], report["dp_bound_by_16k"] = _dp_bound(
        ins16[0], nbytes(ins16), nbytes(dp.squeeze_scan(*ins16)))

    # block_pipeline: 8 rows of 2^17 bytes, and the same rows sharded
    # over two entries of this card.
    cap = PIPELINE_ROW
    ranges = [(i * cap, (i + 1) * cap) for i in range(8)]
    bufs, min_pos, inend = dist.pack_blocks(data, ranges, cap)
    ll = np.full((8, 288), 8.0, np.float32)
    dd = np.full((8, 32), 5.0, np.float32)
    torch.cuda.synchronize()
    t0 = time.time()
    cl, cd, cost = dist.block_pipeline(bufs, cap, min_pos, inend, ll, dd,
                                       device=dev)
    torch.cuda.synchronize()
    report["block_pipeline_seconds"] = time.time() - t0
    scl, scd, scost, total = dist.sharded_pipeline([dev, dev], cap)(
        bufs, min_pos, inend, ll, dd)
    checks["block_pipeline_sharded_equal"] = (
        torch.equal(cl, scl) and torch.equal(cd, scd)
        and torch.equal(cost.view(torch.int32), scost.view(torch.int32)))
    covered = True
    for i, (s, e) in enumerate(ranges):
        lit, dst = dp.traceback(cl[i].cpu().numpy(), cd[i].cpu().numpy(),
                                e - s, data[s:e])
        eng = engine.DeviceBlockEngine(data, s, e, device=dev)
        covered = covered and eng._verify(lit, dst)
    checks["block_pipeline_parses"] = covered and bool(
        torch.isfinite(cost).all()) and float(total) > 0
    report["block_pipeline_cost_total"] = float(total)

    # deflate through the oracle engine: the dp_scan path.
    raw = data.tobytes()
    _reset_counters()
    out = BitStream()
    t0 = time.time()
    tdeflate.deflate(Options(engine="native",
                             numiterations=ORACLE_ITERATIONS), 2, True,
                     data, out, engine_factory=functools.partial(
                         engine.DeviceBlockEngine, device=dev),
                     greedy_fn=engine.device_greedy)
    torch.cuda.synchronize()
    secs = time.time() - t0
    oracle_counts = _counters()
    payload = out.getvalue()
    t0 = time.time()
    native_payload = zt.compress(raw, "deflate", zt.Options(
        engine="native", numiterations=ORACLE_ITERATIONS))
    report["oracle_deflate"] = {
        "iterations": ORACLE_ITERATIONS, "seconds": secs,
        "bytes": len(payload), "native_bytes": len(native_payload),
        "native_seconds": time.time() - t0,
        "size_vs_native": len(payload) / len(native_payload),
        "roundtrip": zlib.decompress(payload, -15) == raw, **oracle_counts}
    od = report["oracle_deflate"]
    checks["oracle_deflate"] = (
        od["roundtrip"] and od["size_vs_native"] <= 1.02
        and od["engine_fallbacks"] == 0
        and od["launches"]["dp_scan"] > 0)

    # K2's large-tile entry at a tile of 32,768 rows and the fused loop's
    # lane count: random valid paths, then the same cut (rows of length 0
    # and 2 on a path).
    T, Ln = LARGE_TILE, fused_engine.LANES
    pos = np.arange(1, T + 1)[:, None]
    ln = rng.integers(3, 259, (T, Ln))
    ce = np.where((rng.random((T, Ln)) < 0.6) | (ln > pos), 1,
                  ln | (rng.integers(1, 32769, (T, Ln)) << 9))
    ce_t = torch.from_numpy(ce.astype(np.int32)).to(dev)
    lit_t = torch.from_numpy(rng.integers(0, 256, (T, Ln)).astype(
        np.int32)).to(dev)
    before = sk.LAUNCHES["traceback_large"]
    checks["traceback_large_tile32768"] = _traceback_cases(
        sk, ce_t, lit_t, T, rng, 1)
    checks["traceback_large_entry_taken"] = (
        sk.LAUNCHES["traceback_large"] - before == 2)
    del ce_t, lit_t
    # A tile past 65,535 rows (past the 16-bit positions of the staged
    # entry), 2 groups of 32 lanes: random valid paths, then cut.
    T2, L2, G2 = 70_000, 32, 2
    pos2 = np.arange(1, T2 + 1)[:, None]
    ce2 = []
    for _ in range(G2):
        ln2 = rng.integers(3, 259, (T2, L2))
        ce2.append(np.where((rng.random((T2, L2)) < 0.6) | (ln2 > pos2), 1,
                            ln2 | (rng.integers(1, 32769, (T2, L2)) << 9)))
    ce_t = torch.from_numpy(np.concatenate(ce2).astype(np.int32)).to(dev)
    lit_t = torch.from_numpy(rng.integers(0, 256, (G2 * T2, L2)).astype(
        np.int32)).to(dev)
    before = sk.LAUNCHES["traceback_large"]
    checks["traceback_large_tile70000_g2"] = _traceback_cases(
        sk, ce_t, lit_t, T2, rng, G2)
    checks["traceback_large_entry_taken_70000"] = (
        sk.LAUNCHES["traceback_large"] - before == 2)
    del ce_t, lit_t, ce2
    # compress() at ZT_TILE=32768, and the entry held and timed on that
    # run's own K2 inputs.
    big = _large_tile_subprocess(raw)
    report["large_tile_compress"] = big
    checks["large_tile_compress"] = (
        big["roundtrip"] and big["launches"]["traceback"] == 0
        and big["launches"]["traceback_large"]
        == big["launches"]["scan"] > 0)
    checks["traceback_large_real"] = big["bit_equal"] and big["entry_taken"]
    checks["traceback_large_real_shape"] = (
        big["shape"]["tile"] == LARGE_TILE
        and big["shape"]["lanes"] == fused_engine.LANES)

    ok = all(checks.values())
    emit({"phase": "oracle", "ok": ok, "checks": checks, **report})
    if not ok:
        raise RuntimeError(f"oracle check failed: {checks}")
    return {
        "dp_scan": {"name": "dp_scan", "route": "cuda",
                    "source": "zopfli_tpu_torch/csrc/dp_scan.cu",
                    "replaces": sk.REPLACES["dp_scan"],
                    "launches": od["launches"]["dp_scan"],
                    "max_abs_err": max(err_a, err_b, err_c, err_d, err_e,
                                       err_f, err_g),
                    "ms": report["dp_ms_16k"],
                    "plain_ms": report["dp_plain_ms_16k"],
                    "bound_ms": report["dp_bound_ms_16k"],
                    "bound_by": report["dp_bound_by_16k"],
                    "library_ms": None, "shape": {"B": 1, "L": 16384},
                    "largest_bucket": {
                        **report["largest_block"],
                        "ms": report["dp_ms_largest"],
                        "bound_ms": report["dp_bound_ms_largest"],
                        "bound_by": report["dp_bound_by_largest"]},
                    "b8_shape": {
                        "B": 8, "L": PIPELINE_ROW, "ms": report["dp_ms_b8"],
                        "bound_ms": report["dp_bound_ms_b8"],
                        "bound_by": report["dp_bound_by_b8"]}},
        "traceback_large": {
            "name": "traceback_large", "route": "cuda",
            "source": "zopfli_tpu_torch/csrc/traceback.cu",
            "replaces": sk.REPLACES["traceback_large"],
            "launches": big["launches"]["traceback_large"],
            "max_abs_err": big["max_abs_err"], "ms": big["ms"],
            "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"], "library_ms": None,
            "shape": big["shape"]},
    }


def corpus_bytes(n: int) -> bytes:
    """n bytes of the corpus files, concatenated and repeated."""
    blob = b"".join(open(p, "rb").read() for p in corpus_paths())
    return (blob * (n // len(blob) + 1))[:n]


_MH_WORKER = r"""
import json, sys, zlib
sys.path.insert(0, {here!r})
import torch
import torch.distributed as dist
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method={addr!r}, world_size=2,
                        rank=rank)
try:
    import zopfli_tpu_torch as zt
    raw = open({path!r}, "rb").read()
    out = zt.compress(raw, "gzip", zt.Options(numiterations=2,
                                              device={device!r}))
    if rank == 0:
        open({outpath!r}, "wb").write(out)
    else:
        assert out is None
finally:
    dist.destroy_process_group()
"""


# compress_many inside the group: each blob goes through compress and
# so through compress_multihost; every rank writes its list.
_MH_MANY_WORKER = r"""
import pickle, sys
sys.path.insert(0, {here!r})
import torch
import torch.distributed as dist
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method={addr!r}, world_size=2,
                        rank=rank)
try:
    import zopfli_tpu_torch as zt
    blobs = pickle.load(open({path!r}, "rb"))
    outs = zt.compress_many(blobs, "gzip", zt.Options(numiterations=2,
                                                      device={device!r}))
    with open({outpath!r} + str(rank), "wb") as f:
        pickle.dump(outs, f)
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two(code: str) -> tuple[list[int], list[str]]:
    """Run `code` as ranks 0 and 1 on this card; their exit codes and
    the tails of their stderr.  Every process is ended before return."""
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              cwd=HERE, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    rcs, errs = [], []
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            rcs.append(p.returncode)
            errs.append(err[-1500:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rcs, errs


def phase_parallel(dev="cuda") -> dict:
    """The multi-device and multi-process layer on the card: compress of
    4 MiB of repo text (the fused loop at G=4), its K1/K2 held
    against their plain versions on the loop's inputs and timed;
    compress with the loop sharded over [cuda:0, cuda:0], byte-equal to
    the unsharded run; compress_multihost in a world-size-1 gloo group,
    byte-equal to compress at one master; two processes on this card in
    a gloo group (2.1 MB, --i2), rank 0's bytes equal to the
    single-process compress_multihost's; two such processes calling
    compress_many, rank 0's list equal to the single-process
    compress_multihost of each blob and rank 1's None for each."""
    import importlib
    import pickle
    import tempfile

    import torch
    import torch.distributed as tdist

    import zopfli_tpu_torch as zt
    from zopfli_tpu_torch.parallel import multihost

    tdeflate = importlib.import_module("zopfli_tpu_torch.deflate")
    dev = torch.device(dev)
    checks, report = {}, {}
    raw = corpus_bytes(4 * MIB)
    opts = zt.Options(numiterations=ITERATIONS, device=str(dev))

    _reset_counters()
    kept, restore = _capture_fused_k1k2()
    try:
        t0 = time.time()
        unsharded = zt.compress(raw, "gzip", opts)
        torch.cuda.synchronize()
        report["unsharded_seconds"] = time.time() - t0
    finally:
        restore()
    report["unsharded"] = _counters()
    G = kept["groups"]
    report["groups"] = G
    checks["groups_4"] = G == 4
    checks["roundtrip_4mib"] = zlib.decompress(unsharded, 31) == raw
    scan_in = kept["scan"]
    rows, kbp, nt = scan_in[0].shape
    k12, _ = _hold_k1k2(scan_in, *kept["traceback"], G, plain_reps=1)
    del kept
    checks.update({f"g4_{k}": v for k, v in k12["bit_equal"].items()})
    report["g4"] = {"groups": G, "tile": rows // G, "lanes": nt, "kbp": kbp,
                    **{k: v for k, v in k12.items() if k != "bit_equal"}}

    local = tdeflate.local_devices
    tdeflate.local_devices = lambda options: [dev, dev]
    _reset_counters()
    try:
        t0 = time.time()
        sharded = zt.compress(raw, "gzip", opts)
        torch.cuda.synchronize()
        report["sharded_seconds"] = time.time() - t0
    finally:
        tdeflate.local_devices = local
    report["sharded"] = _counters()
    checks["sharded_equal"] = sharded == unsharded
    # The patched run really split the loop: each shard launches K1.
    checks["sharded_ran"] = (report["sharded"]["launches"]["scan"]
                             > report["unsharded"]["launches"]["scan"])
    report["bytes"] = len(unsharded)

    one = raw[:1_000_000]
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                             f"{_free_port()}", world_size=1, rank=0)
    try:
        mh1 = multihost.compress_multihost(one, "gzip", opts)
    finally:
        tdist.destroy_process_group()
    checks["multihost_world1_equal"] = mh1 == zt.compress(one, "gzip", opts)

    two = raw[:2_100_000]
    opts2 = zt.Options(numiterations=2, device=str(dev))
    serial = multihost.compress_multihost(two, "gzip", opts2)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "in.bin")
        outpath = os.path.join(tmp, "out.gz")
        with open(path, "wb") as f:
            f.write(two)
        code = _MH_WORKER.format(here=HERE, path=path, outpath=outpath,
                                 addr=f"tcp://127.0.0.1:{_free_port()}",
                                 device=str(dev))
        t0 = time.time()
        rcs, errs = _run_two(code)
        report["two_process_seconds"] = time.time() - t0
        report["two_process_rcs"] = rcs
        got = open(outpath, "rb").read() if os.path.exists(outpath) else b""
    checks["two_process_equal"] = rcs == [0, 0] and got == serial
    if rcs != [0, 0]:
        report["two_process_stderr"] = errs
    checks["two_process_roundtrip"] = zlib.decompress(serial, 31) == two

    # compress_many in the group: rank 0 gets each blob's
    # compress_multihost bytes (masters split over the ranks: the first
    # blob has two), rank 1 None for each.
    blobs = [two[:1_300_000], raw[:200_000], b""]
    serials = [multihost.compress_multihost(b, "gzip", opts2) for b in blobs]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "many.pkl")
        outpath = os.path.join(tmp, "many.out")
        with open(path, "wb") as f:
            pickle.dump(blobs, f)
        code = _MH_MANY_WORKER.format(
            here=HERE, path=path, outpath=outpath,
            addr=f"tcp://127.0.0.1:{_free_port()}", device=str(dev))
        t0 = time.time()
        rcs, errs = _run_two(code)
        report["many_two_process_seconds"] = time.time() - t0
        report["many_two_process_rcs"] = rcs
        got = [pickle.load(open(outpath + str(r), "rb"))
               if os.path.exists(outpath + str(r)) else [] for r in range(2)]
    report["many_inputs"] = [len(b) for b in blobs]
    report["many_bytes"] = [len(o) for o in serials]
    checks["many_two_process_equal"] = rcs == [0, 0] and got[0] == serials
    checks["many_two_process_none"] = rcs == [0, 0] and got[1] == [None] * 3
    checks["many_two_process_roundtrip"] = all(
        zlib.decompress(o, 31) == b for b, o in zip(blobs, serials))
    if rcs != [0, 0]:
        report["many_two_process_stderr"] = errs

    ok = all(checks.values())
    emit({"phase": "parallel", "ok": ok, "checks": checks, **report})
    if not ok:
        raise RuntimeError(f"parallel check failed: {checks}")
    return report["g4"]


def phase_workers(dev="cuda") -> dict:
    """Masters on host threads (Options.workers) on the card.  4 MiB of
    repo text, four 2^20-byte masters at forced btype 1 through
    DeviceBlockEngine (one dp_scan launch a master, at the 2^20 bucket),
    at workers=1 and then at workers=4 with deflate.local_devices
    patched to [cuda:0, cuda:0] (the round-robin of masters over local
    devices, one card standing in for two): bytes equal, zlib round
    trip, 4 dp_scan launches each, no fallback, each master's engine
    made on, and its tensors on, the device its turn named.  dp_scan is
    held bit-equal to its plain version (on the host) on one master's
    inputs and timed there.  Stored blocks (btype 0) at workers=4 must
    splice equal to workers=1; the default path (btype 2) at workers=4
    still takes the fused loop: its launches and bytes equal
    workers=1's.  Returns dp_scan's entries for the kernels line."""
    import importlib
    import threading

    import numpy as np
    import torch

    import zopfli_tpu_torch as zt
    from zopfli_tpu_torch.emit import BitStream
    from zopfli_tpu_torch.ops import dp, engine

    tdeflate = importlib.import_module("zopfli_tpu_torch.deflate")
    dev = torch.device(dev)
    card = torch.device("cuda", torch.cuda.current_device())
    devices = [card, card]
    raw = corpus_bytes(4 * MIB)
    data = np.frombuffer(raw, np.uint8)
    checks, report = {}, {"card": card_line()}
    made, lock = {}, threading.Lock()

    def factory(d, s, e):
        # DeviceBlockEngine(device="cuda") takes the thread's current
        # device; kept to check where its tensors went.
        eng = engine.DeviceBlockEngine(d, s, e, device=dev.type)
        with lock:
            made[s] = (torch.cuda.current_device(), eng)
        return eng

    def run(btype, workers, patched, factory=None):
        opts = zt.Options(numiterations=ITERATIONS, device=str(dev),
                          workers=workers)
        local = tdeflate.local_devices
        if patched:
            tdeflate.local_devices = lambda options: devices
        made.clear()
        _reset_counters()
        out = BitStream()
        torch.cuda.synchronize()
        try:
            t0 = time.time()
            tdeflate.deflate(opts, btype, True, data, out,
                             engine_factory=factory)
            torch.cuda.synchronize()
            secs = time.time() - t0
        finally:
            tdeflate.local_devices = local
        payload = out.getvalue()
        return payload, {"seconds": secs, "bytes": len(payload),
                         "roundtrip": zlib.decompress(payload, -15) == raw,
                         **_counters()}

    def placed(n):
        """Master i's engine made under, and its tensors on, devices[i %
        len(devices)]."""
        starts = sorted(made)
        return (starts == [i * MIB for i in range(n)] and all(
            made[s][0] == devices[i % len(devices)].index
            and made[s][1]._bp_len.device == devices[i % len(devices)]
            for i, s in enumerate(starts)))

    # Each worker count twice, in turns: the first run in a process pays
    # for first use.
    turns = (1, 4, 4, 1)
    fixed, runs = [], []
    for w in turns:
        payload, r = run(1, w, w > 1, factory)
        fixed.append(payload)
        runs.append({"workers": w, "seconds": r["seconds"],
                     "bytes": r["bytes"], "roundtrip": r["roundtrip"],
                     "dp_scan": r["launches"]["dp_scan"],
                     "engine_fallbacks": r["engine_fallbacks"],
                     "placed": placed(4)})
    report["btype1"] = runs
    checks["btype1_equal"] = all(p == fixed[0] for p in fixed)
    checks["btype1_roundtrip"] = all(r["roundtrip"] for r in runs)
    checks["btype1_placed"] = all(r["placed"] for r in runs)
    checks["btype1_dp_scan_launches"] = all(r["dp_scan"] == 4
                                            for r in runs)
    checks["btype1_no_fallback"] = all(r["engine_fallbacks"] == 0
                                       for r in runs)
    # One master's dp_scan inputs (the second, with its window), held
    # against the plain version on the host and timed.
    ins = _dp_inputs(engine, data, MIB, 2 * MIB, dev)
    made.clear()
    t0 = time.time()
    checks["dp_master_row"], err = _dp_hold(dp, ins, "cpu")
    report["dp_plain_host_seconds_master"] = time.time() - t0
    report["dp_ms_master"] = cuda_time_ms(lambda: dp.squeeze_scan(*ins), 3)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    report["dp_bound_ms_master"], report["dp_bound_by_master"] = _dp_bound(
        ins[0], nbytes(ins), nbytes(dp.squeeze_scan(*ins)))
    del ins

    stored1, r1 = run(0, 1, False)
    stored4, r4 = run(0, 4, True)
    report["btype0"] = [{"workers": w, "seconds": r["seconds"],
                         "bytes": r["bytes"]} for w, r in ((1, r1), (4, r4))]
    checks["btype0_equal"] = stored4 == stored1
    checks["btype0_roundtrip"] = r4["roundtrip"]

    def default_run(workers):
        _reset_counters()
        t0 = time.time()
        out = zt.compress(raw, "gzip", zt.Options(
            numiterations=ITERATIONS, device=str(dev), workers=workers))
        torch.cuda.synchronize()
        c = _counters()
        return out, {"workers": workers, "seconds": time.time() - t0,
                     "bytes": len(out),
                     "roundtrip": zlib.decompress(out, 31) == raw,
                     "launches": c["launches"], "split": c["split"],
                     "seed_programs": c["seed_programs"]}

    gzs, dflt = zip(*(default_run(w) for w in turns))
    report["btype2"] = dflt
    d1 = dflt[0]
    checks["btype2_equal"] = (all(g == gzs[0] for g in gzs)
                              and all(d["roundtrip"] for d in dflt))
    # The fused loop at 4 workers as at 1: one seed program a master,
    # the same launches and split searches.
    checks["btype2_fused_launches"] = (
        all(d["launches"] == d1["launches"] and d["split"] == d1["split"]
            and d["seed_programs"] == 4 for d in dflt)
        and d1["launches"]["scan"] > 0 and d1["launches"]["hist_cost"] > 0
        and d1["launches"]["dp_scan"] == 0)

    ok = all(checks.values())
    emit({"phase": "workers", "ok": ok, "checks": checks, **report})
    if not ok:
        raise RuntimeError(f"workers check failed: {checks}")
    return {"launches_workers": runs[1]["dp_scan"],
            "master_shape": {
                "B": 1, "L": MIB, "max_abs_err": err,
                "ms": report["dp_ms_master"],
                "bound_ms": report["dp_bound_ms_master"],
                "bound_by": report["dp_bound_by_master"],
                "plain_host_seconds":
                    report["dp_plain_host_seconds_master"]}}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    only = argv[argv.index("--only") + 1] if "--only" in argv else None
    sys.path.insert(0, HERE)
    try:
        import numpy as np

        from zopfli_tpu_torch.ops import scan_kernel as zt_scan

        phase_env(zt_scan)
        data = np.frombuffer(corpus_1mib(), dtype=np.uint8)
        if only in ("oracle", "parallel", "mega", "split", "workers",
                    "i500"):
            {"oracle": phase_oracle, "parallel": phase_parallel,
             "mega": phase_mega, "split": phase_split,
             "workers": phase_workers, "i500": phase_i500}[only](
                *(() if only in ("parallel", "workers", "i500")
                  else (data,)))
            return 0
        kernels = phase_kernels(data)
        if only == "kernels":
            return 0
        launches, gz = phase_main(data)
        mega_launches = phase_mega(data)
        phase_profile(data)
        phase_many()
        inputs = png_inputs()
        png_launches, png_k12 = phase_png(inputs)
        phase_i500()
        phase_cli(data.tobytes(), gz, inputs)
        oracle = phase_oracle(data)
        g4 = phase_parallel()
        workers = phase_workers()
        for k, entry in kernels.items():
            # The default path's count, with the mega path's beside.
            entry["launches"] = launches[k]
            entry["launches_mega"] = mega_launches[k]
            entry["launches_png"] = png_launches[k]
            if k in ("scan", "traceback"):
                # Times at the PNG batch's fused-loop shape (phase png).
                entry["png_shape"] = {
                    "groups": png_k12["groups"],
                    "max_abs_err": png_k12[f"{k}_err"],
                    "ms": png_k12[f"{k}_ms"],
                    "plain_ms": png_k12[f"{k}_plain_ms"],
                    "bound_ms": png_k12[f"{k}_bound_ms"],
                    "bound_by": png_k12[f"{k}_bound_by"]}
                # Times at the 4 MiB input's fused loop, G=4 (phase
                # parallel).
                entry["g4_shape"] = {
                    "groups": g4["groups"],
                    "max_abs_err": g4[f"{k}_err"], "ms": g4[f"{k}_ms"],
                    "plain_ms": g4[f"{k}_plain_ms"],
                    "bound_ms": g4[f"{k}_bound_ms"],
                    "bound_by": g4[f"{k}_bound_by"]}
        kernels.update(oracle)
        # dp_scan's launches on the threaded btype-1 path (phase
        # workers), and its time at that path's 2^20 bucket.
        kernels["dp_scan"].update(workers)
        emit({"kernels": list(kernels.values())})
    except Exception:
        traceback.print_exc()
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
