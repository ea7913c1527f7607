// Backward path walk (zopfli TraceBackwards) with path histograms, for
// Hopper.
//
// Replaces the Pallas kernel zopfli_tpu/ops/scan_kernel.py::make_traceback
// (pallas_call at scan_kernel.py:289).  Same contract as traceback_plain
// in zopfli_tpu_torch/ops/scan_kernel.py:
//   ce, lit (G*T, L) int32; tile_nbytes (G, L) int32
//   -> hist (G*320, L) float32, pe (G*T, L) int32 (the packed edge into
//      position j+1 if on the path, else 0).
// The kernel writes every element of hist and pe.  The symbol tables are
// the two lookups that bin_tables() derives from symbol_range_table():
// len_bin[512] and dist_bin[ndist] (-1 = not counted).
//
// Bound.  Counted as the contract counts (ce read once, the path's lit
// rows, both outputs written once), the bytes bound it at a few µs.  What
// bounds a walk is its chain of dependent loads: each path row's length
// says where the next row is.  The design keeps that chain in shared
// memory and takes everything else off it:
//
// 1. Stage.  A block takes LPB adjacent lanes (2 at T=8192; fewer for a
//    larger tile, so that the staged tile fits in 227 KB) and copies
//    their whole tile of ce into shared memory with cp.async.
// 2. Jump table.  All threads compute, for every position p, the next
//    four positions a walk through p visits (0 = the walk stops), as
//    16-bit fields of one 64-bit word.
// 3. Walk.  One thread per lane walks its path through the jump table,
//    four rows per dependent shared-memory load, and records only where
//    each step of four starts; then all threads expand those anchors into
//    a bit per visited row.  The walk stops where the Pallas cursor
//    stops: at a row whose edge has length 0, or at once when
//    tile_nbytes > tile.
// 4. Sweep.  All threads visit every row of the block's lanes: pe gets
//    the edge on a marked row and 0 elsewhere (coalesced, so the caller
//    needs no zero fill), and marked rows add their symbols to a
//    per-lane histogram in shared memory with integer atomics (counts
//    are the same in any order).  lit is read only for literal path
//    rows, in batches so that the loads overlap.
// 5. The histogram is written once, as float32 (counts < 2^24 are exact).
//
// Tiles that do not fit (lanes_per_block(tile) == 0: past 17,611 rows, or
// past the 16-bit positions of the jump table) take the second entry,
// zt_traceback_large, with the same contract, in one launch.  A walk only
// ever moves down the tile, so it needs only a window of rows, streamed
// from the top:
//
// - A block of 8 warps takes 4 adjacent lanes of one group (a row's 16
//   bytes) and streams their ce and lit from row tile-1 downwards in
//   chunks of 512 rows through a ring of 4 stages with cp.async: while
//   one chunk is walked and the one above it written, two more are in
//   flight.  At G=1 and 256 lanes that is 64 blocks.
// - One thread per lane walks its path inside the walked chunk in shared
//   memory (one dependent shared-memory load per path row, not one
//   device-memory load) and marks each row it visits with a byte store of
//   its own, which nothing waits for; a walk that leaves the chunk goes on
//   in the next one.  It stops where the Pallas cursor stops: on a row
//   whose length is 0, past the tile's start, and at once when
//   tile_nbytes > tile.
// - Once every walk has left a chunk, the other seven warps write it, a
//   row per thread: pe gets the edge on a marked row and 0 elsewhere
//   (rows above a lane's start included) in one 16-byte store, so pe
//   needs no zero fill; marked rows add their symbols to per-lane shared
//   histograms with integer atomics (the same counts in any order), the
//   row's bins looked up before any atomic so that the table loads
//   overlap.  The histograms are written once, as float32.
//
// What bounds it is the slowest block: its longest walks (one dependent
// shared-memory load per path row) and its writes, which overlap the next
// chunk's walk (experiments/exp_oracle_kernels.py, -DZT_PHASE_CLOCKS).
// It reads all of lit, coalesced, where the contract needs only the
// path's literal rows: then a literal's bin is a shared-memory load.
// Positions are 32-bit, so any tile works.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HBINS = 320;
constexpr int LEN_MASK = 511;
constexpr int LEN_BITS = 9;
constexpr int THREADS = 256;
constexpr int MAX_LPB = 4;
constexpr int MAX_TILE = 65535;          // a position fits 16 bits
constexpr int BATCH = 8;                 // sweep rows per thread per batch
constexpr size_t SMEM_LIMIT = 232448;    // 227 KB a block may use

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Anchors a lane's walk can record: one per four path rows.
__host__ __device__ inline int anchor_cap(int tile) { return tile / 4 + 2; }

// Jump table [T][lpb] (8 bytes), ce [T][lpb], visit bits [lpb][T/32],
// histograms [lpb][HBINS], anchors [lpb][anchor_cap] and their counts.
inline size_t smem_bytes(int tile, int lpb) {
  const size_t words = ((size_t)tile + 31) / 32;
  return sizeof(int) * (3 * (size_t)tile * lpb + words * lpb +
                        (size_t)HBINS * lpb +
                        (size_t)(anchor_cap(tile) + 1) * lpb);
}

// Lanes per block for a tile: the most (<= MAX_LPB, a power of two)
// whose staged tile fits; 0 if even one lane does not.
int lanes_per_block(int tile) {
  if (tile > MAX_TILE) return 0;
  for (int lpb = MAX_LPB; lpb >= 1; lpb /= 2)
    if (smem_bytes(tile, lpb) <= SMEM_LIMIT) return lpb;
  return 0;
}

__global__ void __launch_bounds__(THREADS)
traceback_kernel(const int* __restrict__ ce, const int* __restrict__ lit,
                 const int* __restrict__ tile_nbytes,
                 const int* __restrict__ len_bin,
                 const int* __restrict__ dist_bin, float* __restrict__ hist,
                 int* __restrict__ pe, int tile, int lanes, int ndist,
                 int lsh) {
  extern __shared__ __align__(16) int smem[];
  const int lpb = 1 << lsh;
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * lpb;
  const int g = blockIdx.y;
  const int nl = min(lpb, lanes - lane0);  // lanes of this block
  const int words = (tile + 31) / 32;
  const int n = tile << lsh;               // staged elements
  uint64_t* jump = reinterpret_cast<uint64_t*>(smem);         // [T][lpb]
  int* sce = smem + 2 * n;                                    // [T][lpb]
  unsigned* marks = reinterpret_cast<unsigned*>(sce + n);     // [lpb][words]
  int* sh = sce + n + words * lpb;                            // [lpb][HBINS]
  const int acap = anchor_cap(tile);
  int* anchors = sh + HBINS * lpb;                            // [lpb][acap]
  int* acount = anchors + acap * lpb;                         // [lpb]
  const size_t row0 = (size_t)g * tile;

  for (int e = tid; e < n; e += THREADS) {
    const int w = e & (lpb - 1);
    if (w < nl) cp4(sce + e, ce + (row0 + (e >> lsh)) * lanes + lane0 + w);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = tid; i < words * lpb; i += THREADS) marks[i] = 0u;
  for (int i = tid; i < HBINS * lpb; i += THREADS) sh[i] = 0;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Where a walk at position q goes next: q - len, or 0 if it stops.
  auto next = [&](int q, int w) {
    if (q <= 0) return 0;
    const int l = sce[((q - 1) << lsh) + w] & LEN_MASK;
    return (l == 0 || q - l <= 0) ? 0 : q - l;
  };
#pragma unroll 4
  for (int e = tid; e < n; e += THREADS) {
    const int w = e & (lpb - 1);
    const int p1 = next((e >> lsh) + 1, w);
    const int p2 = next(p1, w);
    const int p3 = next(p2, w);
    const int p4 = next(p3, w);
    jump[e] = (uint64_t)p1 | (uint64_t)p2 << 16 | (uint64_t)p3 << 32 |
              (uint64_t)p4 << 48;
  }
  __syncthreads();

  if (tid < nl) {
    int p = tile_nbytes[(size_t)g * lanes + lane0 + tid];
    if (p > tile) p = 0;  // the Pallas cursor would never match a row
    int* an = anchors + tid * acap;
    int cnt = 0;
    while (p > 0) {
      an[cnt++] = p;
      const uint64_t v = jump[((p - 1) << lsh) + tid];
      if ((v & 0xffffull) == 0 || (v & 0xffff0000ull) == 0 ||
          (v & 0xffff00000000ull) == 0)
        break;  // the walk stops within these four rows
      p = (int)(v >> 48);
    }
    acount[tid] = cnt;
  }
  __syncthreads();
  // Each anchor p stands for p and the next (up to) three positions.
  for (int w = 0; w < nl; ++w) {
    unsigned* mk = marks + w * words;
    for (int i = tid; i < acount[w]; i += THREADS) {
      int q = anchors[w * acap + i];
      const uint64_t v = jump[((q - 1) << lsh) + w];
      for (int f = 0; f < 4 && q > 0; ++f) {
        atomicOr(mk + ((q - 1) >> 5), 1u << ((q - 1) & 31));
        q = f < 3 ? (int)((v >> (16 * f)) & 0xffff) : 0;
      }
    }
  }
  __syncthreads();

  for (int base = tid; base < n; base += THREADS * BATCH) {
    int bins[BATCH][2];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      bins[u][0] = bins[u][1] = -1;
      const int e = base + u * THREADS;
      const int w = e & (lpb - 1), r = e >> lsh;
      if (e >= n || w >= nl) continue;
      const bool on = (marks[w * words + (r >> 5)] >> (r & 31)) & 1u;
      const int v = on ? sce[e] : 0;
      const size_t o = (row0 + r) * lanes + lane0 + w;
      pe[o] = v;
      const int l = v & LEN_MASK;
      if (l == 1) {
        const int b = __ldg(lit + o);
        bins[u][0] = (b >= 0 && b < HBINS) ? b : -1;
      } else if (l >= 3) {
        bins[u][0] = __ldg(len_bin + l);
        const int d = v >> LEN_BITS;
        bins[u][1] = (d >= 0 && d < ndist) ? __ldg(dist_bin + d) : -1;
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int w = (base + u * THREADS) & (lpb - 1);
      if (bins[u][0] >= 0) atomicAdd(sh + w * HBINS + bins[u][0], 1);
      if (bins[u][1] >= 0) atomicAdd(sh + w * HBINS + bins[u][1], 1);
    }
  }
  __syncthreads();

  for (int i = tid; i < HBINS * lpb; i += THREADS) {
    const int b = i >> lsh, w = i & (lpb - 1);
    if (w < nl)
      hist[((size_t)g * HBINS + b) * lanes + lane0 + w] =
          (float)sh[w * HBINS + b];
  }
}

// Large tiles: one block streams LG_LANES adjacent lanes of one group
// from the tile's last row upwards, LG_C rows a chunk, through a ring of
// LG_S stages of ce and lit (cp.async).  In iteration c, warp 0's first
// lanes walk chunk c and warps 1..7 write chunk c-1, a row per thread.
constexpr int LG_LANES = 4;      // a row's 16 bytes; its marks one word
constexpr int LG_THREADS = 256;
constexpr int LG_C = 512;        // rows per chunk
constexpr int LG_S = 4;          // stages: write, walk, two in flight
constexpr int LG_STAGE = LG_C * LG_LANES;
constexpr int LG_WRITERS = LG_THREADS - 32;

// The ring of ce and lit stages [S][2][C][LANES], the visit marks
// [2][C][LANES] bytes (lane w's walk visits the row), the histograms
// [LANES][HBINS].
inline size_t lg_smem_bytes() {
  return sizeof(int) *
         ((size_t)LG_S * 2 * LG_STAGE + 2 * LG_C + LG_LANES * HBINS);
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// -DZT_PHASE_CLOCKS (experiments/exp_oracle_kernels.py): per block, the
// clock64() cycles of the whole block, of warp 0's walks, of warp 1's
// writes, the path rows lane 0 walked, and warp 0's and warp 1's cycles
// at the two barriers of each chunk.
#ifdef ZT_PHASE_CLOCKS
constexpr int TB_DBG_BLOCKS = 1024;
__device__ unsigned long long zt_tb_clocks[TB_DBG_BLOCKS][8];
#define TCLK(x) const long long x = clock64()
#define TCLK_ADD(v, t0) v += clock64() - (t0)
#else
#define TCLK(x)
#define TCLK_ADD(v, t0)
#endif

__global__ void __launch_bounds__(LG_THREADS)
traceback_stream_kernel(const int* __restrict__ ce,
                        const int* __restrict__ lit,
                        const int* __restrict__ tile_nbytes,
                        const int* __restrict__ len_bin,
                        const int* __restrict__ dist_bin,
                        float* __restrict__ hist, int* __restrict__ pe,
                        int tile, int lanes, int ndist, int vec) {
  extern __shared__ __align__(16) int smem[];
  int* ring = smem;                                      // [S][2][C][LANES]
  unsigned* marks =
      reinterpret_cast<unsigned*>(ring + LG_S * 2 * LG_STAGE);  // [2][C]
  unsigned char* marks8 = reinterpret_cast<unsigned char*>(marks);
  int* sh = reinterpret_cast<int*>(marks + 2 * LG_C);    // [LANES][HBINS]
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * LG_LANES;
  const int g = blockIdx.y;
  const int nl = min(LG_LANES, lanes - lane0);
  const size_t row0 = (size_t)g * tile;
  const int nch = (tile + LG_C - 1) / LG_C;
#ifdef ZT_PHASE_CLOCKS
  long long c_walk = 0, c_write = 0, c_bar = 0, steps = 0;
#endif
  TCLK(t_start);

  for (int i = tid; i < 2 * LG_C; i += LG_THREADS) marks[i] = 0u;
  for (int i = tid; i < LG_LANES * HBINS; i += LG_THREADS) sh[i] = 0;

  // Chunk c holds rows [lo, hi) with hi = tile - c * LG_C.
  auto load = [&](int c) {
    const int hi = tile - c * LG_C, lo = max(0, hi - LG_C);
    int* st = ring + (c % LG_S) * 2 * LG_STAGE;
    if (vec) {  // a row of each array is one 16-byte copy
      for (int i = tid; i < (hi - lo) * 2; i += LG_THREADS) {
        const int r = i >> 1, a = i & 1;
        cp16(st + a * LG_STAGE + r * LG_LANES,
             (a ? lit : ce) + (row0 + lo + r) * lanes + lane0);
      }
    } else {
      for (int i = tid; i < (hi - lo) * LG_LANES; i += LG_THREADS) {
        const int r = i / LG_LANES, w = i % LG_LANES;
        if (w < nl) {
          const size_t o = (row0 + lo + r) * lanes + lane0 + w;
          cp4(st + i, ce + o);
          cp4(st + LG_STAGE + i, lit + o);
        }
      }
    }
  };
  for (int c = 0; c < LG_S - 2; ++c) {
    if (c < nch) load(c);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // The walk stops where the Pallas cursor stops: on a row whose edge has
  // length 0, past the tile's start, or at once when tile_nbytes > tile.
  int p = 0;
  if (tid < nl) {
    p = tile_nbytes[(size_t)g * lanes + lane0 + tid];
    if (p > tile) p = 0;
  }
  for (int c = 0; c <= nch; ++c) {
    TCLK(t_b0);
    __syncthreads();  // the walk of c-1 and the writes of c-2 are done
    TCLK_ADD(c_bar, t_b0);
    if (c + LG_S - 2 < nch) load(c + LG_S - 2);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(LG_S - 2) : "memory");
    TCLK(t_b1);
    __syncthreads();  // chunk c has landed
    TCLK_ADD(c_bar, t_b1);
    TCLK(t_work);
    if (tid < 32) {
      if (c < nch && tid < nl) {
        // One dependent shared-memory load per path row; the mark is a
        // byte store of the lane's own, which nothing waits for.
        // Row p-1 of the chunk at [p * LG_LANES] of both (one multiply-add
        // per step).
        const int hi = tile - c * LG_C, lo = max(0, hi - LG_C);
        const int* st =
            ring + (c % LG_S) * 2 * LG_STAGE + tid - (lo + 1) * LG_LANES;
        unsigned char* mk =
            marks8 + (c & 1) * LG_C * LG_LANES + tid - (lo + 1) * LG_LANES;
        while (p > lo) {
          const int v = st[p * LG_LANES];
          mk[p * LG_LANES] = 1;
          const int l = v & LEN_MASK;
          p = l == 0 ? 0 : p - l;
#ifdef ZT_PHASE_CLOCKS
          ++steps;
#endif
        }
      }
      __syncwarp();
      TCLK_ADD(c_walk, t_work);
    } else if (c >= 1) {
      // Chunk c-1, a row per thread: pe (the edge on visited rows, 0
      // elsewhere), then the visited rows' symbols into the histograms.
      const int c1 = c - 1;
      const int hi = tile - c1 * LG_C, lo = max(0, hi - LG_C);
      const int* st = ring + (c1 % LG_S) * 2 * LG_STAGE;
      unsigned* mk = marks + (c1 & 1) * LG_C;
      for (int r = tid - 32; r < hi - lo; r += LG_WRITERS) {
        const unsigned m = mk[r];
        mk[r] = 0u;  // the walk of chunk c+1 reuses the marks
        const int4 a = *reinterpret_cast<const int4*>(st + r * LG_LANES);
        int v[LG_LANES] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int w = 0; w < LG_LANES; ++w) v[w] = (m >> (8 * w)) & 1u ? v[w] : 0;
        int* po = pe + (row0 + lo + r) * lanes + lane0;
        if (vec) {
          *reinterpret_cast<int4*>(po) = make_int4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int w = 0; w < LG_LANES; ++w)
            if (w < nl) po[w] = v[w];
        }
        if (m == 0u) continue;
        // Every bin first (the table loads overlap), then the atomics.
        int b0[LG_LANES], b1[LG_LANES];
        const int* sl = st + LG_STAGE + r * LG_LANES;
#pragma unroll
        for (int w = 0; w < LG_LANES; ++w) {
          const int l = v[w] & LEN_MASK;
          const int d = v[w] >> LEN_BITS;
          const int lb = sl[w];
          b0[w] = l == 1 ? (lb >= 0 && lb < HBINS ? lb : -1)
                         : l >= 3 ? __ldg(len_bin + l) : -1;
          b1[w] = l >= 3 && d >= 0 && d < ndist ? __ldg(dist_bin + d) : -1;
        }
#pragma unroll
        for (int w = 0; w < LG_LANES; ++w) {
          if (b0[w] >= 0) atomicAdd(sh + w * HBINS + b0[w], 1);
          if (b1[w] >= 0) atomicAdd(sh + w * HBINS + b1[w], 1);
        }
      }
      TCLK_ADD(c_write, t_work);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int i = tid; i < HBINS * LG_LANES; i += LG_THREADS) {
    const int b = i / LG_LANES, w = i % LG_LANES;
    if (w < nl)
      hist[((size_t)g * HBINS + b) * lanes + lane0 + w] =
          (float)sh[w * HBINS + b];
  }
#ifdef ZT_PHASE_CLOCKS
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  if (blk < TB_DBG_BLOCKS) {
    unsigned long long* d = zt_tb_clocks[blk];
    if (tid == 0) {
      d[0] = clock64() - t_start;
      d[1] = c_walk;
      d[3] = steps;
      d[4] = c_bar;
    }
    if (tid == 32) {
      d[2] = c_write;
      d[5] = c_bar;
    }
  }
#endif
}

}  // namespace

extern "C" int zt_traceback_lanes_per_block(int tile) {
  return tile > 0 ? lanes_per_block(tile) : 0;
}

extern "C" size_t zt_traceback_smem_bytes(int tile) {
  const int lpb = zt_traceback_lanes_per_block(tile);
  return lpb ? smem_bytes(tile, lpb) : 0;
}

extern "C" int zt_traceback(const void* ce, const void* lit,
                            const void* tile_nbytes, const void* len_bin,
                            const void* dist_bin, void* hist, void* pe,
                            int groups, int tile, int lanes, int ndist,
                            void* stream) {
  if (tile <= 0 || lanes <= 0 || groups <= 0 || ndist <= 0)
    return (int)cudaErrorInvalidValue;
  const int lpb = lanes_per_block(tile);
  if (lpb == 0) return (int)cudaErrorInvalidValue;
  const int lsh = lpb == 4 ? 2 : lpb == 2 ? 1 : 0;
  const size_t smem = smem_bytes(tile, lpb);
  cudaError_t err = cudaFuncSetAttribute(
      traceback_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((lanes + lpb - 1) / lpb, groups);
  traceback_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)ce, (const int*)lit, (const int*)tile_nbytes,
      (const int*)len_bin, (const int*)dist_bin, (float*)hist, (int*)pe,
      tile, lanes, ndist, lsh);
  return (int)cudaGetLastError();
}

// The entry for any tile (positions are 32-bit); the wrapper takes it
// where zt_traceback_lanes_per_block(tile) == 0.
extern "C" int zt_traceback_large(const void* ce, const void* lit,
                                  const void* tile_nbytes,
                                  const void* len_bin, const void* dist_bin,
                                  void* hist, void* pe, int groups, int tile,
                                  int lanes, int ndist, void* stream) {
  if (tile <= 0 || lanes <= 0 || groups <= 0 || ndist <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = lg_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      traceback_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies and stores need 16-byte aligned rows of whole blocks
  // of 4 lanes.
  const int vec = lanes % 4 == 0 &&
                  (((uintptr_t)ce | (uintptr_t)lit | (uintptr_t)pe) & 15) == 0;
  const dim3 grid((lanes + LG_LANES - 1) / LG_LANES, groups);
  traceback_stream_kernel<<<grid, LG_THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)ce, (const int*)lit, (const int*)tile_nbytes,
      (const int*)len_bin, (const int*)dist_bin, (float*)hist, (int*)pe,
      tile, lanes, ndist, vec);
  return (int)cudaGetLastError();
}

#ifdef ZT_PHASE_CLOCKS
// The large-tile entry's clocks of blocks 0..n-1 (n <= 1024), 8 words each.
extern "C" int zt_traceback_debug_read(void* out, int n) {
  return (int)cudaMemcpyFromSymbol(
      out, zt_tb_clocks, sizeof(unsigned long long) * 8 * (size_t)n);
}
#endif
