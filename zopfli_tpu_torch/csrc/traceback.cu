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
// zt_traceback_large, with the same contract.  It keeps nothing of a tile
// in shared memory: pe is zeroed, one thread per lane walks ce in device
// memory (one dependent load per path row) writing pe on its path, then a
// sweep of 32 lanes x 8 rows per block counts the path rows of pe into
// per-lane shared histograms.  Positions are 32-bit, so any tile works.

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

// Large tiles, step 1: one thread per (group, lane) walks its path in
// device memory and writes pe on it (pe was zeroed before).
__global__ void __launch_bounds__(128)
traceback_walk_kernel(const int* __restrict__ ce,
                      const int* __restrict__ tile_nbytes,
                      int* __restrict__ pe, int groups, int tile,
                      int lanes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= groups * lanes) return;
  const int g = i / lanes, lane = i - g * lanes;
  int p = tile_nbytes[i];
  if (p > tile) p = 0;  // the Pallas cursor would never match a row
  const size_t row0 = (size_t)g * tile;
  while (p > 0) {
    const size_t o = (row0 + p - 1) * lanes + lane;
    const int v = ce[o];
    pe[o] = v;
    const int l = v & LEN_MASK;
    if (l == 0) break;  // the cursor stays put: no later row matches
    p -= l;             // past the tile's start: the walk ends
  }
}

constexpr int SWEEP_LANES = 32;
constexpr int SWEEP_ROWS = 8;

// Large tiles, step 2: a block counts the path rows of 32 adjacent lanes
// of one group (8 rows at a time, coalesced) into shared histograms.
__global__ void __launch_bounds__(SWEEP_LANES * SWEEP_ROWS)
traceback_sweep_kernel(const int* __restrict__ pe,
                       const int* __restrict__ lit,
                       const int* __restrict__ len_bin,
                       const int* __restrict__ dist_bin,
                       float* __restrict__ hist, int tile, int lanes,
                       int ndist) {
  __shared__ int sh[SWEEP_LANES * HBINS];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * SWEEP_LANES + tx;
  const int lane = blockIdx.x * SWEEP_LANES + tx;
  const int g = blockIdx.y;
  for (int i = tid; i < SWEEP_LANES * HBINS; i += SWEEP_LANES * SWEEP_ROWS)
    sh[i] = 0;
  __syncthreads();
  if (lane < lanes) {
    const size_t row0 = (size_t)g * tile;
    int* mine = sh + tx * HBINS;
    for (int r = ty; r < tile; r += SWEEP_ROWS) {
      const size_t o = (row0 + r) * lanes + lane;
      const int v = pe[o];
      const int l = v & LEN_MASK;
      if (l == 1) {
        const int b = lit[o];
        if (b >= 0 && b < HBINS) atomicAdd(mine + b, 1);
      } else if (l >= 3) {
        const int lb = __ldg(len_bin + l);
        if (lb >= 0) atomicAdd(mine + lb, 1);
        const int d = v >> LEN_BITS;
        const int db = (d >= 0 && d < ndist) ? __ldg(dist_bin + d) : -1;
        if (db >= 0) atomicAdd(mine + db, 1);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < SWEEP_LANES * HBINS; i += SWEEP_LANES * SWEEP_ROWS) {
    const int b = i / SWEEP_LANES, w = i - b * SWEEP_LANES;
    const int ln = blockIdx.x * SWEEP_LANES + w;
    if (ln < lanes)
      hist[((size_t)g * HBINS + b) * lanes + ln] = (float)sh[w * HBINS + b];
  }
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
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      pe, 0, sizeof(int) * (size_t)groups * tile * lanes, st);
  if (err != cudaSuccess) return (int)err;
  const int walkers = groups * lanes;
  traceback_walk_kernel<<<(walkers + 127) / 128, 128, 0, st>>>(
      (const int*)ce, (const int*)tile_nbytes, (int*)pe, groups, tile,
      lanes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((lanes + SWEEP_LANES - 1) / SWEEP_LANES, groups);
  traceback_sweep_kernel<<<grid, dim3(SWEEP_LANES, SWEEP_ROWS), 0, st>>>(
      (const int*)pe, (const int*)lit, (const int*)len_bin,
      (const int*)dist_bin, (float*)hist, tile, lanes, ndist);
  return (int)cudaGetLastError();
}
