// Exact dynamic-block bits (Huffman tree header + symbol payload) for
// Hopper, behind two entry points.
//
// No TPU kernel counterpart: the JAX package computes these functions as
// XLA ops, which XLA compiles into the block-split search and the fused
// squeeze loop.  In PyTorch the same ops are thousands of small launches
// per call, so the port computes them here.
//
//   zt_hist_cost: ll (B, 288) int64, d (B, 32) int64 counts -> (B,) int64
//     bits, the smaller of the plain and the RleOptimize'd code lengths'
//     tree + data size.  Contract of hist_dynamic_cost_plain in
//     zopfli_tpu_torch/ops/costmodel.py (XLA ops at
//     zopfli_tpu/ops/costmodel.py:354) and of the native HistDynamicCost.
//   zt_autotype_cost: the exact auto-type bits of symbol ranges
//     [starts[b], ends[b]) of one LZ77 stream, from its checkpointed
//     cumulative histograms: the contract of autotype_costs_plain in
//     zopfli_tpu_torch/ops/devsplit.py (XLA ops at
//     zopfli_tpu/ops/devsplit.py:104): range histograms, dynamic, fixed
//     and stored costs.  The fixed-cost gate is one for the whole store
//     or one per range.  The block-split search (csrc/split_search.cu)
//     costs its rounds with the same row code (autotype_row), inside its
//     own persistent kernel.
// The device code of a row is in hist_cost_row.cuh, shared with
// split_search.cu.
// Counts must stay below 2^29 (package-merge weights are int32, clamped
// at 2^29 as the plain version clamps).
//
// Bound.  A row reads 320 counts (or two checkpoint rows and at most 510
// stream symbols) and writes one value: a few bytes.  What bounds the
// kernel is the chain of dependent steps inside one row.  The first
// design ran the row's phases one after another on a 512-thread block
// and spent 372k cycles a row at 19 rows (experiments/
// exp_hist_cost_phases.py): serial RleOptimize 31%, serial tree-size
// encodings 33%, merge levels 25%, leaf ranking 8%.  This design runs
// the row's independent work concurrently and makes each chain short:
//   - a row is a cluster of two 256-thread blocks on two SMs, one per
//     code-length set (plain, RleOptimize'd); block 0 reads block 1's
//     total through distributed shared memory.  In each block 7 warps
//     (a named barrier) run the 288-symbol package-merge and the eighth
//     the 32-symbol one alone (__syncwarp only);
//   - RleOptimize starts at once on the raw counts (block 1): run
//     detection by ballots, the one serial pass reduced to a 3-operation
//     chain per symbol (the boundary test against precomputed limits,
//     eight symbols' loads at a time), then a parallel fill from prefix
//     sums;
//   - package-merge ranks leaves by a sort (bitonic per warp, merge
//     rounds by rank); each level places every item by one fixed-step
//     branchless search of an INF-padded array, a thread's items in
//     step, and each item adds its weight into its next-level package by
//     a shared atomic, so a level is one barrier;
//   - each of the 8 tree-header variants of a set is one warp: runs of
//     equal code lengths by ballots, each run's 16/17/18 counts in closed
//     form, the 19-symbol package-merge on the same code as above;
//   - the symbol payload is summed where the lengths are written.
// One geometry serves few rows (a probe round: 19) and many (a linear
// scan: up to 2047): all scratch is in shared memory (33 KB a block), so
// five blocks share an SM when rows are many.  -DZT_PHASE_CLOCKS builds a
// variant that stamps clock64() around each phase
// (experiments/exp_hist_cost_phases.py).

#include "hist_cost_row.cuh"

namespace {

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(BLOCK, 4)
hist_cost_kernel(const int64_t* __restrict__ ll, const int64_t* __restrict__ d,
                 int64_t* __restrict__ out) {
  __shared__ Smem s;
  const int set = (int)__clusterRelativeBlockRank();
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x >> 1;
  if (tid == 0) stamp(PH_LOAD, 0);
  for (int i = tid; i < NUM_LL + NUM_D; i += BLOCK) {
    if (i < NUM_LL) {
      s.cnt_ll[i] = i == 256 ? 1 : (int)ll[row * NUM_LL + i];
    } else {
      s.cnt_d[i - NUM_LL] = (int)d[row * NUM_D + i - NUM_LL];
    }
  }
  zero_row(s, tid);
  __syncthreads();
  if (tid == 0) stamp(PH_LOAD, 1);
  const long long best = row_cost(s, set);
  if (set == 0 && tid == 0) {
    out[row] = best;
    stamp(PH_FINAL, 1);
  }
}

// One cluster per range, ranges [0, gridDim/2).
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(BLOCK, 4)
autotype_cost_kernel(const int64_t* __restrict__ ll_ck,
                     const int64_t* __restrict__ d_ck,
                     const int64_t* __restrict__ ll_sym,
                     const int64_t* __restrict__ d_sym,
                     const int64_t* __restrict__ bcum,
                     const int64_t* __restrict__ starts,
                     const int64_t* __restrict__ ends,
                     const uint8_t* __restrict__ small_rows,
                     int64_t* __restrict__ out, int64_t ncap, int small) {
  __shared__ Smem s;
  const int set = (int)__clusterRelativeBlockRank();
  const int64_t row = blockIdx.x >> 1;
  const bool gate = small_rows ? small_rows[row] != 0 : small != 0;
  autotype_row(s, set, starts[row], ends[row], gate, ll_ck, d_ck, ll_sym,
               d_sym, bcum, out + row, ncap);
}

}  // namespace


extern "C" size_t zt_hist_cost_smem_bytes() { return sizeof(Smem); }

extern "C" int zt_hist_cost(const void* ll, const void* d, void* out, int rows,
                            void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  hist_cost_kernel<<<2 * rows, BLOCK, 0, (cudaStream_t)stream>>>(
      (const int64_t*)ll, (const int64_t*)d, (int64_t*)out);
  return (int)cudaGetLastError();
}

// The fixed-cost gate (deflate.c:612-615): small_rows, (rows,) bool, one
// gate per range (the per-block-store rule), or null and `small` for the
// whole store (what the split uses).
extern "C" int zt_autotype_cost(const void* ll_ck, const void* d_ck,
                                const void* ll_sym, const void* d_sym,
                                const void* bcum, const void* starts,
                                const void* ends, const void* small_rows,
                                void* out, int rows, long long ncap, int small,
                                void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  autotype_cost_kernel<<<2 * rows, BLOCK, 0, (cudaStream_t)stream>>>(
      (const int64_t*)ll_ck, (const int64_t*)d_ck, (const int64_t*)ll_sym,
      (const int64_t*)d_sym, (const int64_t*)bcum, (const int64_t*)starts,
      (const int64_t*)ends, (const uint8_t*)small_rows, (int64_t*)out,
      (int64_t)ncap, small);
  return (int)cudaGetLastError();
}

#ifdef ZT_PHASE_CLOCKS
// Interval names, in stamp order (a merge is rank, levels, top-down).
extern "C" const char* zt_hist_cost_phase_names() {
  return "load,plain_ll.rank,plain_ll.levels,plain_ll.topdown,"
         "plain_d.rank,plain_d.levels,plain_d.topdown,"
         "rle_ll.rle,rle_ll.rank,rle_ll.levels,rle_ll.topdown,"
         "rle_d.rle,rle_d.rank,rle_d.levels,rle_d.topdown,"
         "tree0,tree1,final";
}

// Blocks of one row; the stamps are per block (each block's own clock).
extern "C" int zt_hist_cost_blocks_per_row() { return 2; }

// Copies the stamps of the first `blocks` blocks: (blocks, NPH, 2) int64.
extern "C" int zt_hist_cost_debug_read(void* dst, int blocks, int* nph) {
  *nph = NPH;
  if (blocks > DBG_BLOCKS) blocks = DBG_BLOCKS;
  return (int)cudaMemcpyFromSymbol(dst, g_stamps,
                                   sizeof(long long) * blocks * NPH * 2);
}
#endif
