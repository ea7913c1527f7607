// Forward min-plus squeeze DP (zopfli GetBestLengths) for Hopper.
//
// Replaces the Pallas kernel zopfli_tpu/ops/scan_kernel.py::make_scan
// (pallas_call at scan_kernel.py:163).  Same contract as scan_plain in
// zopfli_tpu_torch/ops/scan_kernel.py:
//   bp_len, bp_dist (G*T, KBP, L) int32; bp_dcost (G*T, KBP, L) float32;
//   litcost (G*T, L) float32; lcost (G*256, L) float32
//   -> ce (G*T, L) int32 packed edges (len | dist << 9), cost (G*T, L) f32.
//
// Design.  Every (group, lane) chain is an independent sequence of T
// steps, each step 256 lengths wide; step j+1 reads the cost of row j+1,
// which step j may still relax, so the steps of a chain are sequential.
// One warp owns one chain: thread t relaxes lengths 3+t+32i (i < 8), the
// 259-row live window is a 512-row ring in shared memory (4 KB), and a
// __syncwarp() separates the steps -- no block barrier on the chain.
// Step j+1's breakpoints and literal cost are loaded while step j
// computes, and broadcast with warp shuffles.
//
// Bound.  The inputs are ~300 MB at T=8192, L=256, KBP=12, so the bytes
// bound the card at ~0.1 ms; the sequential chain of T dependent steps
// per chain bounds this design (a few hundred cycles per step).
//
// Bit-equality with the reference: the same float order
// (cost_j + lcost) + dcost with round-to-nearest adds and no
// contraction, the literal relaxed as the first relaxation of its row
// in step order, strict < so the earliest relaxation wins ties, the
// lowest covering breakpoint k sets a length's distance, and
// relaxations past the tile's end are dropped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int W = 256;
constexpr int RING = 512;
constexpr int RMASK = RING - 1;
constexpr int MAX_KBP = 16;
constexpr int PER_THREAD = W / 32;
constexpr float BIG = 1e30f;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(32)
scan_kernel(const int* __restrict__ bp_len, const int* __restrict__ bp_dist,
            const float* __restrict__ bp_dcost,
            const float* __restrict__ litcost,
            const float* __restrict__ lcost, int* __restrict__ ce,
            float* __restrict__ cost, int tile, int kbp, int lanes) {
  __shared__ float rc[RING];
  __shared__ int re[RING];
  const int t = threadIdx.x;
  const int chain = blockIdx.x;
  const int g = chain / lanes;
  const int lane = chain - g * lanes;
  const size_t row0 = (size_t)g * tile;            // first row of the tile
  const size_t kstride = (size_t)lanes;            // between breakpoints
  const size_t rstride = (size_t)kbp * lanes;      // between rows

  for (int r = t; r < RING; r += 32) {
    rc[r] = BIG;
    re[r] = 0;
  }
  float lc[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i)
    lc[i] = lcost[((size_t)g * W + t + 32 * i) * lanes + lane];
  __syncwarp();
  if (t == 0) rc[0] = 0.0f;

  // Prefetch step 0: thread k < kbp holds breakpoint k; thread 0 the
  // literal cost.  Threads >= kbp hold length 0, which never covers.
  int nbl = 0, nbd = 0;
  float nbc = 0.0f, nlit = 0.0f;
  if (t < kbp) {
    const size_t o = row0 * rstride + t * kstride + lane;
    nbl = bp_len[o];
    nbd = bp_dist[o];
    nbc = bp_dcost[o];
  }
  if (t == 0) nlit = litcost[row0 * lanes + lane];
  __syncwarp();

  for (int j = 0; j < tile; ++j) {
    const int bl = nbl, bd = nbd;
    const float bc = nbc, lit = nlit;
    if (j + 1 < tile) {
      if (t < kbp) {
        const size_t o = (row0 + j + 1) * rstride + t * kstride + lane;
        nbl = bp_len[o];
        nbd = bp_dist[o];
        nbc = bp_dcost[o];
      }
      if (t == 0) nlit = litcost[(row0 + j + 1) * lanes + lane];
    }

    const float cj = rc[j & RMASK];
    if (t == 0) {
      // Literal edge j -> j+1 (packed value 1).
      const float lt = __fadd_rn(cj, lit);
      const int r = (j + 1) & RMASK;
      if (lt < rc[r]) {
        rc[r] = lt;
        re[r] = 1;
      }
    }

    int kl[MAX_KBP], kd[MAX_KBP];
    float kc[MAX_KBP];
#pragma unroll
    for (int k = 0; k < MAX_KBP; ++k) {
      kl[k] = __shfl_sync(FULL, bl, k);
      kd[k] = __shfl_sync(FULL, bd, k);
      kc[k] = __shfl_sync(FULL, bc, k);
    }

#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int l = 3 + t + 32 * i;
      if (j + l <= tile) {
        float dc = BIG;
        int de = l;
#pragma unroll
        for (int k = MAX_KBP - 1; k >= 0; --k) {
          if (l <= kl[k]) {
            dc = kc[k];
            de = l | (kd[k] << 9);
          }
        }
        const float nw = __fadd_rn(__fadd_rn(cj, lc[i]), dc);
        const int r = (j + l) & RMASK;
        if (nw < rc[r]) {
          rc[r] = nw;
          re[r] = de;
        }
      }
    }
    __syncwarp();
    // Row j+1 is final: emit it.  Row j's slot is free again (its next
    // use, row j+512, is first relaxed at step j+254).
    if (t == 0) {
      const int r = (j + 1) & RMASK;
      const size_t o = (row0 + j) * lanes + lane;
      ce[o] = re[r];
      cost[o] = rc[r];
    } else if (t == 1) {
      rc[j & RMASK] = BIG;
      re[j & RMASK] = 0;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int zt_scan(const void* bp_len, const void* bp_dist,
                       const void* bp_dcost, const void* litcost,
                       const void* lcost, void* ce, void* cost, int groups,
                       int tile, int kbp, int lanes, void* stream) {
  if (kbp > MAX_KBP || kbp < 0 || tile <= 0 || lanes <= 0 || groups <= 0)
    return (int)cudaErrorInvalidValue;
  scan_kernel<<<groups * lanes, 32, 0, (cudaStream_t)stream>>>(
      (const int*)bp_len, (const int*)bp_dist, (const float*)bp_dcost,
      (const float*)litcost, (const float*)lcost, (int*)ce, (float*)cost,
      tile, kbp, lanes);
  return (int)cudaGetLastError();
}
