// Batched min-plus forward DP of the squeeze parse, with distances
// (zopfli GetBestLengths), for Hopper.
//
// Replaces no Pallas kernel: the JAX package runs this DP as one XLA
// lax.scan over all positions (zopfli_tpu/ops/dp.py:68-139,
// `squeeze_scan`).  Same contract as squeeze_scan_plain in
// zopfli_tpu_torch/ops/dp.py:
//   bp_len, bp_dist (B, L, K) int32; bp_dcost (B, L, K) float32;
//   litcost (B, L) float32; lcost (B, 256) float32; mask (B, L) bool
//   -> choice_len, choice_dist (B, L+1) int32 (column p = the edge into
//      position p, column 0 = 0), cost (B, L) float32 (column j =
//      position j+1's cost).
//
// Bound.  Counted as the contract counts, the inputs are read once and
// each position does 256 relaxations of 3 f32 operations, so the bytes
// bound a 16 KiB row at under a microsecond.  What bounds this design is the chain
// of L dependent steps of a row: step j+1 reads position j+1's final
// cost, which step j may still relax.  A simple design, right first:
//
// - One block of 256 threads per row; thread t owns length 3 + t and its
//   length cost in a register.
// - The live window (the current position and the 258 positions its
//   matches reach) is a ring of 512 slots in shared memory: cost, chosen
//   length, chosen distance.  Step j relaxes slots j+1 (the literal,
//   thread 0) and j+3..j+258 (one per thread); thread 0 then writes
//   position j+1's final cost and edge (no later step touches it) and
//   clears the slot of position j+259.  One barrier per step.
// - The breakpoints, literal costs and mask of 32 positions at a time are
//   staged in shared memory, with each position's longest breakpoint;
//   a thread whose length is longer has no edge (most threads at most
//   positions), the others find the lowest breakpoint k with
//   0 < l <= bp_len[k] -- the one the reference's descending-k overwrite
//   keeps (dp.py:104-107) -- by a scan of at most K slots.
//
// Bit-equality with the plain version: the same float order
// where(real, lcost[l] + dcost, BIG) then cost_j + edge, the literal
// cost_j + where(real, lit, BIG), round-to-nearest adds and no
// contraction (-fmad=false), and strict < .

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int W = 256;          // lengths 3..258, one per thread
constexpr int RING = 512;       // window slots (>= 259, a power of two)
constexpr int RMASK = RING - 1;
constexpr int MAX_K = 16;
constexpr int CHUNK = 32;       // positions staged at once
constexpr int REACH = 259;      // step j+1 relaxes up to position j+259
constexpr float BIG = 1e30f;

__global__ void __launch_bounds__(W)
dp_scan_kernel(const int* __restrict__ bp_len, const int* __restrict__ bp_dist,
               const float* __restrict__ bp_dcost,
               const float* __restrict__ litcost,
               const float* __restrict__ lcost,
               const unsigned char* __restrict__ mask,
               int* __restrict__ choice_len, int* __restrict__ choice_dist,
               float* __restrict__ cost, int L, int K) {
  __shared__ float w[RING];
  __shared__ int cl[RING];
  __shared__ int cd[RING];
  __shared__ int sbl[CHUNK * MAX_K];
  __shared__ int sbd[CHUNK * MAX_K];
  __shared__ float sbc[CHUNK * MAX_K];
  __shared__ int smax[CHUNK];
  __shared__ float slit[CHUNK];
  __shared__ unsigned char sreal[CHUNK];

  const int t = threadIdx.x;
  const int l = t + 3;
  const size_t b = blockIdx.x;
  const float lc = lcost[b * W + t];
  const size_t row = b * (size_t)L;        // row start of litcost/mask/cost
  const size_t rowc = b * ((size_t)L + 1); // row start of the choices
  const size_t rowbp = row * K;

  for (int i = t; i < RING; i += W) {
    w[i] = i == 0 ? 0.0f : BIG;
    cl[i] = 0;
    cd[i] = 0;
  }
  if (t == 0) {
    choice_len[rowc] = 0;
    choice_dist[rowc] = 0;
  }

  for (int c0 = 0; c0 < L; c0 += CHUNK) {
    const int n = min(CHUNK, L - c0);
    __syncthreads();  // every step of the previous chunk is done
    for (int i = t; i < n * K; i += W) {
      const size_t o = rowbp + (size_t)c0 * K + i;
      sbl[i] = bp_len[o];
      sbd[i] = bp_dist[o];
      sbc[i] = bp_dcost[o];
    }
    if (t < n) {
      slit[t] = litcost[row + c0 + t];
      sreal[t] = mask[row + c0 + t];
      const int* p = bp_len + rowbp + (size_t)(c0 + t) * K;
      int m = 0;
      for (int k = 0; k < K; ++k) m = max(m, p[k]);
      smax[t] = m;
    }
    for (int r = 0; r < n; ++r) {
      __syncthreads();  // the previous step's relaxations are visible
      const int j = c0 + r;
      const float cj = w[j & RMASK];
      const bool real = sreal[r] != 0;

      float dc = BIG;
      int dist = 0;
      const int* bl = sbl + r * K;
      for (int k = 0; l <= smax[r] && k < K; ++k) {
        const int blk = bl[k];
        if (blk > 0 && l <= blk) {
          dc = sbc[r * K + k];
          dist = sbd[r * K + k];
          break;
        }
      }
      float edge = lc + dc;
      edge = real ? edge : BIG;
      const float nw = cj + edge;
      const int s = (j + l) & RMASK;
      if (nw < w[s]) {
        w[s] = nw;
        cl[s] = l;
        cd[s] = dist;
      }

      if (t == 0) {
        const int s1 = (j + 1) & RMASK;
        const float ln = cj + (real ? slit[r] : BIG);
        float c1 = w[s1];
        int l1 = cl[s1], d1 = cd[s1];
        if (ln < c1) {
          c1 = ln;
          l1 = 1;
          d1 = 0;
          w[s1] = c1;
          cl[s1] = 1;
          cd[s1] = 0;
        }
        // Position j+1 is final: later steps relax only j+2 onwards.
        choice_len[rowc + j + 1] = l1;
        choice_dist[rowc + j + 1] = d1;
        cost[row + j] = c1;
        const int s2 = (j + REACH) & RMASK;
        w[s2] = BIG;
        cl[s2] = 0;
        cd[s2] = 0;
      }
    }
  }
}

}  // namespace

extern "C" int zt_dp_scan(const void* bp_len, const void* bp_dist,
                          const void* bp_dcost, const void* litcost,
                          const void* lcost, const void* mask,
                          void* choice_len, void* choice_dist, void* cost,
                          int B, int L, int K, void* stream) {
  if (B <= 0 || L <= 0 || K < 0 || K > MAX_K)
    return (int)cudaErrorInvalidValue;
  dp_scan_kernel<<<B, W, 0, (cudaStream_t)stream>>>(
      (const int*)bp_len, (const int*)bp_dist, (const float*)bp_dcost,
      (const float*)litcost, (const float*)lcost,
      (const unsigned char*)mask, (int*)choice_len, (int*)choice_dist,
      (float*)cost, L, K);
  return (int)cudaGetLastError();
}
