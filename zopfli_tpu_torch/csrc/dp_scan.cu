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
// bound a 16 KiB row at under a microsecond.  What bounds any design is
// the chain of dependent steps of a row: position p+1's cost is
// min(window[p+1], cost[p] + lit[p]), and the window holds relaxations
// from every earlier position.  Only the literal and lengths 3..34 keep
// that chain tight: a relaxation of length l from position j lands on
// position j+l, so position q is final once the band of lengths
// 3+32w..34+32w has relaxed every source up to q-3-32w.  The band of
// lengths 227..258 may run ~224 steps behind the band of lengths 3..34.
//
// Design: one block of 12 warps per row (B rows spread over the SMs), no
// block-wide barrier after the set-up.  Warps hand work over through
// progress counters in shared memory (a volatile store after a release
// fence; the reader loads the counter, then fences).
//
// - Warp 0 owns the chain.  Band 0's window lives in its registers: lane
//   t owns the position q with (q - 3) mod 32 == t, so at step p it
//   relaxes length 3 + ((t - p) mod 32) in place; after step p the owner
//   of p+3 (no later source reaches it) hands its value over with one
//   shuffle, consumed two steps later.  Every lane computes position
//   p+1's cost from the merged bands 7..1, band 0 and the literal; lane 0
//   stores it.  A step touches no shared memory and takes no branch: its
//   critical path is cost + literal, a compare and a select.
// - Warps 1..7 own bands 1..7.  A band warp relaxes every source whose
//   cost is final and whose longest breakpoint reaches the band (one
//   ballot picks them from 32 sources) into one window the seven share:
//   a 64-bit key per position, relaxed with a shared atomicMin in any
//   order, and publishes how far it got.
// - Once every 16 steps warp 0 checks (from the counters it last read,
//   re-reading only when they fall short) that every band has relaxed
//   every source reaching the next 16 positions, decodes and empties
//   their keys, and loads the batch's merged values, band-0 edges and
//   literal costs into registers with 128-bit loads.
// - Warps 9..11 prepare the rows, a chunk of 32 positions each in turn,
//   from raw rows copied one chunk ahead with cp.async: each position's
//   breakpoints that raise the prefix maximum of bp_len (the lowest
//   covering breakpoint of a length is the one that raised the maximum
//   past it), its literal cost (BIG where masked), its longest length (0
//   where masked: a masked position relaxes nothing), and the band-0
//   edges stored in the row of the warp-0 lane that relaxes them (BIG
//   where nothing is relaxed).  The covering breakpoint of length 3+i is
//   the one after the popcount of raising breakpoints ending below it.
// - Warp 8 writes the outputs 32 positions at a time, coalesced: the
//   edge (length, breakpoint index) of each final position gives the
//   distance from bp_dist at the source.
// - Positions past the row's last real position relax nothing and take
//   no literal, so they are not stepped: once the bands are done, warp 0
//   merges their windows in parallel (BIG and no edge past the reach).
//
// experiments/exp_oracle_kernels.py builds it with -DZT_PHASE_CLOCKS and
// reports each warp's busy and waiting cycles.

// Bit-equality with the plain version: every relaxation is
// cost_j + where(real, lcost[l] + dcost, BIG) in that f32 order, with
// round-to-nearest adds and no contraction (-fmad=false).  The sequential
// loop keeps, per position, the cheapest relaxation and on ties the
// earliest source.  The key window orders (value, source) the same way,
// with -0.0 and 0.0 tied as under f32 < and the winner's sign bit kept in
// the key, so it holds bands 1..7's exact winner in any order of atomics.
// Band 0's sources are later than all of theirs and band 0 relaxes its
// own in order with strict <; then band 0 and last the literal each win
// only with strict <: the relaxation the loop keeps, with its value's
// bits.
// A relaxation the kernel skips or makes at cost BIG (masked source,
// uncovered length, past the row's end) costs cost_j + BIG >= BIG, never
// < a window value (which starts at BIG).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BANDS = 8;            // lengths 3+32w .. 34+32w
constexpr int NPREP = 3;            // prep warps, a chunk each in turn
constexpr int WRITE_WARP = BANDS;
constexpr int PREP_WARP = BANDS + 1;   // the first of them
constexpr int THREADS = (BANDS + 1 + NPREP) * 32;
constexpr int RING = 512;           // window, cost and row ring (>= 259)
constexpr int RM = RING - 1;
constexpr int C = 32;               // positions prepared / written at once
constexpr int TCH = 4;              // band-0 table chunks in flight
constexpr int TS = C + 4;           // table row: 16-byte aligned, and
                                    // conflict-free for 128-bit loads
constexpr int GATE = 16;            // steps per merge of bands 1..7
constexpr int SLEEP = 32;           // ns a band warp sleeps while waiting
constexpr int PUB = 4;              // steps per publication of the chain
constexpr int MAX_K = 16;
constexpr int MAX_LEN = 258;
constexpr int LEN_BITS = 9;
constexpr int LEN_MASK = (1 << LEN_BITS) - 1;
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e30f;
static_assert(C % GATE == 0 && GATE <= 32, "a merge batch is one table row");
static_assert(GATE % PUB == 0, "a whole batch ends on a publication");

// Control words: positions final (0..fin-1), positions written
// (0..wr-1), the row's last real position, sources done per band, chunks
// done per prep warp; then warp 0's merged (value, edge) of a batch's
// positions.
enum { FIN = 0, WR = 2, LASTR = 3, DONE = 4, PREPD = 12, MERGED = 16,
       CTL = 16 + 2 * 32 };
static_assert(NPREP >= 1 && NPREP <= 4, "prep counters");

// Whether chunks 0..x are all prepared: prep warp k takes chunks k,
// k + NPREP, ... in order, and has done ctl[PREPD + k] of them.
__device__ __forceinline__ bool prepared(const int* ctl, int x) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < NPREP; ++k)
    ok = ok && *(const volatile int*)(ctl + PREPD + k) >=
                   (x + 1 > k ? (x + 1 - k + NPREP - 1) / NPREP : 0);
  return ok;
}

__device__ __forceinline__ int vload(const int* p) {
  return *(const volatile int*)p;
}
__device__ __forceinline__ void vstore(int* p, int v) {
  *(volatile int*)p = v;
}
// Orders a warp's shared-memory writes before a counter it then stores,
// and a counter it loaded before the reads that follow (release and
// acquire at block scope; __threadfence_block() is a full SC fence).
__device__ __forceinline__ void fence_cta() {
  asm volatile("fence.acq_rel.cta;" ::: "memory");
}

// Bands 1..7 share one window of 64-bit keys, relaxed with atomicMin:
// the f32 value mapped to an unsigned that orders as f32 < does, with
// -0.0 and 0.0 tied (v + 0.0f), then the source position + 1, then the
// value's sign bit (a zero's sign) and the breakpoint index.  The least
// key is the lowest value and, on ties, the earliest source: what the
// sequential loop's strict < keeps.  A slot starts at BIG with source 0,
// which a relaxation costing BIG never beats.
__device__ __forceinline__ unsigned long long relax_key(float v, int src,
                                                        int k) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.0f));
  const unsigned ord = u & 0x80000000u ? ~u : u | 0x80000000u;
  return (unsigned long long)ord << 32 |
         ((unsigned)(src + 1) << 5 | (__float_as_uint(v) >> 31) << 4 |
          (unsigned)k);
}
// (value, edge) of key x at position q; BIG and no edge for an empty slot.
__device__ __forceinline__ void key_value(unsigned long long x, int q,
                                          float& v, int& m) {
  const unsigned ord = (unsigned)(x >> 32), lo = (unsigned)x;
  const unsigned u = ord & 0x80000000u ? ord & 0x7fffffffu : ~ord;
  v = __uint_as_float(u | (lo >> 4 & 1u) << 31);
  const int src = (int)(lo >> 5) - 1;
  m = src < 0 ? 0 : (q - src) | (int)(lo & 15u) << LEN_BITS;
}

// A wait that outlasts any row (2 s) is a scheduling fault: trap, so the
// launch fails instead of hanging the card.
struct Spin {
  unsigned long long t0 = 0;
  __device__ __forceinline__ void wait(int ns) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t0 == 0) t0 = t;
    else if (t - t0 > 2000000000ull) __trap();
    if (ns) __nanosleep(ns);
  }
};

// -DZT_PHASE_CLOCKS (experiments/exp_oracle_kernels.py): per block and
// warp, the clock64() cycles from the set-up's end to the warp's end
// (slot 2w) and those spent waiting on another warp (slot 2w+1).
static_assert(2 * (BANDS + 1 + NPREP) <= 24, "clock slots");
#ifdef ZT_PHASE_CLOCKS
constexpr int DBG_ROWS = 64;
__device__ unsigned long long zt_dp_clocks[DBG_ROWS][32];
#define CLK_START const long long clk_t0 = clock64(); long long clk_wait = 0
#define CLK_WAIT_BEGIN const long long clk_w0 = clock64()
#define CLK_WAIT_END clk_wait += clock64() - clk_w0
#define CLK_STORE                                                   \
  if (lane == 0 && blockIdx.x < DBG_ROWS) {                         \
    zt_dp_clocks[blockIdx.x][2 * w] = clock64() - clk_t0;           \
    zt_dp_clocks[blockIdx.x][2 * w + 1] = clk_wait;                 \
  }
// Warp 0 also: how often a band or a prep warp was late at its merges
// (slots 24-27), its merges (28) and its steps (29); the first prep
// warp's lane 0: its raising lists (30) and band-0 table (31).
#define CLK_ACC(x) long long x = 0
#define CLK_MARK(x) const long long x = clock64()
#define CLK_ADD(v, t0) v += clock64() - (t0)
#else
#define CLK_START
#define CLK_WAIT_BEGIN
#define CLK_WAIT_END
#define CLK_STORE
#define CLK_ACC(x)
#define CLK_MARK(x)
#define CLK_ADD(v, t0)
#endif

// Shared memory in words: control, the key window of bands 1..7 [RING]
// (64-bit), band 0's window (value, edge) [RING] for the masked tail, the
// final cost and edge ring [RING], the band-0 tables [TCH][32][TS]
// (edge cost, edge), per position (ring) literal cost, longest length and
// raising count, the lengths' costs [256], and the raising breakpoints
// [K][RING] as (min(len, 258) | k << 9, dcost): entry-major, so that the
// prep warp's lanes (one position each) hit distinct banks.
// Then each prep warp's two raw chunks [2] of bp_len, bp_dcost [C][KP]
// and litcost [C], rows padded to an odd stride KP for the same reason.
__host__ __device__ inline int kpad(int K) { return K | 1; }
inline size_t smem_words(int K) {
  return (size_t)CTL + 2 * RING + 2 * RING + 2 * RING + 2 * TCH * 32 * TS +
         3 * RING + 256 + 2 * (size_t)RING * K +
         NPREP * 2 * (2 * C * (size_t)kpad(K) + C);
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__global__ void __launch_bounds__(THREADS)
dp_scan_kernel(const int* __restrict__ bp_len, const int* __restrict__ bp_dist,
               const float* __restrict__ bp_dcost,
               const float* __restrict__ litcost,
               const float* __restrict__ lcost,
               const unsigned char* __restrict__ mask,
               int* __restrict__ choice_len, int* __restrict__ choice_dist,
               float* __restrict__ cost, int L, int K) {
  extern __shared__ __align__(16) int smem[];
  int* ctl = smem;
  unsigned long long* kw =
      reinterpret_cast<unsigned long long*>(ctl + CTL);    // [RING]
  float* wv = reinterpret_cast<float*>(ctl + CTL + 2 * RING);  // [RING]
  int* wm = ctl + CTL + 3 * RING;                          // [RING]
  float* ov = reinterpret_cast<float*>(wm + RING);         // [RING]
  int* om = wm + 2 * RING;                                 // [RING]
  float* te = reinterpret_cast<float*>(om + RING);         // [TCH][32][TS]
  int* tm = om + RING + TCH * 32 * TS;                     // [TCH][32][TS]
  float* plit = reinterpret_cast<float*>(tm + TCH * 32 * TS);
  int* phm = tm + TCH * 32 * TS + RING;
  int* pn = phm + RING;
  float* lcs = reinterpret_cast<float*>(pn + RING);        // [256]
  int* rk = pn + RING + 256;                               // [K][RING]
  float* rd = reinterpret_cast<float*>(rk + RING * K);     // [K][RING]
  int* raw = rk + 2 * RING * K;                 // [NPREP][2][2C*KP + C]

  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31;
  const size_t b = blockIdx.x;
  const size_t row = b * (size_t)L;
  const size_t rowc = b * ((size_t)L + 1);
  const size_t rowbp = row * K;

  // Set-up: empty windows, position 0 final at cost 0, the row's last
  // real position.
  const unsigned long long KEY0 = relax_key(BIG, -1, 0);  // empty slot
  for (int i = tid; i < RING; i += THREADS) {
    kw[i] = KEY0;
    wv[i] = BIG;
    wm[i] = 0;
  }
  for (int i = tid; i < 256; i += THREADS) lcs[i] = lcost[b * 256 + i];
  if (tid < CTL) ctl[tid] = tid == FIN ? 1 : tid == WR ? 1 : tid == LASTR ? -1 : 0;
  if (tid == 0) {
    ov[0] = 0.0f;
    om[0] = 0;
    choice_len[rowc] = 0;
    choice_dist[rowc] = 0;
  }
  __syncthreads();
  int last = -1;
  for (int i = tid; i < L; i += THREADS)
    if (mask[row + i]) last = i;
  if (last >= 0) atomicMax(ctl + LASTR, last);
  __syncthreads();
  const int lastr = ctl[LASTR];
  CLK_START;

  if (w >= PREP_WARP) {
    const int pk = w - PREP_WARP;
    // Chunk c's raw rows are copied (coalesced, cp.async) while chunk c-1
    // is prepared.  A chunk's table slot is free once warp 0 has stepped
    // the chunk TCH before; its ring slots once every band has relaxed
    // the positions a ring before.
    const int KP = kpad(K);
    const int rw = 2 * C * KP + C;
    int* myraw = raw + pk * 2 * rw;
    auto fetch = [&](int c) {
      int* r = myraw + ((c / NPREP) & 1) * rw;
      const int n = min(C, lastr + 1 - c * C);
      const size_t o = rowbp + (size_t)c * C * K;
      // Element i = q * K + k of the chunk goes to q * KP + k.
      for (int i = lane, q = K ? lane / K : 0, k = K ? lane % K : 0; i < n * K;
           i += 32) {
        cp4(r + q * KP + k, bp_len + o + i);
        cp4(r + C * KP + q * KP + k, bp_dcost + o + i);
        k += 32 % K;
        q += 32 / K + (k >= K);
        k -= k >= K ? K : 0;
      }
      if (lane < n) cp4(r + 2 * C * KP + lane, litcost + row + c * C + lane);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    CLK_ACC(clk_raise);
    CLK_ACC(clk_table);
    if (pk * C <= lastr) fetch(pk);
    for (int c = pk; c * C <= lastr; c += NPREP) {
      const int p0 = c * C;
      if ((c + NPREP) * C <= lastr) fetch(c + NPREP);
      else asm volatile("cp.async.commit_group;\n" ::: "memory");
      const bool real = p0 + lane <= lastr && mask[row + p0 + lane] != 0;
      CLK_WAIT_BEGIN;
      for (Spin sp;; sp.wait(64)) {
        bool ok = c < TCH || vload(ctl + FIN) >= (c - TCH + 1) * C + 1;
        if (p0 >= RING)
          for (int v = 1; v < BANDS; ++v)
            ok = ok && vload(ctl + DONE + v) >= p0 - RING + C;
        if (__all_sync(FULL, ok)) break;
      }
      CLK_WAIT_END;
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncwarp();
      fence_cta();
      CLK_MARK(clk_r0);
      const int p = p0 + lane;
      const int s = p & RM;
      // Lane = position: the raising breakpoints, and a bit per length
      // 3+i <= 34 that some raising breakpoint ends on.
      const int* rbl = myraw + ((c / NPREP) & 1) * rw + lane * KP;
      const float* rbc = reinterpret_cast<const float*>(rbl + C * KP);
      int pm = 2, n = 0;  // lengths <= 2 are never relaxed
      unsigned ends = 0u;
      if (p <= lastr) {
        int bv[MAX_K];  // the row, loaded before any store
#pragma unroll
        for (int k = 0; k < MAX_K; ++k) bv[k] = k < K ? rbl[k] : 0;
#pragma unroll
        for (int k = 0; k < MAX_K; ++k) {
          if (k < K) {
            const int v = bv[k];
            if (v > pm) {
              const int hi = min(v, MAX_LEN);
              rk[n * RING + s] = hi | k << LEN_BITS;
              rd[n * RING + s] = rbc[k];
              if (hi < 3 + 32) ends |= 1u << (hi - 3);
              ++n;
              pm = v;
            }
          }
        }
        pn[s] = n;
        phm[s] = real ? min(pm, MAX_LEN) : 0;
        plit[s] = real ? __int_as_float(
                             myraw[((c / NPREP) & 1) * rw + 2 * C * KP + lane])
                       : BIG;
      }
      CLK_ADD(clk_raise, clk_r0);
      __syncwarp();
      // The band-0 table: length 3+i is covered by the raising breakpoint
      // after the ones that end below it, if there is one.  Every entry is
      // loaded before any store.
      CLK_MARK(clk_t0);
      if (p <= lastr) {
        const int nc = real ? n : 0;  // a masked position has no edge
        int ek[32];
        float dc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int j = __popc(ends & ((1u << i) - 1u));
          const int jc = min(j, max(nc - 1, 0));
          ek[i] = j < nc ? rk[jc * RING + s] : -1;
          dc[i] = rd[jc * RING + s];
        }
        // An edge that is not relaxed (no covering breakpoint, or past
        // the row's end) costs BIG: cost + BIG never beats a window value.
        // Length 3+i at position r goes to row (i + r) mod 32, the warp-0
        // lane that relaxes it, column r.
        float* tv = te + (c % TCH) * 32 * TS + lane;
        int* tk = tm + (c % TCH) * 32 * TS + lane;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const bool cov = ek[i] >= 0 && 3 + i <= L - p;
          const int o = ((i + lane) & 31) * TS;
          tv[o] = cov ? __fadd_rn(lcs[i], dc[i]) : BIG;
          tk[o] = (3 + i) | (ek[i] >> LEN_BITS) << LEN_BITS;
        }
      }
      CLK_ADD(clk_table, clk_t0);
      __syncwarp();
      fence_cta();
      if (lane == 0) vstore(ctl + PREPD + pk, c / NPREP + 1);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    CLK_STORE;
#ifdef ZT_PHASE_CLOCKS
    if (lane == 0 && pk == 0 && blockIdx.x < DBG_ROWS) {
      zt_dp_clocks[blockIdx.x][30] = clk_raise;
      zt_dp_clocks[blockIdx.x][31] = clk_table;
    }
#endif
    return;
  }

  if (w == WRITE_WARP) {
    // Positions q0..q0+31 once final: cost, length and distance.
    for (int q0 = 1; q0 <= lastr + 1; q0 += C) {
      const int end = min(q0 + C - 1, lastr + 1);
      {
        CLK_WAIT_BEGIN;
        for (Spin sp; vload(ctl + FIN) <= end;) sp.wait(128);
        CLK_WAIT_END;
      }
      fence_cta();
      const int q = q0 + lane;
      if (q <= end) {
        const int m = om[q & RM];
        const int l = m & LEN_MASK;
        cost[row + q - 1] = ov[q & RM];
        choice_len[rowc + q] = l;
        choice_dist[rowc + q] =
            l >= 3 ? __ldg(bp_dist + rowbp + (size_t)(q - l) * K +
                           (m >> LEN_BITS))
                   : 0;
      }
      __syncwarp();
      fence_cta();
      if (lane == 0) vstore(ctl + WR, end + 1);
    }
    CLK_STORE;
    return;
  }

  if (w > 0) {
    // Band w: length 3 + 32w + lane.
    const int lmin = 3 + 32 * w;
    const int l = lmin + lane;
    const float lc = lcs[l - 3];
    int j = 0;
    while (j <= lastr) {
      CLK_WAIT_BEGIN;
      int f = vload(ctl + FIN);
      for (Spin sp; f <= j; f = vload(ctl + FIN)) sp.wait(SLEEP);
      const int end = min(f, lastr + 1);  // sources j..end-1 are final
      for (Spin sp; !prepared(ctl, (end - 1) / C);) sp.wait(SLEEP);
      CLK_WAIT_END;
      fence_cta();
      // 32 sources at a time: one load picks those that reach the band.
      for (; j < end; j = min(j + 32, end)) {
        unsigned todo = __ballot_sync(
            FULL, j + lane < end && phm[(j + lane) & RM] >= lmin);
        while (todo) {
          const int jj = j + __ffs(todo) - 1;
          todo &= todo - 1;
          const int s = jj & RM;
          const int n = pn[s];
          const float cj = ov[s];
          // The covering breakpoint: the lowest raising one that reaches
          // l (independent loads, highest first).
          int a = 0;
          float d = 0.0f;
          for (int e = n - 1; e >= 0; --e) {
            const int ae = rk[e * RING + s];
            const float de = rd[e * RING + s];
            if ((ae & LEN_MASK) >= l) {
              a = ae;
              d = de;
            }
          }
          if (a != 0 && l <= L - jj)
            atomicMin(kw + ((jj + l) & RM),
                      relax_key(__fadd_rn(cj, __fadd_rn(lc, d)), jj,
                                a >> LEN_BITS));
        }
        fence_cta();
        if (lane == 0) vstore(ctl + DONE + w, min(j + 32, end));
      }
    }
    CLK_STORE;
    return;
  }

  // Warp 0: band 0 and the chain.  Band 0's window is in registers: lane
  // t owns the position q with (q - 3) mod 32 == t, so at step p it
  // relaxes length 3 + ((t - p) mod 32) in place.  Lane p mod 32 owns
  // p+3, which step p relaxes last: after the step it hands the value
  // over (one shuffle) and takes p+35.  f1 and f2 are band 0's final
  // values of positions p+1 and p+2.
  float cp = 0.0f;   // position p's final cost
  int seen = INT_MIN;  // the control word lane watches, as last read
  float rv = BIG, f1v = BIG, f2v = BIG;
  int rm = 0, f1m = 0, f2m = 0;
  CLK_ACC(clk_merge);
  CLK_ACC(clk_steps);
#ifdef ZT_PHASE_CLOCKS
  long long late_band = 0, late_band1 = 0, late_prep = 0, gates = 0;
#endif
  for (int p0 = 0; p0 <= lastr; p0 += GATE) {
    // Bands 7..1 of positions p0+1..p0+GATE, once every band has relaxed
    // every source that reaches them, merged into lane i's (gv, gm).
    const int qmax = min(p0 + GATE, lastr + 1);
    // Lane i watches control word i: lanes DONE+1..DONE+7 the bands (each
    // must have relaxed every source that reaches qmax), PREPD+k the prep
    // warps (the chunks of positions up to p0+GATE-1), WR the writer (the
    // ring slots this batch reuses).  A lane re-reads its word only when
    // the value it last read does not cover this batch.
    const int cx = min(p0 + GATE - 1, lastr) / C;
    const int need =
        lane > DONE && lane < DONE + BANDS ? qmax - 2 - 32 * (lane - DONE)
        : lane >= PREPD && lane < PREPD + NPREP
            ? (cx + 1 > lane - PREPD
                   ? (cx + 1 - (lane - PREPD) + NPREP - 1) / NPREP : 0)
        : lane == WR ? qmax + 1 - RING : INT_MIN;
    CLK_WAIT_BEGIN;
    if (!__all_sync(FULL, seen >= need)) {
      for (Spin sp;; sp.wait(0)) {
        seen = vload(ctl + lane);
#ifdef ZT_PHASE_CLOCKS
        if (sp.t0 == 0) {  // first read: who is late
          const unsigned late = __ballot_sync(FULL, seen < need);
          late_band1 += (late >> (DONE + 1)) & 1u;
          late_band += (late >> (DONE + 1) & 0x7fu) != 0;
          late_prep += (late >> PREPD & ((1u << NPREP) - 1)) != 0;
          ++gates;
        }
#endif
        if (__all_sync(FULL, seen >= need)) break;
      }
      fence_cta();
    }
    CLK_WAIT_END;
    CLK_MARK(clk_m0);
    // Lane i < GATE decodes position p0+1+i's key and empties the slot;
    // every lane then takes the batch's merged values into registers, so
    // no step waits on a shuffle.
    float* mgv = reinterpret_cast<float*>(ctl + MERGED);
    int* mgm = ctl + MERGED + 32;
    if (lane < GATE) {
      float gv = BIG;
      int gm = 0;
      if (p0 + 1 + lane <= qmax) {
        const int q = p0 + 1 + lane;
        key_value(kw[q & RM], q, gv, gm);
        kw[q & RM] = KEY0;
      }
      mgv[lane] = gv;
      mgm[lane] = gm;
    }
    __syncwarp();
    float gvv[GATE];
    int gmm[GATE];
#pragma unroll
    for (int i = 0; i < GATE; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(mgv + i);
      const int4 b = *reinterpret_cast<const int4*>(mgm + i);
      gvv[i] = a.x, gvv[i + 1] = a.y, gvv[i + 2] = a.z, gvv[i + 3] = a.w;
      gmm[i] = b.x, gmm[i + 1] = b.y, gmm[i + 2] = b.z, gmm[i + 3] = b.w;
    }
    // The batch's table entries (lane t's row: its length at each step)
    // and literal costs, into registers: no step waits on shared memory.
    const int r0 = p0 & (C - 1);
    const int toff = ((p0 / C) % TCH) * 32 * TS + lane * TS + r0;
    const int n = qmax - p0;  // steps of this batch
    float ev[GATE], litv[GATE];
    int ekv[GATE];
#pragma unroll
    for (int i = 0; i < GATE; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(te + toff + i);
      const int4 b = *reinterpret_cast<const int4*>(tm + toff + i);
      ev[i] = a.x, ev[i + 1] = a.y, ev[i + 2] = a.z, ev[i + 3] = a.w;
      ekv[i] = b.x, ekv[i + 1] = b.y, ekv[i + 2] = b.z, ekv[i + 3] = b.w;
    }
#pragma unroll
    for (int i = 0; i < GATE; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(plit + ((p0 + i) & RM));
      litv[i] = a.x, litv[i + 1] = a.y, litv[i + 2] = a.z, litv[i + 3] = a.w;
    }
    CLK_ADD(clk_merge, clk_m0);
    CLK_MARK(clk_s0);
    // Step p0+i: relax band 0 from it, then finalize position p0+i+1.
    auto step = [&](int i) {
      const float nw = __fadd_rn(cp, ev[i]);
      if (nw < rv) {
        rv = nw;
        rm = ekv[i];
      }
      float bv = gvv[i];
      int bm = gmm[i];
      if (f1v < bv) {
        bv = f1v;
        bm = f1m;
      }
      const float ln = __fadd_rn(cp, litv[i]);
      if (ln < bv) {
        bv = ln;
        bm = 1;
      }
      cp = bv;
      if (lane == 0) {
        ov[(p0 + i + 1) & RM] = bv;
        om[(p0 + i + 1) & RM] = bm;
      }
      // Position p0+i+3 is final for band 0: its owner hands it over.
      const int own = (r0 + i) & 31;
      f1v = f2v;
      f1m = f2m;
      f2v = __shfl_sync(FULL, rv, own);
      f2m = __shfl_sync(FULL, rm, own);
      if (lane == own) {
        rv = BIG;
        rm = 0;
      }
    };
    auto publish = [&](int p) {  // positions 0..p+1 are final
      __syncwarp();
      fence_cta();
      if (lane == 0) vstore(ctl + FIN, p + 2);
    };
    if (n == GATE) {
      // A whole batch: no branch, publications at fixed steps.
#pragma unroll
      for (int i = 0; i < GATE; ++i) {
        step(i);
        if (i % PUB == PUB - 1) publish(p0 + i);
      }
    } else {
#pragma unroll
      for (int i = 0; i < GATE; ++i)
        if (i < n) step(i);
      publish(lastr);
    }
    CLK_ADD(clk_steps, clk_s0);
  }
#ifdef ZT_PHASE_CLOCKS
  if (lane == 0 && blockIdx.x < DBG_ROWS) {
    zt_dp_clocks[blockIdx.x][28] = clk_merge;
    zt_dp_clocks[blockIdx.x][29] = clk_steps;
    zt_dp_clocks[blockIdx.x][24] = late_band1;
    zt_dp_clocks[blockIdx.x][25] = late_band;
    zt_dp_clocks[blockIdx.x][26] = late_prep;
    zt_dp_clocks[blockIdx.x][27] = gates;
  }
#endif
  // Band 0's window into its ring, for the tail: positions lastr+2 on.
  if (lane == 0) {
    wv[(lastr + 2) & RM] = f1v;
    wm[(lastr + 2) & RM] = f1m;
    wv[(lastr + 3) & RM] = f2v;
    wm[(lastr + 3) & RM] = f2m;
  }
  const int q_own = lastr + 4 + ((lane - lastr - 1) & 31);
  wv[q_own & RM] = rv;
  wm[q_own & RM] = rm;
  __syncwarp();

  // The masked tail: positions lastr+2..L relax nothing and take no
  // literal; their windows are final once every band is done.
  for (Spin sp;; sp.wait(64)) {
    bool ok = true;
    if (lane >= 1 && lane < BANDS)
      ok = vload(ctl + DONE + lane) >= lastr + 1;
    if (__all_sync(FULL, ok)) break;
  }
  fence_cta();
  for (int q = lastr + 2 + lane; q <= L; q += 32) {
    float bv = BIG;
    int bm = 0;
    if (q <= lastr + MAX_LEN) {  // bands 7..1, then band 0
      const int s = q & RM;
      key_value(kw[s], q, bv, bm);
      if (wv[s] < bv) {
        bv = wv[s];
        bm = wm[s];
      }
    }
    const int l = bm & LEN_MASK;
    cost[row + q - 1] = bv;
    choice_len[rowc + q] = l;
    choice_dist[rowc + q] =
        l >= 3 ? __ldg(bp_dist + rowbp + (size_t)(q - l) * K + (bm >> LEN_BITS))
               : 0;
  }
  CLK_STORE;
}

}  // namespace

extern "C" int zt_dp_scan(const void* bp_len, const void* bp_dist,
                          const void* bp_dcost, const void* litcost,
                          const void* lcost, const void* mask,
                          void* choice_len, void* choice_dist, void* cost,
                          int B, int L, int K, void* stream) {
  if (B <= 0 || L <= 0 || K < 0 || K > MAX_K)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * smem_words(K);
  cudaError_t err = cudaFuncSetAttribute(
      dp_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dp_scan_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)bp_len, (const int*)bp_dist, (const float*)bp_dcost,
      (const float*)litcost, (const float*)lcost,
      (const unsigned char*)mask, (int*)choice_len, (int*)choice_dist,
      (float*)cost, L, K);
  return (int)cudaGetLastError();
}

#ifdef ZT_PHASE_CLOCKS
// The clocks of rows 0..n-1 (n <= 64), 32 words a row.
extern "C" int zt_dp_scan_debug_read(void* out, int n) {
  return (int)cudaMemcpyFromSymbol(
      out, zt_dp_clocks, sizeof(unsigned long long) * 32 * (size_t)n);
}
#endif
