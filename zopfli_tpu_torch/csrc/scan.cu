// Forward min-plus squeeze DP (zopfli GetBestLengths) for Hopper.
//
// Replaces the Pallas kernel zopfli_tpu/ops/scan_kernel.py::make_scan
// (pallas_call at scan_kernel.py:163).  Same contract as scan_plain in
// zopfli_tpu_torch/ops/scan_kernel.py:
//   bp_len, bp_dist (G*T, KBP, L) int32; bp_dcost (G*T, KBP, L) float32;
//   litcost (G*T, L) float32; lcost (G*256, L) float32
//   -> ce (G*T, L) int32 packed edges (len | dist << 9), cost (G*T, L) f32.
//
// Bound.  The inputs are ~300 MB at T=8192, L=256, KBP=12, so the bytes
// bound the card at ~0.1 ms.  What bounds this design is the chain of T
// dependent steps per (group, lane) chain: step j+1 reads the final cost
// of position j+1, which step j may still relax.  One warp runs the
// steps of a chain, and a lone warp issues about one instruction every
// few cycles, so the time is T times the instructions of one step.  The
// design takes everything it can off that warp, and keeps the loads in
// whole segments of adjacent lanes:
//
// - A block takes CHAINS=4 adjacent lanes: one loading warp, and per lane
//   a preparing warp and a DP warp.  The loading warp copies each row's 16
//   bytes (4 lanes) of every input into a 3-stage ring of C=32-row chunks
//   with cp.async (4-byte copies where lanes % 4 != 0).  Lanes that read
//   only their own 4 bytes of each sector drift apart and fetch the same
//   sectors again from DRAM: 2.17 ms against 1.46 ms for lane-major
//   inputs on the H100 (experiments/exp_port_kernels.py); the 16-byte
//   copies take 1.46 ms on the contract's layout.  The preparing warp
//   turns a raw chunk into one of two prepared buffers for its DP warp.
//   Shared-memory mbarriers hand stages and buffers over once per chunk,
//   so a fast chain waits only when it is a whole ring ahead of the
//   block's slowest.
// - Preparing a row: walking k upwards, a breakpoint that raises the
//   prefix maximum pm of bp_len covers exactly the lengths
//   (pm, bp_len[k]], and the lowest covering k -- the one the reference's
//   descending-k overwrite keeps -- is the one that raised the maximum
//   past l.  The table holds the covering (dcost, edge) of lengths 3..34
//   per row; a row that reaches past 34 also keeps its covering
//   breakpoints, highest first.  A length no breakpoint covers would cost
//   (c + lcost) + BIG >= BIG, never < a window value (those start at BIG),
//   so skipping it changes no bit.
// - A step: the cost of position j is carried in a register (its final
//   value is min(window[j], cost[j-1] + lit[j-1]), as matches land >= 3
//   rows ahead); thread t relaxes length 3 + t from the table, its length
//   cost in a register; a row reaching past 34 (4% of rows on the repo's
//   text, experiments/exp_port_kernels.py) also relaxes lengths
//   3 + t + 32i from its breakpoints, out of line.  Every window load of a
//   step comes before its stores (the rows a step relaxes are distinct),
//   and the next step's row data is loaded one step ahead.
// - The live window is 320 rows in shared memory, row k = position
//   c0 + k of the chunk at c0: a full chunk's 32 steps are unrolled, so
//   every window and table address is a constant offset.  At the chunk's
//   end each thread writes one finished row of ce and cost and the window
//   slides down 32 rows.
// - When the grid has no more blocks than the card has SMs, a block asks
//   for over half an SM's shared memory, so that the DP warps of two
//   blocks never share an SM's schedulers while other SMs idle.

// Bit-equality with the reference: the same float order
// (cost_j + lcost) + dcost with round-to-nearest adds and no
// contraction (-fmad=false), the literal relaxed first in its row (no
// match of the same step touches row j+1), strict < so the earliest
// relaxation wins ties, the lowest covering breakpoint k sets a length's
// distance, and relaxations past the tile's end are dropped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int W = 256;            // lengths 3..258
constexpr int MAX_LEN = W + 2;
constexpr int LEN_BITS = 9;
constexpr int LEN_MASK = (1 << LEN_BITS) - 1;
constexpr int WIN = 320;          // window rows c0 .. c0+319 of a chunk
constexpr int MAX_KBP = 16;
constexpr int CHAINS = 4;         // chains (adjacent lanes) per block
// A DP and a preparing warp per chain, and one loading warp per block.
constexpr int THREADS = (2 * CHAINS + 1) * 32;
constexpr int C = 32;             // rows per chunk: one per thread
constexpr int PER_THREAD = W / 32;
constexpr int RAW = 3;            // raw stages in flight, per block
constexpr int PREP = 2;           // prepared chunk buffers
constexpr int SHORT = 3 + 31;     // lengths 3..34: one a thread, tabled
constexpr int TS = C + 1;         // padded table row: conflict-free both ways
constexpr float BIG = 1e30f;
static_assert(WIN >= C + MAX_LEN && WIN % 32 == 0, "window too small");
static_assert(CHAINS * 4 == 16, "a 16-byte copy carries the block's lanes");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
// Arrive on b once every cp.async this thread issued so far has landed.
__device__ __forceinline__ void cp_arrive(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared.b64 %0, [%1];\n"
               : "=l"(state)
               : "r"(smem_u32(b))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
}

// A block's shared memory, in words: mbarriers raw_full[RAW],
// raw_empty[RAW]; RAW raw stages; then per chain: mbarriers full[PREP],
// empty[PREP], the window (cost, edge), the lane's length costs [W] and
// PREP prepared chunks.
//
// A raw stage holds the block's CHAINS lanes: bp_len, bp_dist, bp_dcost
// as [C][RS] with [k][lane] inside, and litcost as [C][CHAINS]; rows are
// 16-byte aligned for the copies.  A prepared chunk: the covering
// (dcost, edge) of lengths 3..34 as [l - 3][row] (edge 0 = not covered),
// each row's longest length, its count of kept breakpoints, its literal
// cost, and the kept breakpoints of the rows that reach past 34 -- entry e
// of row r at [e][r] as (dist << 9 | min(len, 259), dcost), highest first.
__host__ __device__ inline int raw_row(int kbp) { return CHAINS * (kbp + 1); }
__host__ __device__ inline int raw_words(int kbp) {
  return 3 * C * raw_row(kbp) + C * CHAINS;
}
__host__ __device__ inline int prep_words(int kbp) {
  return 2 * 32 * TS + 3 * C + 2 * kbp * C;
}
__host__ __device__ inline int chain_words(int kbp) {
  const int w = 4 * PREP + 2 * WIN + W + PREP * prep_words(kbp);
  return (w + 3) & ~3;  // keeps every chain's mbarriers 16-byte aligned
}
__host__ __device__ inline int chains_offset(int kbp) {
  return 4 * RAW + RAW * raw_words(kbp);
}
inline size_t smem_bytes(int kbp) {
  return sizeof(int) *
         ((size_t)chains_offset(kbp) + (size_t)CHAINS * chain_words(kbp));
}

struct Prep {
  float* tdc;
  int* tde;
  int* hm;
  int* cn;
  float* lit;
  int* ca;
  float* cc;
};

__device__ __forceinline__ Prep prep_at(int* p, int kbp) {
  Prep q;
  q.tdc = reinterpret_cast<float*>(p);
  q.tde = p + 32 * TS;
  q.hm = q.tde + 32 * TS;
  q.cn = q.hm + C;
  q.lit = reinterpret_cast<float*>(q.cn + C);
  q.ca = q.cn + 2 * C;
  q.cc = reinterpret_cast<float*>(q.ca + kbp * C);
  return q;
}

// Issue the loads of one chunk for the block's lanes lane0 .. lane0+nl-1:
// thread t copies row t, 16 bytes (CHAINS lanes) at a time where the
// layout allows (vec), else lane by lane; then arrive on full once they
// have landed.
__device__ __forceinline__ void load_chunk(
    int* st, uint64_t* full, const int* __restrict__ bp_len,
    const int* __restrict__ bp_dist, const float* __restrict__ bp_dcost,
    const float* __restrict__ litcost, size_t grow, bool row_ok, int kbp,
    int lanes, int lane0, int nl, bool vec, int t) {
  const int rs = raw_row(kbp);
  if (row_ok) {
    const size_t o = grow * kbp * lanes + lane0;
    int* s = st + t * rs;
    int* sl = st + 3 * C * rs + t * CHAINS;
    const size_t ol = grow * lanes + lane0;
    if (vec) {
      for (int k = 0; k < kbp; ++k) {
        const size_t ok = o + (size_t)k * lanes;
        cp16(s + k * CHAINS, bp_len + ok);
        cp16(s + C * rs + k * CHAINS, bp_dist + ok);
        cp16(s + 2 * C * rs + k * CHAINS, bp_dcost + ok);
      }
      cp16(sl, litcost + ol);
    } else {
      for (int p = 0; p < nl; ++p) {
        for (int k = 0; k < kbp; ++k) {
          const size_t ok = o + (size_t)k * lanes + p;
          cp4(s + k * CHAINS + p, bp_len + ok);
          cp4(s + C * rs + k * CHAINS + p, bp_dist + ok);
          cp4(s + 2 * C * rs + k * CHAINS + p, bp_dcost + ok);
        }
        cp4(sl + p, litcost + ol + p);
      }
    }
  }
  cp_arrive(full);
}

// Prepare row t of lane p of a raw stage (see Prep): element k of the
// row's bp_len is bl[k * CHAINS].
__device__ __forceinline__ void prepare_row(const int* st, Prep q, int kbp,
                                            int p, int t) {
  const int rs = raw_row(kbp);
  const int* bl = st + t * rs + p;
  unsigned mask = 0;
  int pm = 2;  // lengths <= 2 are never relaxed
  int l = 3;
  for (int k = 0; k < kbp; ++k) {
    const int v = bl[k * CHAINS];
    if (v > pm) {
      mask |= 1u << k;
      const float dk = __int_as_float(bl[2 * C * rs + k * CHAINS]);
      const int ek = (int)((unsigned)bl[C * rs + k * CHAINS] << LEN_BITS);
      for (const int hi = min(v, SHORT); l <= hi; ++l) {
        q.tdc[(l - 3) * TS + t] = dk;
        q.tde[(l - 3) * TS + t] = l | ek;
      }
      pm = v;
    }
  }
  for (; l <= SHORT; ++l) q.tde[(l - 3) * TS + t] = 0;
  q.hm[t] = min(pm, MAX_LEN + 1);
  q.lit[t] = __int_as_float(st[3 * C * rs + t * CHAINS + p]);
  int e = 0;
  if (pm > SHORT) {
    while (mask) {
      const int k = 31 - __clz(mask);
      mask ^= 1u << k;
      const unsigned d = (unsigned)bl[C * rs + k * CHAINS] << LEN_BITS;
      q.ca[e * C + t] =
          (int)(d | (unsigned)min(bl[k * CHAINS], MAX_LEN + 1));
      q.cc[e * C + t] = __int_as_float(bl[2 * C * rs + k * CHAINS]);
      ++e;
    }
  }
  q.cn[t] = e;
}

// Relax step jj's matches of lengths past 34 -- thread t's lengths
// 3 + t + 32i for 1 <= i < ni -- from its row's n kept breakpoints.
// Window row jj + l is position c0 + jj + l.  Every window load comes
// before any store; the rows a step relaxes are distinct.  Out of line:
// 4% of steps on text take it.
__device__ __noinline__ void relax_long(float* wc, int* we, const int* ca,
                                        const float* cc, const float* lcs,
                                        int t, int jj, int n, float cur,
                                        int lim, int ni) {
  float rv[PER_THREAD], dc[PER_THREAD];
  int de[PER_THREAD];
#pragma unroll
  for (int i = 1; i < PER_THREAD; ++i) {
    if (i < ni) rv[i] = wc[jj + 3 + t + 32 * i];
    de[i] = 0;
    dc[i] = 0.0f;
  }
  // Highest breakpoint first; a lower one overwrites the lengths it
  // covers, so each length ends with its lowest covering k.
  for (int e = 0; e < n; ++e) {
    const int a = ca[e * C + jj];
    const float cst = cc[e * C + jj];
    const int h = a & LEN_MASK;
    const int dbits = a & ~LEN_MASK;
#pragma unroll
    for (int i = 1; i < PER_THREAD; ++i) {
      const int l = 3 + t + 32 * i;
      if (l <= h) {
        dc[i] = cst;
        de[i] = l | dbits;
      }
    }
  }
#pragma unroll
  for (int i = 1; i < PER_THREAD; ++i) {
    const int l = 3 + t + 32 * i;
    if (i < ni && de[i] != 0 && l <= lim) {
      const float nw = __fadd_rn(__fadd_rn(cur, lcs[l - 3]), dc[i]);
      if (nw < rv[i]) {
        wc[jj + l] = nw;
        we[jj + l] = de[i];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
scan_kernel(const int* __restrict__ bp_len, const int* __restrict__ bp_dist,
            const float* __restrict__ bp_dcost,
            const float* __restrict__ litcost,
            const float* __restrict__ lcost, int* __restrict__ ce,
            float* __restrict__ cost, int tile, int kbp, int lanes,
            int vec) {
  extern __shared__ __align__(16) int smem[];
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int lane0 = blockIdx.x * CHAINS;
  const int nl = min(CHAINS, lanes - lane0);  // lanes of this block
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* raw_empty = raw_full + RAW;
  int* raws = smem + 4 * RAW;
  const int ch = w % CHAINS;  // the chain of a DP or preparing warp
  const int lane = lane0 + ch;
  int* base = smem + chains_offset(kbp) + (size_t)ch * chain_words(kbp);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + PREP;
  float* wc = reinterpret_cast<float*>(base + 4 * PREP);  // [WIN]
  int* we = base + 4 * PREP + WIN;                         // [WIN]
  float* lcs = reinterpret_cast<float*>(we + WIN);         // [W]
  int* preps = we + WIN + W;
  if (w < CHAINS && t < PREP) {
    mbar_init(full + t, 1);
    mbar_init(empty + t, 1);
  }
  if (w == 2 * CHAINS && t < RAW) {
    mbar_init(raw_full + t, 32);   // every loading thread's copies
    mbar_init(raw_empty + t, nl);  // every preparing warp of the block
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  const int g = blockIdx.y;
  const size_t row0 = (size_t)g * tile;  // first row of the tile
  const int nchunks = (tile + C - 1) / C;
  const int rw = raw_words(kbp);

  if (w == 2 * CHAINS) {
    // Loading warp: chunk c into raw stage c % RAW once every preparing
    // warp has released it.
    for (int c = 0; c < nchunks; ++c) {
      const int s = c % RAW;
      if (c >= RAW) mbar_wait(raw_empty + s, ((c / RAW) - 1) & 1);
      load_chunk(raws + s * rw, raw_full + s, bp_len, bp_dist, bp_dcost,
                 litcost, row0 + (size_t)c * C + t, c * C + t < tile, kbp,
                 lanes, lane0, nl, vec != 0, t);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // none left in flight
    return;
  }
  if (ch >= nl) return;  // no barrier follows

  if (w >= CHAINS) {
    // Preparing warp: raw stage -> this chain's prepared buffer.
    for (int c = 0; c < nchunks; ++c) {
      const int s = c % PREP, r = c % RAW;
      if (c >= PREP) mbar_wait(empty + s, ((c / PREP) - 1) & 1);
      mbar_wait(raw_full + r, (c / RAW) & 1);
      if (c * C + t < tile)
        prepare_row(raws + r * rw, prep_at(preps + s * prep_words(kbp), kbp),
                    kbp, ch, t);
      __syncwarp();
      if (t == 0) {
        mbar_arrive(raw_empty + r);
        mbar_arrive(full + s);
      }
    }
    return;
  }

  for (int i = t; i < WIN; i += 32) {
    wc[i] = BIG;
    we[i] = 0;
  }
  for (int l = t; l < W; l += 32)
    lcs[l] = lcost[((size_t)g * W + l) * lanes + lane];
  const float lc0 = lcs[t];  // thread t's short length is 3 + t
  float* mywc = wc + 3 + t;
  int* mywe = we + 3 + t;

  float cj = 0.0f;  // final cost of position j (position 0 costs 0)
  for (int c = 0; c < nchunks; ++c) {
    const int c0 = c * C;
    const int nrows = min(C, tile - c0);
    const int s = c % PREP;
    const Prep q = prep_at(preps + s * prep_words(kbp), kbp);
    __syncwarp();
    mbar_wait(full + s, (c / PREP) & 1);

    // Window row k is position c0 + k.  Step jj's row data is loaded one
    // step ahead; the index wraps so that no load is guarded.
    const float* mydc = q.tdc + t * TS;
    const int* myde = q.tde + t * TS;
    float dc = mydc[0], lit = q.lit[0];
    int de = myde[0], hmax = q.hm[0];
    auto step = [&](int jj) {
      const float old1 = wc[jj + 1];
      const float rv0 = mywc[jj];
      const int jn = (jj + 1) & (C - 1);
      const float dcn = mydc[jn], litn = q.lit[jn];
      const int den = myde[jn], hmaxn = q.hm[jn];

      // Literal edge j -> j+1 (packed value 1), first in its row.
      const float lt = __fadd_rn(cj, lit);
      const bool litwin = lt < old1;
      const float cur = cj;
      cj = litwin ? lt : old1;

      // Length 3 + t: the row's covering breakpoint is tabled.
      const int lim = min(MAX_LEN, tile - c0 - jj);  // j + l <= tile
      const float nw = __fadd_rn(__fadd_rn(cur, lc0), dc);
      if (de != 0 && 3 + t <= lim && nw < rv0) {
        mywc[jj] = nw;
        mywe[jj] = de;
      }
      // Rare: matches past 34 bytes.
      const int top = min(hmax, lim);
      if (top > SHORT)
        relax_long(wc, we, q.ca, q.cc, lcs, t, jj, q.cn[jj], cur, lim,
                   (top + 29) >> 5);
      if (t == 0 && litwin) {
        wc[jj + 1] = lt;
        we[jj + 1] = 1;
      }
      dc = dcn;
      de = den;
      hmax = hmaxn;
      lit = litn;
      __syncwarp();
    };
    if (nrows == C) {
      // Unrolled, every window and table address is a constant offset.
#pragma unroll
      for (int jj = 0; jj < C; ++jj) step(jj);
    } else {
      for (int jj = 0; jj < nrows; ++jj) step(jj);
    }
    // Done reading this prepared chunk: hand it back.
    if (t == 0) mbar_arrive(empty + s);

    // Positions c0+1 .. c0+32 (window rows 1..32) are final: write them
    // (row = position - 1), then slide the window down one chunk; thread
    // t moves column t, so the slide needs no barrier inside.
    const float fc = wc[1 + t];
    const int fe = we[1 + t];
    if (c0 + t < tile) {
      const size_t o = (row0 + c0 + t) * lanes + lane;
      ce[o] = fe;
      cost[o] = fc;
    }
    __syncwarp();
#pragma unroll
    for (int k = t; k < WIN; k += 32) {
      const bool keep = k + C < WIN;
      wc[k] = keep ? wc[k + C] : BIG;
      we[k] = keep ? we[k + C] : 0;
    }
  }
}

}  // namespace

extern "C" size_t zt_scan_smem_bytes(int kbp) { return smem_bytes(kbp); }

extern "C" int zt_scan(const void* bp_len, const void* bp_dist,
                       const void* bp_dcost, const void* litcost,
                       const void* lcost, void* ce, void* cost, int groups,
                       int tile, int kbp, int lanes, void* stream) {
  if (kbp > MAX_KBP || kbp < 0 || tile <= 0 || lanes <= 0 || groups <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((lanes + CHAINS - 1) / CHAINS, groups);
  // 16-byte copies need whole, aligned 16-byte lane groups.
  const bool vec = lanes % 4 == 0 &&
                   (((uintptr_t)bp_len | (uintptr_t)bp_dist |
                     (uintptr_t)bp_dcost | (uintptr_t)litcost) & 15) == 0;
  size_t smem = smem_bytes(kbp);
  // With no more blocks than SMs, ask for over half an SM's shared memory
  // so that no two blocks share an SM (their DP warps would share
  // schedulers while other SMs idle).
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return (int)err;
  if ((size_t)grid.x * grid.y <= (size_t)sms && smem <= (size_t)per_sm / 2)
    smem = (size_t)per_sm / 2 + 1;
  err = cudaFuncSetAttribute(
      scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)bp_len, (const int*)bp_dist, (const float*)bp_dcost,
      (const float*)litcost, (const float*)lcost, (int*)ce, (float*)cost,
      tile, kbp, lanes, (int)vec);
  return (int)cudaGetLastError();
}
