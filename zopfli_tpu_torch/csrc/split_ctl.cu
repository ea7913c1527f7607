// One step of the block-split search's control, for Hopper: the search
// runs as a chain of these steps and autotype_cost rounds that the host
// queues without a sync.
//
// No TPU kernel counterpart: the JAX package runs the search's control as
// one device program, a lax.while_loop over lax.cond and inner
// while_loops (zopfli_tpu/ops/devsplit.py:229-335, ZopfliBlockSplitLZ77,
// blocksplitter.c:215-275, with FindMinimum, blocksplitter.c:43-96).
// Eager PyTorch cannot loop on device data without the host, so the loop
// body is this kernel.  Contract: split_step_plain in
// zopfli_tpu_torch/ops/devsplit.py (same state layout, same rounds).
//
//   zt_split_step(state, nsym, costs, starts, ends, small_rows, mb, last)
//     state: int64 (S_HEAD + 2*mb + 1,): the loop's scalars, then sp[mb]
//       (sorted split points, ncap + 1 past npts) and done[mb + 1]
//       (segment starts found not worth splitting).
//     costs: int64 (MAX_RANGES,), the round the previous step issued,
//       as autotype_cost wrote them.
//     starts, ends: int64 (MAX_RANGES,), small_rows: bool (MAX_RANGES,):
//       the next round's ranges and fixed-cost gates; state[S_COUNT] is
//       their count (0 once the search finished).
//   A step consumes the previous round (a linear scan: argmin of the
//   split costs of up to 1023 points plus the segment's own cost; a probe
//   round: 9 points, narrowing the span), accepts or rejects the segment's
//   split point when FindMinimum ends, picks the next segment, and issues
//   the next round: 2n+1 ranges for a linear scan of n points (n <= 1023),
//   19 for a first probe round (the segment's cost folded in), 18 after.
//
// The chain's length.  The outer loop evaluates at most 2*mb segments
// (it < 2*mb).  Each evaluation is one linear round, or probe rounds that
// narrow a span S to at most 2*floor(S/10) + S%10 until it is <= 9; from
// a span <= ncap that is at most R(ncap) rounds (9 at ncap = 2^20 + 256
// and 2^21 + 256, devsplit.probe_rounds_max).  A step consumes one round
// and issues at most one, so N_MAX = 2*mb*R(ncap) + 1 steps finish any
// search (devsplit.n_max: 289 for mb = 16, the 15 blocks of a 10^6-byte
// part scaled to a 1 MiB master; 577 for mb = 32 at 2 MiB).  A step
// after the search finished does nothing, and the cost launch after it
// sees a count of 0.  The last step (last = 1) sets
// S_OVERFLOW if the search has not finished: the host's one pull reads it
// and raises, so a chain is never cut short unseen.
//
// Bound.  A step reads and writes a few hundred bytes, and at most 2047
// ranges (48 KB): nothing a card measures.  What bounds a step is its
// serial control (the segment pick and the sorted insert over mb + 1
// entries) and the launch itself.  So a step is one warp: lane 0 runs the
// control, and the argmin of a round (up to 1023 sums, each lane a
// strided share, then shuffles, the lowest index winning ties as
// np.argmin does) and the range writes are spread over the 32 lanes.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// State layout: ops/devsplit.py, S_* (keep in step).
enum {
  S_IT, S_NPTS, S_NDONE, S_NUMBLOCKS, S_FINISHED, S_MODE, S_LSTART, S_LEND,
  S_ORIG, S_START, S_END, S_POS, S_LASTBEST, S_NLIN, S_COUNT, S_OVERFLOW,
  S_ROUNDS
};
constexpr int S_HEAD = 20;
constexpr int M_SELECT = 0, M_LINEAR = 1, M_PROBE = 2;
constexpr int LINEAR_MAX = 1024;   // FindMinimum's linear bound
constexpr int NUM = 9;             // probes a round
constexpr long long BIG = 1LL << 30;
constexpr unsigned FULL = 0xffffffffu;

// Minimum of (v, i) over the warp, the lowest i on ties; all lanes get it.
__device__ __forceinline__ void warp_argmin(long long& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const long long ov = __shfl_down_sync(FULL, v, off);
    const int oi = __shfl_down_sync(FULL, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
  v = __shfl_sync(FULL, v, 0);
  i = __shfl_sync(FULL, i, 0);
}

// argmin over k < n of c[k] + c[n + k]; all lanes.
__device__ __forceinline__ void pair_argmin(const int64_t* c, int n,
                                            long long& v, int& k) {
  const int lane = threadIdx.x;
  v = LLONG_MAX;
  k = INT_MAX;
  for (int j = lane; j < n; j += 32) {
    const long long x = c[j] + c[n + j];
    if (x < v) {   // strided ascending: the first minimum of this lane
      v = x;
      k = j;
    }
  }
  warp_argmin(v, k);
}

// A split point found: reject marks the segment done, accept inserts it
// into sp (kept sorted).  Lane 0.
__device__ void accept_reject(int64_t* st, int mb, long long llpos,
                              long long splitcost, long long orig) {
  int64_t* sp = st + S_HEAD;
  int64_t* done = sp + mb;
  const long long lstart = st[S_LSTART], lend = st[S_LEND];
  if (splitcost > orig || llpos == lstart + 1 || llpos == lend) {
    if (st[S_NDONE] >= mb + 1) {
      st[S_OVERFLOW] = 1;
    } else {
      done[st[S_NDONE]] = lstart;
      st[S_NDONE] += 1;
    }
  } else {
    int i = (int)st[S_NPTS];
    while (i > 0 && sp[i - 1] > llpos) {
      sp[i] = sp[i - 1];
      --i;
    }
    sp[i] = llpos;
    st[S_NPTS] += 1;
    st[S_NUMBLOCKS] += 1;
  }
  st[S_IT] += 1;
  st[S_MODE] = M_SELECT;
}

// The next segment (blocksplitter.c:233-246, FindLargestSplittableBlock's
// size-1 quirk for later segment ends).  Lane 0.  Returns 1 if the search
// finished, else sets S_LSTART/S_LEND.
__device__ int select_segment(int64_t* st, int mb, long long nsym) {
  const int64_t* sp = st + S_HEAD;
  const int64_t* done = sp + mb;
  const long long npts = st[S_NPTS], ndone = st[S_NDONE];
  long long best = 0, bstart = 0, bend = 0;
  for (int g = 0; g <= mb; ++g) {
    const long long s = g == 0 ? 0 : sp[g - 1];
    const long long e = g == npts ? nsym - 1 : (g < mb ? sp[g] : 0);
    long long len = -1;
    if (g <= npts) {
      bool is_done = false;
      for (long long d = 0; d < ndone; ++d) is_done |= done[d] == s;
      if (!is_done) len = e - s;
    }
    if (g == 0 || len > best) {   // the first maximum, as np.argmax
      best = len;
      bstart = s;
      bend = e;
    }
  }
  const bool first = st[S_IT] == 0;
  const long long lstart = first ? 0 : bstart;
  const long long lend = first ? nsym : bend;
  const bool found = first || best > 0;
  if (nsym < 10 || st[S_IT] >= 2 * mb || !found || st[S_NUMBLOCKS] >= mb ||
      lend - lstart < 10)
    return 1;
  st[S_LSTART] = lstart;
  st[S_LEND] = lend;
  return 0;
}

__global__ void __launch_bounds__(32)
split_step_kernel(int64_t* __restrict__ st, const int64_t* __restrict__ nsym_p,
                  const int64_t* __restrict__ costs, int64_t* __restrict__ starts,
                  int64_t* __restrict__ ends, uint8_t* __restrict__ small_rows,
                  int mb, int last) {
  const int lane = threadIdx.x;
  if (st[S_FINISHED]) {   // every later step of the chain: nothing to do
    if (lane == 0) st[S_COUNT] = 0;
    return;
  }
  const long long nsym = *nsym_p;
  const int mode = (int)st[S_MODE];
  // The argmin of the round just costed, over the warp.
  long long best = LLONG_MAX;
  int besti = INT_MAX;
  if (mode == M_LINEAR) {
    pair_argmin(costs, (int)st[S_NLIN], best, besti);
  } else if (mode == M_PROBE) {
    if (lane < NUM) {
      best = costs[lane] + costs[NUM + lane];
      besti = lane;
    }
    warp_argmin(best, besti);
  }
  // The control, on lane 0 alone.  issue: 0 none, 1 linear round, 2
  // first probe round, 3 later probe round.
  int issue = 0;
  if (lane == 0) {
    if (mode == M_LINEAR) {
      const int n = (int)st[S_NLIN];
      accept_reject(st, mb, st[S_LSTART] + 1 + besti, best, costs[2 * n]);
    } else if (mode == M_PROBE) {
      const long long start = st[S_START], end = st[S_END];
      const long long step = (end - start) / (NUM + 1);
      if (st[S_NLIN] == 0) st[S_ORIG] = costs[2 * NUM];
      bool stop = best > st[S_LASTBEST];
      if (!stop) {
        const long long nstart = besti == 0 ? start : start + besti * step;
        const long long nend =
            besti == NUM - 1 ? end : start + (besti + 2) * step;
        st[S_START] = nstart;
        st[S_END] = nend;
        st[S_POS] = start + (besti + 1) * step;
        st[S_LASTBEST] = best;
        stop = nend - nstart <= NUM;
      }
      if (stop) {
        accept_reject(st, mb, st[S_POS], st[S_LASTBEST], st[S_ORIG]);
      } else {
        st[S_NLIN] += 1;
        issue = 3;
      }
    }
    if (st[S_MODE] == M_SELECT) {
      if (select_segment(st, mb, nsym)) {
        st[S_FINISHED] = 1;
      } else {
        const long long lstart = st[S_LSTART], lend = st[S_LEND];
        if (lend - lstart - 1 < LINEAR_MAX) {
          st[S_MODE] = M_LINEAR;
          st[S_NLIN] = lend - lstart - 1;
          issue = 1;
        } else {
          st[S_MODE] = M_PROBE;
          st[S_NLIN] = 0;
          st[S_START] = lstart + 1;
          st[S_END] = lend;
          st[S_POS] = lstart + 1;
          st[S_LASTBEST] = BIG;
          issue = 2;
        }
      }
    }
  }
  // Lane 0's results to the warp, which writes the next round's ranges:
  // both halves at each point, then the segment itself on a linear or
  // first probe round.
  issue = __shfl_sync(FULL, issue, 0);
  long long lstart = 0, lend = 0, start = 0, end = 0, n = 0;
  if (lane == 0) {
    lstart = st[S_LSTART];
    lend = st[S_LEND];
    start = st[S_START];
    end = st[S_END];
    n = st[S_NLIN];
  }
  lstart = __shfl_sync(FULL, lstart, 0);
  lend = __shfl_sync(FULL, lend, 0);
  start = __shfl_sync(FULL, start, 0);
  end = __shfl_sync(FULL, end, 0);
  n = __shfl_sync(FULL, n, 0);
  long long count = 0;
  if (issue == 1) {
    for (long long i = lane; i < n; i += 32) {
      const long long p = lstart + 1 + i;
      starts[i] = lstart;
      ends[i] = p;
      starts[n + i] = p;
      ends[n + i] = lend;
    }
    count = 2 * n + 1;
  } else if (issue >= 2) {
    const long long step = (end - start) / (NUM + 1);
    if (lane < NUM) {
      const long long p = start + (lane + 1) * step;
      starts[lane] = lstart;
      ends[lane] = p;
      starts[NUM + lane] = p;
      ends[NUM + lane] = lend;
    }
    count = issue == 2 ? 2 * NUM + 1 : 2 * NUM;
  }
  if ((count & 1) && lane == 0) {
    starts[count - 1] = lstart;
    ends[count - 1] = lend;
  }
  const uint8_t small = nsym <= 1000;
  for (long long i = lane; i < count; i += 32) small_rows[i] = small;
  if (lane == 0) {
    st[S_COUNT] = count;
    if (count) st[S_ROUNDS] += 1;
    if (last && !st[S_FINISHED]) st[S_OVERFLOW] = 1;
  }
}

}  // namespace

extern "C" int zt_split_step(void* state, const void* nsym, const void* costs,
                             void* starts, void* ends, void* small_rows, int mb,
                             int last, void* stream) {
  if (mb <= 0) return (int)cudaErrorInvalidValue;
  split_step_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (int64_t*)state, (const int64_t*)nsym, (const int64_t*)costs,
      (int64_t*)starts, (int64_t*)ends, (uint8_t*)small_rows, mb, last);
  return (int)cudaGetLastError();
}
