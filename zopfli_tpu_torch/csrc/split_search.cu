// The block-split search for Hopper: one persistent kernel runs the whole
// of ZopfliBlockSplitLZ77 on one LZ77 stream, its control and the costs
// of every round it issues.
//
// No TPU kernel counterpart: the JAX package runs the search as one
// device program, a lax.while_loop over lax.cond and inner while_loops
// (zopfli_tpu/ops/devsplit.py:134-336; ZopfliBlockSplitLZ77,
// blocksplitter.c:215-275, with FindMinimum, blocksplitter.c:43-96).
// Contract: split_search_plain in zopfli_tpu_torch/ops/devsplit.py
// (split_step_plain and autotype_costs_plain in turn; the same state
// layout, rounds and costs).
//
//   zt_split_search(ll_ck, d_ck, ll_sym, d_sym, bcum, state, nsym, costs,
//                   starts, ends, small_rows, sync, ncap, mb, steps, stream)
//     ll_ck, d_ck, ll_sym, d_sym, bcum: the stream's checkpointed
//       cumulative histograms, symbols and byte prefix
//       (devsplit.stream_symbols, devsplit.checkpoints).
//     state: int64 (S_HEAD + 2*mb + 1,): the loop's scalars, then sp[mb]
//       (sorted split points, ncap + 1 past npts) and done[mb + 1]
//       (segment starts found not worth splitting); advanced in place.
//     nsym: one int64, the stream's symbol count, read on the device.
//     costs, starts, ends: int64 (MAX_RANGES,), small_rows: bool
//       (MAX_RANGES,): a round's ranges, fixed-cost gates and costs; at
//       the end those of the last round issued (state[S_COUNT] ranges).
//     sync: SYNC_WORDS uint32 of scratch, zeroed here before the launch.
//   At most `steps` steps run, each followed by the costs of the round it
//   issued.  A step consumes the previous round (a linear scan: the
//   argmin of the split costs of up to 1023 points, and the segment's own
//   cost; a probe round: 9 points, narrowing the span), accepts or
//   rejects the segment's split point when FindMinimum ends, picks the
//   next segment and issues the next round: 2n+1 ranges for a linear scan
//   of n points (n <= 1023), 19 for a first probe round (the segment's
//   cost folded in), 18 after.  The kernel ends at the step that finishes
//   the search (S_ROUNDS + 1 steps), or after the costs of step `steps`,
//   which sets S_OVERFLOW if the search has not finished by then: the
//   host's one pull reads it (devsplit.n_max bounds any search's steps).
//
// Bound.  The work is the rounds' costs: each range's histogram from two
// checkpoint rows and at most 510 stream symbols, then its dynamic cost
// (hist_cost.cu); the control moves a few hundred bytes a step.  But the
// rounds form a chain (a probe round's points come from the previous
// round's argmin), about 60 of them a search at 1 MiB, and a probe round
// has 18 or 19 ranges.  What bounds the search is the latency of a round:
// one row's dependent phases, then the hand-off from the costs to the
// control and back.  The first design made each hand-off a kernel
// launch queued by the host: N_MAX step and cost pairs a search (578 at
// 1 MiB, ~80% of them after the search had finished), whose enqueue set
// the wall.  Here a search is one launch:
//   - the grid is the clusters of two 256-thread blocks that are resident
//     at once (two per SM, cudaOccupancyMaxActiveClusters), launched
//     cooperatively: the kernel waits on itself, and the runtime launches
//     it only with every block resident (a card without cooperative
//     launches refuses the search);
//   - warp 0 of cluster 0 runs each step (lane 0 the control, the warp
//     the argmin of a round and the range writes), then publishes the
//     round by a release store of its number to a generation word;
//   - one thread of each cluster acquires the generation word (the other
//     block follows through the cluster barrier); the cluster costs
//     ranges cluster, cluster + nclusters, ... below the count with
//     autotype_row (hist_cost_row.cuh) and arrives on a counter by a
//     release add; warp 0 of cluster 0 acquires the counter before the
//     next step.  A round costs one publish and one arrival, not two grid
//     barriers;
//   - ranges and costs written on one SM and read on another are loaded
//     at L2 (ld.global.cg), after the acquire;
//   - every wait traps after 2 s: a lost arrival becomes a launch error,
//     not a hung card;
//   - nothing runs after the search has finished.

#include <climits>

#include "hist_cost_row.cuh"

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

// Sync words: the generation and the round it describes on one line, the
// arrival counter on another (every cluster adds to it).
enum { W_GEN = 0, W_COUNT = 1, W_LAST = 2, W_ARRIVE = 32, SYNC_WORDS = 64 };

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// A value another SM wrote, read at L2.
__device__ __forceinline__ long long ldcg(const int64_t* p) {
  return __ldcg((const long long*)p);
}

// A wait that outlasts any round (2 s) is a scheduling fault: trap, so the
// launch fails instead of hanging the card.  The sleep doubles up to
// `cap` ns.
struct Spin {
  unsigned long long t0 = 0;
  int ns = 32;
  __device__ __forceinline__ void wait(int cap) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t0 == 0) t0 = t;
    else if (t - t0 > 2000000000ull) __trap();
    __nanosleep(ns);
    ns = ns < cap ? 2 * ns : cap;
  }
};

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
  const int lane = threadIdx.x & 31;
  v = LLONG_MAX;
  k = INT_MAX;
  for (int j = lane; j < n; j += 32) {
    const long long x = ldcg(c + j) + ldcg(c + n + j);
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

// One step of the search (split_step_plain's contract), by one warp:
// consume the costs of the round the previous step issued, advance the
// state, write the next round's ranges and gates.  Returns the next
// round's size (0 once the search finished); all lanes.
__device__ int search_step(int64_t* st, long long nsym, const int64_t* costs,
                           int64_t* starts, int64_t* ends,
                           uint8_t* small_rows, int mb, bool last) {
  const int lane = threadIdx.x & 31;
  const bool finished = st[S_FINISHED] != 0;
  const int mode = (int)st[S_MODE];
  const int nlin = (int)st[S_NLIN];
  __syncwarp();   // every lane has read the state before lane 0 writes it
  if (finished) {   // a state that had finished before the launch
    if (lane == 0) st[S_COUNT] = 0;
    return 0;
  }
  // The argmin of the round just costed, over the warp.
  long long best = LLONG_MAX;
  int besti = INT_MAX;
  if (mode == M_LINEAR) {
    pair_argmin(costs, nlin, best, besti);
  } else if (mode == M_PROBE) {
    if (lane < NUM) {
      best = ldcg(costs + lane) + ldcg(costs + NUM + lane);
      besti = lane;
    }
    warp_argmin(best, besti);
  }
  // The control, on lane 0 alone.  issue: 0 none, 1 linear round, 2
  // first probe round, 3 later probe round.
  int issue = 0;
  if (lane == 0) {
    if (mode == M_LINEAR) {
      accept_reject(st, mb, st[S_LSTART] + 1 + besti, best,
                    ldcg(costs + 2 * nlin));
    } else if (mode == M_PROBE) {
      const long long start = st[S_START], end = st[S_END];
      const long long step = (end - start) / (NUM + 1);
      if (nlin == 0) st[S_ORIG] = ldcg(costs + 2 * NUM);
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
  return (int)count;
}

__global__ void __launch_bounds__(BLOCK, 4)
split_search_kernel(const int64_t* __restrict__ ll_ck,
                    const int64_t* __restrict__ d_ck,
                    const int64_t* __restrict__ ll_sym,
                    const int64_t* __restrict__ d_sym,
                    const int64_t* __restrict__ bcum, int64_t* st,
                    const int64_t* __restrict__ nsym_p, int64_t* costs,
                    int64_t* starts, int64_t* ends, uint8_t* small_rows,
                    unsigned* sync, int64_t ncap, int mb, int64_t steps) {
  __shared__ Smem s;
  __shared__ int round_count, round_last;
  const int set = (int)__clusterRelativeBlockRank();
  const int tid = threadIdx.x;
  const int cluster = blockIdx.x >> 1, nclusters = gridDim.x >> 1;
  const long long nsym = *nsym_p;
  for (int64_t rnd = 1;; ++rnd) {
    if (blockIdx.x == 0 && tid < 32) {   // the control: warp 0, cluster 0
      if (rnd > 1 && tid == 0) {   // every cluster costed the last round
        const unsigned want = (unsigned)((rnd - 1) * nclusters);
        Spin spin;
        while (ld_acquire(sync + W_ARRIVE) < want) spin.wait(64);
        __threadfence();
      }
      __syncwarp();
      const bool last = rnd == steps;
      const int count = search_step(st, nsym, costs, starts, ends,
                                    small_rows, mb, last);
      __threadfence();
      __syncwarp();
      if (tid == 0) {
        sync[W_COUNT] = (unsigned)count;
        sync[W_LAST] = last;
        st_release(sync + W_GEN, (unsigned)rnd);
      }
    }
    if (set == 0 && tid == 0) {   // the cluster's one poller
      Spin spin;
      while (ld_acquire(sync + W_GEN) < (unsigned)rnd) spin.wait(256);
    }
    cluster_sync();   // block 1 follows block 0's acquire
    if (tid == 0) {
      round_count = (int)__ldcg(sync + W_COUNT);
      round_last = (int)__ldcg(sync + W_LAST);
    }
    __syncthreads();
    const int count = round_count;
    const bool last = round_last != 0;
    if (count == 0) break;   // the search finished
    for (int row = cluster; row < count; row += nclusters) {
      autotype_row(s, set, ldcg(starts + row), ldcg(ends + row),
                   nsym <= 1000, ll_ck, d_ck, ll_sym, d_sym, bcum,
                   costs + row, ncap);
      __syncthreads();   // this row's shared memory is read
    }
    cluster_sync();   // both blocks are done with the round's ranges
    if (set == 0 && tid == 0) add_release(sync + W_ARRIVE, 1u);
    if (last) break;
  }
}

// The grid of each device: the clusters resident at once (0: not sized).
constexpr int MAX_DEVICES = 64;
int g_clusters[MAX_DEVICES];

// Clusters of two blocks, launched cooperatively: the runtime refuses the
// launch unless every block is resident at once.
cudaLaunchConfig_t launch_config(int clusters, cudaStream_t stream,
                                 cudaLaunchAttribute* at) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * clusters);
  cfg.blockDim = dim3(BLOCK);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 2;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  return cfg;
}

// Two clusters an SM, or fewer if fewer are resident at once.
cudaError_t size_grid(int dev, int* clusters) {
  int sms = 0, coop = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  cudaLaunchAttribute at[2];
  const cudaLaunchConfig_t cfg = launch_config(2 * sms, 0, at);
  int resident = 0;
  e = cudaOccupancyMaxActiveClusters(&resident, split_search_kernel, &cfg);
  if (e != cudaSuccess) return e;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  *clusters = resident < 2 * sms ? resident : 2 * sms;
  return cudaSuccess;
}

}  // namespace

extern "C" int zt_split_search(const void* ll_ck, const void* d_ck,
                               const void* ll_sym, const void* d_sym,
                               const void* bcum, void* state,
                               const void* nsym, void* costs, void* starts,
                               void* ends, void* small_rows, void* sync,
                               long long ncap, int mb, long long steps,
                               void* stream) {
  if (mb <= 0 || steps <= 0 || !sync) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (g_clusters[dev] == 0 &&
      (e = size_grid(dev, &g_clusters[dev])) != cudaSuccess)
    return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  e = cudaMemsetAsync(sync, 0, SYNC_WORDS * sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute at[2];
  const cudaLaunchConfig_t cfg = launch_config(g_clusters[dev], s, at);
  return (int)cudaLaunchKernelEx(
      &cfg, split_search_kernel, (const int64_t*)ll_ck, (const int64_t*)d_ck,
      (const int64_t*)ll_sym, (const int64_t*)d_sym, (const int64_t*)bcum,
      (int64_t*)state, (const int64_t*)nsym, (int64_t*)costs,
      (int64_t*)starts, (int64_t*)ends, (uint8_t*)small_rows,
      (unsigned*)sync, (int64_t)ncap, mb, (int64_t)steps);
}

// The clusters of two blocks a launch on the current device uses (0
// before the first launch there).
extern "C" int zt_split_search_clusters(int* clusters) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  *clusters = g_clusters[dev];
  return 0;
}
