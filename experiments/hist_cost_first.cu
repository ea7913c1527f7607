// The first design of the hist_cost kernel (one block of 512 threads per
// row, phases one after another), kept to measure where its time goes.
// Built only by experiments/exp_hist_cost_phases.py, always with
// -DZT_PHASE_CLOCKS: thread 0 stamps clock64() at each block barrier,
// and zt_hist_cost_debug_read copies the stamps out.  The kernel the
// port runs is zopfli_tpu_torch/csrc/hist_cost.cu.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NUM_LL = 288;
constexpr int NUM_D = 32;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int INF = 1 << 29;
constexpr int MAXBITS = 15;
constexpr int STRIDE = 2 * NUM_LL + 1;   // a merged level holds <= 2m items
constexpr int NCL = 19;                  // code-length alphabet
constexpr int CL_MAXBITS = 7;

#ifdef ZT_PHASE_CLOCKS
// Phase intervals, each [begin, end) stamped by thread 0.
constexpr int NPH = 20;
constexpr int DBG_ROWS = 4096;
__device__ long long g_stamps[DBG_ROWS * NPH * 2];
#define PH_BEGIN(k) if (threadIdx.x == 0 && blockIdx.x < DBG_ROWS) \
    g_stamps[(blockIdx.x * NPH + (k)) * 2] = clock64();
#define PH_END(k) if (threadIdx.x == 0 && blockIdx.x < DBG_ROWS) \
    g_stamps[(blockIdx.x * NPH + (k)) * 2 + 1] = clock64();
#define PH_SYNC() __syncthreads()
#else
#define PH_BEGIN(k)
#define PH_END(k)
#define PH_SYNC()
#endif

__constant__ int kClOrder[NCL] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                  11, 4,  12, 3, 13, 2, 14, 1, 15};
__constant__ int kLLExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                 4, 4, 4, 4, 5, 5, 5, 5, 0};
__constant__ int kDExtra[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,
                                4, 4, 5, 5, 6, 6, 7,  7,  8,  8,
                                9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

// Scratch of one block-wide package-merge (n <= 288).
struct BigPM {
  int order[NUM_LL];        // used symbols, lightest first
  int leaf_w[NUM_LL];
  int pkg_w[NUM_LL];
  int w_a[2 * NUM_LL];
  int w_b[2 * NUM_LL];
  short pfx[MAXBITS][STRIDE];   // leaves among the first i items
  int pfx_size[MAXBITS];
  int taken[MAXBITS];
  int m;
};

// Scratch of one thread's serial package-merge of the 19 cl symbols.
struct SmallPM {
  int order[NCL];
  int leaf_w[NCL];
  int w_a[2 * NCL];
  int w_b[2 * NCL];
  short pfx[CL_MAXBITS][2 * NCL + 1];
  int pfx_size[CL_MAXBITS];
  int counts[NCL];
  int clcounts[NCL];
  int clcl[NCL];
};

struct Smem {
  int64_t cnt_ll[NUM_LL];   // counts, end symbol pinned to 1
  int64_t cnt_d[NUM_D];
  int64_t rle_ll[NUM_LL];   // RleOptimize'd copies
  int64_t rle_d[NUM_D];
  int len_ll[2][NUM_LL];    // [0] plain, [1] RleOptimize'd
  int len_d[2][NUM_D];
  uint8_t good[NUM_LL + NUM_D];
  int64_t tree[2][8];
  int64_t red[2][WARPS];
  union {
    BigPM big;
    SmallPM small[16];
  } pm;
};

// # of a[0..n) < w (a ascending).
__device__ __forceinline__ int count_less(const int* a, int n, int w) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < w) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// # of a[0..n) <= w (a ascending).
__device__ __forceinline__ int count_less_equal(const int* a, int n, int w) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= w) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Length-limited code lengths of freqs[0..n), all threads of the block.
__device__ void package_merge_block(const int64_t* freqs, int n, int* lengths,
                                    BigPM& s, int ph) {
  const int tid = threadIdx.x;
  PH_BEGIN(ph);
  if (tid == 0) s.m = 0;
  __syncthreads();
  for (int i = tid; i < n; i += THREADS) {
    lengths[i] = 0;
    const int64_t fi = freqs[i];
    if (fi != 0) {
      int rank = 0;
      for (int j = 0; j < n; ++j) {
        const int64_t fj = freqs[j];
        rank += (fj != 0) & ((fj < fi) | ((fj == fi) & (j < i)));
      }
      s.order[rank] = i;
      s.leaf_w[rank] = (int)(fi < INF ? fi : INF);
      atomicAdd(&s.m, 1);
    }
  }
  __syncthreads();
  PH_END(ph);
  PH_BEGIN(ph + 1);
  const int m = s.m;
  if (m == 0) {
    PH_END(ph + 1);
    PH_BEGIN(ph + 2);
    PH_END(ph + 2);
    return;
  }
  if (m <= 2) {
    if (tid < m) lengths[s.order[tid]] = 1;
    __syncthreads();
    PH_END(ph + 1);
    PH_BEGIN(ph + 2);
    PH_END(ph + 2);
    return;
  }
  const int maxbits = m - 1 < MAXBITS ? m - 1 : MAXBITS;
  for (int i = tid; i <= m; i += THREADS) s.pfx[0][i] = (short)i;
  for (int i = tid; i < m; i += THREADS) s.w_a[i] = s.leaf_w[i];
  if (tid == 0) s.pfx_size[0] = m;
  __syncthreads();

  int* prev = s.w_a;
  int* cur = s.w_b;
  int prev_size = m;
  for (int level = 1; level < maxbits; ++level) {
    const int np = prev_size / 2;
    for (int p = tid; p < np; p += THREADS) {
      const int w = prev[2 * p] + prev[2 * p + 1];
      s.pkg_w[p] = w < INF ? w : INF;
    }
    __syncthreads();
    short* pfx = s.pfx[level];
    for (int p = tid; p < np; p += THREADS) {
      const int w = s.pkg_w[p];
      const int pos = p + count_less(s.leaf_w, m, w);
      cur[pos] = w;
      pfx[pos + 1] = (short)(pos - p);
    }
    for (int l = tid; l < m; l += THREADS) {
      const int w = s.leaf_w[l];
      const int pos = l + count_less_equal(s.pkg_w, np, w);
      cur[pos] = w;
      pfx[pos + 1] = (short)(l + 1);
    }
    if (tid == 0) {
      pfx[0] = 0;
      s.pfx_size[level] = np + m;
    }
    __syncthreads();
    int* t = prev;
    prev = cur;
    cur = t;
    prev_size = np + m;
  }

  PH_END(ph + 1);
  PH_BEGIN(ph + 2);
  // Top-down take counts: leaves_taken per level.
  if (tid == 0) {
    int take = 2 * m - 2;
    for (int level = maxbits - 1; level >= 0; --level) {
      if (take > s.pfx_size[level]) take = s.pfx_size[level];
      const int lt = s.pfx[level][take];
      s.taken[level] = lt;
      take = 2 * (take - lt);
    }
  }
  __syncthreads();
  for (int j = tid; j < m; j += THREADS) {
    int c = 0;
    for (int level = 0; level < maxbits; ++level) c += j < s.taken[level];
    lengths[s.order[j]] = c;
  }
  __syncthreads();
  PH_END(ph + 2);
}

// Serial package-merge of the 19 code-length symbols (one thread).
__device__ void package_merge_cl(SmallPM& s) {
  int m = 0;
  for (int i = 0; i < NCL; ++i) {
    s.clcl[i] = 0;
    if (s.clcounts[i]) s.order[m++] = i;
  }
  if (m == 0) return;
  if (m <= 2) {
    for (int k = 0; k < m; ++k) s.clcl[s.order[k]] = 1;
    return;
  }
  const int maxbits = m - 1 < CL_MAXBITS ? m - 1 : CL_MAXBITS;
  // Stable insertion sort by count (ties keep symbol order).
  for (int a = 1; a < m; ++a) {
    const int x = s.order[a];
    const int wx = s.clcounts[x];
    int b = a;
    while (b > 0 && s.clcounts[s.order[b - 1]] > wx) {
      s.order[b] = s.order[b - 1];
      --b;
    }
    s.order[b] = x;
  }
  for (int i = 0; i < m; ++i) s.leaf_w[i] = s.clcounts[s.order[i]];
  for (int i = 0; i <= m; ++i) s.pfx[0][i] = (short)i;
  s.pfx_size[0] = m;
  int* prev = s.w_a;
  int* cur = s.w_b;
  for (int i = 0; i < m; ++i) prev[i] = s.leaf_w[i];
  int prev_size = m;
  for (int level = 1; level < maxbits; ++level) {
    const int np = prev_size / 2;
    int size = 0, pi = 0, li = 0;
    short* pfx = s.pfx[level];
    pfx[0] = 0;
    while (pi < np || li < m) {
      const int pw = pi < np ? prev[2 * pi] + prev[2 * pi + 1] : 0;
      const bool take_pkg = pi < np && (li >= m || pw <= s.leaf_w[li]);
      if (take_pkg) {
        cur[size] = pw;
        pfx[size + 1] = pfx[size];
        ++pi;
      } else {
        cur[size] = s.leaf_w[li];
        pfx[size + 1] = (short)(pfx[size] + 1);
        ++li;
      }
      ++size;
    }
    s.pfx_size[level] = size;
    int* t = prev;
    prev = cur;
    cur = t;
    prev_size = size;
  }
  int take = 2 * m - 2;
  for (int i = 0; i < m; ++i) s.counts[i] = 0;
  for (int level = maxbits - 1; level >= 0; --level) {
    if (take > s.pfx_size[level]) take = s.pfx_size[level];
    const int lt = s.pfx[level][take];
    for (int j = 0; j < lt; ++j) ++s.counts[j];
    take = 2 * (take - lt);
  }
  for (int i = 0; i < m; ++i) s.clcl[s.order[i]] = s.counts[i];
}

// Size in bits of one RLE tree-encoding variant (one thread).
__device__ int64_t encode_tree_size(const int* ll, const int* d, bool use16,
                                    bool use17, bool use18, SmallPM& s) {
  int hlit = 29;
  while (hlit > 0 && ll[257 + hlit - 1] == 0) --hlit;
  int hdist = 29;
  while (hdist > 0 && d[1 + hdist - 1] == 0) --hdist;
  const int hlit2 = hlit + 257;
  const int total = hlit2 + hdist + 1;
  for (int i = 0; i < NCL; ++i) s.clcounts[i] = 0;
  for (int i = 0; i < total; ++i) {
    const int symbol = i < hlit2 ? ll[i] : d[i - hlit2];
    int count = 1;
    if (use16 || (symbol == 0 && (use17 || use18))) {
      for (int j = i + 1; j < total; ++j) {
        const int sj = j < hlit2 ? ll[j] : d[j - hlit2];
        if (sj != symbol) break;
        ++count;
      }
    }
    i += count - 1;
    if (symbol == 0 && count >= 3) {
      if (use18)
        while (count >= 11) {
          ++s.clcounts[18];
          count -= count > 138 ? 138 : count;
        }
      if (use17)
        while (count >= 3) {
          ++s.clcounts[17];
          count -= count > 10 ? 10 : count;
        }
    }
    if (use16 && count >= 4) {
      --count;
      ++s.clcounts[symbol];
      while (count >= 3) {
        ++s.clcounts[16];
        count -= count > 6 ? 6 : count;
      }
    }
    s.clcounts[symbol] += count;
  }
  package_merge_cl(s);
  int hclen = 15;
  while (hclen > 0 && s.clcounts[kClOrder[hclen + 4 - 1]] == 0) --hclen;
  int64_t size = 14 + (hclen + 4) * 3;
  for (int i = 0; i < NCL; ++i) size += (int64_t)s.clcl[i] * s.clcounts[i];
  size += (int64_t)s.clcounts[16] * 2 + (int64_t)s.clcounts[17] * 3 +
          (int64_t)s.clcounts[18] * 7;
  return size;
}

// OptimizeHuffmanForRle (deflate.c:434-518), one thread.
__device__ void rle_optimize(int length, int64_t* counts, uint8_t* good) {
  for (;; --length) {
    if (length == 0) return;
    if (counts[length - 1] != 0) break;
  }
  for (int i = 0; i < length; ++i) good[i] = 0;
  {
    int64_t symbol = counts[0];
    int stride = 0;
    for (int i = 0; i < length + 1; ++i) {
      if (i == length || counts[i] != symbol) {
        if ((symbol == 0 && stride >= 5) || (symbol != 0 && stride >= 7))
          for (int k = 0; k < stride; ++k) good[i - k - 1] = 1;
        stride = 1;
        if (i != length) symbol = counts[i];
      } else {
        ++stride;
      }
    }
  }
  int stride = 0;
  int64_t limit = counts[0];
  int64_t sum = 0;
  for (int i = 0; i < length + 1; ++i) {
    const int64_t diff =
        i == length ? 0
                    : (counts[i] > limit ? counts[i] - limit : limit - counts[i]);
    if (i == length || good[i] || diff >= 4) {
      if (stride >= 4 || (stride >= 3 && sum == 0)) {
        int64_t count = (sum + stride / 2) / stride;
        if (count < 1) count = 1;
        if (sum == 0) count = 0;
        for (int k = 0; k < stride; ++k) counts[i - k - 1] = count;
      }
      stride = 0;
      sum = 0;
      if (i < length - 3)
        limit = (counts[i] + counts[i + 1] + counts[i + 2] + counts[i + 3] + 2) / 4;
      else if (i < length)
        limit = counts[i];
      else
        limit = 0;
    }
    ++stride;
    if (i != length) sum += counts[i];
  }
}

// >= 2 nonzero distance code lengths (deflate.c:86-99), one thread.
__device__ void patch_dist_codes(int* d) {
  int num = 0;
  for (int i = 0; i < 30; ++i) {
    if (d[i]) ++num;
    if (num >= 2) return;
  }
  if (num == 0)
    d[0] = d[1] = 1;
  else
    d[d[0] ? 1 : 0] = 1;
}

__global__ void __launch_bounds__(THREADS)
hist_cost_kernel(const int64_t* __restrict__ ll, const int64_t* __restrict__ d,
                 int64_t* __restrict__ out) {
  __shared__ Smem s;
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  PH_BEGIN(0);
  for (int i = tid; i < NUM_LL; i += THREADS) {
    const int64_t c = i == 256 ? 1 : ll[row * NUM_LL + i];
    s.cnt_ll[i] = c;
    s.rle_ll[i] = c;
  }
  if (tid < NUM_D) {
    const int64_t c = d[row * NUM_D + tid];
    s.cnt_d[tid] = c;
    s.rle_d[tid] = c;
  }
  __syncthreads();
  PH_END(0);

  // Plain lengths.
  package_merge_block(s.cnt_ll, NUM_LL, s.len_ll[0], s.pm.big, 1);
  package_merge_block(s.cnt_d, NUM_D, s.len_d[0], s.pm.big, 4);
  // RleOptimize'd lengths.
  PH_BEGIN(7);
  if (tid == 0) rle_optimize(NUM_LL, s.rle_ll, s.good);
  if (tid == 32) rle_optimize(NUM_D, s.rle_d, s.good + NUM_LL);
  if (tid == 64) patch_dist_codes(s.len_d[0]);
  __syncthreads();
  PH_END(7);
  package_merge_block(s.rle_ll, NUM_LL, s.len_ll[1], s.pm.big, 8);
  package_merge_block(s.rle_d, NUM_D, s.len_d[1], s.pm.big, 11);
  if (tid == 0) patch_dist_codes(s.len_d[1]);
  __syncthreads();
  PH_BEGIN(14);

  // Tree header sizes: lane 0 of each warp takes one (set, variant).
  const int warp = tid >> 5;
  if ((tid & 31) == 0 && warp < 16) {
    const int set = warp >> 3, v = warp & 7;
    s.tree[set][v] = encode_tree_size(s.len_ll[set], s.len_d[set], v & 1,
                                      v & 2, v & 4, s.pm.small[warp]);
  }
  PH_SYNC();
  PH_END(14);
  PH_BEGIN(15);

  // Symbol payload of both sets (counts are the unoptimised ones).
  int64_t p[2] = {0, 0};
  for (int i = tid; i < NUM_LL + NUM_D; i += THREADS) {
    if (i < NUM_LL) {
      if (i < 256 || (i >= 257 && i < 286)) {
        const int64_t c = s.cnt_ll[i];
        const int extra = i >= 257 ? kLLExtra[i - 257] : 0;
        p[0] += (int64_t)(s.len_ll[0][i] + extra) * c;
        p[1] += (int64_t)(s.len_ll[1][i] + extra) * c;
      }
    } else if (i - NUM_LL < 30) {
      const int j = i - NUM_LL;
      const int64_t c = s.cnt_d[j];
      p[0] += (int64_t)(s.len_d[0][j] + kDExtra[j]) * c;
      p[1] += (int64_t)(s.len_d[1][j] + kDExtra[j]) * c;
    }
  }
  for (int k = 0; k < 2; ++k) {
    int64_t v = p[k];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if ((tid & 31) == 0) s.red[k][warp] = v;
  }
  __syncthreads();
  PH_END(15);
  PH_BEGIN(16);
  if (tid == 0) {
    int64_t best = -1;
    for (int k = 0; k < 2; ++k) {
      int64_t tree = s.tree[k][0];
      for (int v = 1; v < 8; ++v) tree = s.tree[k][v] < tree ? s.tree[k][v] : tree;
      int64_t total = tree + s.len_ll[k][256];
      for (int w = 0; w < WARPS; ++w) total += s.red[k][w];
      if (best < 0 || total < best) best = total;
    }
    out[row] = best;
  }
  PH_END(16);
}

}  // namespace

extern "C" size_t zt_hist_cost_smem_bytes() { return sizeof(Smem); }

#ifdef ZT_PHASE_CLOCKS
// Interval names, in stamp order (a merge is rank, levels, top-down).
extern "C" const char* zt_hist_cost_phase_names() {
  return "load,plain_ll.rank,plain_ll.levels,plain_ll.topdown,"
         "plain_d.rank,plain_d.levels,plain_d.topdown,rle,"
         "rle_ll.rank,rle_ll.levels,rle_ll.topdown,"
         "rle_d.rank,rle_d.levels,rle_d.topdown,tree,payload,final";
}

// Copies the stamps of the first `rows` rows: (rows, NPH, 2) int64.
extern "C" int zt_hist_cost_debug_read(void* dst, int rows, int* nph) {
  *nph = NPH;
  if (rows > DBG_ROWS) rows = DBG_ROWS;
  return (int)cudaMemcpyFromSymbol(dst, g_stamps,
                                   sizeof(long long) * rows * NPH * 2);
}
#endif

extern "C" int zt_hist_cost(const void* ll, const void* d, void* out, int rows,
                            void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  hist_cost_kernel<<<rows, THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)ll, (const int64_t*)d, (int64_t*)out);
  return (int)cudaGetLastError();
}
