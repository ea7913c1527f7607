// The device code of one cost row, shared by hist_cost.cu (its two
// entries) and split_search.cu (the block-split search, which costs its
// rounds' ranges with autotype_row): the exact dynamic-block bits of a
// histogram pair on a cluster of two blocks (row_cost), and the exact
// auto-type bits of a symbol range of one LZ77 stream (autotype_row).
// The design and its bound are in hist_cost.cu's header.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NUM_LL = 288;
constexpr int NUM_D = 32;
constexpr int BLOCK = 256;              // one block per code-length set
constexpr int INF = 1 << 29;
constexpr int SENT = 0x7fffffff;        // a forced RleOptimize boundary
constexpr long long BIG = 1LL << 30;    // cost of an empty range
constexpr unsigned FULL = 0xffffffffu;
constexpr int LL_TEAM = 224;            // 7 warps of a block

__constant__ int kClOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                 11, 4,  12, 3, 13, 2, 14, 1, 15};
__constant__ int kLLExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                 4, 4, 4, 4, 5, 5, 5, 5, 0};
__constant__ int kDExtra[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,
                                4, 4, 5, 5, 6, 6, 7,  7,  8,  8,
                                9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

// ---------------------------------------------------------------------------
// Phase clocks (debug builds only).
// ---------------------------------------------------------------------------

enum Phase {
  PH_LOAD, PH_PLAIN_LL, PH_PLAIN_D = PH_PLAIN_LL + 3, PH_RLE_LL = PH_PLAIN_D + 3,
  PH_RLE_D = PH_RLE_LL + 4, PH_TREE = PH_RLE_D + 4, PH_FINAL = PH_TREE + 2,
  PH_COUNT
};

#ifdef ZT_PHASE_CLOCKS
constexpr int NPH = PH_COUNT;
constexpr int DBG_BLOCKS = 4096;
__device__ long long g_stamps[DBG_BLOCKS * NPH * 2];
__device__ __forceinline__ void stamp(int ph, int which) {
  if (ph >= 0 && blockIdx.x < DBG_BLOCKS)
    g_stamps[(blockIdx.x * NPH + ph) * 2 + which] = clock64();
}
#else
__device__ __forceinline__ void stamp(int, int) {}
#endif

// ---------------------------------------------------------------------------
// Teams: T threads (whole warps) that share a barrier.
// ---------------------------------------------------------------------------

template <int T>
struct Team {
  int t;     // thread index in the team
  int bar;   // named barrier id (unused for one warp)
  __device__ __forceinline__ void sync() const {
    if (T == 32) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(T) : "memory");
    }
  }
  __device__ __forceinline__ int warp() const { return t >> 5; }
  __device__ __forceinline__ int lane() const { return t & 31; }
};

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

// Ascending bitonic sort of one value per lane across a warp.
__device__ __forceinline__ uint64_t bitonic32(uint64_t v, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const uint64_t o = __shfl_xor_sync(FULL, v, j);
      const bool up = (lane & k) == 0;
      const bool lower = (lane & j) == 0;
      const uint64_t lo = v < o ? v : o;
      const uint64_t hi = v < o ? o : v;
      v = (lower == up) ? lo : hi;
    }
  }
  return v;
}

// Last set bit <= j in words[0..), or -1.
__device__ __forceinline__ int last_bit_le(const unsigned* words, int j) {
  int w = j >> 5;
  unsigned bits = words[w] & (FULL >> (31 - (j & 31)));
  while (bits == 0) {
    if (--w < 0) return -1;
    bits = words[w];
  }
  return (w << 5) + 31 - __clz(bits);
}

// First set bit > j in words[0..nw), or `none`.
__device__ __forceinline__ int first_bit_gt(const unsigned* words, int nw,
                                            int j, int none) {
  int w = j >> 5;
  unsigned bits = (j & 31) == 31 ? 0u : (words[w] & (FULL << ((j & 31) + 1)));
  while (bits == 0) {
    if (++w >= nw) return none;
    bits = words[w];
  }
  return (w << 5) + __ffs(bits) - 1;
}

// ---------------------------------------------------------------------------
// Package-merge (katajainen.c, counting formulation) for a team.
// ---------------------------------------------------------------------------

// Scratch of one package-merge of N symbols, at most MAXB levels.  Leaves
// are sorted as R = 2^LOG unique keys (weight << 9 | symbol; unused and
// pad symbols weigh INF), so leaf_w is INF-padded to R.  lp[0] holds the
// leaf weights, lp[1 + L % 3] level L's package weights (INF-padded).
template <int N, int LOG, int MAXB>
struct PMS {
  static constexpr int R = 1 << LOG;
  union {
    uint64_t key[2][R];          // sort buffers
    short pfx[MAXB][2 * N + 2];  // leaves among the first i items of a level
  } u;
  int lp[4][R];
  short order[R];                // symbols by rank
  int size[MAXB];
  int taken[MAXB];
  int mcnt[R / 32];              // used symbols per key chunk
};

// Sorts u.key[0] (R keys, unique); returns the buffer that holds them.
// Each warp sorts 32-key chunks by a bitonic network, then merge rounds
// place each key at its index plus its rank in the partner run.
template <int T, int N, int LOG, int MAXB>
__device__ int team_sort(PMS<N, LOG, MAXB>& s, const Team<T>& tm) {
  constexpr int R = 1 << LOG;
  for (int c = tm.warp(); c < R / 32; c += T / 32) {
    const int i = c * 32 + tm.lane();
    s.u.key[0][i] = bitonic32(s.u.key[0][i], tm.lane());
  }
  if (R == 32) return 0;
  tm.sync();
  constexpr int K = (R + T - 1) / T;
  int src = 0;
  for (int run = 32; run < R; run <<= 1) {
    const uint64_t* a = s.u.key[src];
    uint64_t key[K];
    int base[K], dst[K], pos[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int idx = min(tm.t + j * T, R - 1);
      key[j] = a[idx];
      const int r = idx / run;
      base[j] = (r ^ 1) * run;
      dst[j] = (r & ~1) * run + (idx - r * run);
      pos[j] = 0;
    }
    // Rank in the partner run: steps run/2, ..., 1, 1 (branchless).
    for (int st = run >> 1;; st >>= 1) {
      const int step = st > 0 ? st : 1;
#pragma unroll
      for (int j = 0; j < K; ++j)
        pos[j] += a[base[j] + pos[j] + step - 1] < key[j] ? step : 0;
      if (st == 0) break;
    }
    uint64_t* b = s.u.key[src ^ 1];
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (tm.t + j * T < R) b[dst[j] + pos[j]] = key[j];
    tm.sync();
    src ^= 1;
  }
  return src;
}

// Payload bits of one symbol at length `len` (CalculateBlockSymbolSize-
// GivenCounts): kind 1 litlen (end symbol excluded), 2 dist, 0 none.
__device__ __forceinline__ long long payload_term(int kind, int sym, int len,
                                                  const int* cnt) {
  if (kind == 1) {
    if (sym == 256 || sym >= 286) return 0;
    const int extra = sym > 256 ? kLLExtra[sym - 257] : 0;
    return (long long)(len + extra) * cnt[sym];
  }
  if (kind == 2) {
    if (sym >= 30) return 0;
    return (long long)(len + kDExtra[sym]) * cnt[sym];
  }
  return 0;
}

template <int T>
__device__ __forceinline__ void add_payload(long long v, const Team<T>& tm,
                                            unsigned long long* payload) {
  if (payload == nullptr) return;
  v = warp_sum(v);
  if (tm.lane() == 0 && v != 0) atomicAdd(payload, (unsigned long long)v);
}

// Length-limited code lengths of cnt[0..N) (zero counts get 0, and
// `lengths` must be zero on entry), plus the payload of `pay_cnt` at
// those lengths added to *payload.  All threads of the team; phase
// stamps ph (ranking), ph+1 (levels), ph+2 (top-down and lengths).
template <int T, int N, int LOG, int MAXB>
__device__ void pm_team(const int* cnt, int* lengths, PMS<N, LOG, MAXB>& s,
                        const Team<T>& tm, int ph, const int* pay_cnt,
                        int pay_kind, unsigned long long* payload) {
  constexpr int R = 1 << LOG;
  const bool lead = tm.t == 0 && ph >= 0;
  if (lead) stamp(ph, 0);
  for (int c = tm.warp(); c < R / 32; c += T / 32) {
    const int i = c * 32 + tm.lane();
    const int w = i < N ? cnt[i] : 0;
    const bool used = w != 0;
    const unsigned b = __ballot_sync(FULL, used);
    if (tm.lane() == 0) s.mcnt[c] = __popc(b);
    s.u.key[0][i] = ((uint64_t)(used ? min(w, INF) : INF) << 9) | (uint64_t)i;
  }
  tm.sync();
  const int src = team_sort(s, tm);
  tm.sync();
  int m = 0;
#pragma unroll
  for (int c = 0; c < R / 32; ++c) m += s.mcnt[c];
  // Sizes of the merged lists: size_0 = m, size_L = size_{L-1} / 2 + m.
  const int np2 = (m / 2 + m) / 2;
  for (int r = tm.t; r < R; r += T) {
    const uint64_t k = s.u.key[src][r];
    s.lp[0][r] = (int)(k >> 9);
    s.order[r] = (short)(k & 511);
    // Level 1's packages (pairs of leaves), INF-padded to R, and level
    // 2's zeroed sums.
    int p1 = INF;
    if (2 * r + 1 < m) {
      p1 = min((int)(s.u.key[src][2 * r] >> 9) +
                   (int)(s.u.key[src][2 * r + 1] >> 9),
               INF);
    }
    s.lp[2][r] = p1;
    s.lp[3][r] = r < np2 ? 0 : INF;
  }
  tm.sync();
  if (lead) {
    stamp(ph, 1);
    stamp(ph + 1, 0);
  }
  if (m <= 2) {
    long long pay = 0;
    for (int r = tm.t; r < m; r += T) {
      const int sym = s.order[r];
      lengths[sym] = 1;
      pay += payload_term(pay_kind, sym, 1, pay_cnt);
    }
    add_payload(pay, tm, payload);
    if (lead) {
      stamp(ph + 1, 1);
      stamp(ph + 2, 0);
      stamp(ph + 2, 1);
    }
    return;
  }

  // Levels: level L's packages merged with the leaves.  A package's place
  // is its index plus the leaves lighter than it, a leaf's its index plus
  // the packages no heavier (a package precedes an equal-weight leaf):
  // both are one fixed-step search of an INF-padded sorted array, a
  // thread's items in step.  Each item adds its weight into the package
  // it forms at the next level (shared atomics), so a level is one
  // barrier.
  const int maxbits = min(m - 1, MAXB);
  const int* lp = &s.lp[0][0];
  int size = m;
  constexpr int K = (2 * N + T - 1) / T;
  for (int level = 1; level < maxbits; ++level) {
    const int np = size >> 1;
    size = np + m;
    const int pbase = (1 + level % 3) * R;
    int* next = &s.lp[1 + (level + 1) % 3][0];
    int target[K], base[K], pos[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int k = tm.t + j * T;
      const bool pk = k < np;
      const int w = pk ? min(lp[pbase + k], INF)
                       : (k < size ? lp[k - np] : -1);
      target[j] = pk ? w : w + 1;     // < w for packages, <= w for leaves
      base[j] = pk ? 0 : pbase;
      pos[j] = 0;
    }
    for (int st = R >> 1;; st >>= 1) {
      const int step = st > 0 ? st : 1;
#pragma unroll
      for (int j = 0; j < K; ++j)
        pos[j] += lp[base[j] + pos[j] + step - 1] < target[j] ? step : 0;
      if (st == 0) break;
    }
    short* pfx = s.u.pfx[level];
    const bool more = level + 1 < maxbits;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int k = tm.t + j * T;
      if (k < size) {
        const bool pk = k < np;
        const int idx = pk ? k : k - np;
        const int at = idx + pos[j];
        pfx[at + 1] = (short)(pk ? pos[j] : idx + 1);
        if (more) atomicAdd(&next[at >> 1], pk ? target[j] : target[j] - 1);
      }
    }
    if (level + 2 < maxbits) {
      // Level L+2's sums, zeroed where its packages will be.
      const int np_after = (size / 2 + m) / 2;
      int* after = &s.lp[1 + (level + 2) % 3][0];
      for (int q = tm.t; q < R; q += T) after[q] = q < np_after ? 0 : INF;
    }
    if (tm.t == 0) {
      s.size[level] = size;
      pfx[0] = 0;
    }
    tm.sync();
  }

  // Top-down take counts (one thread), then each leaf's length is the
  // number of levels that take it.
  if (tm.t == 0) {
    if (lead) {
      stamp(ph + 1, 1);
      stamp(ph + 2, 0);
    }
    int take = 2 * m - 2;
    for (int level = maxbits - 1; level >= 0; --level) {
      take = min(take, level == 0 ? m : s.size[level]);
      const int lt = level == 0 ? take : s.u.pfx[level][take];
      s.taken[level] = lt;
      take = 2 * (take - lt);
    }
  }
  tm.sync();
  long long pay = 0;
  for (int r = tm.t; r < m; r += T) {
    int c = 0;
    for (int level = 0; level < maxbits; ++level) c += r < s.taken[level];
    const int sym = s.order[r];
    lengths[sym] = c;
    pay += payload_term(pay_kind, sym, c, pay_cnt);
  }
  add_payload(pay, tm, payload);
  if (lead) stamp(ph + 2, 1);
}

// ---------------------------------------------------------------------------
// OptimizeHuffmanForRle (deflate.c:434-518) for a team.
// ---------------------------------------------------------------------------

template <int N>
struct RleS {
  static constexpr int NC = (N + 31) / 32;   // run-start words (N bits)
  static constexpr int NB = (N + 32) / 32;   // boundary words (N + 1 bits)
  static constexpr int NP = N + 8;           // the serial pass reads by 8
  long long P[NP];           // prefix sums of the counts
  int cc[NP];                // counts, cc[N] = 0
  int v[NP];                 // boundary test value, SENT where forced
  int lim[NP];               // the limit a boundary at i sets
  unsigned smask[NC];
  unsigned bmask[NB];
  int lastnz[NC];
};

// out[0..N) = RleOptimize(cnt[0..N)).  The serial pass's control depends
// only on the original counts and on `limit`, which only a boundary
// changes: a position is a boundary iff it is forced (in a good run, or
// the end) or its count is 4 or more from the limit, i.e. iff
// (unsigned)(v[i] - limit) > 6 with v[i] = count + 3 (SENT if forced).
// One thread runs that chain; everything else is parallel.  Segment
// [a, e) between boundaries is filled at e when e - a >= 4, or >= 3
// with a zero sum.
template <int T, int N>
__device__ void rle_team(const int* cnt, int* out, RleS<N>& s,
                         const Team<T>& tm, int ph) {
  constexpr int W = T / 32;
  constexpr int NC = RleS<N>::NC, NB = RleS<N>::NB;
  if (tm.t == 0) stamp(ph, 0);
  for (int c = tm.warp(); c < NC; c += W) {
    const int i = c * 32 + tm.lane();
    const int x = i < N ? cnt[i] : 0;
    if (i < N) s.cc[i] = x;
    const bool start = i < N && (i == 0 || x != cnt[i - 1]);
    const unsigned b = __ballot_sync(FULL, start);
    const unsigned nz = __ballot_sync(FULL, x != 0);
    if (tm.lane() == 0) {
      s.smask[c] = b;
      s.lastnz[c] = nz ? c * 32 + 32 - __clz(nz) : 0;
    }
  }
  if (tm.t == 0) s.cc[N] = 0;
  tm.sync();
  int length = 0;
#pragma unroll
  for (int c = 0; c < NC; ++c) length = max(length, s.lastnz[c]);
  if (length == 0) {
    for (int i = tm.t; i < N; i += T) out[i] = cnt[i];
    if (tm.t == 0) stamp(ph, 1);
    return;
  }
  // good_for_rle: runs of equal counts, >= 5 zeros or >= 7 of another.
  for (int i = tm.t; i <= length; i += T) {
    int v = SENT, lim = 0;
    if (i < length) {
      const int a = last_bit_le(s.smask, i);
      const int e = first_bit_gt(s.smask, NC, i, N);
      const int x = s.cc[i];
      const bool good = x == 0 ? e - a >= 5 : e - a >= 7;
      v = good ? SENT : x + 3;
      lim = i < length - 3
                ? (int)(((unsigned)x + s.cc[i + 1] + s.cc[i + 2] +
                         s.cc[i + 3] + 2u) >> 2)
                : x;
    }
    s.v[i] = v;
    s.lim[i] = lim;
  }
  tm.sync();
  if (tm.t == 0) {
    // The chain, 8 positions per batch: the batch's loads are issued
    // together, the boundary bits gathered into the mask words.
    int limit = s.cc[0];
    long long sum = 0;
    unsigned word = 0;
    for (int i0 = 0; i0 <= length; i0 += 8) {
      int vv[8], lm[8], cv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        vv[k] = s.v[i0 + k];
        lm[k] = s.lim[i0 + k];
        cv[k] = s.cc[i0 + k];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool b = (unsigned)(vv[k] - limit) > 6u;
        limit = b ? lm[k] : limit;
        word |= (unsigned)b << ((i0 + k) & 31);
        s.P[i0 + k] = sum;
        sum += cv[k];
      }
      if (i0 + 8 > length) {   // bits past the end are not boundaries
        const int top = length & 31;
        s.bmask[i0 >> 5] = word & (top == 31 ? FULL : (2u << top) - 1);
      } else if (((i0 + 8) & 31) == 0) {
        s.bmask[i0 >> 5] = word;
        word = 0;
      }
    }
  }
  tm.sync();
  for (int i = tm.t; i < N; i += T) {
    int val = s.cc[i];
    if (i < length) {
      const int a = max(last_bit_le(s.bmask, i), 0);
      const int e = first_bit_gt(s.bmask, NB, i, length);
      const int stride = e - a;
      const long long sum = s.P[e] - s.P[a];
      if (stride >= 4 || (stride >= 3 && sum == 0)) {
        const long long q = (sum + stride / 2) / stride;
        val = sum == 0 ? 0 : (int)(q < 1 ? 1 : q);
      }
    }
    out[i] = val;
  }
  if (tm.t == 0) stamp(ph, 1);
}

// ---------------------------------------------------------------------------
// Tree header size of one RLE variant (EncodeTree's size path), one warp.
// ---------------------------------------------------------------------------

struct TreeS {
  int clc[20];                // code-length-code counts
  int clcl[20];               // their code lengths
  PMS<19, 5, 7> pm;
};

// Bits of the dynamic header for code lengths ll/d with variant v
// (bit 0 use_16, bit 1 use_17, bit 2 use_18); valid in lane 0.  Runs of
// equal lengths come from ballots; a run of r equal lengths turns into
// its 16/17/18 codes in closed form, as the serial loop would.
__device__ int tree_size_warp(const int* ll, const int* d, int v, TreeS& s,
                              int lane) {
  const unsigned bl = __ballot_sync(FULL, lane < 29 && ll[257 + lane] != 0);
  const unsigned bd = __ballot_sync(FULL, lane < 29 && d[1 + lane] != 0);
  const int hlit2 = (bl ? 32 - __clz(bl) : 0) + 257;
  const int total = hlit2 + (bd ? 32 - __clz(bd) : 0) + 1;   // <= 316
  unsigned msk[10];
  int val[10];
#pragma unroll
  for (int c = 0; c < 10; ++c) {
    const int k = c * 32 + lane;
    int x = -1, px = -2;
    if (k < total) {
      x = k < hlit2 ? ll[k] : d[k - hlit2];
      if (k > 0) px = k - 1 < hlit2 ? ll[k - 1] : d[k - 1 - hlit2];
    }
    val[c] = x;
    msk[c] = __ballot_sync(FULL, k < total && x != px);
  }
  if (lane < 20) {
    s.clc[lane] = 0;
    s.clcl[lane] = 0;
  }
  __syncwarp();
  const bool use16 = v & 1, use17 = v & 2, use18 = v & 4;
  int n16 = 0, n17 = 0, n18 = 0;
#pragma unroll
  for (int c = 0; c < 10; ++c) {
    if ((msk[c] >> lane) & 1) {
      const unsigned above = lane == 31 ? 0u : (msk[c] & (FULL << (lane + 1)));
      int e = total;
#pragma unroll
      for (int cc = 9; cc > c; --cc)
        if (msk[cc]) e = cc * 32 + __ffs(msk[cc]) - 1;
      if (above) e = c * 32 + __ffs(above) - 1;
      const int sym = val[c];
      int rem = e - (c * 32 + lane);
      int own = rem;
      if (use16 || (sym == 0 && (use17 || use18))) {
        if (sym == 0 && rem >= 3) {
          if (use18) {
            const int q = rem / 138, r = rem % 138;
            n18 += q + (r >= 11);
            rem = r >= 11 ? 0 : r;
          }
          if (use17) {
            const int q = rem / 10, r = rem % 10;
            n17 += q + (r >= 3);
            rem = r >= 3 ? 0 : r;
          }
        }
        int lit = 0;
        if (use16 && rem >= 4) {
          const int q = (rem - 1) / 6, r = (rem - 1) % 6;
          n16 += q + (r >= 3);
          rem = r >= 3 ? 0 : r;
          lit = 1;
        }
        own = lit + rem;
      }
      if (own) atomicAdd(&s.clc[sym], own);
    }
  }
  n16 = warp_sum_int(n16);
  n17 = warp_sum_int(n17);
  n18 = warp_sum_int(n18);
  __syncwarp();
  if (lane == 0) {
    s.clc[16] = n16;
    s.clc[17] = n17;
    s.clc[18] = n18;
  }
  __syncwarp();
  pm_team(s.clc, s.clcl, s.pm, Team<32>{lane, 0}, -1, nullptr, 0, nullptr);
  __syncwarp();
  const unsigned bh =
      __ballot_sync(FULL, lane < 15 && s.clc[kClOrder[lane + 4]] != 0);
  const int hclen = bh ? 32 - __clz(bh) : 0;
  int term = 0;
  if (lane < 19) {
    const int extra = lane == 16 ? 2 : lane == 17 ? 3 : lane == 18 ? 7 : 0;
    term = (s.clcl[lane] + extra) * s.clc[lane];
  }
  term = warp_sum_int(term);
  return 14 + (hclen + 4) * 3 + term;
}

// ---------------------------------------------------------------------------
// One row: a cluster of two blocks, one per code-length set.
// ---------------------------------------------------------------------------

struct Smem {
  unsigned long long payload;      // symbol bits of this set, end symbol apart
  unsigned long long fixed;        // fixed-tree bits less the header
  long long total;                 // this set's tree + data bits
  long long tree[8];
  int cnt_ll[NUM_LL];              // counts, end symbol pinned to 1
  int cnt_d[NUM_D];
  int rle_ll[NUM_LL];              // RleOptimize'd counts (block 1)
  int rle_d[NUM_D];
  int len_ll[NUM_LL];              // this set's code lengths
  int len_d[NUM_D];
  union {
    RleS<NUM_LL> rle;
    PMS<NUM_LL, 9, 15> pm;
    TreeS tree[8];
  } ll;
  union {
    RleS<NUM_D> rle;
    PMS<NUM_D, 5, 15> pm;
  } d;
};

// What every row needs before the first block barrier.
__device__ __forceinline__ void zero_row(Smem& s, int tid) {
  for (int i = tid; i < NUM_LL; i += BLOCK) s.len_ll[i] = 0;
  if (tid < NUM_D) s.len_d[tid] = 0;
  if (tid == 0) s.payload = 0;
  if (tid == 1) s.fixed = 0;
}

// >= 2 nonzero distance code lengths (deflate.c:86-99), one warp.
__device__ __forceinline__ void patch_dist_warp(int* d, int lane) {
  const unsigned b = __ballot_sync(FULL, lane < 30 && d[lane] != 0);
  const int num = __popc(b);
  if (lane == 0 && num < 2) {
    if (num == 0) {
      d[0] = 1;
      d[1] = 1;
    } else {
      d[d[0] ? 1 : 0] = 1;
    }
  }
  __syncwarp();
}

// Barrier of both blocks of the cluster: arrive releases, wait acquires.
__device__ __forceinline__ void cluster_sync() {
  __cluster_barrier_arrive();
  __cluster_barrier_wait();
}

// Dynamic-block bits of the counts in s: block `set` of the cluster
// computes one code-length set (0 plain, 1 RleOptimize'd); the result,
// the smaller of the two, is valid in thread 0 of block 0.  All threads
// of both blocks, after a block barrier.
__device__ long long row_cost(Smem& s, int set) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  if (warp < 7) {
    const Team<LL_TEAM> tm{tid, 1};
    const int* src = s.cnt_ll;
    if (set == 1) {
      rle_team(s.cnt_ll, s.rle_ll, s.ll.rle, tm, PH_RLE_LL);
      tm.sync();
      src = s.rle_ll;
    }
    pm_team(src, s.len_ll, s.ll.pm, tm, set ? PH_RLE_LL + 1 : PH_PLAIN_LL,
            s.cnt_ll, 1, &s.payload);
  } else {
    const Team<32> tm{tid & 31, 0};
    const int* src = s.cnt_d;
    if (set == 1) {
      rle_team(s.cnt_d, s.rle_d, s.d.rle, tm, PH_RLE_D);
      tm.sync();
      src = s.rle_d;
    }
    pm_team(src, s.len_d, s.d.pm, tm, set ? PH_RLE_D + 1 : PH_PLAIN_D,
            s.cnt_d, 2, &s.payload);
    tm.sync();
    patch_dist_warp(s.len_d, tm.t);
  }
  __syncthreads();
  if (tid == 0) stamp(PH_TREE + set, 0);
  const int t = tree_size_warp(s.len_ll, s.len_d, warp, s.ll.tree[warp],
                               tid & 31);
  if ((tid & 31) == 0) s.tree[warp] = t;
  __syncthreads();
  if (tid == 0) {
    stamp(PH_TREE + set, 1);
    stamp(PH_FINAL, 0);
    long long tree = s.tree[0];
    for (int v = 1; v < 8; ++v) tree = s.tree[v] < tree ? s.tree[v] : tree;
    s.total = tree + s.len_ll[256] + (long long)s.payload;
  }
  cluster_sync();
  long long best = s.total;
  if (set == 0 && tid == 0) {
    const long long other =
        *(const long long*)__cluster_map_shared_rank((void*)&s.total, 1);
    best = other < best ? other : best;
  }
  cluster_sync();   // block 1's shared memory stays until block 0 read it
  return best;
}

// Fixed-tree bits of litlen symbol i, extra bits included.
__device__ __forceinline__ int fixed_ll_bits(int i) {
  const int base = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
  return base + (i >= 257 && i < 286 ? kLLExtra[i - 257] : 0);
}

// One cluster per range [s0, e0) of the stream: both blocks build its
// histograms from two checkpoint rows and at most 2 x 255 stream symbols
// (shared-memory atomics), then the dynamic cost; block 0 adds the
// stored and fixed costs (the fixed cost where `gate`, the GetFixedCost
// rule) and writes *out.  All threads of both blocks, with the same
// s0, e0 and gate.
__device__ __forceinline__ void autotype_row(Smem& s, int set, int64_t s0,
                             int64_t e0, bool gate,
                             const int64_t* __restrict__ ll_ck,
                             const int64_t* __restrict__ d_ck,
                             const int64_t* __restrict__ ll_sym,
                             const int64_t* __restrict__ d_sym,
                             const int64_t* __restrict__ bcum,
                             int64_t* __restrict__ out, int64_t ncap) {
  const int tid = threadIdx.x;
  if (e0 <= s0) {   // both blocks of the cluster leave here
    if (set == 0 && tid == 0) *out = BIG;
    return;
  }
  if (tid == 0) stamp(PH_LOAD, 0);
  const int64_t sc = s0 < 0 ? 0 : (s0 > ncap ? ncap : s0);
  const int64_t ec = e0 > ncap ? ncap : e0;
  const int64_t js = sc >> 8, je = ec >> 8;   // checkpoints every 256
  const int64_t nbytes = set == 0 && tid == 0 ? bcum[ec] - bcum[sc] : 0;
  for (int i = tid; i < NUM_LL + NUM_D; i += BLOCK) {
    if (i < NUM_LL) {
      s.cnt_ll[i] = i == 256 ? 1
                             : (int)(ll_ck[je * NUM_LL + i] -
                                     ll_ck[js * NUM_LL + i]);
    } else {
      const int j = i - NUM_LL;
      s.cnt_d[j] = (int)(d_ck[je * NUM_D + j] - d_ck[js * NUM_D + j]);
    }
  }
  zero_row(s, tid);
  __syncthreads();
  // Add [je*256, ec), take away [js*256, sc): one thread per position.
  for (int i = tid; i < 512; i += BLOCK) {
    const bool add = i < 256;
    const int64_t k = add ? je * 256 + i : js * 256 + (i - 256);
    if (k < (add ? ec : sc)) {
      const int sign = add ? 1 : -1;
      const int ls = (int)ll_sym[k];
      if (ls != 256) atomicAdd(&s.cnt_ll[ls], sign);   // 256 stays pinned
      const int ds = (int)d_sym[k];
      if (ds >= 0) atomicAdd(&s.cnt_d[ds], sign);
    }
  }
  __syncthreads();
  if (set == 0) {
    for (int i = tid; i < NUM_LL + NUM_D; i += BLOCK) {
      long long f;
      if (i < NUM_LL) {
        f = (long long)s.cnt_ll[i] * fixed_ll_bits(i);
      } else {
        const int j = i - NUM_LL;
        f = (long long)s.cnt_d[j] * (5 + (j < 30 ? kDExtra[j] : 0));
      }
      if (f != 0) atomicAdd(&s.fixed, (unsigned long long)f);
    }
  }
  if (tid == 0) stamp(PH_LOAD, 1);
  const long long best = row_cost(s, set);
  if (set == 0 && tid == 0) {
    const int64_t nblk = nbytes / 65535 + (nbytes % 65535 != 0);
    const int64_t unc = nblk * 40 + nbytes * 8;
    const int64_t fixed = gate ? 3 + (int64_t)s.fixed : unc;
    int64_t cost = unc < fixed ? unc : fixed;
    cost = cost < 3 + best ? cost : 3 + best;
    *out = cost;
    stamp(PH_FINAL, 1);
  }
}

}  // namespace
