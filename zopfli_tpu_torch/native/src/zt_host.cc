// zt_host.cc — native host engine for the tpu-zopfli framework.
//
// This is the CPU-side runtime used for (a) the correctness oracle in
// tests, (b) a fast host fallback when no TPU is attached, and (c) the
// host finishing stages (checksums) of the distributed pipeline.  The
// TPU compute path (JAX/Pallas kernels) lives in zopfli_tpu/ops/.
//
// Algorithm semantics follow the reference encoder so that output sizes
// are reproducible (reference: src/zopfli/hash.c, lz77.c, squeeze.c), but
// the design is our own: planar arrays, a per-block candidate table that
// memoizes the full min-distance-per-length step function (subsuming the
// reference's 8-slot longest-match cache losslessly), and a C ABI meant
// for ctypes + numpy buffers.
//
// Build: see ../build.sh (g++ -O2 -shared -fPIC).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>

namespace zt {

constexpr int kMinMatch = 3;
constexpr int kMaxMatch = 258;
constexpr int kWindowSize = 32768;
constexpr int kWindowMask = kWindowSize - 1;
constexpr int kMaxChainHits = 8192;
constexpr double kLargeFloat = 1e30;

// ---------------------------------------------------------------------------
// DEFLATE symbol helpers (RFC 1951 3.2.5).
// ---------------------------------------------------------------------------

// Filled when the library loads, so threads that call into it at once
// (masters on worker threads) never race on a lazy fill.
struct LengthSymbolTable {
  int t[259];
  LengthSymbolTable() : t() {
    int sym = 257, base = 3;
    const int ebits[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
                           3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
    for (int s = 0; s < 28; ++s) {
      int span = 1 << ebits[s];
      for (int i = 0; i < span && base + i <= 258; ++i) t[base + i] = sym;
      base += span;
      ++sym;
    }
    t[258] = 285;
  }
};
static const LengthSymbolTable g_length_symbol;

static inline int LengthSymbol(int l) {
  // 257..285 for l in 3..258.
  return g_length_symbol.t[l];
}

static inline int LengthExtraBits(int l) {
  if (l < 11 || l == 258) return 0;
  if (l < 19) return 1;
  if (l < 35) return 2;
  if (l < 67) return 3;
  if (l < 131) return 4;
  return 5;
}

static inline int DistSymbol(int dist) {
  if (dist < 5) return dist - 1;
  int d1 = dist - 1;
  int lg = 31 - __builtin_clz(d1);
  int r = (d1 >> (lg - 1)) & 1;
  return lg * 2 + r;
}

static inline int DistExtraBits(int dist) {
  if (dist < 5) return 0;
  return (31 - __builtin_clz(dist - 1)) - 1;
}

// The values of the extra bits: the offset from the symbol's base.
static inline int LengthExtraValue(int l) {
  return (l - 3) & ((1 << LengthExtraBits(l)) - 1);
}

static inline int DistExtraValue(int dist) {
  return (dist - 1) & ((1 << DistExtraBits(dist)) - 1);
}

// ---------------------------------------------------------------------------
// Rolling-hash chain index over the 32 KiB window.
// ---------------------------------------------------------------------------

struct ChainIndex {
  // Primary hash: 15-bit rolling hash of 3 bytes.
  std::vector<int32_t> head;       // hash value -> most recent window slot
  std::vector<uint16_t> prev;      // window slot -> previous slot, same hash
  std::vector<int32_t> slot_hash;  // window slot -> hash value stored there
  // Run-length tracker: identical-byte run ending at each slot.
  std::vector<uint16_t> run;
  // Secondary hash keyed on (run length, first byte) for long runs.
  std::vector<int32_t> head2;
  std::vector<uint16_t> prev2;
  std::vector<int32_t> slot_hash2;
  int val = 0;
  int val2 = 0;

  ChainIndex()
      : head(65536, -1), prev(kWindowSize), slot_hash(kWindowSize, -1),
        run(kWindowSize, 0), head2(65536, -1), prev2(kWindowSize),
        slot_hash2(kWindowSize, -1) {
    for (int i = 0; i < kWindowSize; ++i) prev[i] = prev2[i] = (uint16_t)i;
  }

  void Reset() {
    val = val2 = 0;
    std::fill(head.begin(), head.end(), -1);
    std::fill(head2.begin(), head2.end(), -1);
    std::fill(slot_hash.begin(), slot_hash.end(), -1);
    std::fill(slot_hash2.begin(), slot_hash2.end(), -1);
    std::fill(run.begin(), run.end(), 0);
    for (int i = 0; i < kWindowSize; ++i) prev[i] = prev2[i] = (uint16_t)i;
  }

  inline void Mix(uint8_t c) { val = ((val << 5) ^ c) & 0x7fff; }

  // Seed the rolling hash with the first bytes of the window prefix.
  void Warmup(const uint8_t* data, int64_t pos, int64_t end) {
    Mix(data[pos]);
    if (pos + 1 < end) Mix(data[pos + 1]);
  }

  // Insert position `pos`; must be called for consecutive positions.
  void Insert(const uint8_t* data, int64_t pos, int64_t end) {
    int slot = (int)(pos & kWindowMask);
    Mix(pos + kMinMatch <= end ? data[pos + kMinMatch - 1] : 0);
    slot_hash[slot] = val;
    if (head[val] != -1 && slot_hash[head[val]] == val)
      prev[slot] = (uint16_t)head[val];
    else
      prev[slot] = (uint16_t)slot;
    head[val] = slot;

    // Identical-byte run length ending here.
    uint16_t amount = 0;
    uint16_t prev_run = run[(pos - 1) & kWindowMask];
    if (prev_run > 1) amount = prev_run - 1;
    while (pos + amount + 1 < end && data[pos] == data[pos + amount + 1] &&
           amount < (uint16_t)(-1))
      ++amount;
    run[slot] = amount;

    val2 = ((amount - kMinMatch) & 255) ^ val;
    slot_hash2[slot] = val2;
    if (head2[val2] != -1 && slot_hash2[head2[val2]] == val2)
      prev2[slot] = (uint16_t)head2[val2];
    else
      prev2[slot] = (uint16_t)slot;
    head2[val2] = slot;
  }
};

// Common-prefix length of data[a..] and data[b..], capped at `limit`.
static inline int64_t MatchLen(const uint8_t* data, int64_t a, int64_t b,
                               int64_t limit) {
  int64_t i = 0;
  while (i + 8 <= limit) {
    uint64_t x, y;
    std::memcpy(&x, data + a + i, 8);
    std::memcpy(&y, data + b + i, 8);
    if (x != y) {
      uint64_t diff = x ^ y;
      return i + (__builtin_ctzll(diff) >> 3);
    }
    i += 8;
  }
  while (i < limit && data[a + i] == data[b + i]) ++i;
  return i;
}

// One (max-length, distance) breakpoint of the min-distance step function.
struct Breakpoint {
  uint16_t len;
  uint16_t dist;
};

// Longest-match search over the hash chain.  If `sublen` is non-null it
// receives, for every l in [3, returned length], the smallest distance
// achieving a match of at least l (the reference "sublen" contract,
// lz77.c:407-542).
static void FindMatch(const ChainIndex& ix, const uint8_t* data, int64_t pos,
                      int64_t size, int64_t limit, uint16_t* sublen,
                      uint16_t* out_dist, uint16_t* out_len) {
  int hpos = (int)(pos & kWindowMask);
  uint16_t bestdist = 0;
  uint16_t bestlength = 1;
  int chain_budget = kMaxChainHits;

  if (size - pos < kMinMatch) {
    *out_len = 0;
    *out_dist = 0;
    return;
  }
  if (pos + limit > size) limit = size - pos;

  const int32_t* chain_head = ix.head.data();
  const uint16_t* chain_prev = ix.prev.data();
  const int32_t* chain_hash = ix.slot_hash.data();
  int hval = ix.val;

  int pp = chain_head[hval];  // == hpos (inserted just before this call)
  int p = chain_prev[pp];
  uint32_t dist = p < pp ? (uint32_t)(pp - p) : (uint32_t)(kWindowSize - p + pp);

  while (dist < (uint32_t)kWindowSize) {
    if (dist > 0 && (int64_t)dist <= pos) {
      int64_t cur = 0;
      int64_t scan = pos, match = pos - dist;
      if (pos + bestlength >= size ||
          data[scan + bestlength] == data[match + bestlength]) {
        // Skip the shared identical-byte run prefix in one step.
        uint16_t run0 = ix.run[pos & kWindowMask];
        if (run0 > 2 && data[scan] == data[match]) {
          uint16_t run1 = ix.run[(pos - dist) & kWindowMask];
          int64_t same = run0 < run1 ? run0 : run1;
          if (same > limit) same = limit;
          scan += same;
          match += same;
          cur = same;
        }
        cur += MatchLen(data, scan, match, limit - cur);
      }
      if (cur > bestlength) {
        if (sublen) {
          for (int64_t j = bestlength + 1; j <= cur; ++j)
            sublen[j] = (uint16_t)dist;
        }
        bestdist = (uint16_t)dist;
        bestlength = (uint16_t)cur;
        if (cur >= limit) break;
      }
    }

    // Switch to the run-keyed secondary chain once it prunes better.
    if (chain_head != ix.head2.data() && bestlength >= ix.run[hpos] &&
        ix.val2 == ix.slot_hash2[p]) {
      chain_head = ix.head2.data();
      chain_prev = ix.prev2.data();
      chain_hash = ix.slot_hash2.data();
      hval = ix.val2;
    }
    (void)chain_hash;

    pp = p;
    p = chain_prev[p];
    if (p == pp) break;  // end of chain
    dist += p < pp ? (uint32_t)(pp - p) : (uint32_t)(kWindowSize - p + pp);
    if (--chain_budget <= 0) break;
  }

  *out_dist = bestdist;
  *out_len = bestlength;
}

// ---------------------------------------------------------------------------
// Greedy parse with one-step lazy matching (reference lz77.c:544-630).
// ---------------------------------------------------------------------------

static inline int LengthScore(int length, int distance) {
  // Long distances burn extra bits; demote them slightly (lz77.c:265-271).
  return distance > 1024 ? length - 1 : length;
}

static int64_t GreedyParse(const uint8_t* data, int64_t instart, int64_t inend,
                           uint16_t* out_litlens, uint16_t* out_dists) {
  if (instart == inend) return 0;
  ChainIndex ix;
  int64_t windowstart = instart > kWindowSize ? instart - kWindowSize : 0;
  ix.Warmup(data, windowstart, inend);
  for (int64_t i = windowstart; i < instart; ++i) ix.Insert(data, i, inend);

  uint16_t sublen[kMaxMatch + 1];
  int64_t n = 0;
  uint32_t prev_length = 0, prev_match = 0;
  bool match_available = false;

  for (int64_t i = instart; i < inend; ++i) {
    ix.Insert(data, i, inend);
    uint16_t leng, dist;
    FindMatch(ix, data, i, inend, kMaxMatch, sublen, &dist, &leng);
    int lengthscore = LengthScore(leng, dist);

    // One-step lazy matching.
    int prevlengthscore = LengthScore((int)prev_length, (int)prev_match);
    if (match_available) {
      match_available = false;
      if (lengthscore > prevlengthscore + 1) {
        out_litlens[n] = data[i - 1];
        out_dists[n] = 0;
        ++n;
        if (lengthscore >= kMinMatch && leng < kMaxMatch) {
          match_available = true;
          prev_length = leng;
          prev_match = dist;
          continue;
        }
      } else {
        // Emit the previous match instead.
        leng = (uint16_t)prev_length;
        dist = (uint16_t)prev_match;
        out_litlens[n] = leng;
        out_dists[n] = dist;
        ++n;
        for (int64_t j = 2; j < leng; ++j) {
          ++i;
          ix.Insert(data, i, inend);
        }
        continue;
      }
    } else if (lengthscore >= kMinMatch && leng < kMaxMatch) {
      match_available = true;
      prev_length = leng;
      prev_match = dist;
      continue;
    }

    if (lengthscore >= kMinMatch) {
      out_litlens[n] = leng;
      out_dists[n] = dist;
      ++n;
    } else {
      leng = 1;
      out_litlens[n] = data[i];
      out_dists[n] = 0;
      ++n;
    }
    for (int64_t j = 1; j < leng; ++j) {
      ++i;
      ix.Insert(data, i, inend);
    }
  }
  return n;
}

// ---------------------------------------------------------------------------
// Per-block squeeze engine with a memoized candidate table.
// ---------------------------------------------------------------------------

struct BlockEngine {
  const uint8_t* data;
  int64_t instart, inend;

  // Memoized candidates, one entry per block offset: the full
  // min-distance-per-length step function as (len, dist) breakpoints.
  // bp_start[j] == -1 marks "not yet computed".  best_len/best_dist cache
  // the unrestricted search result.  This subsumes the reference's
  // fixed-depth longest-match cache (cache.c) without its re-search path.
  std::vector<int64_t> bp_start;
  std::vector<int32_t> bp_count;
  std::vector<uint16_t> best_len;
  std::vector<uint16_t> best_dist;
  std::vector<Breakpoint> arena;

  // Scratch for DP runs.
  std::vector<float> costs;
  std::vector<uint16_t> len_arr;
  std::vector<uint16_t> dist_arr;

  BlockEngine(const uint8_t* d, int64_t s, int64_t e)
      : data(d), instart(s), inend(e) {
    int64_t bs = e - s;
    bp_start.assign(bs, -1);
    bp_count.assign(bs, 0);
    best_len.assign(bs, 0);
    best_dist.assign(bs, 0);
    costs.resize(bs + 1);
    len_arr.resize(bs + 1);
    dist_arr.resize(bs + 1);
  }

  // Fetch (and memoize) the candidate set for block offset j.  Expands the
  // breakpoint list into sublen[0..258]; returns the best length.
  uint16_t Candidates(ChainIndex& ix, int64_t j, uint16_t* sublen,
                      uint16_t* dist) {
    EnsureMemo(ix, j);
    // Expand breakpoints into sublen.
    const Breakpoint* bp = arena.data() + bp_start[j];
    int prev = kMinMatch;
    for (int c = 0; c < bp_count[j]; ++c) {
      for (int k = prev; k <= bp[c].len; ++k) sublen[k] = bp[c].dist;
      prev = bp[c].len + 1;
    }
    *dist = best_dist[j];
    return best_len[j];
  }

  // Breakpoint view without the sublen expansion (the DP hot path
  // iterates breakpoints directly).
  uint16_t CandidatesBp(ChainIndex& ix, int64_t j, const Breakpoint** bp,
                        int* cnt) {
    EnsureMemo(ix, j);
    *bp = arena.data() + bp_start[j];
    *cnt = bp_count[j];
    return best_len[j];
  }

  void EnsureMemo(ChainIndex& ix, int64_t j) {
    if (bp_start[j] >= 0) return;
    uint16_t d, l;
    uint16_t sl[kMaxMatch + 1];
    FindMatch(ix, data, instart + j, inend, kMaxMatch, sl, &d, &l);
    bp_start[j] = (int64_t)arena.size();
    best_len[j] = l;
    best_dist[j] = d;
    int cnt = 0;
    for (int k = kMinMatch; k <= l; ++k) {
      if (k == l || sl[k] != sl[k + 1]) {
        arena.push_back({(uint16_t)k, sl[k]});
        ++cnt;
      }
    }
    bp_count[j] = cnt;
  }
};

// Cost model: cost of emitting (litlen, dist).  dist==0 -> literal.
struct CostModel {
  const double* ll;  // 288 entries, bits per litlen symbol
  const double* d;   // 32 entries, bits per dist symbol
  bool fixed;

  inline double Cost(unsigned litlen, unsigned dist) const {
    if (fixed) {
      if (dist == 0) return litlen <= 143 ? 8 : 9;
      int lsym = LengthSymbol((int)litlen);
      double c = lsym <= 279 ? 7 : 8;
      return c + 5 + DistExtraBits((int)dist) + LengthExtraBits((int)litlen);
    }
    if (dist == 0) return ll[litlen];
    return LengthExtraBits((int)litlen) + DistExtraBits((int)dist) +
           ll[LengthSymbol((int)litlen)] + d[DistSymbol((int)dist)];
  }

  double MinCost() const {
    // Cheapest possible symbol cost under this model (squeeze.c:163-198).
    static const int dfirst[30] = {1, 2, 3, 4, 5, 7, 9, 13, 17, 25,
                                   33, 49, 65, 97, 129, 193, 257, 385, 513,
                                   769, 1025, 1537, 2049, 3073, 4097, 6145,
                                   8193, 12289, 16385, 24577};
    double minlen = kLargeFloat;
    int bestl = 0;
    for (int i = 3; i < 259; ++i) {
      double c = Cost(i, 1);
      if (c < minlen) {
        minlen = c;
        bestl = i;
      }
    }
    double mind = kLargeFloat;
    int bestd = 0;
    for (int i = 0; i < 30; ++i) {
      double c = Cost(3, dfirst[i]);
      if (c < mind) {
        mind = c;
        bestd = dfirst[i];
      }
    }
    return Cost(bestl, bestd);
  }
};

// Forward DP + traceback: one squeeze run (reference squeeze.c:217-336),
// except distances are recorded during relaxation so no re-walk is needed.
static int64_t SqueezeRun(BlockEngine& eng, const CostModel& cm,
                          uint16_t* out_litlens, uint16_t* out_dists) {
  const uint8_t* data = eng.data;
  int64_t instart = eng.instart, inend = eng.inend;
  int64_t bs = inend - instart;
  if (bs == 0) return 0;

  ChainIndex ix;
  int64_t windowstart = instart > kWindowSize ? instart - kWindowSize : 0;
  ix.Warmup(data, windowstart, inend);
  for (int64_t i = windowstart; i < instart; ++i) ix.Insert(data, i, inend);

  float* costs = eng.costs.data();
  uint16_t* len_arr = eng.len_arr.data();
  uint16_t* dist_arr = eng.dist_arr.data();
  for (int64_t i = 1; i <= bs; ++i) costs[i] = (float)kLargeFloat;
  costs[0] = 0;
  len_arr[0] = 0;

  double mincost = cm.MinCost();

  // Per-run cost tables so the hot loop is pure adds + compares while
  // reproducing cm.Cost's exact double evaluation order:
  //   stat:  ((LE[k] + DE(d)) + ll[lsym(k)]) + d[dsym(d)]
  //   fixed: ((base(k) + 5) + DE(d)) + LE[k]   (all small ints: exact)
  double le_tab[kMaxMatch + 1];      // LengthExtraBits(k)
  double lit_tab[256];               // cost of literal byte b
  double ll_by_len[kMaxMatch + 1];   // stat: ll[LengthSymbol(k)]
  double fx_base5[kMaxMatch + 1];    // fixed: base(k) + 5
  for (int k = kMinMatch; k <= kMaxMatch; ++k) {
    le_tab[k] = LengthExtraBits(k);
    if (cm.fixed) {
      fx_base5[k] = (LengthSymbol(k) <= 279 ? 7.0 : 8.0) + 5.0;
    } else {
      ll_by_len[k] = cm.ll[LengthSymbol(k)];
    }
  }
  for (int b = 0; b < 256; ++b)
    lit_tab[b] = cm.fixed ? (b <= 143 ? 8.0 : 9.0) : cm.ll[b];

  for (int64_t i = instart; i < inend; ++i) {
    int64_t j = i - instart;
    ix.Insert(data, i, inend);

    // Long identical-run shortcut (squeeze.c:251-271): inside a long run,
    // force kMaxMatch steps without match searches.
    if (ix.run[i & kWindowMask] > kMaxMatch * 2 &&
        i > instart + kMaxMatch + 1 && i + kMaxMatch * 2 + 1 < inend &&
        ix.run[(i - kMaxMatch) & kWindowMask] > kMaxMatch) {
      double symbolcost = cm.Cost(kMaxMatch, 1);
      for (int k = 0; k < kMaxMatch; ++k) {
        costs[j + kMaxMatch] = (float)(costs[j] + symbolcost);
        len_arr[j + kMaxMatch] = kMaxMatch;
        dist_arr[j + kMaxMatch] = 1;
        ++i;
        ++j;
        ix.Insert(data, i, inend);
      }
    }

    const Breakpoint* bp;
    int bpcnt;
    uint16_t leng = eng.CandidatesBp(ix, j, &bp, &bpcnt);

    // Literal edge.
    if (i + 1 <= inend) {
      double newcost = lit_tab[data[i]] + costs[j];
      if (newcost < costs[j + 1]) {
        costs[j + 1] = (float)newcost;
        len_arr[j + 1] = 1;
        dist_arr[j + 1] = 0;
      }
    }
    // Match edges per breakpoint: the distance (and its cost terms) is
    // constant over each breakpoint's length range.
    int64_t kend = leng < inend - i ? leng : inend - i;
    double mincostaddcostj = mincost + costs[j];
    double cj = costs[j];
    int lo = kMinMatch;
    for (int c = 0; c < bpcnt && lo <= kend; ++c) {
      uint16_t d = bp[c].dist;
      int hi = bp[c].len < kend ? bp[c].len : (int)kend;
      double de = DistExtraBits(d);
      if (cm.fixed) {
        for (int k = lo; k <= hi; ++k) {
          if (costs[j + k] <= mincostaddcostj) continue;
          double newcost = (((fx_base5[k] + de)) + le_tab[k]) + cj;
          if (newcost < costs[j + k]) {
            costs[j + k] = (float)newcost;
            len_arr[j + k] = (uint16_t)k;
            dist_arr[j + k] = d;
          }
        }
      } else {
        double dd = cm.d[DistSymbol(d)];
        for (int k = lo; k <= hi; ++k) {
          if (costs[j + k] <= mincostaddcostj) continue;
          double newcost = (((le_tab[k] + de) + ll_by_len[k]) + dd) + cj;
          if (newcost < costs[j + k]) {
            costs[j + k] = (float)newcost;
            len_arr[j + k] = (uint16_t)k;
            dist_arr[j + k] = d;
          }
        }
      }
      lo = bp[c].len + 1;
    }
  }

  // Traceback (reference TraceBackwards), emitting (litlen, dist) pairs.
  int64_t nsyms = 0;
  {
    int64_t idx = bs;
    while (idx > 0) {
      ++nsyms;
      idx -= len_arr[idx];
    }
  }
  int64_t idx = bs;
  int64_t w = nsyms;
  while (idx > 0) {
    --w;
    uint16_t l = len_arr[idx];
    if (l >= kMinMatch) {
      out_litlens[w] = l;
      out_dists[w] = dist_arr[idx];
    } else {
      out_litlens[w] = data[instart + idx - 1];
      out_dists[w] = 0;
    }
    idx -= l;
  }
  return nsyms;
}

// ---------------------------------------------------------------------------
// Checksums (RFC 1952 CRC-32, RFC 1950 Adler-32) with combine support.
// ---------------------------------------------------------------------------

struct Crc32Table {
  uint32_t t[8][256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int j = 1; j < 8; ++j)
        t[j][i] = (t[j - 1][i] >> 8) ^ t[0][t[j - 1][i] & 0xff];
  }
};
static const Crc32Table g_crc;

static uint32_t Crc32(uint32_t crc, const uint8_t* p, int64_t n) {
  crc = ~crc;
  while (n >= 8) {
    crc ^= (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
    uint32_t hi = (uint32_t)p[4] | ((uint32_t)p[5] << 8) |
                  ((uint32_t)p[6] << 16) | ((uint32_t)p[7] << 24);
    crc = g_crc.t[7][crc & 0xff] ^ g_crc.t[6][(crc >> 8) & 0xff] ^
          g_crc.t[5][(crc >> 16) & 0xff] ^ g_crc.t[4][crc >> 24] ^
          g_crc.t[3][hi & 0xff] ^ g_crc.t[2][(hi >> 8) & 0xff] ^
          g_crc.t[1][(hi >> 16) & 0xff] ^ g_crc.t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) crc = g_crc.t[0][(crc ^ *p++) & 0xff] ^ (crc >> 8);
  return ~crc;
}

static uint32_t Adler32(uint32_t adler, const uint8_t* p, int64_t n) {
  uint32_t s1 = adler & 0xffff, s2 = (adler >> 16) & 0xffff;
  while (n > 0) {
    int64_t chunk = n > 5552 ? 5552 : n;
    n -= chunk;
    while (chunk-- > 0) {
      s1 += *p++;
      s2 += s1;
    }
    s1 %= 65521;
    s2 %= 65521;
  }
  return (s2 << 16) | s1;
}

// ---------------------------------------------------------------------------
// Exact block-cost evaluation (native port of the host-side entropy stack,
// used by the block splitter which probes thousands of candidate ranges).
// Semantics: deflate.c:348-621 + katajainen.c + the RLE tree encoder.
// ---------------------------------------------------------------------------

constexpr int kNumLL = 288;
constexpr int kNumD = 32;

static const int kClOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                 11, 4,  12, 3, 13, 2, 14, 1, 15};

// Exact minimum-redundancy length-limited code lengths (package-merge,
// counting formulation: O(n * maxbits) flat arrays, no per-item leaf
// sets).  Tie rules match the Python reference implementation in
// entropy.py: leaves sorted stably by (weight, symbol); a package
// precedes an equal-weight leaf.  Key fact exploited: within a merged
// level the leaves appear in ascending weight order, so "k leaves among
// the first t items" are exactly the k smallest leaves, and
// lengths[j-th smallest leaf] = #{levels with leafcount > j}.
static void PackageMerge(const int64_t* freqs, int n, int maxbits,
                         int32_t* lengths) {
  std::vector<int> used;
  for (int i = 0; i < n; ++i) {
    lengths[i] = 0;
    if (freqs[i]) used.push_back(i);
  }
  int m = (int)used.size();
  if (m == 0) return;
  if (m <= 2) {
    for (int i : used) lengths[i] = 1;
    return;
  }
  if (maxbits > m - 1) maxbits = m - 1;

  // Flat thread-local scratch: the splitter calls this tens of
  // thousands of times per master block.
  struct Scratch {
    std::vector<int> order;
    std::vector<int64_t> leaf_w, prev_w, cur_w;
    std::vector<int> pfx_flat;   // maxbits rows of stride (2m+1)
    std::vector<int> pfx_size;
    std::vector<int> counts;
  };
  static thread_local Scratch sc;
  sc.order.assign(used.begin(), used.end());
  std::stable_sort(sc.order.begin(), sc.order.end(),
                   [&](int a, int b) { return freqs[a] < freqs[b]; });
  sc.leaf_w.resize(m);
  for (int i = 0; i < m; ++i) sc.leaf_w[i] = freqs[sc.order[i]];

  int stride = 2 * m + 1;  // merged size <= m + prev/2 <= 2m
  sc.pfx_flat.resize((size_t)maxbits * stride);
  sc.pfx_size.resize(maxbits);
  // leafpfx[i] = #leaves among the first i items of the level's list.
  int* pfx0 = sc.pfx_flat.data();
  for (int i = 0; i <= m; ++i) pfx0[i] = i;
  sc.pfx_size[0] = m;
  sc.prev_w.resize(stride);
  sc.cur_w.resize(stride);
  std::copy(sc.leaf_w.begin(), sc.leaf_w.end(), sc.prev_w.begin());
  int prev_size = m;

  for (int level = 1; level < maxbits; ++level) {
    int np = prev_size / 2;
    int size = 0, pi = 0, li = 0;
    int* pfx = sc.pfx_flat.data() + (size_t)level * stride;
    pfx[0] = 0;
    while (pi < np || li < m) {
      int64_t pw = pi < np ? sc.prev_w[2 * pi] + sc.prev_w[2 * pi + 1] : 0;
      bool take_pkg = pi < np && (li >= m || pw <= sc.leaf_w[li]);
      if (take_pkg) {
        sc.cur_w[size] = pw;
        pfx[size + 1] = pfx[size];
        ++pi;
      } else {
        sc.cur_w[size] = sc.leaf_w[li];
        pfx[size + 1] = pfx[size] + 1;
        ++li;
      }
      ++size;
    }
    sc.pfx_size[level] = size;
    std::swap(sc.prev_w, sc.cur_w);
    prev_size = size;
  }

  // Top-down take counts -> per-level leaf counts -> lengths.
  int take = 2 * m - 2;
  sc.counts.assign(m, 0);
  for (int level = maxbits - 1; level >= 0; --level) {
    const int* pfx = sc.pfx_flat.data() + (size_t)level * stride;
    if (take > sc.pfx_size[level]) take = sc.pfx_size[level];
    int leaves_taken = pfx[take];
    for (int j = 0; j < leaves_taken; ++j) ++sc.counts[j];
    int packages = take - leaves_taken;
    take = 2 * packages;
  }
  for (int i = 0; i < m; ++i) lengths[sc.order[i]] = sc.counts[i];
}

// Histogram massaging for RLE-friendliness (deflate.c:434-518).
static void RleOptimize(int length, int64_t* counts) {
  for (;; --length) {
    if (length == 0) return;
    if (counts[length - 1] != 0) break;
  }
  std::vector<uint8_t> good(length, 0);
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
    int64_t diff = i == length ? 0
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

static void PatchDistCodes(int32_t* d_lengths) {
  int num = 0;
  for (int i = 0; i < 30; ++i) {
    if (d_lengths[i]) ++num;
    if (num >= 2) return;
  }
  if (num == 0)
    d_lengths[0] = d_lengths[1] = 1;
  else
    d_lengths[d_lengths[0] ? 1 : 0] = 1;
}

// Size in bits of one RLE tree-encoding variant (deflate.c:105-249,
// size-only path).
static int64_t EncodeTreeSize(const int32_t* ll_lengths,
                              const int32_t* d_lengths, bool use16, bool use17,
                              bool use18) {
  int hlit = 29;
  while (hlit > 0 && ll_lengths[257 + hlit - 1] == 0) --hlit;
  int hdist = 29;
  while (hdist > 0 && d_lengths[1 + hdist - 1] == 0) --hdist;
  int hlit2 = hlit + 257;
  int lld_total = hlit2 + hdist + 1;
  auto at = [&](int i) { return i < hlit2 ? ll_lengths[i] : d_lengths[i - hlit2]; };

  int64_t clcounts[19] = {0};
  for (int i = 0; i < lld_total; ++i) {
    int symbol = at(i);
    int count = 1;
    if (use16 || (symbol == 0 && (use17 || use18))) {
      for (int j = i + 1; j < lld_total && at(j) == symbol; ++j) ++count;
    }
    i += count - 1;
    if (symbol == 0 && count >= 3) {
      if (use18)
        while (count >= 11) {
          int c2 = count > 138 ? 138 : count;
          ++clcounts[18];
          count -= c2;
        }
      if (use17)
        while (count >= 3) {
          int c2 = count > 10 ? 10 : count;
          ++clcounts[17];
          count -= c2;
        }
    }
    if (use16 && count >= 4) {
      --count;
      ++clcounts[symbol];
      while (count >= 3) {
        int c2 = count > 6 ? 6 : count;
        ++clcounts[16];
        count -= c2;
      }
    }
    clcounts[symbol] += count;
  }

  int32_t clcl[19];
  PackageMerge(clcounts, 19, 7, clcl);
  int hclen = 15;
  while (hclen > 0 && clcounts[kClOrder[hclen + 4 - 1]] == 0) --hclen;

  int64_t size = 14 + (hclen + 4) * 3;
  for (int i = 0; i < 19; ++i) size += (int64_t)clcl[i] * clcounts[i];
  size += clcounts[16] * 2 + clcounts[17] * 3 + clcounts[18] * 7;
  return size;
}

static int64_t TreeSize(const int32_t* ll, const int32_t* d) {
  int64_t best = -1;
  for (int i = 0; i < 8; ++i) {
    int64_t s = EncodeTreeSize(ll, d, i & 1, i & 2, i & 4);
    if (best < 0 || s < best) best = s;
  }
  return best;
}

// Precomputed per-symbol columns for fast range histograms + byte ranges.
struct CostContext {
  std::vector<uint16_t> litlens, dists;
  std::vector<uint16_t> ll_sym, d_sym;
  std::vector<int64_t> nbytes_prefix;  // bytes covered by symbols [0, i)
  int64_t n;

  CostContext(const uint16_t* ll, const uint16_t* dd, int64_t n_) : n(n_) {
    litlens.assign(ll, ll + n);
    dists.assign(dd, dd + n);
    ll_sym.resize(n);
    d_sym.resize(n);
    nbytes_prefix.resize(n + 1);
    nbytes_prefix[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
      if (dd[i] == 0) {
        ll_sym[i] = ll[i];
        d_sym[i] = 0;
        nbytes_prefix[i + 1] = nbytes_prefix[i] + 1;
      } else {
        ll_sym[i] = (uint16_t)LengthSymbol(ll[i]);
        d_sym[i] = (uint16_t)DistSymbol(dd[i]);
        nbytes_prefix[i + 1] = nbytes_prefix[i] + ll[i];
      }
    }
  }

  void Histogram(int64_t lstart, int64_t lend, int64_t* ll_counts,
                 int64_t* d_counts) const {
    std::memset(ll_counts, 0, sizeof(int64_t) * kNumLL);
    std::memset(d_counts, 0, sizeof(int64_t) * kNumD);
    for (int64_t i = lstart; i < lend; ++i) {
      ++ll_counts[ll_sym[i]];
      if (dists[i] != 0) ++d_counts[d_sym[i]];
    }
  }
};

static const int kLLExtraBySym[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                      1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                      4, 4, 4, 4, 5, 5, 5, 5, 0};
static const int kDExtraBySym[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,
                                     4, 4, 5, 5, 6, 6, 7,  7,  8,  8,
                                     9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

static int64_t SymbolPayloadSize(const int64_t* ll_counts,
                                 const int64_t* d_counts,
                                 const int32_t* ll_lengths,
                                 const int32_t* d_lengths) {
  int64_t r = 0;
  for (int i = 0; i < 256; ++i) r += (int64_t)ll_lengths[i] * ll_counts[i];
  for (int i = 257; i < 286; ++i) {
    r += (int64_t)ll_lengths[i] * ll_counts[i];
    r += (int64_t)kLLExtraBySym[i - 257] * ll_counts[i];
  }
  for (int i = 0; i < 30; ++i) {
    r += (int64_t)d_lengths[i] * d_counts[i];
    r += (int64_t)kDExtraBySym[i] * d_counts[i];
  }
  r += ll_lengths[256];
  return r;
}

// Dynamic-block tree+data size with the tried-and-kept RLE optimization
// (deflate.c:525-582).  Optionally returns the chosen lengths.
static double DynamicLengthsCost(const CostContext& ctx, int64_t lstart,
                                 int64_t lend, int32_t* out_ll,
                                 int32_t* out_d) {
  int64_t ll_counts[kNumLL], d_counts[kNumD];
  ctx.Histogram(lstart, lend, ll_counts, d_counts);
  ll_counts[256] = 1;
  int32_t ll[kNumLL], d[kNumD];
  PackageMerge(ll_counts, kNumLL, 15, ll);
  PackageMerge(d_counts, kNumD, 15, d);
  PatchDistCodes(d);
  int64_t treesize = TreeSize(ll, d);
  int64_t datasize = SymbolPayloadSize(ll_counts, d_counts, ll, d);

  int64_t ll_c2[kNumLL], d_c2[kNumD];
  std::memcpy(ll_c2, ll_counts, sizeof(ll_c2));
  std::memcpy(d_c2, d_counts, sizeof(d_c2));
  RleOptimize(kNumLL, ll_c2);
  RleOptimize(kNumD, d_c2);
  int32_t ll2[kNumLL], d2[kNumD];
  PackageMerge(ll_c2, kNumLL, 15, ll2);
  PackageMerge(d_c2, kNumD, 15, d2);
  PatchDistCodes(d2);
  int64_t treesize2 = TreeSize(ll2, d2);
  int64_t datasize2 = SymbolPayloadSize(ll_counts, d_counts, ll2, d2);

  if (treesize2 + datasize2 < treesize + datasize) {
    if (out_ll) std::memcpy(out_ll, ll2, sizeof(ll2));
    if (out_d) std::memcpy(out_d, d2, sizeof(d2));
    return (double)(treesize2 + datasize2);
  }
  if (out_ll) std::memcpy(out_ll, ll, sizeof(ll));
  if (out_d) std::memcpy(out_d, d, sizeof(d));
  return (double)(treesize + datasize);
}

// Histogram-only variant of DynamicLengthsCost: exact dynamic tree+data
// bits given litlen/dist counts (the batched TPU engine computes
// histograms on device; only these 320 counters cross the wire per
// iteration).  Counts are NOT modified; the end-symbol pin is applied to
// a copy, mirroring GetDynamicLengths (deflate.c:569-582).
static double HistDynamicCost(const int64_t* ll_counts_in,
                              const int64_t* d_counts_in, int32_t* out_ll,
                              int32_t* out_d) {
  int64_t ll_counts[kNumLL], d_counts[kNumD];
  std::memcpy(ll_counts, ll_counts_in, sizeof(ll_counts));
  std::memcpy(d_counts, d_counts_in, sizeof(d_counts));
  ll_counts[256] = 1;
  int32_t ll[kNumLL], d[kNumD];
  PackageMerge(ll_counts, kNumLL, 15, ll);
  PackageMerge(d_counts, kNumD, 15, d);
  PatchDistCodes(d);
  int64_t treesize = TreeSize(ll, d);
  int64_t datasize = SymbolPayloadSize(ll_counts, d_counts, ll, d);

  int64_t ll_c2[kNumLL], d_c2[kNumD];
  std::memcpy(ll_c2, ll_counts, sizeof(ll_c2));
  std::memcpy(d_c2, d_counts, sizeof(d_c2));
  RleOptimize(kNumLL, ll_c2);
  RleOptimize(kNumD, d_c2);
  int32_t ll2[kNumLL], d2[kNumD];
  PackageMerge(ll_c2, kNumLL, 15, ll2);
  PackageMerge(d_c2, kNumD, 15, d2);
  PatchDistCodes(d2);
  int64_t treesize2 = TreeSize(ll2, d2);
  int64_t datasize2 = SymbolPayloadSize(ll_counts, d_counts, ll2, d2);

  if (treesize2 + datasize2 < treesize + datasize) {
    if (out_ll) std::memcpy(out_ll, ll2, sizeof(ll2));
    if (out_d) std::memcpy(out_d, d2, sizeof(d2));
    return (double)(treesize2 + datasize2);
  }
  if (out_ll) std::memcpy(out_ll, ll, sizeof(ll));
  if (out_d) std::memcpy(out_d, d, sizeof(d));
  return (double)(treesize + datasize);
}

static double BlockCost(const CostContext& ctx, int64_t lstart, int64_t lend,
                        int btype) {
  if (btype == 0) {
    int64_t length = ctx.nbytes_prefix[lend] - ctx.nbytes_prefix[lstart];
    int64_t blocks = length / 65535 + (length % 65535 ? 1 : 0);
    return (double)(blocks * 5 * 8 + length * 8);
  }
  if (btype == 1) {
    int32_t ll[kNumLL], d[kNumD];
    for (int i = 0; i < 144; ++i) ll[i] = 8;
    for (int i = 144; i < 256; ++i) ll[i] = 9;
    for (int i = 256; i < 280; ++i) ll[i] = 7;
    for (int i = 280; i < 288; ++i) ll[i] = 8;
    for (int i = 0; i < 32; ++i) d[i] = 5;
    int64_t ll_counts[kNumLL], d_counts[kNumD];
    ctx.Histogram(lstart, lend, ll_counts, d_counts);
    return 3.0 + SymbolPayloadSize(ll_counts, d_counts, ll, d);
  }
  return 3.0 + DynamicLengthsCost(ctx, lstart, lend, nullptr, nullptr);
}

// Min over the three block types, gating the fixed probe on total store
// size exactly like the reference (deflate.c:610-621).
static double BlockCostAuto(const CostContext& ctx, int64_t lstart,
                            int64_t lend) {
  double unc = BlockCost(ctx, lstart, lend, 0);
  double fixed = ctx.n > 1000 ? unc : BlockCost(ctx, lstart, lend, 1);
  double dyn = BlockCost(ctx, lstart, lend, 2);
  if (unc < fixed && unc < dyn) return unc;
  return fixed < dyn ? fixed : dyn;
}

// ---------------------------------------------------------------------------
// Bit writer: DEFLATE's order, LSB-first within each byte (RFC 1951 3.1.1).
// ---------------------------------------------------------------------------

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "BitWriter stores its accumulator as little-endian bytes");

// Writes fields into a zero-initialised buffer from any bit offset and
// keeps the bits already in the first byte.  Each put stores the whole
// 64-bit accumulator at the current byte, so the buffer needs 8 bytes
// past the last one written; fewer than 8 bits stay in the accumulator
// between puts, so a put of up to 56 bits always fits.  Past `cap` bytes
// nothing is written and Finish reports -1.
class BitWriter {
 public:
  BitWriter(uint8_t* buf, int64_t cap, int64_t bit)
      : buf_(buf), cap_(cap), pos_(bit >> 3), n_((int)(bit & 7)) {
    ok_ = bit >= 0 && (bit >> 3) + 8 <= cap;
    if (ok_ && n_ != 0) acc_ = buf_[pos_] & ((1u << n_) - 1);
  }

  // v < 2^nb, nb <= 56.
  inline void Put(uint64_t v, int nb) {
    acc_ |= v << n_;
    n_ += nb;
    if (pos_ + 8 > cap_) {
      ok_ = false;
      return;
    }
    std::memcpy(buf_ + pos_, &acc_, 8);
    pos_ += n_ >> 3;
    acc_ >>= n_ & ~7;
    n_ &= 7;
  }

  // The bit offset after the fields, or -1 if they ran past the buffer.
  int64_t Finish() const { return ok_ ? pos_ * 8 + n_ : -1; }

 private:
  uint8_t* buf_;
  int64_t cap_;
  int64_t pos_;
  int n_;
  uint64_t acc_ = 0;
  bool ok_;
};

}  // namespace zt

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

int64_t zt_greedy(const uint8_t* data, int64_t instart, int64_t inend,
                  uint16_t* out_litlens, uint16_t* out_dists) {
  return zt::GreedyParse(data, instart, inend, out_litlens, out_dists);
}

// PNG scanline unfilter (RFC 2083 §6; lodepng.cpp:4101-4305 semantics).
// raw: height*(1+stride) filtered bytes.  Returns 0, or 1 + bad line
// index on an invalid filter type.  Serial in the Up/Avg/Paeth line
// dependency, so this lives in C rather than per-byte Python.
int64_t zt_png_unfilter(const uint8_t* raw, int64_t height, int64_t stride,
                        int64_t bpp, uint8_t* out) {
  const uint8_t* prev = nullptr;
  for (int64_t y = 0; y < height; y++) {
    const uint8_t* in = raw + y * (stride + 1);
    uint8_t* rec = out + y * stride;
    const uint8_t f = in[0];
    const uint8_t* line = in + 1;
    switch (f) {
      case 0:
        memcpy(rec, line, stride);
        break;
      case 1:  // Sub
        for (int64_t x = 0; x < stride; x++)
          rec[x] = line[x] + (x >= bpp ? rec[x - bpp] : 0);
        break;
      case 2:  // Up
        if (prev)
          for (int64_t x = 0; x < stride; x++) rec[x] = line[x] + prev[x];
        else
          memcpy(rec, line, stride);
        break;
      case 3:  // Average
        for (int64_t x = 0; x < stride; x++) {
          const int a = x >= bpp ? rec[x - bpp] : 0;
          const int b = prev ? prev[x] : 0;
          rec[x] = line[x] + ((a + b) >> 1);
        }
        break;
      case 4:  // Paeth
        for (int64_t x = 0; x < stride; x++) {
          const int a = x >= bpp ? rec[x - bpp] : 0;
          const int b = prev ? prev[x] : 0;
          const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
          const int p = a + b - c;
          const int pa = p >= a ? p - a : a - p;
          const int pb = p >= b ? p - b : b - p;
          const int pc = p >= c ? p - c : c - p;
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          rec[x] = line[x] + pred;
        }
        break;
      default:
        return 1 + y;
    }
    prev = rec;
  }
  return 0;
}

void* zt_block_new(const uint8_t* data, int64_t instart, int64_t inend) {
  return new zt::BlockEngine(data, instart, inend);
}

void zt_block_free(void* eng) { delete (zt::BlockEngine*)eng; }

// One squeeze run.  ll_cost/d_cost may be null for the fixed-tree model.
int64_t zt_squeeze_run(void* eng, const double* ll_cost, const double* d_cost,
                       uint16_t* out_litlens, uint16_t* out_dists) {
  zt::CostModel cm;
  cm.fixed = (ll_cost == nullptr);
  cm.ll = ll_cost;
  cm.d = d_cost;
  return zt::SqueezeRun(*(zt::BlockEngine*)eng, cm, out_litlens, out_dists);
}

void* zt_cost_new(const uint16_t* litlens, const uint16_t* dists, int64_t n) {
  return new zt::CostContext(litlens, dists, n);
}

void zt_cost_free(void* ctx) { delete (zt::CostContext*)ctx; }

// btype 0/1/2 exact block cost; btype -1 selects auto-type (min of three
// with the fixed-probe gate).
double zt_cost_block(void* ctx, int64_t lstart, int64_t lend, int32_t btype) {
  zt::CostContext* c = (zt::CostContext*)ctx;
  if (btype < 0) return zt::BlockCostAuto(*c, lstart, lend);
  return zt::BlockCost(*c, lstart, lend, btype);
}

// Batched split-point probe: out[i] = auto-type cost of [lstart, idx[i])
// plus [idx[i], lend).  One call per FindMinimum round instead of one
// ctypes round trip per probe (blocksplitter.c:43-96 evaluates up to a
// whole sub-1024 range linearly).
void zt_split_costs(void* ctx, int64_t lstart, int64_t lend,
                    const int64_t* idx, int64_t n, double* out) {
  zt::CostContext* c = (zt::CostContext*)ctx;
  for (int64_t i = 0; i < n; ++i)
    out[i] = zt::BlockCostAuto(*c, lstart, idx[i]) +
             zt::BlockCostAuto(*c, idx[i], lend);
}

// Chosen dynamic-tree code lengths for a range (out_ll[288], out_d[32]);
// returns tree+data cost in bits.
double zt_cost_dynamic_lengths(void* ctx, int64_t lstart, int64_t lend,
                               int32_t* out_ll, int32_t* out_d) {
  zt::CostContext* c = (zt::CostContext*)ctx;
  return zt::DynamicLengthsCost(*c, lstart, lend, out_ll, out_d);
}

// Exact dynamic-block tree+data bits from litlen/dist histograms alone.
double zt_hist_dynamic_cost(const int64_t* ll_counts, const int64_t* d_counts,
                            int32_t* out_ll, int32_t* out_d) {
  return zt::HistDynamicCost(ll_counts, d_counts, out_ll, out_d);
}

// Traceback over a batch of parse tiles (the TPU DP's choice arrays).
//
// cl/cd: (ntiles, tile_len + 1) int16 row-major; cl[t][p] is the edge
// length chosen to reach local position p (1 = literal, >=3 = match),
// cd[t][p] its distance.  tile_nbytes[t] <= tile_len is each tile's real
// length (0 for padding tiles).  data_tile: (ntiles, tile_len) the raw
// bytes, for literal values.  Symbols are appended in forward order per
// tile into out_litlens/out_dists (caller-sized to sum(tile_nbytes));
// returns total symbol count, or -1 on a malformed path.
int64_t zt_traceback_tiles(const int16_t* cl, const int16_t* cd,
                           const uint8_t* data_tile, const int64_t* tile_nbytes,
                           int64_t ntiles, int64_t tile_len,
                           uint16_t* out_litlens, uint16_t* out_dists) {
  int64_t total = 0;
  std::vector<uint16_t> rl, rd;
  for (int64_t t = 0; t < ntiles; ++t) {
    const int16_t* cl_t = cl + t * (tile_len + 1);
    const int16_t* cd_t = cd + t * (tile_len + 1);
    const uint8_t* bytes = data_tile + t * tile_len;
    rl.clear();
    rd.clear();
    int64_t p = tile_nbytes[t];
    while (p > 0) {
      int l = cl_t[p];
      if (l < 1 || l > p) return -1;
      if (l >= zt::kMinMatch) {
        rl.push_back((uint16_t)l);
        rd.push_back((uint16_t)cd_t[p]);
      } else {
        rl.push_back(bytes[p - 1]);
        rd.push_back(0);
      }
      p -= l;
    }
    for (int64_t k = (int64_t)rl.size() - 1; k >= 0; --k) {
      out_litlens[total] = rl[k];
      out_dists[total] = rd[k];
      ++total;
    }
  }
  return total;
}

uint32_t zt_crc32(uint32_t crc, const uint8_t* data, int64_t n) {
  return zt::Crc32(crc, data, n);
}

uint32_t zt_adler32(uint32_t adler, const uint8_t* data, int64_t n) {
  return zt::Adler32(adler, data, n);
}

// The sizes in bits of the 8 tree-header encodings (use16 = i & 1,
// use17 = i & 2, use18 = i & 4) of a dynamic block's code lengths.
void zt_tree_sizes(const int32_t* ll_lengths, const int32_t* d_lengths,
                   int64_t* out) {
  for (int i = 0; i < 8; ++i)
    out[i] = zt::EncodeTreeSize(ll_lengths, d_lengths, i & 1, i & 2, i & 4);
}

// Generic fields (headers, trees): values[i] in its low nbits[i] bits,
// 0 <= nbits[i] <= 64, written in order from bit offset `bit` of `buf`
// (cap bytes, zero past the offset, 8 of them spare past the fields).
// Returns the new bit offset, or -1 past the buffer or on a width
// outside 0..64.
int64_t zt_put_fields(uint8_t* buf, int64_t cap, int64_t bit,
                      const uint64_t* values, const int64_t* nbits,
                      int64_t n) {
  zt::BitWriter w(buf, cap, bit);
  for (int64_t i = 0; i < n; ++i) {
    int64_t nb = nbits[i];
    if (nb < 0 || nb > 64) return -1;
    uint64_t v = nb == 64 ? values[i] : values[i] & ((1ull << nb) - 1);
    if (nb > 32) {
      w.Put(v & 0xffffffffull, 32);
      w.Put(v >> 32, (int)nb - 32);
    } else {
      w.Put(v, (int)nb);
    }
  }
  return w.Finish();
}

// A block's symbol payload (reference AddLZ77Data): per symbol its
// litlen code and, for a match, the length's extra bits, the distance
// code and the distance's extra bits, into `buf` as zt_put_fields does.
// ll_code/ll_len (288) and d_code/d_len (32) are the block's bit-reversed
// codes and their lengths.  Returns the new bit offset, -1 past the
// buffer, or -2 on a symbol outside DEFLATE's ranges (a literal past 255,
// a length outside 3..258, a distance outside 1..32768).
int64_t zt_put_lz77(uint8_t* buf, int64_t cap, int64_t bit,
                    const int32_t* litlens, const int32_t* dists, int64_t n,
                    const uint32_t* ll_code, const int32_t* ll_len,
                    const uint32_t* d_code, const int32_t* d_len) {
  // A length's code and extra bits in one field (at most 15 + 5 bits).
  uint32_t len_val[zt::kMaxMatch + 1] = {};
  int len_bits[zt::kMaxMatch + 1] = {};
  for (int l = zt::kMinMatch; l <= zt::kMaxMatch; ++l) {
    int s = zt::LengthSymbol(l);
    len_val[l] = ll_code[s] | ((uint32_t)zt::LengthExtraValue(l) << ll_len[s]);
    len_bits[l] = ll_len[s] + zt::LengthExtraBits(l);
  }
  zt::BitWriter w(buf, cap, bit);
  for (int64_t i = 0; i < n; ++i) {
    int32_t l = litlens[i];
    int32_t d = dists[i];
    if (d == 0) {
      if ((uint32_t)l > 255) return -2;
      w.Put(ll_code[l], ll_len[l]);
    } else {
      if (l < zt::kMinMatch || l > zt::kMaxMatch || d < 1 ||
          d > zt::kWindowSize)
        return -2;
      // The distance's code and extra bits (at most 15 + 13 bits) after
      // the length's: one put of at most 48 bits.
      int s = zt::DistSymbol(d);
      uint64_t dist_val =
          d_code[s] | ((uint64_t)zt::DistExtraValue(d) << d_len[s]);
      w.Put(len_val[l] | (dist_val << len_bits[l]),
            len_bits[l] + d_len[s] + zt::DistExtraBits(d));
    }
  }
  return w.Finish();
}

// An LZ77 store's index of n symbols (litlens/dists) starting at byte
// `instart` of `data`, in one pass: pos (int64, max(n, 1) entries; an
// empty parse's one entry is instart), the litlen and distance symbols
// (int32; a match's length clamped to 258 and its distance raised to 1
// first, the distance symbol 0 for a literal), and the cumulative
// histograms cum_ll[c] (288) and cum_d[c] (32) of symbols
// [0, c * chunk) for c in 0..n / chunk.
//
// With `check` set, the pass also holds the parse to data[instart,
// inend): the steps (1 a literal, its length a match) sum to
// inend - instart (an empty parse only where inend == instart), every
// match's distance is 1..min(pos - wstart, 32768) and its bytes equal
// those `dist` back.  Bytes are compared only once both ranges lie in
// [wstart, inend).  The caller keeps 0 <= wstart <= instart <= inend <=
// len(data).
//
// Returns the matched bytes compared (0 without `check`), -1 when the
// check fails (the outputs are then partial), or -2 on a symbol outside
// the store's alphabets (a literal outside 0..287, a negative length, a
// distance whose symbol passes 31).
int64_t zt_parse_index(const uint8_t* data, const int32_t* litlens,
                       const int32_t* dists, int64_t n, int64_t chunk,
                       int64_t instart, int64_t inend, int64_t wstart,
                       int32_t check,
                       int64_t* pos, int32_t* ll_symbol, int32_t* d_symbol,
                       int64_t* cum_ll, int64_t* cum_d) {
  constexpr int kNumLL = 288, kNumD = 32;
  int64_t ll[kNumLL] = {};
  int64_t dh[kNumD] = {};
  std::memcpy(cum_ll, ll, sizeof(ll));
  std::memcpy(cum_d, dh, sizeof(dh));
  int64_t p = instart;
  int64_t compared = 0, in_chunk = 0;
  if (n == 0) pos[0] = instart;
  for (int64_t i = 0; i < n; ++i) {
    int32_t l = litlens[i];
    int32_t d = dists[i];
    pos[i] = p;
    if (d == 0) {
      if ((uint32_t)l >= (uint32_t)kNumLL) return -2;
      ll_symbol[i] = l;
      d_symbol[i] = 0;
      ++ll[l];
      p += 1;
    } else {
      if (l < 0) return -2;
      int s = zt::LengthSymbol(l < zt::kMaxMatch ? l : zt::kMaxMatch);
      int ds = zt::DistSymbol(d > 1 ? d : 1);
      if (ds >= kNumD) return -2;
      ll_symbol[i] = s;
      d_symbol[i] = ds;
      ++ll[s];
      ++dh[ds];
      if (check) {
        if (d < 0 || d > p - wstart || d > zt::kWindowSize || p + l > inend)
          return -1;
        if (std::memcmp(data + p, data + p - d, (size_t)l) != 0) return -1;
        compared += l;
      }
      p += l;
    }
    if (++in_chunk == chunk) {
      in_chunk = 0;
      cum_ll += kNumLL;
      cum_d += kNumD;
      std::memcpy(cum_ll, ll, sizeof(ll));
      std::memcpy(cum_d, dh, sizeof(dh));
    }
  }
  if (check && p != inend) return -1;
  return compared;
}

}  // extern "C"
