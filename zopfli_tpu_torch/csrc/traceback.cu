// Backward path walk (zopfli TraceBackwards) with path histograms, for
// Hopper.
//
// Replaces the Pallas kernel zopfli_tpu/ops/scan_kernel.py::make_traceback
// (pallas_call at scan_kernel.py:289).  Same contract as traceback_plain
// in zopfli_tpu_torch/ops/scan_kernel.py:
//   ce, lit (G*T, L) int32; tile_nbytes (G, L) int32
//   -> hist (G*320, L) float32, pe (G*T, L) int32 (the packed edge into
//      position j+1 if on the path, else 0).
// The caller passes hist and pe zero-filled, and the symbol tables that
// symbol_range_table() defines as two lookups: len_bin[512] and
// dist_bin[ndist] (-1 = not counted).
//
// Design.  The TPU kernel visits every row of every lane in lockstep; the
// path is sparse, so here one thread owns one chain and visits only the
// rows on its path: from the cursor at tile_nbytes it reads the edge,
// writes it to pe, counts its symbols into its own histogram column (no
// other thread touches that column, so no atomics) and steps back by
// the edge's length.  A row whose edge has length 0 is unreachable: the
// TPU kernel's cursor stops there, and so does this walk.
//
// Bound.  The bytes it must move are the path rows (a few per 8 input
// bytes) plus the zero-filled outputs; the chain of dependent loads
// along each path bounds this design.  Counts stay below 2^24, so the
// float32 histogram is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HBINS = 320;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
traceback_kernel(const int* __restrict__ ce, const int* __restrict__ lit,
                 const int* __restrict__ tile_nbytes,
                 const int* __restrict__ len_bin,
                 const int* __restrict__ dist_bin, float* __restrict__ hist,
                 int* __restrict__ pe, int groups, int tile, int lanes,
                 int ndist) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= groups * lanes) return;
  const int g = c / lanes;
  const int lane = c - g * lanes;
  const size_t row0 = (size_t)g * tile;
  float* h = hist + (size_t)g * HBINS * lanes + lane;
  int p = tile_nbytes[c];
  if (p > tile) p = 0;  // the TPU kernel's cursor would never match a row
  while (p > 0) {
    const size_t o = (row0 + p - 1) * lanes + lane;
    const int v = ce[o];
    pe[o] = v;
    const int l = v & 511;
    if (l == 0) break;
    if (l == 1) {
      const int b = lit[o];
      if (b >= 0 && b < HBINS) h[(size_t)b * lanes] += 1.0f;
    } else if (l >= 3) {
      const int lb = len_bin[l];
      if (lb >= 0) h[(size_t)lb * lanes] += 1.0f;
      const int d = v >> 9;
      const int db = (d >= 0 && d < ndist) ? dist_bin[d] : -1;
      if (db >= 0) h[(size_t)db * lanes] += 1.0f;
    }
    p -= l;
  }
}

}  // namespace

extern "C" int zt_traceback(const void* ce, const void* lit,
                            const void* tile_nbytes, const void* len_bin,
                            const void* dist_bin, void* hist, void* pe,
                            int groups, int tile, int lanes, int ndist,
                            void* stream) {
  if (tile <= 0 || lanes <= 0 || groups <= 0 || ndist <= 0)
    return (int)cudaErrorInvalidValue;
  const int chains = groups * lanes;
  traceback_kernel<<<(chains + THREADS - 1) / THREADS, THREADS, 0,
                     (cudaStream_t)stream>>>(
      (const int*)ce, (const int*)lit, (const int*)tile_nbytes,
      (const int*)len_bin, (const int*)dist_bin, (float*)hist, (int*)pe,
      groups, tile, lanes, ndist);
  return (int)cudaGetLastError();
}
