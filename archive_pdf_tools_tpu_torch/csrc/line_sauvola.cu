// Per-hOCR-line dual Sauvola thresholds (k = 0.1) for Hopper (sm_90a).
//
// Replaces: archive_pdf_tools_tpu/ops/lines_pallas.py,
//   line_thresholds_pallas (entry :185, pallas_call :256).  Semantics are
//   the reference's (mrc.py:188-270): each line's bbox crop [t,b) x [l,r)
//   of its page is thresholded on its own, and so is its inverse
//   255 - crop, with Sauvola windows clamped to the crop: integer mean and
//   E[x^2] by floor division, then the float32 squared-form test (k >= 0
//   branch).  The inverse needs no second pass: with S, Q and C the
//   window's sum, sum of squares and count, its sums are S' = 255C - S
//   and Q' = 65025C - 510S + Q.  Ink counts of both polarities over the
//   whole crop are fused.
//
// Layout: ragged.  Line i's crops are stored row-major, (b-t) rows of
//   (r-l) bytes, at out_t + off[i] and out_i + off[i], where off is the
//   host prefix sum of the line areas.
//
// What bounds it: bytes, 117 MB a batch of 8 x 3300x2550 with ~400
//   lines (each crop pixel read, both crops written), 0.035 ms at 3.35
//   TB/s.  The first form was one CTA a line walking its rows:
//   ~400 CTAs, each ~40 dependent row steps of a column-sum update, a
//   block scan and two barriers, with byte loads and stores.  But a line
//   is short next to the window: at 400 DPI the window is 101 (o = 51,
//   u = 50) and text lines are 32-52 rows, so the vertical window
//   [max(y-o+1,t), min(y+u,b-1)] is the whole line on every row of a line
//   of <= 51 rows, and the walk rescanned unchanged sums on every row.
//
// Design: work units of (row segment, column tile) of a line, one CTA
//   each.  A tile is TILE_COLS output columns and loads the column sums
//   of its columns plus a halo of o-1 on the left and u on the right,
//   clamped to the line; a segment is up to SEG_ROWS rows.  Within a
//   segment the rows fall into runs that share one vertical window (a
//   line of h rows has 1 + max(0,h-1-u) + max(0,h-o) - max(0,h-window)
//   distinct windows; 1 for every main-path line of <= 51 rows).  Per
//   run the CTA brings its column sums S, Q (uint32, in registers, three
//   columns a thread) to the run's window, from the rows themselves for
//   the first run and by adding and removing rows after that, and takes
//   their prefix once (one block scan).  Every row of the run then
//   shares each column's window sums, so the ink test of a column is a
//   function of the pixel alone, and a monotone one (sauvola_limit in
//   csrc/sauvola.cuh): per column and polarity one limit, ink iff the
//   pixel is below it, found with the test's own operations.  The rows of
//   the run are then a map of compares, four columns a thread aligned to
//   the crop's bytes (word stores of both crops where the four columns
//   are whole, a word load of the centre pixels where the page row
//   allows it).  The prefix arrays are padded a word every 32 so that
//   threads a column apart hit distinct banks.  Each unit
//   adds its ink counts into the line's two counters (zeroed before the
//   launch): integer sums, exact in any order.  A 40-row line of 2,000
//   columns is four CTAs with one run each; a line of any height or
//   width takes the same path.  The count is the exact clamped
//   (hi - lo + 1) * (min(x+u,r-1) - max(x-o,l-1)), the division by it a
//   multiply-high where no column edge clamps the window, and every
//   float multiply and add of the test is rounded separately (__fmul_rn,
//   __fadd_rn, -fmad=false) in the plain version's order, so the two
//   agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sauvola.cuh"

#define TILE_COLS 512            // output columns of a unit
#define SEG_ROWS 64              // rows of a unit
#define COLS_A_THREAD 3          // column sums a thread keeps
#define MAX_LOADED (COLS_A_THREAD * 256)   // TILE_COLS + window - 1 fits
#define PADX(i) ((i) + ((i) >> 5))

namespace {

using apt::kThreads;
using apt::kWarps;

static_assert(kThreads == 256, "three column sums a thread of 256");

// add (sign 1) or remove (sign -1) rows [ya, yb) of the thread's columns
__device__ __forceinline__ void add_rows(const uint8_t* col, int W, int ya,
                                         int yb, int m, uint32_t (&s)[3],
                                         uint32_t (&q)[3], bool sub) {
  for (int y = ya; y < yb; ++y) {
    const uint8_t* row = col + (size_t)y * W;
#pragma unroll
    for (int j = 0; j < COLS_A_THREAD; ++j) {
      if (j < m) {
        const uint32_t v = row[j];
        s[j] = sub ? s[j] - v : s[j] + v;
        q[j] = sub ? q[j] - v * v : q[j] + v * v;
      }
    }
  }
}

// table: int32 (n, 5) rows (t, b, l, r, page); offs: int64 (n + 1);
// counts: int32 (n, 2), zeroed first.  Block x = line * tiles * segs +
// unit.
__global__ void __launch_bounds__(kThreads)
line_sauvola_kernel(const uint8_t* __restrict__ gray,
                    const int* __restrict__ table,
                    const long long* __restrict__ offs,
                    uint8_t* __restrict__ out_t, uint8_t* __restrict__ out_i,
                    int* __restrict__ counts, int H, int W, int tiles,
                    int segs, int o, int u, float km1, float k2) {
  __shared__ uint32_t ps[PADX(MAX_LOADED + 1) + 1];
  __shared__ uint32_t pq[PADX(MAX_LOADED + 1) + 1];
  __shared__ uint32_t wbuf[2 * kWarps];
  __shared__ uint32_t lim[TILE_COLS];     // plain | inverse << 16
  const int per_line = tiles * segs;
  const int i = blockIdx.x / per_line;
  const int unit = blockIdx.x - i * per_line;
  const int seg = unit / tiles, tile = unit - seg * tiles;
  const int t = table[5 * i], b = table[5 * i + 1];
  const int l = table[5 * i + 2], r = table[5 * i + 3];
  const int p = table[5 * i + 4];
  const int c0 = l + tile * TILE_COLS, ya = t + seg * SEG_ROWS;
  if (c0 >= r || ya >= b) return;           // past this line's units
  const int c1 = min(c0 + TILE_COLS, r), yb = min(ya + SEG_ROWS, b);
  // the columns [lc0, lc1) whose sums the tile's windows reach
  const int lc0 = max(c0 - o + 1, l), lc1 = min(c1 + u, r);
  const int n = lc1 - lc0, wl = r - l;
  const int window = o + u;
  const int tid = threadIdx.x;
  const int k0 = tid * COLS_A_THREAD;      // this thread's columns
  const int m = max(min(n - k0, COLS_A_THREAD), 0);
  const uint8_t* page = gray + (size_t)p * H * W;
  const uint8_t* mycol = page + lc0 + k0;
  const size_t off = (size_t)offs[i];
  apt::CountDiv div;

  uint32_t cs[COLS_A_THREAD] = {0u, 0u, 0u}, cq[COLS_A_THREAD] = {0u, 0u, 0u};
  int lo = 0, hi = -1;                     // the window the sums hold
  int ink_t = 0, ink_i = 0;
  // output columns in groups of 4 aligned to the crop's bytes: at most
  // this many groups a row
  const int ngroups = (c1 - c0 + 3) / 4 + 1;
  const int dy = kThreads / ngroups, dg = kThreads % ngroups;

  for (int y = ya; y < yb;) {
    // the run of rows from y that share its window
    const int nlo = max(y - o + 1, t), nhi = min(y + u, b - 1);
    int ye = yb;
    if (y - o + 1 > t) ye = min(ye, y + 1);        // lo moves every row
    else ye = min(ye, t + o);                      // lo = t up to t+o-1
    if (y + u < b - 1) ye = min(ye, y + 1);        // hi moves every row
    if (hi < lo) {
      add_rows(mycol, W, nlo, nhi + 1, m, cs, cq, false);
    } else {
      add_rows(mycol, W, hi + 1, nhi + 1, m, cs, cq, false);
      add_rows(mycol, W, lo, nlo, m, cs, cq, true);
    }
    lo = nlo;
    hi = nhi;

    // prefix sums of the column sums over [lc0, lc1)
    uint32_t s = 0u, q = 0u;
#pragma unroll
    for (int j = 0; j < COLS_A_THREAD; ++j) {
      s += cs[j];      // zero past the thread's m columns
      q += cq[j];
    }
    apt::block_exclusive_scan2(s, q, wbuf);   // its barriers: all threads
                                              // are past the last map
#pragma unroll
    for (int j = 0; j < COLS_A_THREAD; ++j) {
      if (j < m) {
        s += cs[j];
        q += cq[j];
        ps[PADX(k0 + j + 1)] = s;
        pq[PADX(k0 + j + 1)] = q;
      }
    }
    if (tid == 0) {
      ps[0] = 0u;
      pq[0] = 0u;
    }
    __syncthreads();

    // every row of the run shares the window, so each column's ink test
    // is one limit a polarity: ink iff px < the plain limit, and 255 - px
    // < the inverse one
    const int rows_in = hi - lo + 1;
    div.set((uint32_t)(rows_in * window));
    for (int x = c0 + tid; x < c1; x += kThreads) {
      const int a = max(x - o + 1, l) - lc0;
      const int e = min(x + u, r - 1) + 1 - lc0;
      const uint32_t cnt = (uint32_t)(rows_in * (e - a));
      const uint32_t sw = ps[PADX(e)] - ps[PADX(a)];
      const uint32_t qw = pq[PADX(e)] - pq[PADX(a)];
      const int lt = apt::sauvola_limit(sw, qw, cnt, km1, k2, div);
      const int li = apt::sauvola_limit(255u * cnt - sw,
                                        65025u * cnt - 510u * sw + qw, cnt,
                                        km1, k2, div);
      lim[x - c0] = (uint32_t)lt | (uint32_t)li << 16;
    }
    __syncthreads();

    // threshold rows [y, ye) x columns [c0, c1), four columns a thread
    // aligned to the crop's bytes
    int yy = y + tid / ngroups, g = tid % ngroups;
    for (; yy < ye; yy += dy, g += dg) {
      if (g >= ngroups) {
        g -= ngroups;
        if (++yy >= ye) break;
      }
      const size_t orow = off + (size_t)(yy - t) * wl - l;  // + x
      const int xs = c0 - (int)((uintptr_t)(out_t + orow + c0) & 3);
      const int x0 = xs + 4 * g;
      if (x0 >= c1) continue;
      const bool whole = x0 >= c0 && x0 + 4 <= c1;
      const uint8_t* prow = page + (size_t)yy * W;
      uint32_t pix;
      if (whole && (((uintptr_t)(prow + x0)) & 3) == 0) {
        pix = *(const uint32_t*)(prow + x0);
      } else {
        pix = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (x0 + j >= c0 && x0 + j < c1)
            pix |= (uint32_t)prow[x0 + j] << (8 * j);
      }
      uint32_t wt = 0u, wi = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int x = x0 + j;
        if (x < c0 || x >= c1) continue;
        const int px = (int)((pix >> (8 * j)) & 0xFFu);
        const uint32_t lm = lim[x - c0];
        wt |= (uint32_t)(px < (int)(lm & 0xFFFFu)) << (8 * j);
        wi |= (uint32_t)(255 - px < (int)(lm >> 16)) << (8 * j);
      }
      ink_t += __popc(wt);
      ink_i += __popc(wi);
      if (whole) {
        *(uint32_t*)(out_t + orow + x0) = wt;
        *(uint32_t*)(out_i + orow + x0) = wi;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (x0 + j >= c0 && x0 + j < c1) {
            out_t[orow + x0 + j] = (uint8_t)(wt >> (8 * j));
            out_i[orow + x0 + j] = (uint8_t)(wi >> (8 * j));
          }
        }
      }
    }
    y = ye;
  }

  // ink counts: warp shuffles, one word per warp, then the line's counters
  for (int d = 16; d > 0; d >>= 1) {
    ink_t += __shfl_down_sync(0xffffffffu, ink_t, d);
    ink_i += __shfl_down_sync(0xffffffffu, ink_i, d);
  }
  __syncthreads();
  if ((tid & 31) == 0) {
    wbuf[tid >> 5] = (uint32_t)ink_t;
    wbuf[kWarps + (tid >> 5)] = (uint32_t)ink_i;
  }
  __syncthreads();
  if (tid == 0) {
    int st = 0, si = 0;
    for (int w = 0; w < kWarps; ++w) {
      st += (int)wbuf[w];
      si += (int)wbuf[kWarps + w];
    }
    atomicAdd(&counts[2 * i], st);
    atomicAdd(&counts[2 * i + 1], si);
  }
}

}  // namespace

// n lines; tiles, segs: the most column tiles and row segments a line has
// (ops/lines_cuda.line_units).  out_t and out_i must be 4-byte aligned
// alike (every CUDA allocation is 256-byte aligned).  Returns the first
// cudaError_t.
extern "C" int apt_line_sauvola(const void* gray, const void* table,
                                const void* offs, void* out_t, void* out_i,
                                void* counts, int n, int H, int W,
                                int tiles, int segs, int window, float km1,
                                float k2, void* stream) {
  if (n == 0) return 0;
  const int o = (window + 1) / 2, u = window / 2;
  if (window < 1 || window > 255 || TILE_COLS + window - 1 > MAX_LOADED
      || (((uintptr_t)out_t ^ (uintptr_t)out_i) & 3))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)n * tiles * segs;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(counts, 0, (size_t)n * 2 * sizeof(int),
                                        st);
  if (e != cudaSuccess) return (int)e;
  line_sauvola_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      (const uint8_t*)gray, (const int*)table, (const long long*)offs,
      (uint8_t*)out_t, (uint8_t*)out_i, (int*)counts, H, W, tiles, segs, o,
      u, km1, k2);
  return (int)cudaGetLastError();
}
