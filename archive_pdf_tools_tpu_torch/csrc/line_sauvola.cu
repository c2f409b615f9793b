// Per-hOCR-line dual Sauvola thresholds (k = 0.1) for Hopper (sm_90a).
//
// Replaces: archive_pdf_tools_tpu/ops/lines_pallas.py,
//   line_thresholds_pallas (entry :185, pallas_call :256).  Semantics are
//   the reference's (mrc.py:188-270): each line's bbox crop [t,b) x [l,r)
//   of its page is thresholded on its own, and so is its inverse
//   255 - crop, with Sauvola windows clamped to the crop: integer mean and
//   E[x^2] by floor division, then the float32 squared-form test (k >= 0
//   branch).  The inverse needs no second walk: with S, Q and C the
//   window's sum, sum of squares and count, its sums are S' = 255C - S
//   and Q' = 65025C - 510S + Q.  Ink counts of both polarities over the
//   whole crop are fused.
//
// Layout: ragged.  Line i's crops are stored row-major, (b-t) rows of
//   (r-l) bytes, at out_t + off[i] and out_i + off[i], where off is the
//   host prefix sum of the line areas.  No height buckets, no row
//   alignment: a line of any height takes the same path.
//
// What bounds it: a few reads of each crop pixel (enter, leave, centre)
//   and one write per polarity: bytes, and at ~500 lines per 8-page
//   400-DPI batch, the row walk's latency inside each CTA.
//
// Design (simple first): one CTA per line walks the line's rows top to
//   bottom.  Shared memory holds the column sums S and Q of the vertical
//   window, rows [max(y-o+1,t), min(y+u,b-1)], and per row their prefix
//   sums from a block scan (uint32, csrc/sauvola.cuh).  The window sums
//   are prefix differences, the count the exact clamped
//   (min(y+u,b-1) - max(y-o,t-1)) * (min(x+u,r-1) - max(x-o,l-1)), and
//   the division by it a multiply-high where no column edge clamps the
//   window.  Every float multiply and add is rounded separately
//   (__fmul_rn, __fadd_rn, -fmad=false), in the plain version's order, so
//   the two agree bit for bit.
//   A line wider than one CTA's shared memory holds (MAX_LINE_WIDTH of
//   ops/lines_cuda.py) is split into column strips
//   (ops/lines_cuda.line_strips), a CTA each: a strip keeps the sums of
//   its columns plus a halo of o-1 on the left and u on the right,
//   clamped to the crop, writes only its own columns of the crop and adds
//   its ink counts into the line's two counters.  The window stays
//   clamped to the line's edges, so strips share nothing but the halo,
//   which each recomputes.  A narrower line is one strip, the whole line.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sauvola.cuh"

namespace {

using apt::kThreads;
using apt::kWarps;

// table: int32 (n, 5) rows (t, b, l, r, page); strips: int32 (m, 3) rows
// (line, c0, c1), or null for one strip a line; offs: int64 (n + 1);
// counts: int32 (n, 2), zeroed where there are strips
__global__ void __launch_bounds__(kThreads)
line_sauvola_kernel(const uint8_t* __restrict__ gray,
                    const int* __restrict__ table,
                    const int* __restrict__ strips,
                    const long long* __restrict__ offs,
                    uint8_t* __restrict__ out_t, uint8_t* __restrict__ out_i,
                    int* __restrict__ counts, int H, int W, int o, int u,
                    float km1, float k2) {
  extern __shared__ uint32_t sh[];
  const int i = strips ? strips[3 * blockIdx.x] : blockIdx.x;
  const int t = table[5 * i], b = table[5 * i + 1];
  const int l = table[5 * i + 2], r = table[5 * i + 3];
  const int p = table[5 * i + 4];
  // this CTA's output columns [c0, c1) and the columns [lc0, lc1) whose
  // sums their windows reach
  const int c0 = strips ? strips[3 * blockIdx.x + 1] : l;
  const int c1 = strips ? strips[3 * blockIdx.x + 2] : r;
  const int lc0 = max(c0 - o + 1, l), lc1 = min(c1 + u, r);
  const int wl = r - l, n = lc1 - lc0;
  uint32_t* colS = sh;
  uint32_t* colQ = sh + n;
  uint32_t* ps = sh + 2 * n;         // ps[c] = sum of colS[0..c)
  uint32_t* pq = ps + (n + 1);
  uint32_t* wbuf = pq + (n + 1);     // 2 * kWarps words

  const uint8_t* page = gray + (size_t)p * H * W + lc0;
  const size_t off = (size_t)offs[i];
  const int tid = threadIdx.x;
  apt::CountDiv div;

  // vertical window of row t: rows [t, min(t+u, b-1)]
  const int y_hi0 = min(t + u, b - 1);
  for (int c = tid; c < n; c += kThreads) {
    uint32_t s = 0, q = 0;
    for (int yy = t; yy <= y_hi0; ++yy) {
      const uint32_t v = page[(size_t)yy * W + c];
      s += v;
      q += v * v;
    }
    colS[c] = s;
    colQ[c] = q;
  }

  const int chunk = (n + kThreads - 1) / kThreads;
  const int k0 = min(tid * chunk, n);
  const int k1 = min(k0 + chunk, n);
  int ink_t = 0, ink_i = 0;

  for (int y = t; y < b; ++y) {
    if (y > t) {                     // rows [y-o+1, y+u] from [y-o, y+u-1]
      const bool add = y + u <= b - 1, rem = y - o >= t;
      for (int c = tid; c < n; c += kThreads) {
        uint32_t s = colS[c], q = colQ[c];
        if (add) {
          const uint32_t v = page[(size_t)(y + u) * W + c];
          s += v;
          q += v * v;
        }
        if (rem) {
          const uint32_t v = page[(size_t)(y - o) * W + c];
          s -= v;
          q -= v * v;
        }
        colS[c] = s;
        colQ[c] = q;
      }
    }
    __syncthreads();

    // prefix sums of the column sums over [lc0, lc1)
    uint32_t s = 0, q = 0;
    for (int c = k0; c < k1; ++c) {
      s += colS[c];
      q += colQ[c];
    }
    apt::block_exclusive_scan2(s, q, wbuf);
    for (int c = k0; c < k1; ++c) {
      s += colS[c];
      q += colQ[c];
      ps[c + 1] = s;
      pq[c + 1] = q;
    }
    if (tid == 0) {
      ps[0] = 0;
      pq[0] = 0;
    }
    __syncthreads();

    const int rows_in = min(y + u, b - 1) - max(y - o, t - 1);
    div.set((uint32_t)(rows_in * (o + u)));
    const uint8_t* row = page + (size_t)y * W - lc0;
    const size_t obase = off + (size_t)(y - t) * wl - l;
    for (int x = c0 + tid; x < c1; x += kThreads) {
      const int lo = max(x - o + 1, l) - lc0;
      const int hi = min(x + u, r - 1) + 1 - lc0;
      const uint32_t cnt = (uint32_t)(rows_in * (hi - lo));
      const uint32_t sw = ps[hi] - ps[lo];
      const uint32_t qw = pq[hi] - pq[lo];
      const int px = row[x];
      const bool it = apt::sauvola_ink(sw, qw, cnt, px, km1, k2, div);
      const uint32_t si = 255u * cnt - sw;
      const uint32_t qi = 65025u * cnt - 510u * sw + qw;
      const bool ii = apt::sauvola_ink(si, qi, cnt, 255 - px, km1, k2, div);
      out_t[obase + x] = it ? 1 : 0;
      out_i[obase + x] = ii ? 1 : 0;
      ink_t += it;
      ink_i += ii;
    }
  }

  // ink counts: warp shuffles, then one word per warp, then the line's
  // counters
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
    if (strips) {
      atomicAdd(&counts[2 * i], st);
      atomicAdd(&counts[2 * i + 1], si);
    } else {
      counts[2 * i] = st;
      counts[2 * i + 1] = si;
    }
  }
}

}  // namespace

// m strips (ops/lines_cuda.line_strips; strips null: m = n, the whole
// lines), max_loaded: the most columns a strip keeps sums of.  Returns
// the first cudaError_t.
extern "C" int apt_line_sauvola(const void* gray, const void* table,
                                const void* strips, const void* offs,
                                void* out_t, void* out_i, void* counts,
                                int m, int H, int W, int max_loaded,
                                int window, float km1, float k2,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int o = (window + 1) / 2, u = window / 2;
  const size_t smem = (4 * (size_t)max_loaded + 2 + 2 * kWarps)
      * sizeof(uint32_t);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(line_sauvola_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  line_sauvola_kernel<<<m, kThreads, smem, st>>>(
      (const uint8_t*)gray, (const int*)table, (const int*)strips,
      (const long long*)offs, (uint8_t*)out_t, (uint8_t*)out_i,
      (int*)counts, H, W, o, u, km1, k2);
  return (int)cudaGetLastError();
}
