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
//   window, rows [max(y-o+1,t), min(y+u,b-1)], for cols [l,r), and per
//   row their prefix sums from a block scan (uint32: Q reaches
//   65025 * window^2, exact while below 2^32, i.e. window <= 255; the
//   wrapper raises above that).  The window sums are prefix differences,
//   the count is the exact clamped
//   (min(y+u,b-1) - max(y-o,t-1)) * (min(x+u,r-1) - max(x-o,l-1)).
//   Every float multiply and add is rounded separately (__fmul_rn,
//   __fadd_rn, -fmad=false), in the plain version's order, so the two
//   agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)

// Exclusive block-wide prefix sums of two per-thread values (uint32,
// wrapping).  wbuf holds 2 * WARPS words.  All THREADS threads call it.
__device__ __forceinline__ void block_exclusive_scan2(uint32_t& a,
                                                      uint32_t& b,
                                                      uint32_t* wbuf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t ia = a, ib = b;
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t va = __shfl_up_sync(0xffffffffu, ia, d);
    const uint32_t vb = __shfl_up_sync(0xffffffffu, ib, d);
    if (lane >= d) {
      ia += va;
      ib += vb;
    }
  }
  if (lane == 31) {
    wbuf[warp] = ia;
    wbuf[WARPS + warp] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    const uint32_t wa = lane < WARPS ? wbuf[lane] : 0u;
    const uint32_t wb = lane < WARPS ? wbuf[WARPS + lane] : 0u;
    uint32_t xa = wa, xb = wb;
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t va = __shfl_up_sync(0xffffffffu, xa, d);
      const uint32_t vb = __shfl_up_sync(0xffffffffu, xb, d);
      if (lane >= d) {
        xa += va;
        xb += vb;
      }
    }
    if (lane < WARPS) {
      wbuf[lane] = xa - wa;
      wbuf[WARPS + lane] = xb - wb;
    }
  }
  __syncthreads();
  a = wbuf[warp] + (ia - a);
  b = wbuf[WARPS + warp] + (ib - b);
}

__device__ __forceinline__ bool sauvola_ink(uint32_t s, uint32_t q,
                                            uint32_t cnt, int px, float km1,
                                            float k2) {
  const int mean_i = (int)(s / cnt);
  const int var_i = (int)(q / cnt) - mean_i * mean_i;
  const float mean = (float)mean_i;
  const float var = (float)var_i;
  const float t = __fadd_rn((float)px, __fmul_rn(mean, km1));
  const float rhs = __fmul_rn(__fmul_rn(__fmul_rn(mean, mean), k2), var);
  return t <= 0.0f || __fmul_rn(t, t) <= rhs;
}

// table: int32 (n, 5) rows (t, b, l, r, page); offs: int64 (n + 1)
__global__ void __launch_bounds__(THREADS)
line_sauvola_kernel(const uint8_t* __restrict__ gray,
                    const int* __restrict__ table,
                    const long long* __restrict__ offs,
                    uint8_t* __restrict__ out_t, uint8_t* __restrict__ out_i,
                    int* __restrict__ counts, int H, int W, int o, int u,
                    float km1, float k2) {
  extern __shared__ uint32_t sh[];
  const int i = blockIdx.x;
  const int t = table[5 * i], b = table[5 * i + 1];
  const int l = table[5 * i + 2], r = table[5 * i + 3];
  const int p = table[5 * i + 4];
  const int wl = r - l;
  uint32_t* colS = sh;
  uint32_t* colQ = sh + wl;
  uint32_t* ps = sh + 2 * wl;        // ps[c] = sum of colS[0..c)
  uint32_t* pq = ps + (wl + 1);
  uint32_t* wbuf = pq + (wl + 1);    // 2 * WARPS words

  const uint8_t* page = gray + (size_t)p * H * W + l;
  const size_t off = (size_t)offs[i];
  const int tid = threadIdx.x;

  // vertical window of row t: rows [t, min(t+u, b-1)]
  const int y_hi0 = min(t + u, b - 1);
  for (int c = tid; c < wl; c += THREADS) {
    uint32_t s = 0, q = 0;
    for (int yy = t; yy <= y_hi0; ++yy) {
      const uint32_t v = page[(size_t)yy * W + c];
      s += v;
      q += v * v;
    }
    colS[c] = s;
    colQ[c] = q;
  }

  const int chunk = (wl + THREADS - 1) / THREADS;
  const int c0 = min(tid * chunk, wl);
  const int c1 = min(c0 + chunk, wl);
  int ink_t = 0, ink_i = 0;

  for (int y = t; y < b; ++y) {
    if (y > t) {                     // rows [y-o+1, y+u] from [y-o, y+u-1]
      const bool add = y + u <= b - 1, rem = y - o >= t;
      for (int c = tid; c < wl; c += THREADS) {
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

    // prefix sums of the column sums over [l, r)
    uint32_t s = 0, q = 0;
    for (int c = c0; c < c1; ++c) {
      s += colS[c];
      q += colQ[c];
    }
    block_exclusive_scan2(s, q, wbuf);
    for (int c = c0; c < c1; ++c) {
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
    const uint8_t* row = page + (size_t)y * W;
    const size_t obase = off + (size_t)(y - t) * wl;
    for (int c = tid; c < wl; c += THREADS) {
      const int x = l + c;
      const int lo = max(x - o + 1, l) - l;
      const int hi = min(x + u, r - 1) + 1 - l;
      const uint32_t cnt = (uint32_t)(rows_in * (hi - lo));
      const uint32_t sw = ps[hi] - ps[lo];
      const uint32_t qw = pq[hi] - pq[lo];
      const int px = row[c];
      const bool it = sauvola_ink(sw, qw, cnt, px, km1, k2);
      const uint32_t si = 255u * cnt - sw;
      const uint32_t qi = 65025u * cnt - 510u * sw + qw;
      const bool ii = sauvola_ink(si, qi, cnt, 255 - px, km1, k2);
      out_t[obase + c] = it ? 1 : 0;
      out_i[obase + c] = ii ? 1 : 0;
      ink_t += it;
      ink_i += ii;
    }
  }

  // ink counts: warp shuffles, then one word per warp
  for (int d = 16; d > 0; d >>= 1) {
    ink_t += __shfl_down_sync(0xffffffffu, ink_t, d);
    ink_i += __shfl_down_sync(0xffffffffu, ink_i, d);
  }
  __syncthreads();
  if ((tid & 31) == 0) {
    wbuf[tid >> 5] = (uint32_t)ink_t;
    wbuf[WARPS + (tid >> 5)] = (uint32_t)ink_i;
  }
  __syncthreads();
  if (tid == 0) {
    int st = 0, si = 0;
    for (int w = 0; w < WARPS; ++w) {
      st += (int)wbuf[w];
      si += (int)wbuf[WARPS + w];
    }
    counts[2 * i] = st;
    counts[2 * i + 1] = si;
  }
}

extern "C" int apt_line_sauvola(const void* gray, const void* table,
                                const void* offs, void* out_t, void* out_i,
                                void* counts, int n, int H, int W,
                                int max_wl, int window, float km1, float k2,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int o = (window + 1) / 2, u = window / 2;
  const size_t smem = (4 * (size_t)max_wl + 2 + 2 * WARPS) * sizeof(uint32_t);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(line_sauvola_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  line_sauvola_kernel<<<n, THREADS, smem, st>>>(
      (const uint8_t*)gray, (const int*)table, (const long long*)offs,
      (uint8_t*)out_t, (uint8_t*)out_i, (int*)counts, H, W, o, u, km1, k2);
  return (int)cudaGetLastError();
}
