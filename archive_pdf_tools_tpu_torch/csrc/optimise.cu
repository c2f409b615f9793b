// fg/bg 'optimise' radiate fill for Hopper (sm_90a).
//
// Replaces: archive_pdf_tools_tpu/ops/optimise_pallas.py, optimise_pallas
//   (entry :186, pallas_call :232 in _optimise_impl).  Semantics are those
//   of ops/optimise.py (reference optimiser.pyx:153-429): for a non-mask
//   pixel, out = (FIR_sum + IIR_sum) / (FIR_cnt + IIR_cnt), or 0 when the
//   count is 0.  FIR sums img over mask pixels in rows [y-n, y+n) x cols
//   [x-n, x+n); IIR sums the already-produced output over rows [y-n, y) x
//   cols [x-n, x), counted min(y,n) * (x - max(x-n,0)).  Mask pixels keep
//   img.
//
// What bounds it: the IIR term makes every row depend on the n rows
//   produced before it, so rows are sequential; the work per row is a few
//   dozen integer adds per pixel.  Latency of the row walk, not bytes or
//   operations, bounds this form.
//
// Design: one CTA per (page, channel) walks the rows.  Three int32 column
//   arrays live in shared memory (3 * W * 4 bytes, ~30 KB at W=2550): the
//   masked-FIR column sums and counts over rows [y-n, y+n) (row y+n-1
//   enters, row y-n-1 leaves), and the IIR column sums over the produced
//   rows [y-n, y) (read back from the output, which this CTA wrote).  Each
//   thread owns the same columns in every row; horizontal windows are
//   direct 2n- and n-wide sums from shared memory, with __syncthreads()
//   between the phases of a row.  All quantities are non-negative int32,
//   so the division is an exact integer '/'.  At batch 8 RGB this is 24
//   CTAs on 132 SMs: simple first; filling the card is later work.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void optimise_kernel(const uint8_t* __restrict__ img,
                                const uint8_t* __restrict__ mask,
                                uint8_t* out, int H, int W, int C, int n) {
  extern __shared__ int smem[];
  int* colF = smem;          // sum of img over mask pixels, rows [y-n, y+n)
  int* colC = smem + W;      // mask pixel count, rows [y-n, y+n)
  int* colI = smem + 2 * W;  // sum of output, rows [y-n, y)

  const int b = blockIdx.x / C;
  const int c = blockIdx.x % C;
  const size_t plane = (size_t)H * W;
  const uint8_t* m = mask + b * plane;
  const uint8_t* im = img + b * plane * C + c;  // pixel p at im[p * C]
  uint8_t* o = out + b * plane * C + c;

  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    int f = 0, k = 0;
    for (int r = 0; r < n && r < H; ++r) {      // window of row 0
      const size_t p = (size_t)r * W + x;
      const int mv = m[p] != 0;
      f += mv * im[p * C];
      k += mv;
    }
    colF[x] = f;
    colC[x] = k;
    colI[x] = 0;
  }
  __syncthreads();

  for (int y = 0; y < H; ++y) {
    if (y > 0) {
      const int ra = y + n - 1, rd = y - n - 1;
      for (int x = threadIdx.x; x < W; x += blockDim.x) {
        if (ra < H) {
          const size_t p = (size_t)ra * W + x;
          const int mv = m[p] != 0;
          colF[x] += mv * im[p * C];
          colC[x] += mv;
        }
        if (rd >= 0) {
          const size_t p = (size_t)rd * W + x;
          const int mv = m[p] != 0;
          colF[x] -= mv * im[p * C];
          colC[x] -= mv;
        }
      }
      __syncthreads();   // also publishes the previous row's colI update
    }
    const int ih = y < n ? y : n;
    for (int x = threadIdx.x; x < W; x += blockDim.x) {
      const size_t p = (size_t)y * W + x;
      int v;
      if (m[p]) {
        v = im[p * C];
      } else {
        const int x0 = x - n > 0 ? x - n : 0;
        const int x1 = x + n < W ? x + n : W;
        int fs = 0, fc = 0, is = 0;
        for (int xx = x0; xx < x1; ++xx) {
          fs += colF[xx];
          fc += colC[xx];
        }
        for (int xx = x0; xx < x; ++xx) is += colI[xx];
        const int cnt = fc + ih * (x - x0);
        v = cnt > 0 ? (fs + is) / cnt : 0;
      }
      o[p * C] = (uint8_t)v;
    }
    __syncthreads();     // every read of colI for row y is done
    for (int x = threadIdx.x; x < W; x += blockDim.x) {
      int d = o[((size_t)y * W + x) * C];
      if (y >= n) d -= o[((size_t)(y - n) * W + x) * C];
      colI[x] += d;
    }
  }
}

extern "C" int apt_optimise(const void* img, const void* mask, void* out,
                            int B, int H, int W, int C, int n,
                            void* stream) {
  const size_t smem = 3 * (size_t)W * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        optimise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  optimise_kernel<<<B * C, 1024, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (const uint8_t*)mask, (uint8_t*)out, H, W, C, n);
  return (int)cudaGetLastError();
}
