// Exact in-place raster mask despeckle for Hopper (sm_90a), n = 2.
//
// Replaces: archive_pdf_tools_tpu/ops/denoise_pallas.py,
//   fast_mask_denoise_pallas (entry :304, pallas_call :349).  Semantics
//   are those of ops/denoise.py:fast_mask_denoise_exact (reference
//   optimiser.pyx:436-472): scanning row-major, a set interior pixel
//   survives iff TOP (final rows y-2..y-1, cols x-2..x+2) + BOT (original
//   rows y+1..y+2, cols x-2..x+2) + CUR (original row y, cols x+1..x+2) +
//   popcount(last two produced bits of this row) >= mincnt.  Border rows
//   and columns (< 2, >= h-2 / w-2) and zero pixels keep their value.
//
// What bounds it: two true recurrences, over rows (TOP reads the final
//   rows above) and within a row (the last two produced bits).  The row
//   walk is latency-bound; bytes and operations are small.
//
// Design: one CTA per page walks the rows.  Per row, all threads compute
//   tau = mincnt - TOP - BOT - CUR for every column in parallel and store
//   each column as an 8-bit transition map (2-bit next state for each of
//   the 4 states "last two produced bits") in shared memory.  Warp 0 then
//   resolves the row: each lane composes the maps of its chunk of
//   columns, a __shfl_up_sync inclusive scan composes the lanes' maps, and
//   each lane replays its chunk from its start state, writing the final
//   row.  TOP reads the two final rows from the output, which this CTA
//   wrote; __syncthreads() orders the rows.  The JAX package's bit-plane
//   and packed-table variants are the same function and are not needed.

#include <cuda_runtime.h>
#include <stdint.h>

// apply map a, then map b (4 states, 2 bits each)
__device__ __forceinline__ uint32_t compose(uint32_t a, uint32_t b) {
  uint32_t r = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint32_t as = (a >> (2 * s)) & 3u;
    r |= ((b >> (2 * as)) & 3u) << (2 * s);
  }
  return r;
}

__global__ void despeckle_kernel(const uint8_t* __restrict__ in,
                                 uint8_t* out, int H, int W, int mincnt) {
  extern __shared__ uint8_t maps[];
  const size_t plane = (size_t)H * W;
  const uint8_t* m = in + blockIdx.x * plane;
  uint8_t* o = out + blockIdx.x * plane;

  for (int y = 0; y < H; ++y) {
    const bool row_border = y < 2 || y >= H - 2;
    const uint8_t* r0 = m + (size_t)y * W;
    for (int x = threadIdx.x; x < W; x += blockDim.x) {
      const int v = r0[x] != 0;
      uint32_t map = 0;
      if (row_border || v == 0 || x < 2 || x >= W - 2) {
#pragma unroll
        for (int s = 0; s < 4; ++s) map |= (((s << 1) | v) & 3u) << (2 * s);
      } else {
        const uint8_t* f1 = o + (size_t)(y - 1) * W;
        const uint8_t* f2 = o + (size_t)(y - 2) * W;
        const uint8_t* b1 = m + (size_t)(y + 1) * W;
        const uint8_t* b2 = m + (size_t)(y + 2) * W;
        int cnt = (r0[x + 1] != 0) + (r0[x + 2] != 0);
#pragma unroll
        for (int dx = -2; dx <= 2; ++dx) {
          cnt += f1[x + dx] + f2[x + dx];
          cnt += (b1[x + dx] != 0) + (b2[x + dx] != 0);
        }
        const int tau = mincnt - cnt;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int u = __popc(s) >= tau;
          map |= (((s << 1) | u) & 3u) << (2 * s);
        }
      }
      maps[x] = (uint8_t)map;
    }
    __syncthreads();

    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int chunk = (W + 31) / 32;
      const int x0 = min(lane * chunk, W);
      const int x1 = min(x0 + chunk, W);
      uint32_t f = 0xE4u;                      // identity map
      for (int x = x0; x < x1; ++x) f = compose(f, maps[x]);
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t g = __shfl_up_sync(0xffffffffu, f, d);
        if (lane >= d) f = compose(g, f);
      }
      const uint32_t pre = __shfl_up_sync(0xffffffffu, f, 1);
      uint32_t s = lane == 0 ? 0u : (pre & 3u);  // state entering x0
      uint8_t* orow = o + (size_t)y * W;
      for (int x = x0; x < x1; ++x) {
        s = (maps[x] >> (2 * s)) & 3u;
        orow[x] = (uint8_t)(s & 1u);
      }
    }
    __syncthreads();
  }
}

extern "C" int apt_despeckle(const void* mask, void* out, int B, int H,
                             int W, int mincnt, void* stream) {
  const size_t smem = (size_t)W;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        despeckle_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  despeckle_kernel<<<B, 256, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (uint8_t*)out, H, W, mincnt);
  return (int)cudaGetLastError();
}
