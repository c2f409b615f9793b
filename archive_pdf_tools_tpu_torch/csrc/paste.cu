// Ordered paste of the selected hOCR line crops into page masks, for
// Hopper (sm_90a).
//
// Replaces: archive_pdf_tools_tpu/ops/paste_pallas.py, paste_crops_pallas
//   (entry :145, pallas_call :203; host plan build_paste_plan :43).
//   Semantics are the reference's (mrc.py:265-266, 329): the crop of
//   each selected line (1 = plain, 2 = inverse) overwrites its box in
//   document order, so the last selected line wins an overlap and an
//   unselected line pastes nothing; then the global mask is OR-ed in.
//
// Layout: the ragged crop buffers of csrc/line_sauvola.cu (line i's
//   crop row-major at off[i]); table int32 (n, 5) rows (t, b, l, r,
//   page) in document order.
//
// What bounds it: bytes.  The owner map (int32 per pixel, 269 MB at
//   8 x 3300x2550) is zeroed, scattered into over the selected boxes and
//   read once; the crops and the global mask are read once; the mask is
//   written once: under 1 GB of traffic per 8-page 400-DPI batch.
//
// Design: two passes, no host plan.  "Last selected line wins" is a
//   maximum over line indices, which atomicMax computes exactly in any
//   order:
//   1. owner: one CTA per selected line scatters atomicMax(owner, i + 1)
//      over its box (owner zeroed first);
//   2. compose: one thread per pixel reads the winning line's crop byte,
//      if any, and ORs the global mask.

#include <cuda_runtime.h>
#include <stdint.h>

#define OWNER_THREADS 256
#define PIX_THREADS 256

__global__ void owner_kernel(const int* __restrict__ table,
                             const int* __restrict__ sel,
                             int* __restrict__ owner, int H, int W) {
  const int i = blockIdx.x;
  if (sel[i] == 0) return;
  const int t = table[5 * i], b = table[5 * i + 1];
  const int l = table[5 * i + 2], r = table[5 * i + 3];
  int* pg = owner + (size_t)table[5 * i + 4] * H * W;
  for (int y = t; y < b; ++y) {
    for (int x = l + threadIdx.x; x < r; x += blockDim.x) {
      atomicMax(pg + (size_t)y * W + x, i + 1);
    }
  }
}

__global__ void compose_kernel(const uint8_t* __restrict__ crops_t,
                               const uint8_t* __restrict__ crops_i,
                               const int* __restrict__ table,
                               const long long* __restrict__ offs,
                               const int* __restrict__ sel,
                               const int* __restrict__ owner,
                               const uint8_t* __restrict__ gmask,
                               uint8_t* __restrict__ out, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y, p = blockIdx.z;
  if (x >= W) return;
  const size_t idx = ((size_t)p * H + y) * W + x;
  uint8_t v = 0;
  const int o = owner[idx];
  if (o > 0) {
    const int i = o - 1;
    const int t = table[5 * i], l = table[5 * i + 2];
    const int wl = table[5 * i + 3] - l;
    const uint8_t* src = sel[i] == 1 ? crops_t : crops_i;
    v = src[(size_t)offs[i] + (size_t)(y - t) * wl + (x - l)];
  }
  out[idx] = (v | gmask[idx]) ? 1 : 0;
}

extern "C" int apt_paste(const void* crops_t, const void* crops_i,
                         const void* table, const void* offs,
                         const void* sel, void* owner, const void* gmask,
                         void* out, int n, int B, int H, int W,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(owner, 0, (size_t)B * H * W * sizeof(int),
                                  st);
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    owner_kernel<<<n, OWNER_THREADS, 0, st>>>((const int*)table,
                                              (const int*)sel, (int*)owner,
                                              H, W);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + PIX_THREADS - 1) / PIX_THREADS, H, B);
  compose_kernel<<<grid, PIX_THREADS, 0, st>>>(
      (const uint8_t*)crops_t, (const uint8_t*)crops_i, (const int*)table,
      (const long long*)offs, (const int*)sel, (const int*)owner,
      (const uint8_t*)gmask, (uint8_t*)out, H, W);
  return (int)cudaGetLastError();
}
