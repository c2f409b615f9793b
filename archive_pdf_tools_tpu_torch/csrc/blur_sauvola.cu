// Noise-adaptive gaussian pre-blur + global Sauvola for Hopper (sm_90a).
//
// Replaces: archive_pdf_tools_tpu/ops/threshold_pallas.py,
//   blur_sauvola_pallas (entry :175, pallas_call :233 in
//   _blur_sauvola_impl).  Semantics are those of the XLA form
//   mrc/decompose.py:global_threshold_input + global_threshold: a
//   separable blur with per-page f32 taps and symmetric (edge-repeating)
//   borders, truncated to uint8, then Sauvola with a window x window box
//   clamped at the edges: integer mean and E[x^2] by floor division and
//   the float32 squared-form test (k >= 0 branch).
//
// Numerics: one fixed order, shared with the plain PyTorch version in
//   ops/threshold_cuda.py: vertical pass, then horizontal, taps ascending
//   from 0, no folding of mirrored taps, every multiply and add rounded
//   separately (built with -fmad=false; __fmul_rn/__fadd_rn make it
//   explicit).  The f32 sum decides the uint8 truncation, so kernel and
//   plain version agree bit for bit.
//
// What bounds it: no true recurrence; it is a few windowed stencils over
//   the page.  Bytes (the f32 intermediate and the int32 column sums,
//   ~1.7 GB per 8-page 400-DPI batch) and the tap MACs (2 * (2r+1) per
//   pixel) bound it.
//
// Design (simple first, four launches):
//   1. vblur:  thread per pixel, vertical MAC -> f32 scratch;
//   2. hblur:  thread per pixel, horizontal MAC, truncate to uint8;
//   3. colsum: thread per (column, 64-row chunk), running window column
//              sums of x and x^2 over rows [y-o+1, y+u] -> int32 scratch;
//   4. rows:   CTA per row, prefix sums of the column sums in shared memory
//              (uint32, whose wrap leaves window differences exact), then
//              the window sums, the exact clamped count
//              (min(y+u,h-1) - max(y-o,-1)) * (min(x+u,w-1) - max(x-o,-1))
//              and the Sauvola test.
//   The window sum of squares Q reaches 65025 * window^2, past 2^31 from
//   window 183 (dpi >= 728), so it is kept and divided as uint32, as the
//   JAX package does: exact while Q < 2^32, i.e. window <= 255 (the
//   wrapper raises above that).  Fusing the passes into one H-tiled
//   kernel with halos is later work.
//
// Ablation builds (-DAPT_ABLATE=APT_ABL_<variant>, one .so each, for
//   archive_pdf_tools_tpu_torch/tools/threshold_ablate.py; they replace
//   the TPU tool tools/threshold_ablate.py:189 _build).  Each switches
//   parts of the four launches off to localise their cost; built with no
//   define, this file is the shipped kernel:
//   NO_VMAC    vblur stores the centre pixel (horizontal-only blur);
//   NO_HMAC    hblur truncates the centre value (vertical-only blur);
//   NO_BLUR    both: Sauvola on the raw page;
//   NO_EMIT    colsum and rows skipped; hblur writes the uint8 blurred
//              page to out;
//   MACHINERY  the four launches keep their loads and stores and drop
//              their arithmetic (no MACs, no window sums, no test):
//              out = img;
//   U8RING     MACHINERY with the vtmp scratch held as uint8: scratch
//              bandwidth apart from the float conversion;
//   PASSTHRU   one copy launch, img -> out: the floor.

#include <cuda_runtime.h>
#include <stdint.h>

#define COL_ROWS 64
#define ROW_THREADS 256

#define APT_ABL_FULL 0
#define APT_ABL_NO_VMAC 1
#define APT_ABL_NO_HMAC 2
#define APT_ABL_NO_BLUR 3
#define APT_ABL_NO_EMIT 4
#define APT_ABL_MACHINERY 5
#define APT_ABL_U8RING 6
#define APT_ABL_PASSTHRU 7
#ifndef APT_ABLATE
#define APT_ABLATE APT_ABL_FULL
#endif
#define ABL(v) (APT_ABLATE == APT_ABL_##v)
#define BARE (ABL(MACHINERY) || ABL(U8RING))

#if ABL(U8RING)
typedef uint8_t vtmp_t;
#else
typedef float vtmp_t;
#endif

__device__ __forceinline__ int sym_index(int p, int n) {
  int q = p % (2 * n);
  if (q < 0) q += 2 * n;
  return q < n ? q : 2 * n - 1 - q;
}

__global__ void vblur_kernel(const uint8_t* __restrict__ img,
                             const float* __restrict__ taps,
                             vtmp_t* __restrict__ v, int H, int W, int r) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y, b = blockIdx.z;
  if (x >= W) return;
  const uint8_t* p = img + (size_t)b * H * W + x;
#if ABL(NO_VMAC) || ABL(NO_BLUR) || BARE
  v[((size_t)b * H + y) * W + x] = (vtmp_t)p[(size_t)y * W];
#else
  const float* wt = taps + (size_t)b * (2 * r + 1);
  float acc = 0.0f;
  for (int t = 0; t <= 2 * r; ++t) {
    const int yy = sym_index(y - r + t, H);
    acc = __fadd_rn(acc, __fmul_rn(wt[t], (float)p[(size_t)yy * W]));
  }
  v[((size_t)b * H + y) * W + x] = acc;
#endif
}

__global__ void hblur_kernel(const vtmp_t* __restrict__ v,
                             const float* __restrict__ taps,
                             uint8_t* __restrict__ blur, int H, int W,
                             int r) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y, b = blockIdx.z;
  if (x >= W) return;
  const vtmp_t* row = v + ((size_t)b * H + y) * W;
#if BARE
  blur[((size_t)b * H + y) * W + x] = (uint8_t)row[x];
#else
#if ABL(NO_HMAC) || ABL(NO_BLUR)
  const float acc = row[x];
#else
  const float* wt = taps + (size_t)b * (2 * r + 1);
  float acc = 0.0f;
  for (int t = 0; t <= 2 * r; ++t) {
    acc = __fadd_rn(acc, __fmul_rn(wt[t], row[sym_index(x - r + t, W)]));
  }
#endif
  int iv = (int)acc;                 // truncation, like astype(uint8)
  iv = iv < 0 ? 0 : (iv > 255 ? 255 : iv);
  blur[((size_t)b * H + y) * W + x] = (uint8_t)iv;
#endif
}

__global__ void colsum_kernel(const uint8_t* __restrict__ blur,
                              int* __restrict__ scol, int* __restrict__ qcol,
                              int H, int W, int o, int u) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y0 = blockIdx.y * COL_ROWS, b = blockIdx.z;
  if (x >= W) return;
  const int y1 = min(y0 + COL_ROWS, H);
  const size_t base = (size_t)b * H * W + x;
  const uint8_t* p = blur + base;
#if BARE
  for (int y = y0; y < y1; ++y) {    // one load, two stores a pixel
    const int val = p[(size_t)y * W];
    scol[base + (size_t)y * W] = val;
    qcol[base + (size_t)y * W] = val;
  }
#else
  int s = 0, q = 0;
  for (int yy = max(y0 - o + 1, 0); yy <= min(y0 + u, H - 1); ++yy) {
    const int val = p[(size_t)yy * W];
    s += val;
    q += val * val;
  }
  for (int y = y0; y < y1; ++y) {
    if (y > y0) {                    // rows [y-o+1, y+u]
      if (y + u < H) {
        const int val = p[(size_t)(y + u) * W];
        s += val;
        q += val * val;
      }
      if (y - o >= 0) {
        const int val = p[(size_t)(y - o) * W];
        s -= val;
        q -= val * val;
      }
    }
    scol[base + (size_t)y * W] = s;
    qcol[base + (size_t)y * W] = q;
  }
#endif
}

__global__ void rows_kernel(const uint8_t* __restrict__ blur,
                            const int* __restrict__ scol,
                            const int* __restrict__ qcol,
                            uint8_t* __restrict__ out, int H, int W, int o,
                            int u, float km1, float k2) {
  const int y = blockIdx.x, b = blockIdx.y;
  const size_t rbase = ((size_t)b * H + y) * W;
#if BARE
  // the loads and the store of the test, nothing between: out = blur
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    out[rbase + x] = (uint8_t)(scol[rbase + x] ^ qcol[rbase + x]
                               ^ blur[rbase + x]);
  }
#else
  extern __shared__ uint32_t sh[];
  uint32_t* ps = sh;                 // ps[i] = sum of scol[0..i)
  uint32_t* pq = sh + (W + 1);
  uint32_t* tot_s = sh + 2 * (W + 1);
  uint32_t* tot_q = tot_s + ROW_THREADS;

  const int chunk = (W + ROW_THREADS - 1) / ROW_THREADS;
  const int c0 = min((int)threadIdx.x * chunk, W);
  const int c1 = min(c0 + chunk, W);

  uint32_t s = 0, q = 0;
  for (int x = c0; x < c1; ++x) {
    s += (uint32_t)scol[rbase + x];
    q += (uint32_t)qcol[rbase + x];
    ps[x + 1] = s;
    pq[x + 1] = q;
  }
  tot_s[threadIdx.x] = s;
  tot_q[threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.x == 0) {            // exclusive scan of chunk totals
    uint32_t as = 0, aq = 0;
    for (int i = 0; i < ROW_THREADS; ++i) {
      const uint32_t ts = tot_s[i], tq = tot_q[i];
      tot_s[i] = as;
      tot_q[i] = aq;
      as += ts;
      aq += tq;
    }
    ps[0] = 0;
    pq[0] = 0;
  }
  __syncthreads();
  for (int x = c0; x < c1; ++x) {
    ps[x + 1] += tot_s[threadIdx.x];
    pq[x + 1] += tot_q[threadIdx.x];
  }
  __syncthreads();

  const int rows_in = min(y + u, H - 1) - max(y - o, -1);
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const int lo = max(x - o + 1, 0);
    const int hi = min(x + u, W - 1) + 1;
    const int sw = (int)(ps[hi] - ps[lo]);
    const uint32_t qw = pq[hi] - pq[lo];
    const int cnt = rows_in * (min(x + u, W - 1) - max(x - o, -1));
    const int mean_i = sw / cnt;
    const int var_i = (int)(qw / (uint32_t)cnt) - mean_i * mean_i;
    const float mean = (float)mean_i;
    const float var = (float)var_i;
    const float px = (float)blur[rbase + x];
    const float t = __fadd_rn(px, __fmul_rn(mean, km1));
    const float rhs = __fmul_rn(__fmul_rn(__fmul_rn(mean, mean), k2), var);
    out[rbase + x] = (t <= 0.0f || __fmul_rn(t, t) <= rhs) ? 1 : 0;
  }
#endif
}

#if ABL(PASSTHRU)
__global__ void copy_kernel(const uint8_t* __restrict__ img,
                            uint8_t* __restrict__ out, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t i = ((size_t)blockIdx.z * H + blockIdx.y) * W + x;
  if (x < W) out[i] = img[i];
}
#endif

extern "C" int apt_blur_sauvola(const void* img, const void* taps, void* out,
                                void* vtmp, void* blur, void* scol,
                                void* qcol, int B, int H, int W, int radius,
                                int window, float km1, float k2,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 pix((W + 255) / 256, H, B);
#if ABL(PASSTHRU)
  copy_kernel<<<pix, 256, 0, st>>>((const uint8_t*)img, (uint8_t*)out, H, W);
#elif ABL(NO_EMIT)                   // hblur writes the blurred page to out
  vblur_kernel<<<pix, 256, 0, st>>>((const uint8_t*)img, (const float*)taps,
                                    (vtmp_t*)vtmp, H, W, radius);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  hblur_kernel<<<pix, 256, 0, st>>>((const vtmp_t*)vtmp, (const float*)taps,
                                    (uint8_t*)out, H, W, radius);
#else
  const int o = (window + 1) / 2, u = window / 2;
  cudaError_t e;
  vblur_kernel<<<pix, 256, 0, st>>>((const uint8_t*)img, (const float*)taps,
                                    (vtmp_t*)vtmp, H, W, radius);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  hblur_kernel<<<pix, 256, 0, st>>>((const vtmp_t*)vtmp, (const float*)taps,
                                    (uint8_t*)blur, H, W, radius);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const dim3 cols((W + 255) / 256, (H + COL_ROWS - 1) / COL_ROWS, B);
  colsum_kernel<<<cols, 256, 0, st>>>((const uint8_t*)blur, (int*)scol,
                                      (int*)qcol, H, W, o, u);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const size_t smem = (2 * ((size_t)W + 1) + 2 * ROW_THREADS)
      * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(rows_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rows_kernel<<<dim3(H, B), ROW_THREADS, smem, st>>>(
      (const uint8_t*)blur, (const int*)scol, (const int*)qcol,
      (uint8_t*)out, H, W, o, u, km1, k2);
#endif
  return (int)cudaGetLastError();
}
