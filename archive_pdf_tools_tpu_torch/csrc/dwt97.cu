// JPEG2000 forward transform for Hopper (sm_90a): DC shift or the exact
// int32 ICT, the L-level CDF 9/7 lifting DWT and the per-band deadzone
// quantiser, for a batch of pages.
//
// Replaces: archive_pdf_tools_tpu/codecs/jp2tpu.py, _device_transform
//   (:260-308), which is XLA ops, not a Pallas kernel.  It must equal that
//   transform on XLA-CPU and native/jp2t1.cpp:jp2dwt_quantize bit for bit,
//   and the plain PyTorch version ops/dwt97.py.  So every lifting update is
//   one __fmaf_rn(coef, __fadd_rn(a, b), dst), as Lift1D's fmaf; the
//   low/high scalings and the quantiser's multiply are separate __fmul_rn;
//   the build has -fmad=false, so nothing else fuses; the ICT is integer.
//
// What bounds it: in this first form, latency.  The data is a few
//   operations a sample and a few passes over each level's active region:
//   at batch 8 x 3300x2550 gray the float32 plane is 270 MB, so level 1
//   moves ~2-3 GB, ~1 ms at 3.35 TB/s.  But the vertical lift below walks
//   each column in one thread, a chain of ~13,000 load-compute-store steps
//   at level 1 with only ~20 warps of columns a page in flight, and that
//   chain, not the bytes, sets the time (PERF.md has the measured times).
//   Tiling the columns into row strips with halos is the next step.
//
// Design, a simple first form:
//   1. one elementwise pass: uint8 pixels -> float32 planes (B*ncomp, H, W);
//   2. per level, on the active top-left region (hh, ww) of every plane
//      (the Mallat layout of jp2dwt_quantize):
//      - vertical: one thread per column, coalesced across x, walks its
//        column: even rows then odd rows into the scratch plane, the four
//        lifting steps in place there, then the scalings;
//      - horizontal: one CTA per row, the row in shared memory (2550
//        floats, 10 KB), evens then odds, the four lifting steps separated
//        by __syncthreads, then low * 1/K and high * K packed back into the
//        plane, low then high;
//   3. per band, one pass: trunc(x * f32(1/step)) into the int32 output,
//      laid out band by band (codestream order), component by component,
//      page by page.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kAlpha = -1.586134342059924f;
constexpr float kBeta = -0.052980118572961f;
constexpr float kGamma = 0.882911075530934f;
constexpr float kDelta = 0.443506852043971f;
constexpr float kK = 1.230174104914001f;
// f32 round of the f64 quotient, as native/jp2t1.cpp's kInvK
constexpr float kInvK = (float)(1.0 / 1.230174104914001);

// ICT_FIX of codecs/jp2tpu.py: round(c * 65536)
__constant__ int32_t kIct[3][3] = {{19595, 38470, 7471},
                                   {-11059, -21709, 32768},
                                   {32768, -27439, -5329}};

constexpr int kMaxBands = 3 * 32 + 1;

__device__ __forceinline__ float lift(float coef, float a, float b,
                                      float d) {
  return __fmaf_rn(coef, __fadd_rn(a, b), d);
}

__global__ void to_planes(const uint8_t* __restrict__ img,
                          float* __restrict__ planes, long npix, int B,
                          int ncomp) {
  const long total = (long)B * npix;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const long b = i / npix, p = i - b * npix;
    if (ncomp == 1) {
      planes[i] = __fsub_rn((float)img[i], 128.0f);
    } else {
      const uint8_t* px = img + 3 * i;
      const int32_t r = (int32_t)px[0] - 128, g = (int32_t)px[1] - 128,
                    bl = (int32_t)px[2] - 128;
      for (int c = 0; c < 3; ++c) {
        const int32_t s = kIct[c][0] * r + kIct[c][1] * g + kIct[c][2] * bl;
        planes[(b * 3 + c) * npix + p] = __fmul_rn((float)s, 0x1p-16f);
      }
    }
  }
}

// Column x of plane p, rows [0, hh): src (stride W) -> dst (stride W),
// packed low rows [0, ne) then high rows [ne, hh).
__global__ void lift_vertical(const float* __restrict__ src,
                              float* __restrict__ dst, int H, int W,
                              int hh, int ww) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= ww) return;
  const size_t off = (size_t)blockIdx.y * H * W + x;
  const float* s = src + off;
  float* d = dst + off;
  const int ne = (hh + 1) / 2, no = hh / 2;
  for (int i = 0; i < ne; ++i) d[(size_t)i * W] = s[(size_t)(2 * i) * W];
  for (int i = 0; i < no; ++i)
    d[(size_t)(ne + i) * W] = s[(size_t)(2 * i + 1) * W];
  float* ev = d;
  float* od = d + (size_t)ne * W;
#define EV(i) ev[(size_t)(i) * W]
#define OD(i) od[(size_t)(i) * W]
  if (no > 0) {
    for (int i = 0; i < no; ++i)
      OD(i) = lift(kAlpha, EV(i), EV(i + 1 < ne ? i + 1 : ne - 1), OD(i));
    for (int i = 0; i < ne; ++i)
      EV(i) = lift(kBeta, OD(i > 0 ? i - 1 : 0), OD(i < no ? i : no - 1),
                   EV(i));
    for (int i = 0; i < no; ++i)
      OD(i) = lift(kGamma, EV(i), EV(i + 1 < ne ? i + 1 : ne - 1), OD(i));
    for (int i = 0; i < ne; ++i)
      EV(i) = lift(kDelta, OD(i > 0 ? i - 1 : 0), OD(i < no ? i : no - 1),
                   EV(i));
  }
  for (int i = 0; i < ne; ++i) EV(i) = __fmul_rn(EV(i), kInvK);
  for (int i = 0; i < no; ++i) OD(i) = __fmul_rn(OD(i), kK);
#undef EV
#undef OD
}

// Row y of plane p, columns [0, ww): src -> dst, low then high.
__global__ void lift_horizontal(const float* __restrict__ src,
                                float* __restrict__ dst, int H, int W,
                                int ww) {
  extern __shared__ float row[];
  const size_t off = ((size_t)blockIdx.y * H + blockIdx.x) * W;
  const float* s = src + off;
  float* d = dst + off;
  const int ne = (ww + 1) / 2, no = ww / 2;
  float* ev = row;
  float* od = row + ne;
  for (int i = threadIdx.x; i < ne; i += blockDim.x) ev[i] = s[2 * i];
  for (int i = threadIdx.x; i < no; i += blockDim.x) od[i] = s[2 * i + 1];
  __syncthreads();
  if (no > 0) {
    for (int i = threadIdx.x; i < no; i += blockDim.x)
      od[i] = lift(kAlpha, ev[i], ev[i + 1 < ne ? i + 1 : ne - 1], od[i]);
    __syncthreads();
    for (int i = threadIdx.x; i < ne; i += blockDim.x)
      ev[i] = lift(kBeta, od[i > 0 ? i - 1 : 0], od[i < no ? i : no - 1],
                   ev[i]);
    __syncthreads();
    for (int i = threadIdx.x; i < no; i += blockDim.x)
      od[i] = lift(kGamma, ev[i], ev[i + 1 < ne ? i + 1 : ne - 1], od[i]);
    __syncthreads();
    for (int i = threadIdx.x; i < ne; i += blockDim.x)
      ev[i] = lift(kDelta, od[i > 0 ? i - 1 : 0], od[i < no ? i : no - 1],
                   ev[i]);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < ne; i += blockDim.x)
    d[i] = __fmul_rn(ev[i], kInvK);
  for (int i = threadIdx.x; i < no; i += blockDim.x)
    d[ne + i] = __fmul_rn(od[i], kK);
}

// One band: rows [y0, y0+bh) x cols [x0, x0+bw) of every plane p = b *
// ncomp + c -> out[c][b][y][x] (out at the band's offset).
__global__ void quantize(const float* __restrict__ planes,
                         int32_t* __restrict__ out, int H, int W, int B,
                         int ncomp, int y0, int x0, int bh, int bw,
                         float inv) {
  const long per = (long)bh * bw;
  const long total = per * B * ncomp;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const long cb = i / per, r = i - cb * per;     // cb = c * B + b
    const int c = (int)(cb / B), b = (int)(cb - (long)c * B);
    const int y = (int)(r / bw), x = (int)(r - (long)y * bw);
    const float v = planes[((size_t)(b * ncomp + c) * H + y0 + y) * W +
                           x0 + x];
    out[i] = __float2int_rz(__fmul_rn(v, inv));
  }
}

int grid_for(long n, int threads) {
  long g = (n + threads - 1) / threads;
  if (g > 132L * 32) g = 132L * 32;
  return (int)(g > 0 ? g : 1);
}

}  // namespace

// img: uint8 (B, H, W) or (B, H, W, 3) contiguous; planes and scratch:
// float32 (B * ncomp, H, W); inv: host array of the 3L+1 per-band f32
// reciprocal steps in codestream order; out: int32, band by band in
// codestream order, each band (ncomp, B, bh, bw).  Returns the first
// cudaError_t.
extern "C" int apt_dwt97(const void* img, void* planes, void* scratch,
                         void* out, int B, int H, int W, int ncomp,
                         int levels, const float* inv, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (levels < 1 || 3 * levels + 1 > kMaxBands) return (int)cudaErrorInvalidValue;
  float* pl = (float*)planes;
  float* sc = (float*)scratch;
  const long npix = (long)H * W;
  const int P = B * ncomp;
  to_planes<<<grid_for((long)B * npix, 256), 256, 0, stream>>>(
      (const uint8_t*)img, pl, npix, B, ncomp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem = (size_t)W * sizeof(float);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(lift_horizontal,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int lws[33], lhs[33];
  lws[0] = W;
  lhs[0] = H;
  for (int l = 0; l < levels; ++l) {
    const int ww = lws[l], hh = lhs[l];
    dim3 vg((ww + 127) / 128, P);
    lift_vertical<<<vg, 128, 0, stream>>>(pl, sc, H, W, hh, ww);
    dim3 hg(hh, P);
    lift_horizontal<<<hg, 256, (size_t)ww * sizeof(float), stream>>>(
        sc, pl, H, W, ww);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    lws[l + 1] = (ww + 1) / 2;
    lhs[l + 1] = (hh + 1) / 2;
  }

  // bands in codestream order (jp2tpu._band_shapes): LL, then per level
  // from the coarsest HL (rows [0, lh), cols [lw, pw)), LH (rows [lh, ph),
  // cols [0, lw)), HH (rows [lh, ph), cols [lw, pw))
  int32_t* o = (int32_t*)out;
  long pos = 0;
  for (int k = 0; k < 3 * levels + 1; ++k) {
    int y0 = 0, x0 = 0, bh, bw;
    if (k == 0) {
      bh = lhs[levels];
      bw = lws[levels];
    } else {
      const int r = (k - 1) / 3, kind = (k - 1) % 3, lvl = levels - r;
      const int pw = lws[lvl - 1], ph = lhs[lvl - 1];
      const int lw = lws[lvl], lh = lhs[lvl];
      bh = kind == 0 ? lh : ph - lh;
      bw = kind == 1 ? lw : pw - lw;
      y0 = kind == 0 ? 0 : lh;
      x0 = kind == 1 ? 0 : lw;
    }
    const long n = (long)bh * bw * P;
    if (n > 0) {
      quantize<<<grid_for(n, 256), 256, 0, stream>>>(
          pl, o + pos, H, W, B, ncomp, y0, x0, bh, bw, inv[k]);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    pos += n;
  }
  return (int)cudaSuccess;
}
