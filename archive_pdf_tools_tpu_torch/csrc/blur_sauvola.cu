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
// What bounds it: no true recurrence; two windowed stencils over the
//   page.  Its work is the page read once and the mask written once
//   (~0.04 ms at batch 8 x 3300x2550) and the blur's 2 * (2r+1) multiplies
//   and adds a pixel.  What bounds this form is issue: the byte-wide
//   loads and stores, the walk's per-row scan and per-pixel test (PERF.md
//   has the measured times and the ablation).
//
// Design, two launches and no page-size float or int intermediate:
//   1. blur_kernel: a CTA owns a tile of 32 x 128 output pixels; it loads
//      the raw tile with a halo of r each side (rows and columns mapped by
//      the symmetric border) into shared memory, converted to float32
//      once, runs the vertical MAC into a float32 tile in shared memory
//      (32 rows, 128 + 2r columns), then the horizontal MAC, truncates and
//      writes the uint8 blurred page (the one intermediate, a byte a
//      pixel).  A thread computes 4 outputs of a pass from one run of
//      loads (4 rows of a column; 4 columns of a row, by float4), and
//      issues the tile's loads 4 rows at a time.  The radius buckets (4,
//      8, 16, 48) are compiled apart, so their tap loops unroll, with the
//      taps up to radius 16 in registers.
//   2. sauvola_kernel: a CTA owns a column strip of the page and a run of
//      rows (ops/threshold_cuda.sauvola_plan: the strip plus the window's
//      halo, o-1 columns to the left and u to the right, is 1,024
//      columns, 4 a thread) and walks its rows (sauvola_walk below): the
//      column sums of the window in registers, the row entering and the
//      row leaving the window added and taken away, loaded a row ahead
//      with the next row's centre pixels; the window sums from one block
//      prefix scan a row (warp shuffles, then the warps' totals), the
//      exact clamped count, the division by it (a multiply-high where no
//      column edge clamps the window, csrc/sauvola.cuh), the test, the
//      mask byte.  Two barriers a row: the prefixes and the warp totals
//      alternate between two buffers, with a spare word after every 32
//      prefixes against bank conflicts.
//   Both kernels are held to 64 registers, 4 CTAs an SM.
//   The window sum of squares Q reaches 65025 * window^2, past 2^31 from
//   window 183 (dpi >= 728), so it is kept and divided as uint32, as the
//   JAX package does: exact while Q < 2^32, i.e. window <= 255 (the
//   wrapper raises above that).  No row is held whole: no width limit.
//
// Ablation builds (-DAPT_ABLATE=APT_ABL_<variant>, one .so each, for
//   archive_pdf_tools_tpu_torch/tools/threshold_ablate.py; they replace
//   the TPU tool tools/threshold_ablate.py:189 _build).  Each switches
//   parts of the two launches off to localise their cost; built with no
//   define, this file is the shipped kernel:
//   NO_VMAC    the vertical pass takes the centre pixel (horizontal-only
//              blur);
//   NO_HMAC    the horizontal pass takes the centre value (vertical-only
//              blur);
//   NO_BLUR    both: Sauvola on the raw page;
//   NO_EMIT    the Sauvola launch skipped; the blur launch writes the
//              uint8 blurred page to out;
//   MACHINERY  the two launches keep their loads, shared-memory staging,
//              barriers and stores and drop their arithmetic (no MACs, no
//              window sums, no scan, no test): out = img;
//   U8RING     MACHINERY with the blur's vertical-pass tile held as uint8
//              in shared memory, not float32 (the four-launch design's
//              uint8 vtmp scratch has no counterpart here);
//   PASSTHRU   one copy launch, img -> out: the floor.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sauvola.cuh"

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

namespace {

__device__ __forceinline__ int sym_index(int p, int n) {
  if (p >= 0 && p < n) return p;
  int q = p % (2 * n);
  if (q < 0) q += 2 * n;
  return q < n ? q : 2 * n - 1 - q;
}

// The blur tile: output rows and columns of a CTA of (32, 8) threads, 4
// rows a thread in the vertical pass, 4 columns in the horizontal one
// (ops/threshold_cuda.BLUR_TILE)
constexpr int kTy = 32, kTx = 128;

// Row pitch (floats) of a blur tile's shared arrays: TX + 2r columns, a
// multiple of 4 with 4 to spare for the last float4 loads.
__host__ __device__ constexpr int blur_pitch(int r) {
  return (kTx + 2 * r + 3) / 4 * 4 + 4;
}

// Shared bytes of a blur tile: the raw tile as float32 (TY + 2r rows),
// the vertical pass (TY rows), the taps.
size_t blur_smem(int r) {
  return (sizeof(float) * (kTy + 2 * r) + sizeof(vtmp_t) * kTy)
      * blur_pitch(r) + sizeof(float) * (2 * r + 1);
}

// R > 0: the radius at compile time (the loops unrolled, taps up to
// radius 16 in registers); R = 0: any radius r.  Each thread computes 4
// neighbouring outputs of a pass from one run of loads (4 rows of a
// column, then 4 columns of a row): out[k] takes tap t - k of load t, so
// each output still sums its taps in ascending order from 0.
// grid (tiles across, tiles down, B); block (32, 8)
template <int R>
__global__ void __launch_bounds__(256, 4)
blur_kernel(const uint8_t* __restrict__ img, const float* __restrict__ taps,
            uint8_t* __restrict__ blur, int H, int W, int r_) {
  constexpr int kRegTaps = R > 0 && R <= 16 ? 2 * R + 1 : 1;
  extern __shared__ __align__(16) float bsm[];
  const int r = R > 0 ? R : r_;
  const int pitch = blur_pitch(r);
  float* raw = bsm;                   // the page's pixels as float32
  vtmp_t* vt = (vtmp_t*)(bsm + pitch * (kTy + 2 * r));
  float* wt = (float*)(vt + pitch * kTy);
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTy, x0 = blockIdx.x * kTx;
  const int nrow = min(kTy, H - y0), ncol = min(kTx, W - x0);
  const int wcol = ncol + 2 * r;
  const uint8_t* page = img + (size_t)b * H * W;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;

  for (int t = tid; t <= 2 * r; t += blockDim.x * blockDim.y)
    wt[t] = taps[(size_t)b * (2 * r + 1) + t];
  if (R > 0) {
    // the raw tile, 4 of this thread's rows at a time with all their
    // loads in flight (columns threadIdx.x + 32j, rows threadIdx.y + 8g)
    constexpr int NJ = (kTx + 2 * R + 31) / 32;
    int sx[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      sx[j] = sym_index(x0 - r + (int)threadIdx.x + 32 * j, W);
    for (int yb = threadIdx.y; yb < nrow + 2 * r; yb += 32) {
      uint32_t v[4][NJ];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int yy = yb + 8 * g;
        const uint8_t* src =
            page + (size_t)sym_index(y0 - r + min(yy, nrow + 2 * r - 1), H) * W;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          v[g][j] = yy < nrow + 2 * r && (int)threadIdx.x + 32 * j < wcol
              ? src[sx[j]] : 0u;
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int yy = yb + 8 * g, cc = threadIdx.x + 32 * j;
          if (yy < nrow + 2 * r && cc < wcol)
            raw[yy * pitch + cc] = (float)v[g][j];
        }
      }
    }
  } else {
    for (int yy = threadIdx.y; yy < nrow + 2 * r; yy += blockDim.y) {
      const uint8_t* src = page + (size_t)sym_index(y0 - r + yy, H) * W;
      for (int cc = threadIdx.x; cc < wcol; cc += blockDim.x)
        raw[yy * pitch + cc] = (float)src[sym_index(x0 - r + cc, W)];
    }
  }
  __syncthreads();
  float w[kRegTaps];
#pragma unroll
  for (int t = 0; t < kRegTaps; ++t) w[t] = wt[t];
#define TAP(t) (kRegTaps > 1 ? w[kRegTaps > 1 ? (t) : 0] : wt[t])

  // vertical pass: rows 4 * threadIdx.y + [0, 4) of the tile (rows past
  // the page are computed from the symmetric border and never stored),
  // every loaded column
  const int yq = 4 * threadIdx.y;
  for (int cc = threadIdx.x; cc < wcol; cc += blockDim.x) {
    const float* col = raw + yq * pitch + cc;
#if ABL(NO_VMAC) || ABL(NO_BLUR) || BARE
#pragma unroll
    for (int k = 0; k < 4; ++k)
      vt[(yq + k) * pitch + cc] = (vtmp_t)col[(k + r) * pitch];
#else
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int t = 0; t < 2 * r + 4; ++t) {
      const float v = col[t * pitch];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (t - k >= 0 && t - k <= 2 * r)
          acc[k] = __fadd_rn(acc[k], __fmul_rn(TAP(t - k), v));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) vt[(yq + k) * pitch + cc] = acc[k];
#endif
  }
  __syncthreads();

  // horizontal pass: columns 4 * threadIdx.x + [0, 4) of rows threadIdx.y
  // + 8j, truncated like astype(uint8)
  const int xq = 4 * threadIdx.x;
  for (int y = threadIdx.y; y < nrow; y += blockDim.y) {
    const vtmp_t* row = vt + y * pitch + xq;
    uint8_t* dst = blur + ((size_t)b * H + y0 + y) * W + x0 + xq;
    if (xq >= ncol) continue;
    uint32_t out4 = 0;
#if BARE
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out4 |= (uint32_t)(uint8_t)row[k + r] << (8 * k);
#else
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#if ABL(NO_HMAC) || ABL(NO_BLUR)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = row[k + r];
#else
#pragma unroll
    for (int t4 = 0; t4 < 2 * r + 4; t4 += 4) {
      const float4 v4 = *(const float4*)(row + t4);
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t4 + j;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (t - k >= 0 && t - k <= 2 * r)
            acc[k] = __fadd_rn(acc[k], __fmul_rn(TAP(t - k), v[j]));
      }
    }
#endif
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int iv = (int)acc[k];
      iv = iv < 0 ? 0 : (iv > 255 ? 255 : iv);
      out4 |= (uint32_t)iv << (8 * k);
    }
#endif
    if (xq + 4 <= ncol && ((uintptr_t)dst & 3) == 0) {
      *(uint32_t*)dst = out4;
    } else {
      for (int k = 0; k < 4 && xq + k < ncol; ++k)
        dst[k] = (uint8_t)(out4 >> (8 * k));
    }
  }
#undef TAP
}

template <int R>
cudaError_t launch_blur(const uint8_t* img, const float* taps, uint8_t* dst,
                        int B, int H, int W, int r, cudaStream_t st) {
  const size_t bs = blur_smem(r);
  if (bs > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        blur_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bs);
    if (e != cudaSuccess) return e;
  }
  const dim3 tiles((W + kTx - 1) / kTx, (H + kTy - 1) / kTy, B);
  blur_kernel<R><<<tiles, dim3(32, 8), bs, st>>>(img, taps, dst, H, W, r);
  return cudaGetLastError();
}

// the radius buckets of ops/threshold_cuda.RADIUS_BUCKETS at compile time
cudaError_t blur(const uint8_t* img, const float* taps, uint8_t* dst, int B,
                 int H, int W, int r, cudaStream_t st) {
  switch (r) {
    case 4: return launch_blur<4>(img, taps, dst, B, H, W, r, st);
    case 8: return launch_blur<8>(img, taps, dst, B, H, W, r, st);
    case 16: return launch_blur<16>(img, taps, dst, B, H, W, r, st);
    case 48: return launch_blur<48>(img, taps, dst, B, H, W, r, st);
    default: return launch_blur<0>(img, taps, dst, B, H, W, r, st);
  }
}

using apt::kThreads;
using apt::kWarps;

// columns a thread of the walk: a strip and its halo are 1,024 columns
// (ops/threshold_cuda.WALK_COLS)
constexpr int kWalkChunk = 4;

// Where prefix j lives: a spare word after every 32.
__device__ __forceinline__ int pad32(int j) { return j + (j >> 5); }

// Shared uint32 words of a walk over n loaded columns: two buffers of the
// padded prefixes of S and Q, two of the warp totals.
constexpr size_t walk_smem_words(int n) {
  return 4 * ((size_t)n + 2 + (n >> 5)) + 4 * kWarps;
}

// The walk of a CTA over output rows [y0, y1) and columns [c0, c1) of a
// clamp region, rows [t, b) x cols [l, r) of the page (see the notes at
// the top).  page: row 0, column 0, rows W bytes apart; sh: at least
// walk_smem_words(min(c1+u, r) - max(c0-o+1, l)) words; at most C *
// kThreads columns.  emit(y, x, S, Q, count, pixel, div) is called once
// for every output pixel.
template <int C, class Emit>
__device__ __forceinline__ void sauvola_walk(const uint8_t* __restrict__ page,
                                             size_t W, int t, int b, int l,
                                             int r, int y0, int y1, int c0,
                                             int c1, int o, int u,
                                             uint32_t* sh, Emit& emit) {
  const int lc0 = max(c0 - o + 1, l), lc1 = min(c1 + u, r);
  const int n = lc1 - lc0;
  const int np = n + 2 + (n >> 5);
  uint32_t* pre = sh;                // [buffer][S, Q][np]
  uint32_t* tot = sh + 4 * np;       // [buffer][S, Q][kWarps]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = tid * C;            // this thread's columns [k0, k0 + C)
  const uint8_t* base = page + lc0;
  apt::CountDiv div;

  // the vertical window of row y0: rows [max(y0-o+1, t), min(y0+u, b-1)]
  uint32_t cs[C], cq[C];
#pragma unroll
  for (int i = 0; i < C; ++i) cs[i] = cq[i] = 0;
#pragma unroll 4
  for (int yy = max(y0 - o + 1, t); yy <= min(y0 + u, b - 1); ++yy) {
    const uint8_t* p = base + (size_t)yy * W + k0;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (k0 + i < n) {
        const uint32_t v = p[i];
        cs[i] += v;
        cq[i] += v * v;
      }
    }
  }

  // the bytes of a row: entering and leaving the window, centre pixels
  uint32_t in_v[C], out_v[C], px_v[C];
  auto fetch = [&](int y) {
    const bool add = y > y0 && y + u <= b - 1, rem = y > y0 && y - o >= t;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const bool mine = k0 + i < n;
      in_v[i] = add && mine ? base[(size_t)(y + u) * W + k0 + i] : 0u;
      out_v[i] = rem && mine ? base[(size_t)(y - o) * W + k0 + i] : 0u;
      const int x = c0 + tid + i * kThreads;
      px_v[i] = x < c1 ? page[(size_t)y * W + x] : 0u;
    }
  };
  fetch(y0);

  for (int y = y0; y < y1; ++y) {
    const int buf = y & 1;
    uint32_t* ps = pre + buf * 2 * np;
    uint32_t* pq = ps + np;
    uint32_t* ts = tot + buf * 2 * kWarps;
    // rows [y-o+1, y+u] from [y-o, y+u-1]
    uint32_t px[C], s = 0, q = 0;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      cs[i] += in_v[i] - out_v[i];
      cq[i] += in_v[i] * in_v[i] - out_v[i] * out_v[i];
      s += cs[i];
      q += cq[i];
      px[i] = px_v[i];
    }
    if (y + 1 < y1) fetch(y + 1);

    // inclusive scan of the chunk totals: lanes by shuffles, warps by the
    // totals of the warps to the left
    uint32_t is = s, iq = q;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t vs = __shfl_up_sync(0xffffffffu, is, d);
      const uint32_t vq = __shfl_up_sync(0xffffffffu, iq, d);
      if (lane >= d) {
        is += vs;
        iq += vq;
      }
    }
    if (lane == 31) {
      ts[warp] = is;
      ts[kWarps + warp] = iq;
    }
    __syncthreads();
    {                                // add the totals of the warps to the left
      const uint32_t ws = lane < warp ? ts[lane] : 0u;
      const uint32_t wq = lane < warp ? ts[kWarps + lane] : 0u;
      is += __reduce_add_sync(0xffffffffu, ws);
      iq += __reduce_add_sync(0xffffffffu, wq);
    }
    s = is - s;                      // the columns left of this chunk
    q = iq - q;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      s += cs[i];
      q += cq[i];
      if (k0 + i < n) {
        ps[pad32(k0 + i + 1)] = s;
        pq[pad32(k0 + i + 1)] = q;
      }
    }
    if (tid == 0) {
      ps[0] = 0;
      pq[0] = 0;
    }
    __syncthreads();

    const uint32_t rows_in =
        (uint32_t)(min(y + u, b - 1) - max(y - o, t - 1));
    div.set(rows_in * (uint32_t)(o + u));
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int x = c0 + tid + i * kThreads;
      if (x < c1) {
        const int lo = max(x - o + 1, l) - lc0;
        const int hi = min(x + u, r - 1) + 1 - lc0;
        const int plo = pad32(lo), phi = pad32(hi);
        emit(y, x, ps[phi] - ps[plo], pq[phi] - pq[plo],
             rows_in * (uint32_t)(hi - lo), (int)px[i], div);
      }
    }
  }
}


struct PageEmit {
  uint8_t* out;
  size_t W;
  float km1, k2;
  __device__ __forceinline__ void operator()(int y, int x, uint32_t s,
                                             uint32_t q, uint32_t cnt,
                                             int px,
                                             const apt::CountDiv& div) {
    out[(size_t)y * W + x] = apt::sauvola_ink(s, q, cnt, px, km1, k2, div);
  }
};

// grid (strips across, runs down, B); block kWalkThreads
__global__ void __launch_bounds__(kThreads, 4)
sauvola_kernel(const uint8_t* __restrict__ blur, uint8_t* __restrict__ out,
               int H, int W, int o, int u, int strip, int run, float km1,
               float k2, int zero) {
  extern __shared__ uint32_t wsm[];
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * run, y1 = min(y0 + run, H);
  const int c0 = blockIdx.x * strip, c1 = min(c0 + strip, W);
  const uint8_t* page = blur + (size_t)b * H * W;
  uint8_t* dst = out + (size_t)b * H * W;
#if BARE
  // the walk's loads, barriers and stores, none of its arithmetic: the
  // rows entering and leaving the window into shared memory, the centre
  // pixel out (zero is 0 at run time, unknown to the compiler)
  const int lc0 = max(c0 - o + 1, 0), lc1 = min(c1 + u, W);
  const int n = lc1 - lc0;
  const int chunk = (n + kThreads - 1) / kThreads;
  const int k0 = min((int)threadIdx.x * chunk, n), k1 = min(k0 + chunk, n);
  for (int y = y0; y < y1; ++y) {
    for (int k = k0; k < k1; ++k) {
      wsm[k] = y + u < H ? page[(size_t)(y + u) * W + lc0 + k] : 0u;
      wsm[n + k] = y - o >= 0 ? page[(size_t)(y - o) * W + lc0 + k] : 0u;
    }
    __syncthreads();
    __syncthreads();
    for (int x = c0 + threadIdx.x; x < c1; x += kThreads)
      dst[(size_t)y * W + x] = page[(size_t)y * W + x]
          ^ (uint8_t)(wsm[x - lc0] & zero);
    __syncthreads();
  }
#else
  PageEmit emit{dst, (size_t)W, km1, k2};
  sauvola_walk<kWalkChunk>(page, (size_t)W, 0, H, 0, W, y0, y1, c0,
                                c1, o, u, wsm, emit);
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

}  // namespace

// img: uint8 (B, H, W); taps: f32 (B, 2r+1); out: uint8 (B, H, W);
// blur_page: uint8 (B, H, W) scratch (unused by no_emit and passthru);
// strip, run: the Sauvola CTA's columns and rows
// (ops/threshold_cuda.sauvola_plan).  Returns the first cudaError_t.
extern "C" int apt_blur_sauvola(const void* img, const void* taps, void* out,
                                void* blur_page, int B, int H, int W,
                                int radius, int window, float km1, float k2,
                                int strip, int run, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B == 0 || H == 0 || W == 0) return (int)cudaSuccess;
#if ABL(PASSTHRU)
  copy_kernel<<<dim3((W + 255) / 256, H, B), 256, 0, st>>>(
      (const uint8_t*)img, (uint8_t*)out, H, W);
  return (int)cudaGetLastError();
#elif ABL(NO_EMIT)                   // the blurred page is the result
  return (int)blur((const uint8_t*)img, (const float*)taps, (uint8_t*)out,
                   B, H, W, radius, st);
#else
  cudaError_t e = blur((const uint8_t*)img, (const float*)taps,
                       (uint8_t*)blur_page, B, H, W, radius, st);
  if (e != cudaSuccess) return (int)e;
  const int o = (window + 1) / 2, u = window / 2;
  const int loaded = strip + o - 1 + u;      // a strip and its halo
  const size_t ws = walk_smem_words(loaded < W ? loaded : W)
      * sizeof(uint32_t);
  if (ws > 48 * 1024) {
    e = cudaFuncSetAttribute(sauvola_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)ws);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 walks((W + strip - 1) / strip, (H + run - 1) / run, B);
  sauvola_kernel<<<walks, kThreads, ws, st>>>(
      (const uint8_t*)blur_page, (uint8_t*)out, H, W, o, u, strip, run,
      km1, k2, 0);
  return (int)cudaGetLastError();
#endif
}
