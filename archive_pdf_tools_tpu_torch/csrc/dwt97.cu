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
// What bounds it: bytes.  A level reads its input once (uint8 pixels at
//   level 1, the float32 LL of the level before after that) and writes
//   the float32 LL and the three int32 detail bands once: at batch 8 x
//   3300x2550 gray, level 1 moves ~0.35 GB, ~0.1 ms at 3.35 TB/s, and the
//   four coarser levels a third of that together.  The lifting is ~10
//   float operations a sample, far below the card's rate.
//
// Design: one launch a level, over 2-D tiles of the level's active region
//   (hh, ww) of every plane (the Mallat layout of jp2dwt_quantize).
//   - A CTA owns an output tile of TY x TX samples (TY, TX even, from the
//     wrapper) and loads it with a halo of kHalo = 4 samples each side,
//     clamped to the region, into shared memory: at level 1 from the
//     pixels, doing the DC shift or the ICT as it loads; after that from
//     the LL plane the level before wrote.
//   - Reach: a lift reads one sample each side, so after the four lifts a
//     low (even) sample depends on the input 4 samples away and a high
//     (odd) one on 3.  With 4 samples of halo every output of the tile
//     sees the same operands as in a whole-row transform; the halo's own
//     values go wrong at the tile's edge and are never written.
//     (tests/test_torch_tiles.py stitches this tiling from the plain
//     version, and shows that 3 samples of halo are not enough.)
//   - At the region's true edges the neighbour index is clamped exactly as
//     in the whole-row form (odd: min(i+1, ne-1); even: max(i-1, 0),
//     min(i, no-1)), so every output sample is the same expression on the
//     same operands, whatever the tiling.
//   - The four vertical lifts on every loaded column, the scalings of the
//     tile's output rows, the four horizontal lifts on those rows, each
//     step separated by a barrier; then the writes: LL as float32 into
//     the next level's input (a compact plane, two of them in turn), or,
//     at the last level, quantised; HL, LH and HH quantised,
//     trunc(x * f32(1/step)), straight into their int32 band slots.
//   No row is held whole, so no width limit; no separate plane pass and no
//   separate quantise pass.

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
constexpr int kHalo = 4;

enum Source { kGray = 0, kRgb = 1, kPlane = 2 };

struct Level {
  long long off[4];   // first int32 of the LL (last level), HL, LH, HH band
  float inv[4];       // f32(1/step) of those bands
  int hh, ww;         // the active region this level transforms
  int in_stride;      // row pitch of the input
  long long in_plane; // plane pitch of the input (pixels or floats)
  int last;           // LL is quantised (else written as float32)
};

__device__ __forceinline__ float lift(float coef, float a, float b,
                                      float d) {
  return __fmaf_rn(coef, __fadd_rn(a, b), d);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One lifting step along the tile's rows (dim 0) or columns (dim 1): the
// samples of global parity `par` get coef * (left + right).  Odd samples
// take their even neighbours p-1 and min(p+1, 2ne-2); even samples their
// odd neighbours max(p-1, 1) and min(p+1, 2no-1) (the whole-row clamps);
// a neighbour past the loaded span is only ever needed by halo samples,
// which are never written, and is clamped into the span.
// Along rows: rows [0, n) of the span, every column in [0, m).
// Along columns: columns [0, n), rows [m0, m).
template <int DIM>
__device__ __forceinline__ void lift_step(float* t, int P, int s0, int n,
                                          int m0, int m, int par, int lim,
                                          float coef) {
  const int first = (par - s0) & 1;
  if (DIM == 0) {
    for (int r = first + 2 * (int)threadIdx.y; r < n;
         r += 2 * (int)blockDim.y) {
      const int g = s0 + r;
      const int a = clampi((par ? g - 1 : max(g - 1, 1)) - s0, 0, n - 1);
      const int b = clampi(min(g + 1, lim) - s0, 0, n - 1);
      for (int c = threadIdx.x; c < m; c += blockDim.x)
        t[r * P + c] = lift(coef, t[a * P + c], t[b * P + c], t[r * P + c]);
    }
  } else {
    for (int r = m0 + threadIdx.y; r < m; r += blockDim.y) {
      float* row = t + r * P;
      for (int c = first + 2 * (int)threadIdx.x; c < n;
           c += 2 * (int)blockDim.x) {
        const int g = s0 + c;
        const int a = clampi((par ? g - 1 : max(g - 1, 1)) - s0, 0, n - 1);
        const int b = clampi(min(g + 1, lim) - s0, 0, n - 1);
        row[c] = lift(coef, row[a], row[b], row[c]);
      }
    }
  }
}

template <int DIM>
__device__ __forceinline__ void lift_all(float* t, int P, int s0, int n,
                                         int m0, int m, int len) {
  const int ne = (len + 1) / 2, no = len / 2;
  lift_step<DIM>(t, P, s0, n, m0, m, 1, 2 * ne - 2, kAlpha);
  __syncthreads();
  lift_step<DIM>(t, P, s0, n, m0, m, 0, 2 * no - 1, kBeta);
  __syncthreads();
  lift_step<DIM>(t, P, s0, n, m0, m, 1, 2 * ne - 2, kGamma);
  __syncthreads();
  lift_step<DIM>(t, P, s0, n, m0, m, 0, 2 * no - 1, kDelta);
  __syncthreads();
}

// grid: (tiles across * ncomp, tiles down, B); block (32, 8)
template <int SRC>
__global__ void __launch_bounds__(256)
dwt_level(const void* __restrict__ src, float* __restrict__ ll_out,
          int32_t* __restrict__ out, Level L, int B, int ncomp, int ty,
          int tx) {
  extern __shared__ float tile[];
  const int P = tx + 2 * kHalo;
  const int c = blockIdx.x % ncomp;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * ty, x0 = (blockIdx.x / ncomp) * tx;
  const int hh = L.hh, ww = L.ww;
  const int ys = max(y0 - kHalo, 0), ye = min(y0 + ty + kHalo, hh);
  const int xs = max(x0 - kHalo, 0), xe = min(x0 + tx + kHalo, ww);
  const int nr = ye - ys, nc = xe - xs;

  for (int r = threadIdx.y; r < nr; r += blockDim.y) {
    const size_t rowoff = (size_t)(ys + r) * L.in_stride + xs;
    for (int cc = threadIdx.x; cc < nc; cc += blockDim.x) {
      float v;
      if (SRC == kGray) {
        const uint8_t* img = (const uint8_t*)src + (size_t)b * L.in_plane;
        v = __fsub_rn((float)img[rowoff + cc], 128.0f);
      } else if (SRC == kRgb) {
        const uint8_t* px = (const uint8_t*)src
            + 3 * ((size_t)b * L.in_plane + rowoff + cc);
        const int32_t rr = (int32_t)px[0] - 128, g = (int32_t)px[1] - 128,
                      bl = (int32_t)px[2] - 128;
        const int32_t s = kIct[c][0] * rr + kIct[c][1] * g + kIct[c][2] * bl;
        v = __fmul_rn((float)s, 0x1p-16f);
      } else {
        v = ((const float*)src)[((size_t)b * ncomp + c) * L.in_plane + rowoff
                                + cc];
      }
      tile[r * P + cc] = v;
    }
  }
  __syncthreads();

  if (hh > 1) lift_all<0>(tile, P, ys, nr, 0, nc, hh);
  const int y1 = min(y0 + ty, hh), x1 = min(x0 + tx, ww);
  const int r0 = y0 - ys, r1 = y1 - ys;
  for (int r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
    const float s = ((ys + r) & 1) ? kK : kInvK;
    for (int cc = threadIdx.x; cc < nc; cc += blockDim.x)
      tile[r * P + cc] = __fmul_rn(tile[r * P + cc], s);
  }
  __syncthreads();
  if (ww > 1) lift_all<1>(tile, P, xs, nc, r0, r1, ww);

  // the four bands of the tile: LL, HL (low rows, high columns), LH, HH
  const int lh = (hh + 1) / 2, lw = (ww + 1) / 2;
  for (int band = 0; band < 4; ++band) {
    const int py = band >= 2, px = band & 1;
    const int bh = py ? hh - lh : lh, bw = px ? ww - lw : lw;
    const int ni = (y1 - y0 - py + 1) / 2, nj = (x1 - x0 - px + 1) / 2;
    const float s = px ? kK : kInvK;
    const bool to_float = band == 0 && !L.last;
    for (int i = threadIdx.y; i < ni; i += blockDim.y) {
      const int gy = y0 + py + 2 * i;
      const float* row = tile + (gy - ys) * P - xs;
      const size_t brow = (size_t)(gy >> 1) * bw;
      for (int j = threadIdx.x; j < nj; j += blockDim.x) {
        const int gx = x0 + px + 2 * j;
        const float v = __fmul_rn(row[gx], s);
        if (to_float) {
          ll_out[((size_t)b * ncomp + c) * ((size_t)lh * lw) + brow
                 + (gx >> 1)] = v;
        } else {
          out[L.off[band] + ((size_t)c * B + b) * ((size_t)bh * bw) + brow
              + (gx >> 1)] = __float2int_rz(__fmul_rn(v, L.inv[band]));
        }
      }
    }
  }
}

template <int SRC>
cudaError_t launch(const void* src, float* ll_out, int32_t* out,
                   const Level& L, int B, int ncomp, int ty, int tx,
                   cudaStream_t st) {
  const size_t smem = (size_t)(ty + 2 * kHalo) * (tx + 2 * kHalo)
      * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dwt_level<SRC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)(((L.ww + tx - 1) / tx) * ncomp),
                  (unsigned)((L.hh + ty - 1) / ty), (unsigned)B);
  dwt_level<SRC><<<grid, dim3(32, 8), smem, st>>>(src, ll_out, out, L, B,
                                                  ncomp, ty, tx);
  return cudaGetLastError();
}

}  // namespace

// img: uint8 (B, H, W) or (B, H, W, 3) contiguous; ll_a: float32 of
// B * ncomp * ceil(H/2) * ceil(W/2) (levels >= 2), ll_b: of B * ncomp *
// ceil(H/4) * ceil(W/4) (levels >= 3), the LL planes of odd and even
// levels; inv: host array of the 3L+1 per-band f32 reciprocal steps in
// codestream order; out: int32, band by band in codestream order, each
// band (ncomp, B, bh, bw); ty, tx: the output tile, both even.  Returns
// the first cudaError_t.
extern "C" int apt_dwt97(const void* img, void* ll_a, void* ll_b, void* out,
                         int B, int H, int W, int ncomp, int levels,
                         const float* inv, int ty, int tx, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (levels < 1 || 3 * levels + 1 > kMaxBands || ty < 2 || tx < 2
      || (ty & 1) || (tx & 1))
    return (int)cudaErrorInvalidValue;
  int lws[33], lhs[33];
  lws[0] = W;
  lhs[0] = H;
  for (int l = 0; l < levels; ++l) {
    lws[l + 1] = (lws[l] + 1) / 2;
    lhs[l + 1] = (lhs[l] + 1) / 2;
  }
  // band offsets in codestream order (jp2tpu._band_shapes): LL, then per
  // level from the coarsest HL (lh x (pw - lw)), LH ((ph - lh) x lw), HH
  const long long P = (long long)B * ncomp;
  long long off[kMaxBands];
  long long pos = 0;
  for (int k = 0; k < 3 * levels + 1; ++k) {
    long long bh, bw;
    if (k == 0) {
      bh = lhs[levels];
      bw = lws[levels];
    } else {
      const int r = (k - 1) / 3, kind = (k - 1) % 3, lvl = levels - r;
      const int pw = lws[lvl - 1], ph = lhs[lvl - 1];
      const int lw = lws[lvl], lh = lhs[lvl];
      bh = kind == 0 ? lh : ph - lh;
      bw = kind == 1 ? lw : pw - lw;
    }
    off[k] = pos;
    pos += bh * bw * P;
  }

  float* bufs[2] = {(float*)ll_a, (float*)ll_b};
  int32_t* o = (int32_t*)out;
  for (int l = 1; l <= levels; ++l) {
    const int k = 1 + 3 * (levels - l);      // this level's HL
    Level L;
    L.off[0] = off[0];
    L.inv[0] = inv[0];
    for (int j = 1; j < 4; ++j) {
      L.off[j] = off[k + j - 1];
      L.inv[j] = inv[k + j - 1];
    }
    L.hh = lhs[l - 1];
    L.ww = lws[l - 1];
    L.last = l == levels;
    float* ll_out = bufs[(l - 1) & 1];
    cudaError_t e;
    if (l == 1) {
      L.in_stride = W;
      L.in_plane = (long long)H * W;
      e = ncomp == 1
          ? launch<kGray>(img, ll_out, o, L, B, ncomp, ty, tx, stream)
          : launch<kRgb>(img, ll_out, o, L, B, ncomp, ty, tx, stream);
    } else {
      L.in_stride = L.ww;
      L.in_plane = (long long)L.hh * L.ww;
      e = launch<kPlane>(bufs[l & 1], ll_out, o, L, B, ncomp, ty, tx,
                         stream);
    }
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
