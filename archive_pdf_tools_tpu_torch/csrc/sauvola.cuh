// Sauvola pieces shared by csrc/line_sauvola.cu (K4) and
// csrc/blur_sauvola.cu (K3): the block prefix scan of their row walks, the
// floor division by a window's count, the ink test and (K4) the ink
// limit of a window.  Both walks keep
// the window's column sums S and Q as uint32: they wrap, but window
// differences stay exact while the sum of squares is below 2^32: 65025 *
// window^2, so window <= 255 (the wrappers raise above that).

#pragma once

#include <stddef.h>
#include <stdint.h>

namespace apt {

constexpr int kThreads = 256;        // threads of a CTA of either walk
constexpr int kWarps = kThreads / 32;

// Exclusive block-wide prefix sums of two per-thread values (uint32,
// wrapping).  wbuf holds 2 * kWarps words.  All threads call it.
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
    wbuf[kWarps + warp] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    const uint32_t wa = lane < kWarps ? wbuf[lane] : 0u;
    const uint32_t wb = lane < kWarps ? wbuf[kWarps + lane] : 0u;
    uint32_t xa = wa, xb = wb;
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t va = __shfl_up_sync(0xffffffffu, xa, d);
      const uint32_t vb = __shfl_up_sync(0xffffffffu, xb, d);
      if (lane >= d) {
        xa += va;
        xb += vb;
      }
    }
    if (lane < kWarps) {
      wbuf[lane] = xa - wa;
      wbuf[kWarps + lane] = xb - wb;
    }
  }
  __syncthreads();
  a = wbuf[warp] + (ia - a);
  b = wbuf[kWarps + warp] + (ib - b);
}

// Floor division by a window's pixel count.  In a row, every window that
// no column edge clamps has the same count d = rows * window, and there
// n / d is one multiply-high by c = ceil(2^64 / d), exact for every
// 32-bit n (Lemire, Kaser and Kurz, "Faster remainder by direct
// computation", 2019: F = 64 >= 32 + log2 d); other counts divide.
struct CountDiv {
  uint32_t d = 0;
  unsigned long long c = 0;
  __device__ __forceinline__ void set(uint32_t count) {
    if (count != d) {
      d = count;
      c = count > 1 ? ~0ull / count + 1 : 0ull;
    }
  }
  __device__ __forceinline__ uint32_t operator()(uint32_t n,
                                                 uint32_t cnt) const {
    return cnt == d && c ? (uint32_t)__umul64hi(n, c) : n / cnt;
  }
};

// Exact float of an int in [0, 2^23): its bits above 2^23, minus 2^23
// (two full-rate operations in place of a conversion).
__device__ __forceinline__ float small_float(int v) {
  return __fsub_rn(__int_as_float(0x4B000000 | v), 8388608.0f);
}

// Integer mean and E[x^2] by floor division, then the float32
// squared-form test (k >= 0 branch), every operation rounded separately.
// mean, var (>= 0: floor(Q/C) >= floor(S/C)^2) and px are below 2^16.
__device__ __forceinline__ bool sauvola_ink(uint32_t s, uint32_t q,
                                            uint32_t cnt, int px, float km1,
                                            float k2, const CountDiv& div) {
  const int mean_i = (int)div(s, cnt);
  const int var_i = (int)div(q, cnt) - mean_i * mean_i;
  const float mean = small_float(mean_i);
  const float var = small_float(var_i);
  const float t = __fadd_rn(small_float(px), __fmul_rn(mean, km1));
  const float rhs = __fmul_rn(__fmul_rn(__fmul_rn(mean, mean), k2), var);
  return t <= 0.0f || __fmul_rn(t, t) <= rhs;
}

// The pixel values a window marks as ink, as a count: sauvola_ink(s, q,
// cnt, px, ...) holds exactly for px < sauvola_limit(s, q, cnt, ...).
// The test is monotone in px: t = fl(px + mean (k-1)) rises with px, ink
// is t <= 0 or fl(t t) <= rhs, and fl(t t) rises with t >= 0, so the ink
// values are a prefix of 0..255.  A guess from sqrt(rhs) is walked to
// the prefix's end with the test itself (same operations, same
// rounding), so the limit is exact whatever the guess.
__device__ __forceinline__ int sauvola_limit(uint32_t s, uint32_t q,
                                             uint32_t cnt, float km1,
                                             float k2, const CountDiv& div) {
  const int mean_i = (int)div(s, cnt);
  const int var_i = (int)div(q, cnt) - mean_i * mean_i;
  const float mean = small_float(mean_i);
  const float var = small_float(var_i);
  const float c = __fmul_rn(mean, km1);
  const float rhs = __fmul_rn(__fmul_rn(__fmul_rn(mean, mean), k2), var);
  auto ink = [&](int px) {
    const float t = __fadd_rn(small_float(px), c);
    return t <= 0.0f || __fmul_rn(t, t) <= rhs;
  };
  int g = __float2int_rd(__fsub_rn(__fsqrt_rn(rhs), c));
  g = min(max(g, -1), 255);
  while (g < 255 && ink(g + 1)) ++g;
  while (g >= 0 && !ink(g)) --g;
  return g + 1;
}

}  // namespace apt
