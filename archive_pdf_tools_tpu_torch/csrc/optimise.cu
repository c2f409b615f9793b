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
// What bounds it: the IIR term makes output row y read rows y-n..y-1, so
//   the rows of one (page, channel) form a dependent chain of H steps that
//   no split along the rows can shorten.  A launch takes about H times the
//   latency of one row step, far above the time its bytes (img, mask and
//   out, each once) need at 3.35 TB/s: the kernel stays latency-bound, and
//   the design is about the length of one row step.  Within a row every
//   pixel is independent once the rows above are done.
//
// Design, three kernels:
//   fir_kernel: the FIR sums do not depend on the output, so a fully
//     parallel pre-pass computes them for every pixel into a scratch plane
//     (one uint32 a pixel: sum in the low 21 bits, count in the high 11;
//     a mask pixel holds its img value under count 0x7FF).  A CTA covers a
//     tile of FT columns and RS rows of a page, all channels, keeps running
//     column sums with the bytes that enter them loaded a row ahead, and
//     sums 2n of them a pixel.
//   optimise_kernel: one CTA per (page, channel) walks the rows; thread t
//     owns columns [8t, 8t+8) in every row.  Nothing on the chain touches
//     device memory: the FIR rows arrive DEPTH rows ahead by cp.async into
//     a shared ring (each thread copies only its own columns, so no
//     barrier guards the ring), the last n output rows sit in a shared
//     byte ring and the IIR column sums colI in registers.  Per row a
//     thread needs the n column sums left of its run: every thread writes
//     its colI to a shared row (double-buffered by row parity, a spare
//     word after every 8 columns against bank conflicts), one
//     __syncthreads() per row publishes it, and the IIR window of each
//     column is a running difference.  The floor division is a multiply
//     by a table of reciprocals rounded up (floor_div).  Each row is
//     staged in shared memory and written once, after the barrier, with
//     16-byte stores; it is never read back.
//     A row wider than one CTA's shared memory holds (5,888 columns at
//     n=10) is split into K strips, one CTA each, launched as a thread
//     block cluster of K: the threads owning the last columns of a strip
//     also write their colI into the left halo of the next CTA's colI row
//     (distributed shared memory), and the row's barrier is the
//     cluster's.
//     A row wider than a cluster holds (47,104 columns at n=10, 59,392 at
//     n=3) is cut into S > 8 strips of at most one CTA's width that run as
//     a wavefront through device memory: output (y, x) depends on the
//     FIR plane and on output rows y-n..y-1 at columns x-n..x-1, up and
//     to the left, so strip k may start row y once strip k-1 has finished
//     row y-1.  After each row the threads of a strip's last PAD columns
//     write their colI to a halo row in device memory (one row of PAD
//     words a (plane, strip, row)), and the strip's last thread
//     publishes the row count in a progress flag (release); the threads
//     of strip k that read the left halo wait for the flag (acquire) and
//     copy the halo into their colI row before they sum it.  Nothing
//     flows right to left, so a launch may hold strips [s0, s0 + G) of a
//     few planes when strip s0 - 1 ran in an earlier launch; every CTA
//     of a launch is resident at once (a cooperative launch, refused
//     rather than hung), so no strip spins on one that is not running.
//     Launch by launch, the width has no limit: at 132 CTAs a launch a
//     row of 120,000 columns at n=10 (S = 21) runs as one launch for up
//     to 6 planes.
//   interleave_kernel: for RGB the walk writes planes, and this pass
//     interleaves them into (B, H, W, C).
//   Batch 8 gray is 8 chains (24 RGB) on 132 SMs; the chain is inherent.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define FS_BITS 21
#define FS_MASK 0x1FFFFFu
#define FC_SENTINEL 0x7FFu       // count field of a mask pixel
#define PAD 32                   // zero columns left of colI (n <= 22)
// a colI row in shared memory keeps one spare word after every 8 columns,
// so that the threads' runs of 8 columns start 9 words apart (no bank
// conflicts when each thread reads the columns left of its run)
#define CB(c) ((c) + PAD + (((c) + PAD) >> 3))
#define CBROW(P) (((P) + PAD) / 8 * 9)
#define DEPTH 4                  // FIR rows in flight ahead of the walk
#define COLS 8                   // columns a thread owns
#define MAX_CLUSTER 8            // CTAs a row may be split over (portable)
#define RS 128                   // rows a pre-pass CTA sums
#define FT 256                   // columns a pre-pass CTA sums
// reciprocal table: count <= 2047 + n^2, a multiple of 4 entries
#define RTAB(n) (2048 + (((n) * (n) + 3) & ~3))

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_depth() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(DEPTH - 1) : "memory");
}

// one pixel's term of the FIR sums: img over mask and the count bit, from
// a mask byte and an img byte loaded a row earlier
__device__ __forceinline__ uint32_t fir_term(uint32_t mv, uint32_t iv) {
  return mv ? (iv | (1u << FS_BITS)) : 0u;
}

// the mask byte and the C img bytes of pixel (r, x), 0 outside the page
template <int C>
__device__ __forceinline__ void fir_load(const uint8_t* m, const uint8_t* im,
                                         int r, int x, int H, int W,
                                         uint32_t& mv, uint32_t (&iv)[C]) {
  mv = 0u;
#pragma unroll
  for (int c = 0; c < C; ++c) iv[c] = 0u;
  if (r >= 0 && r < H && x >= 0 && x < W) {
    const size_t p = (size_t)r * W + x;
    mv = m[p];
#pragma unroll
    for (int c = 0; c < C; ++c) iv[c] = im[p * C + c];
  }
}

// fir[(b*C + c), y, x] for x < P (the pitch: K strips of the walk).  A
// CTA sums a tile of FT columns over RS rows of one page, all C channels
// (the mask bytes once): thread t keeps the running sums over rows
// [y-n, y+n) of tile columns t and FT + t (the 2n halo columns), with the
// bytes that enter and leave them loaded a row ahead, and sums 2n of them
// for its pixel.
template <int C>
__global__ void __launch_bounds__(FT)
fir_kernel(const uint8_t* __restrict__ img, const uint8_t* __restrict__ mask,
           uint32_t* __restrict__ fir, int H, int W, int n, int P) {
  __shared__ uint32_t hrow[2][C][FT + 2 * PAD];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const size_t plane = (size_t)H * W;
  const uint8_t* m = mask + b * plane;
  const uint8_t* im = img + b * plane * C;
  uint32_t* f = fir + (size_t)b * C * H * P;
  const int x = blockIdx.y * FT + t;            // this thread's pixel
  const int xa = x - n, xb = x - n + FT;        // its tile columns
  const bool halo = t < 2 * n;
  const int y0 = blockIdx.z * RS;
  const int y1 = min(y0 + RS, H);

  uint32_t va[C], vb[C], mv, iv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) va[c] = vb[c] = 0u;
#pragma unroll 2
  for (int r = y0 - n; r < y0 + n; ++r) {
    fir_load<C>(m, im, r, xa, H, W, mv, iv);
#pragma unroll
    for (int c = 0; c < C; ++c) va[c] += fir_term(mv, iv[c]);
    if (halo) {
      fir_load<C>(m, im, r, xb, H, W, mv, iv);
#pragma unroll
      for (int c = 0; c < C; ++c) vb[c] += fir_term(mv, iv[c]);
    }
  }
  // the bytes entering (a) and leaving (d) the sums of the next row, for
  // columns xa and xb, and this thread's pixel p
  uint32_t am, ai[C], dm, di[C], bam = 0u, bai[C], bdm = 0u, bdi[C], pm,
      pi[C];
#pragma unroll
  for (int c = 0; c < C; ++c) bai[c] = bdi[c] = 0u;
  fir_load<C>(m, im, y0 + n, xa, H, W, am, ai);
  fir_load<C>(m, im, y0 - n, xa, H, W, dm, di);
  if (halo) {
    fir_load<C>(m, im, y0 + n, xb, H, W, bam, bai);
    fir_load<C>(m, im, y0 - n, xb, H, W, bdm, bdi);
  }
  fir_load<C>(m, im, y0, x, H, W, pm, pi);
  for (int y = y0; y < y1; ++y) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      uint32_t* hr = hrow[y & 1][c];
      hr[t] = va[c];
      if (halo) hr[FT + t] = vb[c];
      va[c] += fir_term(am, ai[c]) - fir_term(dm, di[c]);
      vb[c] += fir_term(bam, bai[c]) - fir_term(bdm, bdi[c]);
    }
    uint32_t cm = pm, ci[C];
#pragma unroll
    for (int c = 0; c < C; ++c) ci[c] = pi[c];
    fir_load<C>(m, im, y + 1 + n, xa, H, W, am, ai);
    fir_load<C>(m, im, y + 1 - n, xa, H, W, dm, di);
    if (halo) {
      fir_load<C>(m, im, y + 1 + n, xb, H, W, bam, bai);
      fir_load<C>(m, im, y + 1 - n, xb, H, W, bdm, bdi);
    }
    fir_load<C>(m, im, y + 1, x, H, W, pm, pi);
    __syncthreads();   // the other buffer's readers passed the last one
    if (x < P) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        uint32_t v = 0u;
        if (x < W) {
          if (cm) {
            v = (FC_SENTINEL << FS_BITS) | ci[c];
          } else {
            const uint32_t* hr = hrow[y & 1][c];
#pragma unroll 4
            for (int d = 0; d < 2 * n; ++d) v += hr[t + d];
          }
        }
        f[((size_t)c * H + y) * P + x] = v;
      }
    }
  }
}

// The walk's division.  With val < 2^24 and r = 1/cnt rounded up,
// val * r lies in [val/cnt, val/cnt * (1 + 2^-23)], which for cnt <= 2531
// and val/cnt < 256 stays below the next integer by far more than half an
// ulp, so truncating the rounded product is floor(val / cnt) exactly.
// rtab[0] = 0 gives the reference's 0 for an empty window.
__device__ __forceinline__ int floor_div(int val, const float* rtab,
                                         int cnt) {
  return __float2int_rz(__fmul_rn(__int2float_rn(val), rtab[cnt]));
}

// 8 bytes to shared memory at any alignment
__device__ __forceinline__ void sts8(uint8_t* p, uint32_t lo, uint32_t hi) {
  const uintptr_t a = (uintptr_t)p;
  if ((a & 7) == 0) {
    *(uint2*)p = make_uint2(lo, hi);
  } else if ((a & 3) == 0) {
    ((uint32_t*)p)[0] = lo;
    ((uint32_t*)p)[1] = hi;
  } else if ((a & 1) == 0) {
    ((uint16_t*)p)[0] = (uint16_t)lo;
    ((uint16_t*)p)[1] = (uint16_t)(lo >> 16);
    ((uint16_t*)p)[2] = (uint16_t)hi;
    ((uint16_t*)p)[3] = (uint16_t)(hi >> 16);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[j] = (uint8_t)(lo >> (8 * j));
      p[4 + j] = (uint8_t)(hi >> (8 * j));
    }
  }
}

// row y of a plane, staged in shared memory at the global row's offset
// within 16 bytes, to device memory: a thread a 16-byte store, and a
// thread a byte at the two ragged ends
__device__ __forceinline__ void store_row(uint8_t* grow, const uint8_t* stage,
                                          int W) {
  const int s = (int)((uintptr_t)grow & 15);
  uint8_t* base = grow - s;
  const int k0 = s ? 1 : 0;                    // first whole chunk
  const int k1 = (s + W) / 16;                 // past the last one
  const int whole = max(k1 - k0, 0);
  const int head = min(16 * k0, s + W) - s;    // bytes before chunk k0
  const int t1 = max(16 * max(k1, k0), s + head);  // first byte after
  const int tail = max(s + W - t1, 0);
  for (int k = threadIdx.x; k < whole + head + tail; k += blockDim.x) {
    if (k < whole) {
      const int lo = 16 * (k0 + k);
      *(uint4*)(base + lo) = *(const uint4*)(stage + lo);
    } else {
      const int i = k < whole + head ? s + (k - whole)
                                     : t1 + (k - whole - head);
      base[i] = stage[i];
    }
  }
}

// the wavefront's progress flags: a release store after the halo, an
// acquire load before it is read
__device__ __forceinline__ void flag_release(unsigned* f, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" :: "l"(f), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned flag_acquire(const unsigned* f) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(f)
               : "memory");
  return v;
}

// the row's barrier: the CTA's, or the cluster's when K CTAs share a row
// (it also publishes the halo columns written into a neighbour)
__device__ __forceinline__ void row_sync(int K) {
  if (K > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// CTA k of a cluster of K walks the strip of columns [k*Q, k*Q + Q) of
// one (page, channel), Q = P / K.  With ghalo (the wavefront, K = 1):
// CTA j walks strip s0 + j % G of plane pl0 + j / G, of S strips of
// Q = P / S columns, handing its colI to the next strip through ghalo
// (PAD words a (plane, strip, row)) and flags (rows published a (plane,
// strip), zeroed before the first launch).  WAVE compiles the wavefront
// in; the one-CTA and cluster forms are built without it.
template <bool WAVE>
__global__ void __launch_bounds__(1024)
optimise_kernel(const uint32_t* __restrict__ fir, uint8_t* planes, int H,
                int W, int n, int P, int K, int* ghalo, unsigned* flags,
                int S, int s0, int G, int pl0) {
  extern __shared__ __align__(16) uint8_t osm[];
  const int Q = P / (WAVE ? S : K);
  uint32_t* ring = (uint32_t*)osm;                          // DEPTH x Q
  int* cb = (int*)(ring + DEPTH * Q);                       // 2 x CBROW
  uint8_t* stage = (uint8_t*)(cb + 2 * CBROW(Q));           // 2 x (Q+16)
  float* rtab = (float*)(stage + 2 * (Q + 16));             // RTAB(n)
  uint8_t* oring = (uint8_t*)(rtab + RTAB(n));              // n x Q
  const int t = threadIdx.x;
  const int x0 = COLS * t;                       // first column, in strip
  // the strip (= the cluster rank) and the plane
  const int rank = WAVE ? s0 + (int)blockIdx.x % G : (int)blockIdx.x % K;
  const int plane = WAVE ? pl0 + (int)blockIdx.x / G : (int)blockIdx.x / K;
  const int xs = rank * Q;                       // the strip's first column
  const int ws = max(min(W - xs, Q), 0);         // its columns on the page
  const uint32_t* f = fir + (size_t)plane * H * P + xs + x0;
  uint8_t* o = planes + (size_t)plane * H * W + xs;
  // the wavefront: the left strip's halo rows and flag, this strip's
  int* hleft = WAVE && rank > 0
      ? ghalo + (size_t)(plane * S + rank - 1) * H * PAD : nullptr;
  int* hmine = WAVE && rank + 1 < S
      ? ghalo + (size_t)(plane * S + rank) * H * PAD : nullptr;
  const unsigned* fleft = hleft ? flags + plane * S + rank - 1 : nullptr;
  // the next strip's colI rows, whose left halo this strip's end feeds
  int* right = !WAVE && rank + 1 < K
      ? cg::this_cluster().map_shared_rank(cb, rank + 1) : nullptr;

  for (int i = t; i < 2 * CBROW(Q); i += blockDim.x) cb[i] = 0;
  for (int i = t; i < RTAB(n); i += blockDim.x)
    rtab[i] = i ? __frcp_ru((float)i) : 0.0f;
  for (int d = 0; d < DEPTH; ++d) {
    if (d < H) {
      cp_async16(ring + d * Q + x0, f + (size_t)d * P);
      cp_async16(ring + d * Q + x0 + 4, f + (size_t)d * P + 4);
    }
    cp_async_commit();
  }
  int iw[COLS];                                  // min(x, n)
#pragma unroll
  for (int j = 0; j < COLS; ++j) iw[j] = min(xs + x0 + j, n);
  row_sync(K);       // every halo is zero before a neighbour writes it

  int colI[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) colI[j] = 0;
  int oslot = 0;                                 // y % n
  for (int y = 0; y < H; ++y) {
    if (y > 0)                                   // row y-1, now complete
      store_row(o + (size_t)(y - 1) * W, stage + ((y - 1) & 1) * (Q + 16),
                ws);
    int* cur = cb + (y & 1) * CBROW(Q);
    if (WAVE && hleft != nullptr && y > 0 && x0 < n) {
      // the left strip's colI after row y-1, for columns [x0-n, 0)
      while (flag_acquire(fleft) < (unsigned)y) {
      }
      const int* hrow = hleft + (size_t)y * PAD;
      for (int c = x0 - n; c < 0; ++c) cur[CB(c)] = __ldcg(hrow + PAD + c);
    }
    int s = 0;                                   // colI over [x0-n, x0)
#pragma unroll 8
    for (int i = 1; i <= n; ++i) s += cur[CB(x0 - i)];
    cp_async_wait_depth();                       // this thread's row y
    const uint32_t* fr = ring + (y % DEPTH) * Q + x0;
    const uint4 fa = *(const uint4*)fr;
    const uint4 fb = *(const uint4*)(fr + 4);
    const uint32_t fv[COLS] = {fa.x, fa.y, fa.z, fa.w,
                               fb.x, fb.y, fb.z, fb.w};
    const int ih = y < n ? y : n;
    int v[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int fc = (int)(fv[j] >> FS_BITS);
      const int fs = (int)(fv[j] & FS_MASK);
      const int q = floor_div(fs + s, rtab, fc + ih * iw[j]);
      v[j] = fc == FC_SENTINEL ? fs : q;
      s += colI[j] - cur[CB(x0 + j - n)];        // slide to column x+1
    }
    // the ring slot of row y-n becomes row y; colI moves down one row
    uint8_t* orow = oring + (size_t)oslot * Q + x0;
    const uint2 old = *(const uint2*)orow;
    const uint32_t ow[2] = {old.x, old.y};
    uint32_t nw[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int leave = y >= n ? (int)((ow[j >> 2] >> (8 * (j & 3))) & 0xFFu)
                               : 0;
      colI[j] += v[j] - leave;
      nw[j >> 2] |= (uint32_t)v[j] << (8 * (j & 3));
    }
    *(uint2*)orow = make_uint2(nw[0], nw[1]);
    oslot = oslot + 1 == n ? 0 : oslot + 1;
    int* nxt = cb + ((y + 1) & 1) * CBROW(Q) + CB(x0);
#pragma unroll
    for (int j = 0; j < COLS; ++j) nxt[j] = colI[j];
    if (!WAVE && right != nullptr && x0 + COLS > Q - PAD) {
      // the strip's last PAD columns are the next strip's left halo
      int* halo = right + ((y + 1) & 1) * CBROW(Q);
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        if (x0 + j >= Q - PAD) halo[CB(x0 + j - Q)] = colI[j];
    }
    if (WAVE && hmine != nullptr && y + 1 < H && t >= (int)blockDim.x - 32) {
      // the last warp hands the strip's last PAD columns' colI on
      if (x0 + COLS > Q - PAD) {
        int* hrow = hmine + (size_t)(y + 1) * PAD;
#pragma unroll
        for (int j = 0; j < COLS; ++j)
          if (x0 + j >= Q - PAD) hrow[x0 + j - (Q - PAD)] = colI[j];
        __threadfence();
      }
      __syncwarp();
      if (t == (int)blockDim.x - 1) {
        __threadfence();
        flag_release(flags + plane * S + rank, (unsigned)(y + 1));
      }
    }
    const int so = (int)((uintptr_t)(o + (size_t)y * W) & 15);
    sts8(stage + (y & 1) * (Q + 16) + so + x0, nw[0], nw[1]);
    // this thread's columns of row y+DEPTH into the slot row y left
    const int ya = y + DEPTH;
    if (ya < H) {
      uint32_t* dst = ring + (y % DEPTH) * Q + x0;
      cp_async16(dst, f + (size_t)ya * P);
      cp_async16(dst + 4, f + (size_t)ya * P + 4);
    }
    cp_async_commit();
    row_sync(K);       // publishes colI, the halo and the staged row y
  }
  if (H > 0)
    store_row(o + (size_t)(H - 1) * W, stage + ((H - 1) & 1) * (Q + 16),
              ws);
}

// planes (B*3, H, W) -> out (B, H, W, 3), 4 pixels a thread (HW % 4 == 0:
// 4-byte loads from each plane, three 4-byte stores); blockIdx.y is the
// page
__global__ void interleave3_kernel(const uint8_t* __restrict__ planes,
                                   uint8_t* __restrict__ out, int HW) {
  const size_t b = blockIdx.y;
  const uint32_t* p0 = (const uint32_t*)(planes + b * 3 * HW);
  const uint32_t* p1 = (const uint32_t*)(planes + (b * 3 + 1) * HW);
  const uint32_t* p2 = (const uint32_t*)(planes + (b * 3 + 2) * HW);
  uint32_t* o = (uint32_t*)(out + b * 3 * HW);
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < HW / 4;
       q += gridDim.x * blockDim.x) {
    const uint32_t r = p0[q], g = p1[q], bl = p2[q];
    // pixels 0-3 as r0 g0 b0 r1 | g1 b1 r2 g2 | b2 r3 g3 b3
    const uint32_t rg = __byte_perm(r, g, 0x5140);     // r0 g0 r1 g1
    const uint32_t rg2 = __byte_perm(r, g, 0x7362);    // r2 g2 r3 g3
    o[3 * q] = __byte_perm(rg, bl, 0x2410);            // r0 g0 b0 r1
    o[3 * q + 1] = __byte_perm(__byte_perm(rg, bl, 0x0053), rg2,
                               0x5410);                 // g1 b1 r2 g2
    o[3 * q + 2] = __byte_perm(rg2, bl, 0x7326);       // b2 r3 g3 b3
  }
}

// planes (B*C, H, W) -> out (B, H, W, C); blockIdx.y is the page
__global__ void interleave_kernel(const uint8_t* __restrict__ planes,
                                  uint8_t* __restrict__ out, int HW, int C) {
  const size_t b = blockIdx.y;
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < HW;
       q += gridDim.x * blockDim.x)
    for (int c = 0; c < C; ++c)
      out[(b * HW + q) * C + c] = planes[(b * C + c) * HW + q];
}

// threads of the row walk for width W: one per COLS columns, whole warps
static int walk_threads(int W) {
  const int t = (W + COLS - 1) / COLS;
  return (t + 31) / 32 * 32;
}

// The wavefront's launches: strips [s0, s0 + G) of planes [pl0, pl0 +
// np) each, every CTA resident at once (a cooperative launch).  The
// strips left of s0 ran in an earlier launch, so a launch holds G <= R
// strips (R: the CTAs the card keeps resident) and as many planes as fit.
static cudaError_t launch_wavefront(const uint32_t* fc, uint8_t* dst, int* ghalo,
                                    unsigned* flags, int BC, int H, int W,
                                    int n, int P, int S, int T, size_t osm,
                                    cudaStream_t st) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, optimise_kernel<true>, T, osm);
  if (e != cudaSuccess) return e;
  const int R = per_sm * sms;
  if (R < 1) return cudaErrorCooperativeLaunchTooLarge;
  e = cudaMemsetAsync(flags, 0, (size_t)BC * S * sizeof(unsigned), st);
  if (e != cudaSuccess) return e;
  const int G = S < R ? S : R;
  const int per = G == S ? R / S : 1;           // planes a launch
  for (int s0 = 0; s0 < S; s0 += G) {
    const int g = S - s0 < G ? S - s0 : G;
    for (int pl0 = 0; pl0 < BC; pl0 += per) {
      const int np = BC - pl0 < per ? BC - pl0 : per;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(np * g);
      cfg.blockDim = dim3(T);
      cfg.dynamicSmemBytes = osm;
      cfg.stream = st;
      cudaLaunchAttribute at[1];
      at[0].id = cudaLaunchAttributeCooperative;
      at[0].val.cooperative = 1;
      cfg.attrs = at;
      cfg.numAttrs = 1;
      e = cudaLaunchKernelEx(&cfg, optimise_kernel<true>, fc, dst, H, W, n,
                             P, 1, ghalo, flags, S, s0, g, pl0);
      if (e != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

// A row is split over K CTAs of T threads each, strips of Q = COLS * T
// columns (T = walk_threads(ceil(W / K))); ops/optimise_cuda.py picks the
// least K whose strip fits one CTA's shared memory: a cluster up to
// MAX_CLUSTER, the wavefront past it.  fir: B * C * H * P uint32 of
// scratch, P = K * Q; planes: B * C * H * W bytes of scratch for C > 1
// (out itself for C == 1); for the wavefront (K > MAX_CLUSTER) ghalo:
// B * C * K * H * PAD int32 and flags: B * C * K uint32 of scratch.
extern "C" int apt_optimise(const void* img, const void* mask, void* fir,
                            void* planes, void* out, void* ghalo,
                            void* flags, int B, int H, int W, int C, int n,
                            int K, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;     // nothing to fill
  if (K < 1 || n < 1 || n > 22 || (K > MAX_CLUSTER && (!ghalo || !flags)))
    return (int)cudaErrorInvalidValue;
  const int T = walk_threads((W + K - 1) / K);
  const int Q = COLS * T;
  const int P = K * Q;
  if (T > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 fgrid(B, P / FT, (H + RS - 1) / RS);
  const uint8_t* im = (const uint8_t*)img;
  const uint8_t* mk = (const uint8_t*)mask;
  uint32_t* fr = (uint32_t*)fir;
  switch (C) {
    case 1: fir_kernel<1><<<fgrid, FT, 0, st>>>(im, mk, fr, H, W, n, P); break;
    case 2: fir_kernel<2><<<fgrid, FT, 0, st>>>(im, mk, fr, H, W, n, P); break;
    case 3: fir_kernel<3><<<fgrid, FT, 0, st>>>(im, mk, fr, H, W, n, P); break;
    case 4: fir_kernel<4><<<fgrid, FT, 0, st>>>(im, mk, fr, H, W, n, P); break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t osm = (size_t)DEPTH * Q * 4 + (size_t)2 * CBROW(Q) * 4
                     + (size_t)2 * (Q + 16) + (size_t)RTAB(n) * 4
                     + (size_t)n * Q;
  if (osm > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (osm > 48 * 1024) {
    e = K > MAX_CLUSTER
        ? cudaFuncSetAttribute(optimise_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)osm)
        : cudaFuncSetAttribute(optimise_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)osm);
    if (e != cudaSuccess) return (int)e;
  }
  uint8_t* dst = C == 1 ? (uint8_t*)out : (uint8_t*)planes;
  const uint32_t* fc = (const uint32_t*)fir;
  if (K == 1) {
    optimise_kernel<false><<<B * C, T, osm, st>>>(fc, dst, H, W, n, P, 1,
                                                  nullptr, nullptr, 1, 0, 1,
                                                  0);
  } else if (K > MAX_CLUSTER) {
    e = launch_wavefront(fc, dst, (int*)ghalo, (unsigned*)flags, B * C, H,
                         W, n, P, K, T, osm, st);
    if (e != cudaSuccess) return (int)e;
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * C * K);
    cfg.blockDim = dim3(T);
    cfg.dynamicSmemBytes = osm;
    cfg.stream = st;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = K;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, optimise_kernel<false>, fc, dst, H, W, n, P,
                           K, (int*)nullptr, (unsigned*)nullptr, 1, 0, 1, 0);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaGetLastError();
  if (e != cudaSuccess || C == 1) return (int)e;
  if (C == 3 && (H * W) % 4 == 0)
    interleave3_kernel<<<dim3(256, B), 256, 0, st>>>(
        (const uint8_t*)planes, (uint8_t*)out, H * W);
  else
    interleave_kernel<<<dim3(256, B), 256, 0, st>>>(
        (const uint8_t*)planes, (uint8_t*)out, H * W, C);
  return (int)cudaGetLastError();
}
