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
//   rows above) and within a row (the last two produced bits).  A page is
//   a dependent chain of H row steps, so a launch takes about H times the
//   latency of one row step, far above the time its bytes need at 3.35
//   TB/s: the kernel stays latency-bound.  With one CTA a page on its own
//   SM, a row step costs what that SM issues for the row, so the design
//   cuts the instructions a row takes.
//
// Design, three kernels:
//   pack_kernel packs the bool mask into bit rows (a word per 32 columns,
//     one __ballot_sync each), fully parallel; unpack_kernel writes the
//     final bit rows back as bytes.  The walk reads and writes one word a
//     thread a row, coalesced, and never reads back what it wrote.
//   despeckle_kernel: one CTA per page walks the rows; thread t owns the
//     32 columns of word t (WPT = 1, rows up to 32,768 columns), or the 64
//     of words 2t and 2t+1 (WPT = 2, up to 65,536; its map covers both
//     words).  Shared memory holds the original rows y..y+3
//     and the final rows y-4..y-1 as bit rows (rings of 4), and two tables
//     of 4-column steps.  The original row y+4 is loaded into a register
//     while row y resolves.  Per row:
//   - BOT + CUR as a bit-sliced sum of 12 shifted words (carry-save
//     adders on whole words: 32 columns an instruction);
//   - barrier A publishes the final row y-1;
//   - TOP, the same way from the final rows y-1 and y-2, added in; three
//     bit-sliced comparisons with mincnt give each column one of four
//     kinds: always 1 (count >= mincnt), "either of the two last bits"
//     (mincnt - 1), "both" (mincnt - 2), always 0 (else, and every forced
//     zero); a forced set pixel is "always 1";
//   - the thread's 4-state transition map of its 32 columns from a table
//     of 4-column maps (256 entries), composed right to left with one
//     byte permute each; a warp-shuffle scan composes the lanes' maps,
//     barrier B publishes the warps' maps, and each thread applies those
//     of the warps to its left to start state 0, then replays its columns
//     4 at a time from a table of (state, 4 kinds) -> (4 bits, state).
//   Composition is associative, so the result is the sequential one.
//   Two barriers a row; batch 8 is 8 chains on 132 SMs, inherent.
//   A page wider than one CTA holds (65,536 columns) is cut into S
//   strips of at most 1,024 words, one CTA each, that run as a wavefront
//   through device memory.  Row y of strip k needs (a) the final bits of
//   row y at the two columns left of it, which are its start state, and
//   (b) the final rows y-1 and y-2 two columns past each side (TOP).  So
//   after each row a strip's first thread writes its first final word,
//   and its last thread its last one, to a halo in device memory (two
//   words a (page, strip, row)), each then publishing its row count in
//   its own progress flag (release).  Before barrier A the first thread
//   waits (acquire) for strip k-1's last word of row y-1 and the last
//   thread for strip k+1's first word of row y-1, into the padding words
//   of the final ring; before barrier B the first thread waits for strip
//   k-1's last word of row y and hands its top two bits on as the start
//   state.  The original rows' padding words come from the packed input.
//   Strips wait on both neighbours, so every strip of a page is in one
//   launch with all its CTAs resident (a cooperative launch, refused
//   rather than hung; pages are chunked to fit): at one 1,024-thread CTA
//   an SM that is 132 strips, 4,325,376 columns, 720 inches at 6,000
//   DPI, far past PDF's 200-inch page.

#include <cuda_runtime.h>
#include <stdint.h>

// full adder on 32 columns at once
__device__ __forceinline__ void fa(uint32_t a, uint32_t b, uint32_t c,
                                   uint32_t& s, uint32_t& cy) {
  s = a ^ b ^ c;
  cy = (a & b) | (c & (a ^ b));
}

// bit (x + k) for the 32 columns x of word `cur`, -2 <= k <= 2
__device__ __forceinline__ uint32_t shifted(uint32_t prev, uint32_t cur,
                                            uint32_t next, int k) {
  return k >= 0 ? __funnelshift_r(cur, next, k)
                : __funnelshift_l(prev, cur, -k);
}

// a map's byte form (byte s = next state from state s) as the selector of
// __byte_perm (nibble s)
__device__ __forceinline__ uint32_t selector(uint32_t bf) {
  return __byte_perm(bf | (bf >> 4), 0, 0x4420);
}

// 5-bit count >= m (m uniform over the block), bit-sliced
__device__ __forceinline__ uint32_t count_ge(const uint32_t* c, int m) {
  if (m <= 0) return ~0u;
  if (m > 31) return 0u;
  uint32_t gt = 0u, eq = ~0u;
#pragma unroll
  for (int i = 4; i >= 0; --i) {
    if ((m >> i) & 1) {
      eq &= c[i];
    } else {
      gt |= eq & c[i];
      eq &= ~c[i];
    }
  }
  return gt | eq;
}

__device__ __forceinline__ uint32_t count_eq(const uint32_t* c, int m) {
  if (m < 0 || m > 31) return 0u;
  uint32_t eq = ~0u;
#pragma unroll
  for (int i = 0; i < 5; ++i) eq &= ((m >> i) & 1) ? c[i] : ~c[i];
  return eq;
}

// bool (B*H, W) -> bit rows (B*H, T) words, bit j of word k = column 32k+j
__global__ void pack_kernel(const uint8_t* __restrict__ in,
                            uint32_t* __restrict__ bits, int rows, int W,
                            int T) {
  const int lane = threadIdx.x & 31;
  const size_t warps = ((size_t)gridDim.x * blockDim.x) >> 5;
  const size_t total = (size_t)rows * T;
  for (size_t k = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       k < total; k += warps) {
    const size_t r = k / T;
    const int x = 32 * (int)(k - r * T) + lane;
    const bool v = x < W && in[r * W + x] != 0;
    const uint32_t word = __ballot_sync(0xffffffffu, v);
    if (lane == 0) bits[k] = word;
  }
}

// bit rows (B*H, T) -> bool (B*H, W); blockIdx.y strides over the rows
__global__ void unpack_kernel(const uint32_t* __restrict__ bits,
                              uint8_t* __restrict__ out, int rows, int W,
                              int T) {
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint32_t* br = bits + (size_t)r * T;
    uint8_t* orow = out + (size_t)r * W;
    for (int x = blockIdx.x * blockDim.x + threadIdx.x; x < W;
         x += gridDim.x * blockDim.x)
      orow[x] = (uint8_t)((br[x >> 5] >> (x & 31)) & 1u);
  }
}

__device__ __forceinline__ void flag_release(unsigned* f, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" :: "l"(f), "r"(v)
               : "memory");
}

__device__ __forceinline__ void flag_wait(const unsigned* f, unsigned v) {
  unsigned got;
  do {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(got)
                 : "l"(f) : "memory");
  } while (got < v);
}

// WPT: bit words a thread owns (1 up to 32,768 columns, 2 up to 65,536).
// WAVE: the wavefront of S strips, CTA j walks strip j % S of page pg0 + j / S;
// halo holds 2 words a (page, strip, row) (its first and last final
// word), flags 2 a (page, strip) (rows published of each), zeroed.
// WAVE compiles the wavefront in; one CTA a page is built without it.
template <int WPT, bool WAVE>
__global__ void __launch_bounds__(1024)
despeckle_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                 int H, int W, int mincnt, uint32_t* halo, unsigned* flags,
                 int S, int pg0) {
  extern __shared__ __align__(16) uint32_t dsm[];
  const int T = blockDim.x;
  const int TW = T * WPT;                     // words a strip's bit row
  const int RW = WAVE ? S * TW : TW;          // words a page's bit row
  const int page = WAVE ? pg0 + (int)blockIdx.x / S : (int)blockIdx.x;
  const int strip = WAVE ? (int)blockIdx.x % S : 0;
  const bool has_left = WAVE && strip > 0;
  const bool has_right = WAVE && strip + 1 < S;
  const int stride = TW + 2;                  // a zero word each side
  uint32_t* orig = dsm + 1;                   // 4 bit rows, original
  uint32_t* fin = dsm + 4 * stride + 1;       // 4 bit rows, final
  uint32_t* agg = dsm + 8 * stride;           // a map per warp
  // agg[32]: the start state a wavefront strip takes from its left
  uint32_t* lut_bf = agg + 33;                // 4-column map, byte form
  uint32_t* lut_nf = lut_bf + 256;            // the same as a selector
  uint8_t* lut_rep = (uint8_t*)(lut_nf + 256);  // (state, kinds) -> bits
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int w0 = t * WPT;                     // this thread's first word
  const uint32_t* mb = in + (size_t)page * H * RW + strip * TW;
  const uint32_t* m = mb + w0;
  uint32_t* o = out + (size_t)page * H * RW + strip * TW + w0;
  // the wavefront's halo words and flags: [0] first word, [1] last
  uint32_t* hme = halo + (size_t)(page * S + strip) * H * 2;
  const uint32_t* hl = hme - (size_t)H * 2;            // strip - 1
  const uint32_t* hr = hme + (size_t)H * 2;            // strip + 1
  unsigned* fme = flags + (size_t)(page * S + strip) * 2;
  const bool lead = t == 0 && has_left;                // reads the left
  const bool tail = t == T - 1 && has_right;           // reads the right

  for (int i = t; i < 8 * stride; i += T) dsm[i] = 0u;
  // the tables: index a | b << 4 holds the kinds of 4 columns, column j
  // in bit j of a ("always 1" or "both") and of b ("either" or "both")
  for (int idx = t; idx < 256; idx += T) {
    uint32_t bf = 0u;
    for (int s = 0; s < 4; ++s) {
      uint32_t p0 = s & 1, p1 = s >> 1, bits = 0u;
      for (int j = 0; j < 4; ++j) {
        const uint32_t a = (idx >> j) & 1u, b = (idx >> (4 + j)) & 1u;
        const uint32_t u = (a & (b ^ 1u)) | (b & (a ^ 1u) & (p0 | p1))
                           | (a & b & p0 & p1);
        bits |= u << j;
        p1 = p0;
        p0 = u;
      }
      const uint32_t e = p0 | (p1 << 1);
      bf |= e << (8 * s);
      lut_rep[s * 256 + idx] = (uint8_t)(bits | (e << 4));
    }
    lut_bf[idx] = bf;
    lut_nf[idx] = selector(bf);
  }
  // interior columns 2..W-3 of each word
  uint32_t interior[WPT];
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    interior[k] = 0u;
    for (int j = 0; j < 32; ++j) {
      const int x = 32 * (strip * TW + w0 + k) + j;
      interior[k] |= (uint32_t)(x >= 2 && x < W - 2) << j;
    }
  }
  __syncthreads();
  uint32_t pend[WPT];
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    for (int r = 0; r < 3 && r < H; ++r)
      orig[r * stride + w0 + k] = m[(size_t)r * RW + k];
    pend[k] = 3 < H ? m[(size_t)3 * RW + k] : 0u;
  }
  // the neighbours' original words beside the strip (padding words)
  uint32_t pedge = 0u;
  if (lead || tail) {
    const int e = lead ? -1 : TW;
    for (int r = 0; r < 3 && r < H; ++r)
      orig[r * stride + e] = mb[(size_t)r * RW + e];
    pedge = 3 < H ? mb[(size_t)3 * RW + e] : 0u;
  }
  __syncthreads();

  for (int y = 0; y < H; ++y) {
    const bool row_border = y < 2 || y >= H - 2;
    const uint32_t* r0 = orig + (y & 3) * stride;
    uint32_t own[WPT], bc[WPT][4];            // BOT + CUR, bit-sliced
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
      const int wd = w0 + k;
      own[k] = r0[wd];
      if (!row_border) {
        const uint32_t* r1 = orig + ((y + 1) & 3) * stride;
        const uint32_t* r2 = orig + ((y + 2) & 3) * stride;
        const uint32_t a0 = r1[wd - 1], a1 = r1[wd], a2 = r1[wd + 1];
        const uint32_t b0 = r2[wd - 1], b1 = r2[wd], b2 = r2[wd + 1];
        const uint32_t c2 = r0[wd + 1];
        uint32_t s1, s2, s3, s4, s5, k1, k2, k3, k4, k5;
        fa(shifted(a0, a1, a2, -2), shifted(a0, a1, a2, -1), a1, s1, k1);
        fa(shifted(a0, a1, a2, 1), shifted(a0, a1, a2, 2),
           shifted(b0, b1, b2, -2), s2, k2);
        fa(shifted(b0, b1, b2, -1), b1, shifted(b0, b1, b2, 1), s3, k3);
        fa(shifted(b0, b1, b2, 2), shifted(0u, own[k], c2, 1),
           shifted(0u, own[k], c2, 2), s4, k4);
        fa(s1, s2, s3, s5, k5);
        bc[k][0] = s5 ^ s4;
        const uint32_t k6 = s5 & s4;
        uint32_t u1, u2, d1, d2;
        fa(k1, k2, k3, u1, d1);
        fa(k4, k5, k6, u2, d2);
        bc[k][1] = u1 ^ u2;
        fa(d1, d2, u1 & u2, bc[k][2], bc[k][3]);  // BOT + CUR <= 12
      }
    }
    // original row y+3 into the ring; row y+4 on its way
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
      orig[((y + 3) & 3) * stride + w0 + k] = pend[k];
      pend[k] = y + 4 < H ? m[(size_t)(y + 4) * RW + k] : 0u;
    }
    if (lead || tail) {
      const int e = lead ? -1 : TW;
      orig[((y + 3) & 3) * stride + e] = pedge;
      pedge = y + 4 < H ? mb[(size_t)(y + 4) * RW + e] : 0u;
      if (y > 0) {
        // the neighbour's final word of row y-1 beside the strip
        flag_wait(lead ? fme - 1 : fme + 2, (unsigned)y);
        fin[((y - 1) & 3) * stride + e] =
            __ldcg(lead ? hl + 2 * (y - 1) + 1 : hr + 2 * (y - 1));
      }
    }
    __syncthreads();                          // A: final row y-1 is done

    uint32_t bits[WPT];
#pragma unroll
    for (int k = 0; k < WPT; ++k) bits[k] = own[k];
    if (!row_border) {
      // the kinds of the 8 groups of 4 columns of each word, as table
      // indices, in column order
      uint32_t idx[8 * WPT];
#pragma unroll
      for (int k = 0; k < WPT; ++k) {
        const int wd = w0 + k;
        // TOP: the vertical count of rows y-1, y-2 is lo + 2 hi
        const uint32_t* f1 = fin + ((y - 1) & 3) * stride;
        const uint32_t* f2 = fin + ((y - 2) & 3) * stride;
        const uint32_t g0 = f1[wd - 1], g1 = f1[wd], g2 = f1[wd + 1];
        const uint32_t h0 = f2[wd - 1], h1 = f2[wd], h2 = f2[wd + 1];
        const uint32_t l0 = g0 ^ h0, l1 = g1 ^ h1, l2 = g2 ^ h2;
        const uint32_t q0 = g0 & h0, q1 = g1 & h1, q2 = g2 & h2;
        uint32_t w1, e1, w3, e3, w4, e4, w5, e5, w6, e6;
        fa(shifted(l0, l1, l2, -2), shifted(l0, l1, l2, -1), l1, w1, e1);
        const uint32_t lp1 = shifted(l0, l1, l2, 1);
        const uint32_t lp2 = shifted(l0, l1, l2, 2);
        const uint32_t w2 = lp1 ^ lp2, e2 = lp1 & lp2;
        const uint32_t top0 = w1 ^ w2;
        const uint32_t e0 = w1 & w2;
        fa(shifted(q0, q1, q2, -2), shifted(q0, q1, q2, -1), q1, w3, e3);
        fa(shifted(q0, q1, q2, 1), shifted(q0, q1, q2, 2), e1, w4, e4);
        fa(e2, e0, w3, w5, e5);
        const uint32_t top1 = w4 ^ w5;
        const uint32_t e7 = w4 & w5;
        fa(e3, e4, e5, w6, e6);
        const uint32_t top2 = w6 ^ e7;
        const uint32_t top3 = e6 | (w6 & e7);   // TOP <= 10
        // count = BOT + CUR + TOP, 5 bits
        uint32_t c[5], cy;
        c[0] = bc[k][0] ^ top0;
        cy = bc[k][0] & top0;
        fa(bc[k][1], top1, cy, c[1], cy);
        fa(bc[k][2], top2, cy, c[2], cy);
        fa(bc[k][3], top3, cy, c[3], c[4]);
        const uint32_t one = count_ge(c, mincnt);
        const uint32_t either = count_eq(c, mincnt - 1);
        const uint32_t both = count_eq(c, mincnt - 2);
        const uint32_t inner = own[k] & interior[k];
        const uint32_t ka = (inner & (one | both)) | (own[k] & ~interior[k]);
        const uint32_t kb = inner & (either | both);
        // bytes of ev are groups 0, 2, 4, 6, of od groups 1, 3, 5, 7
        const uint32_t ev = (ka & 0x0F0F0F0Fu) | ((kb & 0x0F0F0F0Fu) << 4);
        const uint32_t od = ((ka >> 4) & 0x0F0F0F0Fu) | (kb & 0xF0F0F0F0u);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          idx[8 * k + 2 * g] = (ev >> (8 * g)) & 0xFFu;
          idx[8 * k + 2 * g + 1] = (od >> (8 * g)) & 0xFFu;
        }
      }
      // this thread's map, composed right to left
      uint32_t map = lut_bf[idx[8 * WPT - 1]];
#pragma unroll
      for (int g = 8 * WPT - 2; g >= 0; --g)
        map = __byte_perm(map, 0, lut_nf[idx[g]]);
      // inclusive scan over the lanes: map := map o (lanes to the left)
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t left = __shfl_up_sync(0xffffffffu, map, d);
        if (lane >= d) map = __byte_perm(map, 0, selector(left));
      }
      if (lane == 31) agg[warp] = map;
      const uint32_t excl = __shfl_up_sync(0xffffffffu, map, 1);
      if (lead) {
        // the start state: strip k-1's final bits of row y at its last
        // two columns (bit 0 the column just left of this strip)
        flag_wait(fme - 1, (unsigned)(y + 1));
        const uint32_t lw = __ldcg(hl + 2 * y + 1);
        agg[32] = (lw >> 31) | ((lw >> 29) & 2u);
      }
      __syncthreads();                        // B: the warps' maps
      uint32_t s = has_left ? agg[32] : 0u;
      for (int w = 0; w < warp; ++w) s = (agg[w] >> (8 * s)) & 3u;
      if (lane > 0) s = (excl >> (8 * s)) & 3u;
#pragma unroll
      for (int k = 0; k < WPT; ++k) {
        bits[k] = 0u;
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const uint32_t rep = lut_rep[s * 256 + idx[8 * k + g]];
          bits[k] |= (rep & 15u) << (4 * g);
          s = rep >> 4;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
      fin[(y & 3) * stride + w0 + k] = bits[k];
      o[(size_t)y * RW + k] = bits[k];
    }
    if (WAVE && ((t == 0 && has_left) || (t == T - 1 && has_right))) {
      // hand this row's edge word to the neighbour that reads it
      const int side = t == 0 && has_left ? 0 : 1;
      hme[2 * y + side] = side ? bits[WPT - 1] : bits[0];
      __threadfence();
      flag_release(fme + side, (unsigned)(y + 1));
    }
  }
}

template <int WPT, bool WAVE>
cudaError_t walk(const uint32_t* packed, uint32_t* fbits, uint32_t* halo,
                 unsigned* flags, int B, int H, int W, int T, int S,
                 int mincnt, cudaStream_t st) {
  const size_t smem = (size_t)(8 * (T * WPT + 2) + 33 + 512) * 4 + 1024;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        despeckle_kernel<WPT, WAVE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (!WAVE) {
    despeckle_kernel<WPT, false><<<B, T, smem, st>>>(
        packed, fbits, H, W, mincnt, nullptr, nullptr, 1, 0);
    return cudaGetLastError();
  }
  // the wavefront: all S strips of a page in one launch, every CTA
  // resident, as many pages a launch as fit
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, despeckle_kernel<WPT, WAVE>, T, smem);
  if (e != cudaSuccess) return e;
  const int per = per_sm * sms / S;             // pages a launch
  if (per < 1) return cudaErrorCooperativeLaunchTooLarge;
  e = cudaMemsetAsync(flags, 0, (size_t)B * S * 2 * sizeof(unsigned), st);
  if (e != cudaSuccess) return e;
  for (int pg0 = 0; pg0 < B; pg0 += per) {
    const int np = B - pg0 < per ? B - pg0 : per;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(np * S);
    cfg.blockDim = dim3(T);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeCooperative;
    at[0].val.cooperative = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, despeckle_kernel<WPT, WAVE>, packed, fbits,
                           H, W, mincnt, halo, flags, S, pg0);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// The row walk's layout for w columns (ops/denoise_cuda.walk_layout sizes
// the scratch the same way): T threads of WPT words a strip, S strips.
// Up to 65,536 columns one strip (WPT 1 up to 32,768, 2 above), past it
// S = ceil(words / 1024) strips of one word a thread.
static void layout(int W, int& T, int& wpt, int& S) {
  const int words = (W + 31) / 32;
  if (words <= 2048) {
    wpt = words <= 1024 ? 1 : 2;
    S = 1;
    T = (words + 32 * wpt - 1) / (32 * wpt) * 32;
  } else {
    wpt = 1;
    S = (words + 1023) / 1024;
    T = ((words + S - 1) / S + 31) / 32 * 32;
  }
}

// bits: 2 * B * H * RW uint32 of scratch, RW = S * T * WPT words a bit
// row; for S > 1 (the wavefront) halo: 2 * B * S * H uint32 and flags:
// 2 * B * S uint32 of scratch
extern "C" int apt_despeckle(const void* mask, void* bits, void* halo,
                             void* flags, void* out, int B, int H, int W,
                             int mincnt, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;     // nothing to despeckle
  int T, wpt, S;
  layout(W, T, wpt, S);
  if (T > 1024 || (S > 1 && (!halo || !flags)))
    return (int)cudaErrorInvalidValue;
  const int RW = S * T * wpt;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = B * H;
  uint32_t* packed = (uint32_t*)bits;
  uint32_t* fbits = packed + (size_t)rows * RW;
  pack_kernel<<<1024, 256, 0, st>>>((const uint8_t*)mask, packed, rows, W,
                                    RW);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  uint32_t* hl = (uint32_t*)halo;
  unsigned* fl = (unsigned*)flags;
  e = S > 1 ? walk<1, true>(packed, fbits, hl, fl, B, H, W, T, S, mincnt, st)
      : wpt == 1 ? walk<1, false>(packed, fbits, hl, fl, B, H, W, T, S,
                                  mincnt, st)
                 : walk<2, false>(packed, fbits, hl, fl, B, H, W, T, S,
                                  mincnt, st);
  if (e != cudaSuccess) return (int)e;
  const int gx = (W + 255) / 256;
  unpack_kernel<<<dim3(gx, rows < 4096 ? rows : 4096), 256, 0, st>>>(
      fbits, (uint8_t*)out, rows, W, RW);
  return (int)cudaGetLastError();
}
