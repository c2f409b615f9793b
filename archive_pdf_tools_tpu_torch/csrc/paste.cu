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
//   crop row-major at off[i], rows of r - l bytes, no alignment).  The
//   plan (ops/paste_cuda.paste_plan, built on the host once for a batch's
//   lines, with their crops' layout) lists the lines of each page in
//   document order: int32 page starts, then a record a line of its box,
//   its crop's offset and its index.  A call sends only the selector.
//
// What bounds it: bytes, 174 MB a batch of 8 x 3300x2550 (the global
//   mask read and the output written once, the selected crops read
//   once), 0.052 ms at 3.35 TB/s.  The first form moved ~0.8 GB:
//   an int32 owner map of every pixel, zeroed, scattered into with
//   atomicMax over every selected box, and read back by a pass of one
//   byte a thread; byte-wide access alone sets a ~0.24 ms floor on this
//   card (PERF.md, section 6).
//
// Design: one launch, no scratch, no atomics.  A CTA owns a tile of
//   TILE_ROWS rows x 32 16-byte chunks of a page (512 columns; a warp
//   covers a row's 512 bytes, so every mask load and output store is a
//   coalesced 16-byte access), chunks aligned to the page buffer, so a
//   row's ragged ends are the only byte-wide accesses.  The tile first
//   lists the selected lines of its page that meet it, in document order
//   (a ballot per warp and a prefix over the warps keep the order), then
//   every thread overwrites its own chunks' bytes in registers line by
//   line, so the last selected line wins with no barrier between lines.
//   A chunk a box covers whole takes its 16 crop bytes
//   (a ragged row at any alignment) as five aligned words shifted into
//   place, a chunk at a box's edge byte by byte; each crop byte is read
//   about once.  A tile no box meets is a vector copy of the mask.  32 rows keep a 3300-row page at 104 x 6 = 624 tiles
//   (~38 CTAs an SM for a batch of 8) while a tile meets only the one or
//   two text lines that cross its rows.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_ROWS 32
#define TILE_CHUNKS 32           // 16-byte chunks of a tile row
#define THREADS 256
#define ROWS_A_THREAD (TILE_ROWS / (THREADS / TILE_CHUNKS))
#define LIST 256                 // lines listed a round

namespace {

struct Hit {
  int t, b, l, r, sel2;
  long long off;
};

// bytes of a 16-byte chunk as 0/1 (any non-zero byte -> 1)
__device__ __forceinline__ uint32_t nonzero(uint32_t x) {
  return (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) >> 7 & 0x01010101u;
}

// plan: int32 B + 1 page starts (padded to a multiple of 4), then a
// record of 8 int32 a line, (t, b, l, r, off low, off high, line index,
// 0); sel: the selector of each line in document order
__global__ void __launch_bounds__(THREADS)
paste_kernel(const uint8_t* __restrict__ crops_t,
             const uint8_t* __restrict__ crops_i,
             const int* __restrict__ plan, const int* __restrict__ sel,
             const uint8_t* __restrict__ gmask, uint8_t* __restrict__ out,
             int B, int H, int W) {
  __shared__ Hit hits[LIST];
  __shared__ int wcount[THREADS / 32];
  const int p = blockIdx.z;
  const int y0 = blockIdx.y * TILE_ROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunk = blockIdx.x * TILE_CHUNKS + lane;
  // the tile's columns, widened by a chunk for the rows' alignment
  const int xa = blockIdx.x * TILE_CHUNKS * 16 - 16;
  const int xb = xa + TILE_CHUNKS * 16 + 16;
  const int y1 = min(y0 + TILE_ROWS, H);
  const int first = plan[p], last = plan[p + 1];

  // this thread's chunks: rows y0 + warp + 8 k, columns [cx, cx + 16)
  uint32_t v[ROWS_A_THREAD][4];
  int cx[ROWS_A_THREAD];
  bool full[ROWS_A_THREAD];
#pragma unroll
  for (int k = 0; k < ROWS_A_THREAD; ++k) {
    const int y = y0 + warp + 8 * k;
    v[k][0] = v[k][1] = v[k][2] = v[k][3] = 0u;
    cx[k] = 0;
    full[k] = false;
    if (y >= H) continue;
    const size_t row = ((size_t)p * H + y) * W;
    const int s = (int)((uintptr_t)(gmask + row) & 15);
    cx[k] = 16 * chunk - s;
    full[k] = cx[k] >= 0 && cx[k] + 16 <= W;
  }

  const int4* recs = (const int4*)(plan + ((B + 4) & ~3));
  for (int base = first; base < last; base += LIST) {
    // list the selected lines of this round that meet the tile, in order
    const int j = base + threadIdx.x;
    bool hit = false;
    int4 e0 = make_int4(0, 0, 0, 0), e1 = e0;
    int pick = 0;                        // the line's selector
    if (j < last) {
      e0 = recs[2 * j];
      e1 = recs[2 * j + 1];
      pick = sel[e1.z];
      hit = pick != 0 && e0.x < y1 && e0.y > y0 && e0.z < xb && e0.w > xa;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) wcount[warp] = __popc(ball);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      before += w < warp ? wcount[w] : 0;
      total += wcount[w];
    }
    if (hit) {
      Hit& h = hits[before + __popc(ball & ((1u << lane) - 1u))];
      h.t = e0.x;
      h.b = e0.y;
      h.l = e0.z;
      h.r = e0.w;
      h.off = (long long)(((unsigned long long)(unsigned)e1.y << 32)
                          | (unsigned)e1.x);
      h.sel2 = pick == 2;
    }
    __syncthreads();
    // paste them in that order; each thread writes only its own chunks
    for (int q = 0; q < total; ++q) {
      const Hit h = hits[q];
      const uint8_t* src = h.sel2 ? crops_i : crops_t;
      const int wl = h.r - h.l;
      const long long size = (long long)(h.b - h.t) * wl;
#pragma unroll
      for (int k = 0; k < ROWS_A_THREAD; ++k) {
        const int y = y0 + warp + 8 * k;
        if (y < h.t || y >= h.b || y >= H) continue;
        const int lo = max(h.l - cx[k], 0), hi = min(h.r - cx[k], 16);
        if (lo >= hi) continue;
        // the crop's byte of column x = cx + c is at rel + c
        const long long rel = (long long)(y - h.t) * wl + (cx[k] - h.l);
        const uint8_t* s = src + h.off + rel;
        if (lo == 0 && hi == 16 && rel + 20 <= size) {
          // the whole chunk: five aligned words (all inside the crop),
          // shifted into place
          const uintptr_t a = (uintptr_t)s;
          const uint32_t* w = (const uint32_t*)(a & ~(uintptr_t)3);
          const int sh = 8 * (int)(a & 3);
          const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3],
                         w4 = w[4];
          v[k][0] = __funnelshift_r(w0, w1, sh);
          v[k][1] = __funnelshift_r(w1, w2, sh);
          v[k][2] = __funnelshift_r(w2, w3, sh);
          v[k][3] = __funnelshift_r(w3, w4, sh);
        } else {
#pragma unroll
          for (int c = 0; c < 16; ++c) {
            if (c >= lo && c < hi) {
              const int b8 = 8 * (c & 3);
              v[k][c >> 2] = (v[k][c >> 2] & ~(0xFFu << b8))
                             | ((uint32_t)s[c] << b8);
            }
          }
        }
      }
    }
    __syncthreads();   // hits and wcount are rewritten by the next round
  }

  // OR the global mask in: 16-byte accesses, bytes at a row's ragged ends
#pragma unroll
  for (int k = 0; k < ROWS_A_THREAD; ++k) {
    const int y = y0 + warp + 8 * k;
    if (y >= H || cx[k] + 16 <= 0 || cx[k] >= W) continue;
    const size_t row = ((size_t)p * H + y) * W;
    const uint8_t* gm = gmask + row + cx[k];
    uint8_t* o = out + row + cx[k];
    if (full[k]) {
      const uint4 g = *(const uint4*)gm;
      *(uint4*)o = make_uint4(nonzero(v[k][0] | g.x), nonzero(v[k][1] | g.y),
                              nonzero(v[k][2] | g.z), nonzero(v[k][3] | g.w));
    } else {
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int x = cx[k] + c;
        if (x >= 0 && x < W)
          o[c] = ((v[k][c >> 2] >> (8 * (c & 3))) & 0xFFu) | gm[c] ? 1 : 0;
      }
    }
  }
}

}  // namespace

// plan: int32, B + 1 page starts, then a record of 8 int32 a line
// (ops/paste_cuda.paste_plan); sel: int32, a selector a line.  plan,
// gmask and out must be 16-byte aligned (every CUDA allocation is).
extern "C" int apt_paste(const void* crops_t, const void* crops_i,
                         const void* plan, const void* sel,
                         const void* gmask, void* out, int B, int H, int W,
                         void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if (((uintptr_t)gmask | (uintptr_t)out | (uintptr_t)plan) & 15)
    return (int)cudaErrorMisalignedAddress;
  // chunks a row: the row's alignment in its first chunk, plus W bytes
  const int chunks = (15 + W + 15) / 16;
  const dim3 grid((chunks + TILE_CHUNKS - 1) / TILE_CHUNKS,
                  (H + TILE_ROWS - 1) / TILE_ROWS, B);
  paste_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)crops_t, (const uint8_t*)crops_i, (const int*)plan,
      (const int*)sel, (const uint8_t*)gmask, (uint8_t*)out, B, H, W);
  return (int)cudaGetLastError();
}
