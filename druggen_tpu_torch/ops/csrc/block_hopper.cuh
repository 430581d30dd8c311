// Hopper building blocks of the bf16 megablock kernels K7 (fused_block.cu)
// and K8 (fused_block_bwd.cu): the slab-tile plan, the three-piece bf16
// split that makes an f32 operand exact on the tensor cores, column
// reductions over a tile's keys, and the staged square weights.  It builds
// on tail_hopper.cuh (wgmma, TMA, mbarriers, swizzled panels, the
// accumulator layout and the LayerNorm row helpers).
//
// The plan (its geometry mirrored by ops/fused_block.py::launch_plan, which
// the CPU tests check; the shared memory below is exported to Python, not
// recomputed there):
//   - One warpgroup a block, one block an SM (persistent, a contiguous run
//     of slabs each).  A slab is the N key rows (b, i, :) of one query atom;
//     a warpgroup owns one slab at a time as one 64-row tile (rows j < N
//     valid, the rest masked), so the per-channel softmax over the keys,
//     node_agg and dq reduce inside the tile.  N at most 64 (at the published N 45, 19 of
//     the tile's 64 rows are padding: 1.42x the products' work).
//   - C = 128 (the width the tile's C-wide accumulator and the shared
//     memory below hold); H any multiple of 128 (K8's wgrad tiles).  Other
//     widths, and N > 64, take the libraries' CUDA-core route
//     (ops/fused_block.py routes).
//   - We^T and Woe^T are staged once a block (2 x 32 KB): one copy serves
//     e = y We and t Woe (K-major B) and the backward's de We^T and dtt
//     Woe^T (the same bytes MN-major, wgmma's transpose bit).  W1^T and W2^T
//     stream chunk by chunk (64 hidden) through a TMA ring from L2, as K1's.
//   - P: three bf16 tiles (48 KB), the A operand of a product whose left
//     side is f32: x = p0 + p1 + p2 exactly (split3), so x W runs as three
//     bf16 wgmma passes into one f32 accumulator, every product term exact
//     (W is bf16-exact: the stream-type-rounded weight).  The same three
//     tiles give back the f32 x bit for bit (load_exact).
//
// Shared memory, bytes from the 1,024-aligned base, C 128:
//   K7:        We^T 32,768 | Woe^T 32,768 | y tile 16,384 | P 49,152 |
//              column reductions 6,144 | ring RING x 32,768 | mbarriers
//                                                      (RING 2: 203,800 B)
//   K8's rows launches (one layout; each uses what it needs):
//              We^T | Woe^T | y tile | P | S, a 64 x 64 f32 staging tile
//              16,384 | column reductions 6,144 | ring | mbarriers
//                                                      (RING 2: 220,184 B)
// Every f32 row that K8 writes or reads back goes through S: the
// accumulator layout's pairs into S (an XOR swizzle of its 16-byte chunks
// keeps the stores at two wavefronts), then 16-byte loads and stores of
// whole rows, 512 contiguous bytes a warp instruction.

#pragma once

#include "tail_hopper.cuh"

#define BLOCK_HOPPER (KERNEL_C == 128 && KERNEL_H % 128 == 0)

namespace {
namespace blk {
using namespace hop;

constexpr int NT = 128;                          // threads a block: one warpgroup
constexpr int MAX_N = BM;                        // keys a slab: one 64-row tile
constexpr size_t SQ_BYTES = size_t(CP) * CP * 2; // a staged C x C weight
constexpr size_t PIECES = 3 * TILE_BYTES;        // the three bf16 pieces of an f32 tile

// Ring stages that fit beside `fixed` bytes (one warpgroup a block).
constexpr int ring_fit(size_t fixed) {
  const size_t n = (SMEM_MAX - ALIGN_SLACK - 256 - fixed) / CHUNK_BYTES;
  return n > 4 ? 4 : int(n);
}

constexpr size_t RED_BYTES = align1k(12 * size_t(CP) * 4);  // column reductions: scratch, results
constexpr size_t STAGE_BYTES = size_t(BM) * 64 * 4;        // f32 row staging: 64 x 64

// K7's layout.
namespace fwd {
constexpr size_t OFF_WE = 0, OFF_WOE = SQ_BYTES, OFF_Y = 2 * SQ_BYTES, OFF_P = OFF_Y + TILE_BYTES,
                 OFF_RED = OFF_P + PIECES, OFF_RING = OFF_RED + RED_BYTES;
constexpr int RING = ring_fit(OFF_RING);
constexpr size_t OFF_BAR = OFF_RING + size_t(RING) * CHUNK_BYTES;
constexpr size_t SMEM = OFF_BAR + size_t(1 + RING) * 8 + ALIGN_SLACK;
}  // namespace fwd

// K8 rows pass's layout.
namespace rows {
constexpr size_t OFF_WE = 0, OFF_WOE = SQ_BYTES, OFF_Y = 2 * SQ_BYTES, OFF_P = OFF_Y + TILE_BYTES,
                 OFF_S = OFF_P + PIECES, OFF_RED = OFF_S + STAGE_BYTES,
                 OFF_RING = OFF_RED + RED_BYTES;
constexpr int RING = ring_fit(OFF_RING);
constexpr size_t OFF_BAR = OFF_RING + size_t(RING) * CHUNK_BYTES;
constexpr size_t SMEM = OFF_BAR + size_t(1 + RING) * 8 + ALIGN_SLACK;
}  // namespace rows

#if BLOCK_HOPPER
static_assert(C == NT && CP == C && HP == H, "the Hopper route is built for C 128");
static_assert(fwd::RING >= 2 && rows::RING >= 2, "no room for the weight ring");
static_assert(fwd::SMEM <= SMEM_MAX && rows::SMEM <= SMEM_MAX, "shared memory over the limit");
#endif

// ---------------------------------------------------------------------------
// The three-piece split
// ---------------------------------------------------------------------------
// x = a + (b + c) with a, b, c bf16 values: a = bf16(x), b = bf16(x - a),
// c = x - a - b (both differences exact in f32).  c has at most 8
// significant bits, so it is exact in bf16 while it is not below bf16's
// normal range: the split is exact for 2^-110 <= |x| < 2^128 (1 - 2^-9)
// and for 0; below, c loses the bits under 2^-133; from 2^128 (1 - 2^-9) on,
// bf16(x) rounds past bf16's largest value and a is infinite.
__device__ __forceinline__ void split3(float x, float& a, float& b, float& c) {
  a = __bfloat162float(__float2bfloat16_rn(x));
  const float r = __fsub_rn(x, a);
  b = __bfloat162float(__float2bfloat16_rn(r));
  c = __fsub_rn(r, b);
}

// A C-wide f32 tile in the accumulator layout (v[4 j + 2 half + e]) as its
// three pieces in P (each a C-wide bf16 tile of KP panels).
__device__ __forceinline__ void store_pieces(uint8_t* P, const float (&v)[4 * JC], const Lane& ln) {
#pragma unroll
  for (int j = 0; j < JC; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float a0, b0, c0, a1, b1, c1;
      split3(v[4 * j + 2 * half], a0, b0, c0);
      split3(v[4 * j + 2 * half + 1], a1, b1, c1);
      const uint32_t off = tile_off(ln.row(half), j, ln.q);
      *reinterpret_cast<uint32_t*>(P + off) = pack_bf16(a0, a1);
      *reinterpret_cast<uint32_t*>(P + TILE_BYTES + off) = pack_bf16(b0, b1);
      *reinterpret_cast<uint32_t*>(P + 2 * TILE_BYTES + off) = pack_bf16(c0, c1);
    }
}

// The f32 pair at (r, 8 j + 2 q) back from its pieces, bit for bit.
__device__ __forceinline__ float2 load_exact(const uint8_t* P, uint32_t off) {
  const float2 a = unpack_bf16(*reinterpret_cast<const uint32_t*>(P + off));
  const float2 b = unpack_bf16(*reinterpret_cast<const uint32_t*>(P + TILE_BYTES + off));
  const float2 c = unpack_bf16(*reinterpret_cast<const uint32_t*>(P + 2 * TILE_BYTES + off));
  return make_float2(__fadd_rn(a.x, __fadd_rn(b.x, c.x)), __fadd_rn(a.y, __fadd_rn(b.y, c.y)));
}

// A 64-column chunk accumulator (32 values) as the three pieces' A registers
// of its four k-steps (to_a_regs' layout).
__device__ __forceinline__ void split_regs(const float (&v)[32], uint32_t (&a)[3][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float a0, b0, c0, a1, b1, c1;
      split3(v[8 * kk + 2 * i], a0, b0, c0);
      split3(v[8 * kk + 2 * i + 1], a1, b1, c1);
      a[0][kk][i] = pack_bf16(a0, a1);
      a[1][kk][i] = pack_bf16(b0, b1);
      a[2][kk][i] = pack_bf16(c0, c1);
    }
}

// ---------------------------------------------------------------------------
// Products
// ---------------------------------------------------------------------------
// B operands of a staged C x C weight W^T [C rows n][C columns k] (KP
// panels of [C rows][128 B]): K-major for x W (k-step kk), MN-major for
// x W^T.
__device__ __forceinline__ uint64_t b_sq(const uint8_t* ws, int kk) {
  return desc(ws + size_t(kk >> 2) * (CP * 128) + (kk & 3) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t b_sqt(const uint8_t* ws, int kk) {
  return desc(ws + kk * 2048, CP * 128, 1024);
}

template <typename T>
__device__ __forceinline__ void zero(T& acc) {
#pragma unroll
  for (int i = 0; i < int(sizeof(acc) / sizeof(acc[0])); ++i) acc[i] = 0.0f;
}

// acc = x W (TB 0) or x W^T (TB 1) for an f32 x held as three pieces in P
// and a staged square weight: 3 x C / 16 wgmma, the smallest piece first.
template <int TB>
__device__ __forceinline__ void mma_pieces_sq(float (&acc)[4 * JC], const uint8_t* P,
                                              const uint8_t* ws) {
  zero(acc);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int piece = 2; piece >= 0; --piece)
#pragma unroll
    for (int kk = 0; kk < CP / 16; ++kk)
      Mma<CP>::ss<0, TB>(acc, a_tile(P + piece * TILE_BYTES, kk), TB ? b_sqt(ws, kk) : b_sq(ws, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// acc = y W for a bf16 tile y (one pass).
__device__ __forceinline__ void mma_tile_sq(float (&acc)[4 * JC], const uint8_t* y,
                                            const uint8_t* ws) {
  zero(acc);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < CP / 16; ++kk) Mma<CP>::ss<0, 0>(acc, a_tile(y, kk), b_sq(ws, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// ---------------------------------------------------------------------------
// Column reductions over a tile's rows
// ---------------------------------------------------------------------------
// warp_col_scatter_of (tail_hopper.cuh) with max or sum: each lane keeps
// J / 8 column pairs of the warp's 16 rows, in a fixed order.
template <int J, bool kMax, typename F>
__device__ __forceinline__ void warp_scatter(F&& f, float (&u)[J / 2][2]) {
  static_assert(J % 8 == 0, "eight row groups");
  const int lane = threadIdx.x & 31;
  {
    const bool hi = (lane & 16) != 0;
#pragma unroll
    for (int i = 0; i < J / 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float lo_v = f(i, e), hi_v = f(i + J / 2, e);
        const float send = hi ? lo_v : hi_v;
        const float keep = hi ? hi_v : lo_v;
        const float got = __shfl_xor_sync(0xffffffffu, send, 16);
        u[i][e] = kMax ? fmaxf(keep, got) : keep + got;
      }
  }
#pragma unroll
  for (int lvl = 1; lvl < 3; ++lvl) {
    const int mask = 16 >> lvl;
    const int half = J >> (lvl + 1);
    const bool hi = (lane & mask) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float send = hi ? u[i][e] : u[i + half][e];
        const float keep = hi ? u[i + half][e] : u[i][e];
        const float got = __shfl_xor_sync(0xffffffffu, send, mask);
        u[i][e] = kMax ? fmaxf(keep, got) : keep + got;
      }
  }
}

// out[c] = max or sum over the tile's 64 rows of f(j, e, half) (the value at
// row ln.row(half), column 8 j + 2 q + e; the caller masks the rows past N
// with -inf or 0), and for a sum 1 / out[c] at out[C + c].  red: 4 x C
// floats of scratch.  Ends with every thread
// past a barrier after out is written; fixed order throughout.
template <bool kMax, typename F>
__device__ __forceinline__ void col_reduce(F&& f, float* red, float* out, const Lane& ln) {
  float u[JC / 2][2];
  warp_scatter<JC, kMax>(
      [&](int j, int e) {
        const float a = f(j, e, 0), b = f(j, e, 1);
        return kMax ? fmaxf(a, b) : a + b;
      },
      u);
#pragma unroll
  for (int i = 0; i < JC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) red[ln.warp * C + 8 * scattered_j<JC>(i) + 2 * ln.q + e] = u[i][e];
  __syncthreads();
  {
    const int c = threadIdx.x;  // NT == C
    float a = red[c];
#pragma unroll
    for (int w = 1; w < 4; ++w) a = kMax ? fmaxf(a, red[w * C + c]) : a + red[w * C + c];
    out[c] = a;
    if (!kMax) out[C + c] = 1.0f / a;
  }
  __syncthreads();
}

// ex = exp(t - m_c) in place of t, and 0 on the rows past n (t is finite
// there: 0), without a branch around the exponential.
__device__ __forceinline__ void softmax_ex(float (&acc)[4 * JC], const float* st_m, int n,
                                           const Lane& ln) {
#pragma unroll
  for (int j = 0; j < JC; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * half + e;
        const float x = expf(acc[i] - st_m[ln.col(j, e)]);
        acc[i] = ln.row(half) < n ? x : 0.0f;
      }
}

// This block's run of slabs: contiguous, so that its rows of each
// edge-sized tensor share pages and cache lines.
struct SlabRange {
  long long begin, end;
  __device__ __forceinline__ explicit SlabRange(long long slabs)
      : begin(slabs * blockIdx.x / gridDim.x), end(slabs * (blockIdx.x + 1) / gridDim.x) {}
};

// ---------------------------------------------------------------------------
// Loads and stores
// ---------------------------------------------------------------------------
// W^T [C][C] bf16 into KP panels of [C rows][128 B] (16-byte copies).
__device__ __forceinline__ void stage_square(uint8_t* dst, const __nv_bfloat16* __restrict__ src) {
  for (int i = threadIdx.x; i < CP * (CP / 8); i += NT) {
    const int r = i / (CP / 8), c = (i % (CP / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + size_t(c >> 6) * (CP * 128) + sw_off(r, c & 63)) =
        *reinterpret_cast<const uint4*>(src + size_t(r) * CP + c);
  }
}

// The 64 rows from flat row `row0` of a [rows][C] bf16 map into a tile
// buffer (zeros past the end of the rows).
__device__ __forceinline__ void load_slab(uint8_t* buf, const CUtensorMap* map, uint64_t* bar,
                                          long long row0) {
  mbar_expect_tx(bar, uint32_t(TILE_BYTES));
#pragma unroll
  for (int p = 0; p < KP; ++p) tma_load(buf + size_t(p) * (BM * 128), map, bar, 64 * p, int(row0));
}

// After chunk nc of a ring of `stages` is consumed: every thread past a
// barrier, thread 0 brings chunk nc + stages into its stage.
__device__ __forceinline__ void refill_ring(uint8_t* ring, uint64_t* ring_full, int stages,
                                            long long nc, long long chunks, const CUtensorMap* w1,
                                            const CUtensorMap* w2) {
  __syncthreads();
  if (threadIdx.x == 0 && nc + stages < chunks)
    load_chunk(ring + size_t(nc % stages) * CHUNK_BYTES, ring_full + nc % stages, w1, w2,
               int((nc + stages) % NJ));
}

// The bf16 pair at (row, column c) of a [*, C] tensor, as floats.
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  return unpack_bf16(__ldg(reinterpret_cast<const unsigned int*>(p)));
}

// The tile element pair (row ln.row(half), columns ln.col(j)) of a bf16
// tile buffer.
__device__ __forceinline__ float2 tile_pair(const uint8_t* buf, const Lane& ln, int j, int half) {
  return unpack_bf16(*reinterpret_cast<const uint32_t*>(buf + tile_off(ln.row(half), j, ln.q)));
}

// The staging tile S: f32 [64 rows][64 columns], 16-byte chunk ch of row r
// at chunk ch ^ 2 (r & 7).
__device__ __forceinline__ int s_off(int r, int c) {
  return r * 64 + ((((c >> 2) ^ ((r & 7) << 1))) << 2) + (c & 3);
}

// The NV / 32 64-column slices of an accumulator-layout tile (v[4 j + 2
// half + e], columns 8 j + 2 q + e) to rows row0 + r, r < n, of a [*, ld]
// f32 tensor from column col0, through S.  Every thread of the block calls
// it; it starts and ends with S free.
template <int NV>
__device__ __forceinline__ void store_rows_s(float* S, float* dst, long long ld, int col0,
                                             long long row0, int n, const float (&v)[NV],
                                             const Lane& ln) {
#pragma unroll
  for (int sl = 0; sl < NV / 32; ++sl) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * (8 * sl + j) + 2 * half;
        *reinterpret_cast<float2*>(S + s_off(ln.row(half), ln.col(j))) = make_float2(v[i], v[i + 1]);
      }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BM * 16 / NT; ++k) {
      const int idx = threadIdx.x + k * NT, r = idx >> 4, ch = idx & 15;
      if (r < n)
        *reinterpret_cast<float4*>(dst + (row0 + r) * ld + col0 + 64 * sl + 4 * ch) =
            *reinterpret_cast<const float4*>(S + s_off(r, 4 * ch));
    }
    __syncthreads();
  }
}
// ... and back into the accumulator layout (zeros on the rows past n); the
// loads of a slice are all issued before the first is used.
template <int NV>
__device__ __forceinline__ void load_rows_s(float* S, const float* src, long long ld, int col0,
                                            long long row0, int n, float (&v)[NV],
                                            const Lane& ln) {
  constexpr int PER = BM * 16 / NT;  // 16-byte chunks a thread
#pragma unroll
  for (int sl = 0; sl < NV / 32; ++sl) {
    float4 x[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int idx = threadIdx.x + k * NT, r = idx >> 4, ch = idx & 15;
      x[k] = r < n ? __ldg(reinterpret_cast<const float4*>(src + (row0 + r) * ld + col0 + 64 * sl + 4 * ch))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int idx = threadIdx.x + k * NT, r = idx >> 4, ch = idx & 15;
      *reinterpret_cast<float4*>(S + s_off(r, 4 * ch)) = x[k];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * (8 * sl + j) + 2 * half;
        const float2 y = *reinterpret_cast<const float2*>(S + s_off(ln.row(half), ln.col(j)));
        v[i] = y.x;
        v[i + 1] = y.y;
      }
    __syncthreads();
  }
}

// The bf16 pairs of a [*, C] tensor at the rows r < n of the tile (row0 +
// r) and the thread's columns, as an accumulator-layout f32 tile (zeros on
// the rows past n).
__device__ __forceinline__ void load_pairs(const __nv_bfloat16* __restrict__ src, long long row0,
                                           int n, float (&v)[4 * JC], const Lane& ln) {
#pragma unroll
  for (int j = 0; j < JC; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = ln.row(half);
      const float2 x = r < n ? ld_pair(src + (row0 + r) * C + ln.col(j)) : make_float2(0.0f, 0.0f);
      v[4 * j + 2 * half] = x.x;
      v[4 * j + 2 * half + 1] = x.y;
    }
}

// A C-wide accumulator-layout tile rounded to bf16 and stored to rows row0 +
// r (r < n) of a [*, C] bf16 tensor, 16 bytes a store.
__device__ __forceinline__ void store_bf16_rows(__nv_bfloat16* dst, long long row0, int n,
                                                const float (&v)[4 * JC], const Lane& ln) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t o[JC];
#pragma unroll
    for (int j = 0; j < JC; ++j) o[j] = pack_bf16(v[4 * j + 2 * half], v[4 * j + 2 * half + 1]);
    uint4 og[JC / 4];
    quad_transpose(o, og);
    const int r = ln.row(half);
    if (r < n) {
#pragma unroll
      for (int g = 0; g < JC / 4; ++g)
        *reinterpret_cast<uint4*>(dst + (row0 + r) * C + 8 * (4 * g + ln.q)) = og[g];
    }
  }
}

// t = ((q_i k_j) inv (e + 1)) e in place of acc = y We (+ be), zero on the
// rows past n (k_j read as 0 there): the Pallas kernels' order of
// operations.
__device__ __forceinline__ void attn_t(float (&acc)[4 * JC], const __nv_bfloat16* __restrict__ qi,
                                       const __nv_bfloat16* __restrict__ kb,
                                       const float* __restrict__ be, int n, float inv,
                                       const Lane& ln) {
#pragma unroll
  for (int j = 0; j < JC; ++j) {
    const int c = ln.col(j);
    const float2 qv = ld_pair(qi + c);
    const float2 bv = *reinterpret_cast<const float2*>(be + c);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = ln.row(half);
      const float2 kv = r < n ? ld_pair(kb + size_t(r) * C + c) : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ev = acc[4 * j + 2 * half + e] + (e ? bv.y : bv.x);
        const float p = ((e ? qv.y : qv.x) * (e ? kv.y : kv.x)) * inv;
        acc[4 * j + 2 * half + e] = (p * (ev + 1.0f)) * ev;
      }
    }
  }
}

}  // namespace blk
}  // namespace
