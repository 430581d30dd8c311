// Hopper building blocks of the bf16 edge-attention kernels K5
// (fused_attention.cu) and K6 (fused_attention_bwd.cu) at D = 128, N <= 64:
// the staged three-piece weights, products whose f32 operand is split into
// bf16 pieces in registers, and the shared-memory layout of their slab
// launches.  It builds on block_hopper.cuh (the slab plan, split3, the
// column reductions, the row loads and stores) and tail_hopper.cuh (wgmma,
// TMA, mbarriers, swizzled panels, the accumulator layout).
//
// Unlike the megablock, whose square weights are the stream-rounded
// (bf16-exact) values, K5/K6 multiply by the raw f32 parameters We and Woe
// (the Pallas kernels' rounding points).  So each weight is staged as its
// three bf16 pieces, W = W0 + W1 + W2 exactly (split3): a bf16-exact left
// operand (eraw, ge) times W is three passes, every product term exact; an
// f32 left operand x (t, de), itself as three pieces x0 + x1 + x2 in
// registers, times W is the six significant piece products x0 W0, x0 W1,
// x1 W0, x0 W2, x1 W1, x2 W0 (the three left out, x1 W2, x2 W1, x2 W2, are
// below 2^-23 of |x| |W| together).  Both weights' pieces (6 x 32 KB) are
// staged once a block, so a left operand's pieces live in registers (the A
// operand of `wgmma` from registers), not in shared memory: 48 KB of pieces
// beside 192 KB of weights would not fit.
//
// The plan (mirrored by ops/fused_attention.py::launch_plan; the shared
// memory is exported by the libraries, not recomputed in Python):
//   - K5 and K6's rows pass: one block an SM (persistent, a contiguous run
//     of slabs each, blk::SlabRange), two warpgroups a block taking the
//     block's slabs in turn (warpgroup w the slabs begin + w, begin + w +
//     2, ...), so one warpgroup's products overlap the other's softmax,
//     loads and stores.  A slab is the N key rows (b, i, :) of one query
//     atom, one 64-row tile (rows j < N valid, the rest masked), its eraw
//     rows brought by TMA into the warpgroup's own tile.  The warpgroup's
//     column reductions use its tile once the e product has read it; the
//     tile's next slab is asked for after them.  (So K6 takes its softmax
//     statistics from a launch of their own: its only reduction, dq,
//     follows the e product.)
//   - Shared memory, bytes from the 1,024-aligned base:
//       We^T pieces 3 x 32,768 | Woe^T pieces 3 x 32,768 | 2 eraw tiles
//       2 x 16,384 | 2 mbarriers                     (230,416 B with the slack)
//     Each piece is staged as W^T [C rows n][C columns k] in KP panels
//     (block_hopper.cuh's stage_square layout): K-major it is the B operand
//     of x W, MN-major (the transpose bit) of x W^T.

#pragma once

#include "block_hopper.cuh"

#define ATTN_HOPPER (KERNEL_C == 128)

namespace {
namespace ahop {
using namespace blk;

constexpr int WARPGROUPS = 2;                       // warpgroups a block
constexpr size_t OFF_WE = 0;                        // We^T pieces, 3 x SQ_BYTES
constexpr size_t OFF_WOE = 3 * SQ_BYTES;            // Woe^T pieces
constexpr size_t OFF_TILE = 6 * SQ_BYTES;           // a slab's eraw rows (bf16) a warpgroup
constexpr size_t OFF_BAR = OFF_TILE + WARPGROUPS * TILE_BYTES;  // an mbarrier a warpgroup
constexpr size_t SMEM = OFF_BAR + WARPGROUPS * 8 + ALIGN_SLACK;

#if ATTN_HOPPER
static_assert(C == NT && CP == C && JC == 16, "the Hopper route is built for D 128");
static_assert(SMEM <= SMEM_MAX, "shared memory over the limit");
static_assert(8 * C * 4 <= TILE_BYTES, "the column reductions fit a tile");
#endif

// A warpgroup's place in a two-warpgroup block: its tile and mbarrier, its
// named barrier, its thread's place in its tiles, and its column-reduction
// region (scratch [4][C], then the results), which is its tile once the e
// product has read it.
struct Warpgroup {
  int wg;
  int bar;           // named barrier (0 is __syncthreads)
  Lane ln;
  uint8_t* tile;
  uint64_t* full;
  float* red;
  __device__ __forceinline__ explicit Warpgroup(uint8_t* smem)
      : wg(threadIdx.x / NT), bar(1 + threadIdx.x / NT), ln(threadIdx.x % NT),
        tile(smem + OFF_TILE + size_t(threadIdx.x / NT) * TILE_BYTES),
        full(reinterpret_cast<uint64_t*>(smem + OFF_BAR) + threadIdx.x / NT),
        red(reinterpret_cast<float*>(smem + OFF_TILE + size_t(threadIdx.x / NT) * TILE_BYTES)) {}
  __device__ __forceinline__ bool leader() const { return ln.t == 0; }
};

// The left operand's pieces as A registers: [piece][k-step][4].
using Pieces = uint32_t[3][CP / 16][4];

// The three bf16 pieces of W^T for an f32 W [C in k][C out n] (row-major,
// x @ W), staged at dst (piece p at dst + p SQ_BYTES).  Every thread of the
// block; the reads are coalesced along n.
__device__ __forceinline__ void stage_pieces(uint8_t* dst, const float* __restrict__ w) {
  for (int i = threadIdx.x; i < C * (C / 8); i += blockDim.x) {
    const int n = i % C, k0 = (i / C) * 8;
    uint32_t pa[4], pb[4], pc[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float a0, b0, c0, a1, b1, c1;
      split3(__ldg(w + size_t(k0 + 2 * e) * C + n), a0, b0, c0);
      split3(__ldg(w + size_t(k0 + 2 * e + 1) * C + n), a1, b1, c1);
      pa[e] = pack_bf16(a0, a1);
      pb[e] = pack_bf16(b0, b1);
      pc[e] = pack_bf16(c0, c1);
    }
    const size_t off = size_t(k0 >> 6) * (CP * 128) + sw_off(n, k0 & 63);
    *reinterpret_cast<uint4*>(dst + off) = make_uint4(pa[0], pa[1], pa[2], pa[3]);
    *reinterpret_cast<uint4*>(dst + SQ_BYTES + off) = make_uint4(pb[0], pb[1], pb[2], pb[3]);
    *reinterpret_cast<uint4*>(dst + 2 * SQ_BYTES + off) = make_uint4(pc[0], pc[1], pc[2], pc[3]);
  }
}

// block_hopper.cuh's col_reduce for one warpgroup of several: out[c] =
// max or sum over the tile's 64 rows of f(j, e, half), and for a sum 1 /
// out[c] at out[C + c]; red: 4 x C floats of scratch; named barrier `bar`
// (the warpgroup's own).  Ends with the warpgroup past a barrier after out
// is written; fixed order throughout.
template <bool kMax, typename F>
__device__ __forceinline__ void wg_col_reduce(F&& f, float* red, float* out, const Lane& ln,
                                              int bar) {
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
  wg_sync(bar);
  {
    const int c = ln.t;
    float a = red[c];
#pragma unroll
    for (int w = 1; w < 4; ++w) a = kMax ? fmaxf(a, red[w * C + c]) : a + red[w * C + c];
    out[c] = a;
    if (!kMax) out[C + c] = 1.0f / a;
  }
  wg_sync(bar);
}

// A C-wide accumulator-layout f32 tile as its three pieces' A registers
// (to_a_regs' layout, k-step kk = columns 16 kk .. 16 kk + 15).
__device__ __forceinline__ void split_acc(const float (&v)[4 * JC], Pieces& a) {
#pragma unroll
  for (int kk = 0; kk < CP / 16; ++kk)
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

// acc = y W (TB 0) or y W^T (TB 1) for a bf16 tile y in shared memory and
// the three staged pieces of W: 3 x C / 16 wgmma, the smallest piece first.
template <int TB>
__device__ __forceinline__ void mma_tile_w3(float (&acc)[4 * JC], const uint8_t* y,
                                            const uint8_t* wp) {
  zero(acc);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int piece = 2; piece >= 0; --piece)
#pragma unroll
    for (int kk = 0; kk < CP / 16; ++kk) {
      const uint8_t* ws = wp + piece * SQ_BYTES;
      Mma<CP>::ss<0, TB>(acc, a_tile(y, kk), TB ? b_sqt(ws, kk) : b_sq(ws, kk));
    }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// acc = g W (TB 0) or g W^T (TB 1) for a bf16-exact g held as one piece of
// A registers: three passes over W's pieces, the smallest first.
template <int TB>
__device__ __forceinline__ void mma_regs_w3(float (&acc)[4 * JC], const uint32_t (&g)[CP / 16][4],
                                            const uint8_t* wp) {
  zero(acc);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int piece = 2; piece >= 0; --piece)
#pragma unroll
    for (int kk = 0; kk < CP / 16; ++kk) {
      const uint8_t* ws = wp + piece * SQ_BYTES;
      Mma<CP>::rs<TB>(acc, g[kk], TB ? b_sqt(ws, kk) : b_sq(ws, kk));
    }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// acc = x W (TB 0) or x W^T (TB 1) for an f32 x held as three pieces of A
// registers: the six significant piece products (x piece, W piece), the
// smallest first: (2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0).
template <int TB>
__device__ __forceinline__ void mma_pieces_w6(float (&acc)[4 * JC], const Pieces& x,
                                              const uint8_t* wp) {
  zero(acc);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int pi = 0; pi < 6; ++pi) {
    const int pa = pi == 0 ? 2 : pi == 1 || pi == 3 ? 1 : 0;
    const int pb = pi == 2 ? 2 : pi == 1 || pi == 4 ? 1 : 0;
    const uint8_t* ws = wp + pb * SQ_BYTES;
#pragma unroll
    for (int kk = 0; kk < CP / 16; ++kk)
      Mma<CP>::rs<TB>(acc, x[pa][kk], TB ? b_sqt(ws, kk) : b_sq(ws, kk));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// The bf16 rows r < n of a [*, C] tensor from row row0, as one piece of A
// registers (zeros on the rows past n): the pairs are loaded as they are.
__device__ __forceinline__ void load_a_regs(const __nv_bfloat16* __restrict__ src, long long row0,
                                            int n, uint32_t (&a)[CP / 16][4], const Lane& ln) {
#pragma unroll
  for (int kk = 0; kk < CP / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ln.row(i & 1);
      const int c = 16 * kk + 8 * (i >> 1) + 2 * ln.q;
      a[kk][i] = r < n ? __ldg(reinterpret_cast<const unsigned int*>(src + (row0 + r) * C + c)) : 0u;
    }
}

// A C-wide accumulator-layout tile to rows row0 + r (r < n) of a [*, C] f32
// tensor, 8 bytes a store (a quad writes a row's 32-byte sector).
__device__ __forceinline__ void store_f32_rows(float* dst, long long row0, int n,
                                               const float (&v)[4 * JC], const Lane& ln) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = ln.row(half);
    if (r < n) {
#pragma unroll
      for (int j = 0; j < JC; ++j)
        *reinterpret_cast<float2*>(dst + (row0 + r) * C + ln.col(j)) =
            make_float2(v[4 * j + 2 * half], v[4 * j + 2 * half + 1]);
    }
  }
}

}  // namespace ahop
}  // namespace
