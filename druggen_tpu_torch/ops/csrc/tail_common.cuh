// The edge-stream tail of one 16-row tile, shared by K1 (fused_mlp.cu), K7
// (fused_block.cu) and K9 (fused_generator.cu), and the row helpers of K2
// and K8:
//
//     x   = LN1(s)                                  (f32)
//     h   = relu(round_T(x) @ W1 + b1)              (f32 accumulate)
//     m   = round_T(h) @ W2 + b2                    (f32 accumulate)
//     out = round_T(LN2(x + m))                     (residual on the f32 x)
//
// with the Pallas kernels' rounding points (druggen_tpu/ops/fused_mlp.py
// _fwd_kernel; fused_block.py _fwd_kernel's LN4 -> MLP2 -> LN6); eps 1e-5.
// The rounding policy kRoundResidual (K9's, fused_generator.py _kernel:
// every product and every add rounded to T) changes the last line to
//
//     out = round_T(LN2(round_T(round_T(x) + round_T(m))))
//
// and nothing else: h is rounded in both, and K9 hands in LN parameters and
// biases that are already stream-type values.
//
// Widths.  C (the stream width) and H (the MLP hidden) are compile-time
// constants set by the build (-DKERNEL_C=... -DKERNEL_H=..., default 128 and
// 384).  A row is held by one warp, VEC columns a lane at a time in NCH
// chunks; the products run on 16 x 16 WMMA tiles (bf16 in, f32 accumulate)
// over C and H padded to multiples of 16.  The weights come in the padded
// nn.Linear layout W1^T [HP][CP] and W2^T [CP][HP] (zeros in the padding),
// and tail_tile reads their fragments through a pointer and a leading
// dimension: a block that has room stages them in shared memory (K1 at the
// published widths), any other reads them from device memory, where the
// <= 1.5 MB of bf16 weights stay resident in the 50 MB L2 (K1 at a width
// whose weights do not fit one SM's 227 KB, and K7 at every width).  The f32
// twin multiplies on the CUDA cores with the weights read through L2.
//
// Also the row helpers that K1/K2 and K7/K8 share (vector loads, LayerNorm
// statistics and backward).  Included by its users inside their own
// translation unit; everything lives in namespace tailk so that it sits
// beside attn_common.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

#ifndef KERNEL_C
#define KERNEL_C 128
#endif
#ifndef KERNEL_H
#define KERNEL_H 384
#endif

namespace {
namespace tailk {

using namespace nvcuda;

constexpr int C = KERNEL_C;               // stream width (dim)
constexpr int H = KERNEL_H;               // MLP hidden (mlp_ratio * dim)
constexpr int CP = (C + 15) / 16 * 16;    // widths padded to WMMA tiles
constexpr int HP = (H + 15) / 16 * 16;
constexpr int BM = 16;                    // rows per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = BM / WARPS; // LayerNorm rows owned by a warp
constexpr float EPS = 1e-5f;
// A lane holds columns (ch * 32 + lane) * VEC + v of its rows, ch < NCH.
constexpr int VEC = C % 4 == 0 ? 4 : (C % 2 == 0 ? 2 : 1);
constexpr int NCH = (C + 32 * VEC - 1) / (32 * VEC);
constexpr int HT = HP / 16;               // hidden column tiles
constexpr int CTL = CP / 16;              // output column tiles
constexpr int NT1 = (HT + WARPS - 1) / WARPS;  // fc1 tiles a warp owns
constexpr int NT2 = (CTL + WARPS - 1) / WARPS; // fc2 tiles a warp owns
// Whether every lane's columns and every warp's tiles exist: then the
// guards below are compile-time constants (true at the published widths).
constexpr bool kFullRow = C == NCH * 32 * VEC;
constexpr bool kFullHT = HT % WARPS == 0;
constexpr bool kFullCT = CTL % WARPS == 0;

// Padded leading dimensions (elements): a row shift of 16 bytes keeps the
// 8-row fragment loads off a single bank group.
constexpr int LDW1 = CP + 8;  // staged W1^T: [HP][LDW1]
constexpr int LDW2 = HP + 8;  // staged W2^T: [CP][LDW2]
constexpr int LDX = CP + 8;   // rounded LN1 output: [BM][LDX]
constexpr int LDH = HP + 8;   // rounded hidden:     [BM][LDH]
constexpr int LDS = CP + 4;   // f32 product stage:  [BM][LDS]
constexpr int STAGE = BM * LDS > WARPS * 256 ? BM * LDS : WARPS * 256;  // floats

// Dynamic shared memory one block may use on the H100 (227 KB).
constexpr size_t SMEM_MAX = 232448;

static_assert(C > 0 && H > 0 && BM % WARPS == 0, "tile shapes must divide among the warps");

// The tile's working buffers: rounded x, rounded h, the f32 stage.
template <typename T>
struct Bufs {
  static constexpr size_t x = size_t(BM) * LDX * sizeof(T);
  static constexpr size_t h = size_t(BM) * LDH * sizeof(T);
  static constexpr size_t stage = size_t(STAGE) * sizeof(float);
  static constexpr size_t total = x + h + stage;
};
static_assert(Bufs<__nv_bfloat16>::x % 128 == 0 && Bufs<__nv_bfloat16>::h % 128 == 0 &&
                  Bufs<float>::x % 128 == 0 && Bufs<float>::h % 128 == 0,
              "shared buffers must stay 128-byte aligned");
// Both bf16 weights staged in shared memory.
constexpr size_t STAGED_W = size_t(HP) * LDW1 * 2 + size_t(CP) * LDW2 * 2;

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// VEC consecutive elements <-> VEC floats.
__device__ __forceinline__ void loadv(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float* v) {
  if constexpr (VEC == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else if constexpr (VEC == 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}
__device__ __forceinline__ void storev(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}
__device__ __forceinline__ void storev(__nv_bfloat16* p, const float* v) {
  if constexpr (VEC == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 t;
    t.x = *reinterpret_cast<const uint32_t*>(&a);
    t.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = t;
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

// First column of chunk `ch` of this lane, and whether the chunk is in the row.
__device__ __forceinline__ int col_of(int ch, int lane) { return (ch * 32 + lane) * VEC; }
__device__ __forceinline__ bool col_ok(int ch, int lane) {
  return kFullRow || col_of(ch, lane) < C;
}
__device__ __forceinline__ bool ht_ok(int tile) { return kFullHT || tile < HT; }
__device__ __forceinline__ bool ct_ok(int tile) { return kFullCT || tile < CTL; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm of one C-wide row held by a warp (NCH x VEC columns a lane, zero
// past the row), in f32 (two-pass variance, as the Pallas kernel's _ln_fwd).
__device__ __forceinline__ void layer_norm_row(float v[NCH][VEC], const float g[NCH][VEC],
                                               const float b[NCH][VEC], int lane) {
  float s = 0.0f;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int i = 0; i < VEC; ++i) s += v[ch][i];
  const float mu = warp_sum(s) * (1.0f / C);
  float d[NCH][VEC];
  float q = 0.0f;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      d[ch][i] = col_ok(ch, lane) ? v[ch][i] - mu : 0.0f;
      q += d[ch][i] * d[ch][i];
    }
  const float rstd = rsqrtf(warp_sum(q) * (1.0f / C) + EPS);
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[ch][i] = d[ch][i] * rstd * g[ch][i] + b[ch][i];
}

// LayerNorm statistics of one C-wide row held by a warp (zero past the row),
// in f32 (two-pass variance, as the Pallas kernels' _ln_fwd): xhat (zero past
// the row) and rstd.  The backward kernels' recompute.
__device__ __forceinline__ float ln_stats(const float v[NCH][VEC], float xhat[NCH][VEC], int lane) {
  float s = 0.0f;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int i = 0; i < VEC; ++i) s += v[ch][i];
  const float mu = warp_sum(s) * (1.0f / C);
  float q = 0.0f;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      xhat[ch][i] = col_ok(ch, lane) ? v[ch][i] - mu : 0.0f;
      q += xhat[ch][i] * xhat[ch][i];
    }
  const float rstd = rsqrtf(warp_sum(q) * (1.0f / C) + EPS);
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int i = 0; i < VEC; ++i) xhat[ch][i] *= rstd;
  return rstd;
}

// d(input) of y = gamma * xhat + beta given the upstream dy (the Pallas
// kernels' _ln_bwd_input); zero past the row.
__device__ __forceinline__ void ln_bwd(const float dy[NCH][VEC], const float xhat[NCH][VEC],
                                       float rstd, const float g[NCH][VEC], float dx[NCH][VEC],
                                       int lane) {
  float dxh[NCH][VEC];
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      dxh[ch][i] = dy[ch][i] * g[ch][i];
      s1 += dxh[ch][i];
      s2 += dxh[ch][i] * xhat[ch][i];
    }
  const float m1 = warp_sum(s1) * (1.0f / C);
  const float m2 = warp_sum(s2) * (1.0f / C);
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      dx[ch][i] = col_ok(ch, lane) ? (dxh[ch][i] - m1 - xhat[ch][i] * m2) * rstd : 0.0f;
}

// dst[r * LD + c] = src[r * COLS + c] for r < ROWS, c < COLS (16-byte copies
// where the rows allow it): the padded weights into shared memory.
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                           int tid) {
  if constexpr (COLS % 8 == 0) {
    for (int i = tid; i < ROWS * (COLS / 8); i += THREADS) {
      const int r = i / (COLS / 8), c = (i % (COLS / 8)) * 8;
      *reinterpret_cast<uint4*>(dst + r * LD + c) =
          *reinterpret_cast<const uint4*>(src + size_t(r) * COLS + c);
    }
  } else {
    for (int i = tid; i < ROWS * COLS; i += THREADS) dst[(i / COLS) * LD + i % COLS] = src[i];
  }
}

// The tail's per-lane parameters: this lane's columns of the LayerNorm
// parameters and of b2 (zero past the row), and the pointer to b1.
struct LaneParams {
  float g1[NCH][VEC], bl1[NCH][VEC], g2[NCH][VEC], bl2[NCH][VEC], b2[NCH][VEC];
  const float* b1;
};

__device__ __forceinline__ void load_lane_params(LaneParams& p, const float* __restrict__ g1,
                                                 const float* __restrict__ bl1,
                                                 const float* __restrict__ b1,
                                                 const float* __restrict__ b2,
                                                 const float* __restrict__ g2,
                                                 const float* __restrict__ bl2, int lane) {
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = col_of(ch, lane) + i;
      const bool ok = col_ok(ch, lane);
      p.g1[ch][i] = ok ? g1[c] : 0.0f;
      p.bl1[ch][i] = ok ? bl1[c] : 0.0f;
      p.g2[ch][i] = ok ? g2[c] : 0.0f;
      p.bl2[ch][i] = ok ? bl2[c] : 0.0f;
      p.b2[ch][i] = ok ? b2[c] : 0.0f;
    }
  p.b1 = b1;
}

// The padded columns of the rounded LN1 output stay zero (the products read
// them against zero weights; uninitialised bits could be NaN).  Once per
// block, before the first tile.
template <typename T>
__device__ __forceinline__ void init_bufs(T* xs, int tid) {
  if constexpr (CP > C) {
    for (int r = 0; r < BM; ++r)
      for (int c = C + tid; c < CP; c += THREADS) xs[r * LDX + c] = from_float<T>(0.0f);
  }
}

// One tile.  xr: this warp's rows (warp * ROWS_PER_WARP + j) of the tile's
// f32 input s, zero past the row; `valid` rows of the tile exist (uniform
// across the block).  w1 / w2: W1^T [HP][CP] and W2^T [CP][HP] in T, at
// leading dimensions LD1 / LD2 (in shared or device memory; for the f32
// twin in device memory).  xs, hs, stage: the Bufs<T> buffers.  Writes the
// tile's rows r < valid to out + r * LDO.  kRoundResidual: K9's rounding
// policy (see the top of this file).  Every thread of the block calls it;
// it begins and ends with __syncthreads-separated uses of the buffers, so two
// calls in a row need no barrier between them.
template <typename T, int LD1, int LD2, bool kRoundResidual = false, int LDO = C>
__device__ __forceinline__ void tail_tile(float xr[ROWS_PER_WARP][NCH][VEC], int valid,
                                          const LaneParams& p, const T* w1, const T* w2, T* xs,
                                          T* hs, float* stage, T* __restrict__ out) {
  constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // ---- 1. LN1 in f32; x kept in registers for the residual, rounded copy
  //         to shared memory for fc1.  Rows past `valid` are zero.
#pragma unroll
  for (int j = 0; j < ROWS_PER_WARP; ++j) {
    const int r = warp * ROWS_PER_WARP + j;
    if (r < valid) layer_norm_row(xr[j], p.g1, p.bl1, lane);  // uniform across the warp
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
      if (col_ok(ch, lane)) storev(xs + r * LDX + col_of(ch, lane), xr[j][ch]);
  }
  __syncthreads();

  // ---- 2. h = relu(x @ W1 + b1), rounded to T, into shared memory (zero in
  //         the padded hidden columns).
  if constexpr (kTensorCores) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT1];
#pragma unroll
    for (int t = 0; t < NT1; ++t) wmma::fill_fragment(acc[t], 0.0f);
#pragma unroll
    for (int k = 0; k < CP; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, xs + k, LDX);
#pragma unroll
      for (int t = 0; t < NT1; ++t) {
        if (ht_ok(warp + t * WARPS)) {  // uniform across the warp
          const int n0 = (warp + t * WARPS) * 16;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
          wmma::load_matrix_sync(b, w1 + n0 * LD1 + k, LD1);
          wmma::mma_sync(acc[t], a, b, acc[t]);
        }
      }
    }
    float* scratch = stage + warp * 256;  // this warp's 16x16 f32 tile
#pragma unroll
    for (int t = 0; t < NT1; ++t) {
      if (!ht_ok(warp + t * WARPS)) continue;
      const int n0 = (warp + t * WARPS) * 16;
      wmma::store_matrix_sync(scratch, acc[t], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, n = n0 + (e & 15);
        hs[r * LDH + n] =
            from_float<T>(HP == H || n < H ? fmaxf(scratch[e] + p.b1[n], 0.0f) : 0.0f);
      }
      __syncwarp();
    }
  } else {
    for (int e = tid; e < BM * H; e += THREADS) {
      const int r = e / H, n = e % H;
      const T* xrow = xs + r * LDX;
      const T* wrow = w1 + size_t(n) * LD1;
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < C; ++k) acc = fmaf(to_float(xrow[k]), to_float(__ldg(wrow + k)), acc);
      hs[r * LDH + n] = from_float<T>(fmaxf(acc + p.b1[n], 0.0f));
    }
  }
  __syncthreads();

  // ---- 3. m = h @ W2 (b2 is added in the epilogue), f32 into the stage.
  if constexpr (kTensorCores) {
#pragma unroll
    for (int t = 0; t < NT2; ++t) {
      if (!ct_ok(warp + t * WARPS)) continue;  // uniform across the warp
      const int n0 = (warp + t * WARPS) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0, acc1;
      wmma::fill_fragment(acc0, 0.0f);
      wmma::fill_fragment(acc1, 0.0f);
#pragma unroll
      for (int k = 0; k + 32 <= HP; k += 32) {  // two independent chains
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a0, a1;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b0, b1f;
        wmma::load_matrix_sync(a0, hs + k, LDH);
        wmma::load_matrix_sync(b0, w2 + n0 * LD2 + k, LD2);
        wmma::load_matrix_sync(a1, hs + k + 16, LDH);
        wmma::load_matrix_sync(b1f, w2 + n0 * LD2 + k + 16, LD2);
        wmma::mma_sync(acc0, a0, b0, acc0);
        wmma::mma_sync(acc1, a1, b1f, acc1);
      }
      if constexpr (HP % 32 != 0) {  // the last 16 of the hidden
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a0;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b0;
        wmma::load_matrix_sync(a0, hs + HP - 16, LDH);
        wmma::load_matrix_sync(b0, w2 + n0 * LD2 + HP - 16, LD2);
        wmma::mma_sync(acc0, a0, b0, acc0);
      }
#pragma unroll
      for (int i = 0; i < acc0.num_elements; ++i) acc0.x[i] += acc1.x[i];
      wmma::store_matrix_sync(stage + n0, acc0, LDS, wmma::mem_row_major);
    }
  } else {
    for (int e = tid; e < BM * C; e += THREADS) {
      const int r = e / C, n = e % C;
      const T* hrow = hs + r * LDH;
      const T* wrow = w2 + size_t(n) * LD2;
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) acc = fmaf(to_float(hrow[k]), to_float(__ldg(wrow + k)), acc);
      stage[r * LDS + n] = acc;
    }
  }
  __syncthreads();

  // ---- 4. out = LN2(x + (m + b2)), rounded to T.
#pragma unroll
  for (int j = 0; j < ROWS_PER_WARP; ++j) {
    const int r = warp * ROWS_PER_WARP + j;
    if (r < valid) {  // uniform across the warp
      float v[NCH][VEC];
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int c = col_of(ch, lane) + i;
          if constexpr (kRoundResidual) {
            v[ch][i] = 0.0f;
            if (col_ok(ch, lane)) {
              const float m = to_float(from_float<T>(stage[r * LDS + c] + p.b2[ch][i]));
              const float x = to_float(from_float<T>(xr[j][ch][i]));
              v[ch][i] = to_float(from_float<T>(x + m));
            }
          } else {
            v[ch][i] = col_ok(ch, lane) ? xr[j][ch][i] + (stage[r * LDS + c] + p.b2[ch][i]) : 0.0f;
          }
        }
      layer_norm_row(v, p.g2, p.bl2, lane);
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
        if (col_ok(ch, lane)) storev(out + size_t(r) * LDO + col_of(ch, lane), v[ch]);
    }
  }
  // No barrier needed here: the next tile's first writes (xs, then the stage
  // and hs) all follow its own first __syncthreads.
}

}  // namespace tailk
}  // namespace
