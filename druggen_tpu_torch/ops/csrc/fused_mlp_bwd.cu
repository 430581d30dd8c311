// Fused LN -> MLP -> residual -> LN row kernel (the edge-stream tail), backward.
//
// Replaces the TPU kernel druggen_tpu/ops/fused_mlp.py::_bwd_kernel.  Given the
// forward's input s [rows, C] and the output cotangent dout, it recomputes the
// forward of fused_mlp.cu and returns
//
//     ds                          [rows, C] in the stream type
//     dg1 dbl1 dw1 db1 dw2 db2 dg2 dbl2   the 8 parameter gradients, f32,
//                                         summed over all rows
//
// with the Pallas kernel's rounding points: forward as in K1; dr = LN2'(dout);
// dh = (round_T(dr) @ W2^T) * (h_pre > 0); dx = dr + round_T(dh) @ W1^T;
// ds = round_T(LN1'(dx)); dw1 = round_T(x)^T round_T(dh),
// dw2 = round_T(h)^T round_T(dr), the vector gradients summed in f32.
//
// What bounds it on an H100 SXM: at the training shape (512 graphs of 45
// atoms, rows = 1,036,800, C = 128, H = 384) it does six products of
// 2 * rows * C * H = 101.9 GFLOP each (two forward products recomputed, four
// backward), 611.5 GFLOP, i.e. 0.618 ms at 989 TFLOP/s in bf16; it must read
// s and dout and write ds, 0.80 GB, i.e. 0.24 ms at 3.35 TB/s.  So the
// tensor cores' operations bound it.
//
// Why this design.  On the TPU the grid runs in order on one core, so the
// Pallas kernel adds each tile's weight gradients into its output refs.  On
// the card blocks run in parallel, and the f32 weight gradients (dW1 + dW2 =
// 384 KB) fit neither in one SM's shared memory (K1's persistent block
// already spends 200 KB of its 227 KB on the two bf16 weights) nor in its
// 256 KB register file.  Adding a tile's contribution into a per-block f32
// partial in device memory would read and write that 384 KB once per group
// of at most 16 rows (all that fits in the 27 KB left beside the weights):
// ~50 GB of traffic at the training shape.  Instead the backward runs as
// three deterministic launches:
//
//   1. rows    persistent block per SM, both bf16 weights staged once in
//              shared memory (as K1).  Per 16-row tile: recompute the forward
//              and run the backward with WMMA (bf16 in, f32 accumulate), write
//              ds and the four operands of the weight-gradient products
//              (x, h, dm, dh rounded to the stream type: 2.1 GB at the
//              training shape in bf16), and keep the vector gradients in
//              registers; each warp writes its private vector partial.
//   2. wgrad   dW1 = X^T dH and dW2 = H^T dM as a split-K GEMM: each block
//              owns one 128 x 128 output tile and one contiguous run of rows,
//              streams both operands through shared memory (64-row slabs,
//              zero-filled past the end) and writes its f32 partial tile.
//   3. reduce  sums the partials in a fixed order into the 8 gradients.
//
// No float atomics anywhere: the same inputs give the same bits on every
// run.  Traffic beyond the bound's 0.80 GB: the four row operands written
// once (2.1 GB) and read back by wgrad (3.2 GB: X and dM are read once per
// output tile of the other matrix, three times), plus 17 MB of f32 weight
// partials and 4 MB of vector partials at 132 SMs.  wgmma, TMA and fusing
// wgrad into the rows pass (a cluster that shares the accumulators) are later
// work.
//
// Ragged last tile: rows past the end are masked (zeros in, nothing stored,
// nothing summed); the input is not padded.
//
// Widths: C and H are compile-time constants set by the build
// (-DKERNEL_C=... -DKERNEL_H=..., default 128 and 384), as in fused_mlp.cu:
// the rows pass holds C-wide rows VEC columns a lane at a time and runs its
// products on WMMA tiles over C and H padded to multiples of 16 (the weights
// come zero-padded; the row helpers are tail_common.cuh's, shared with K1
// and K8); its block stages both bf16 weights where they fit 227 KB
// beside its buffers (RowSmem<bf16>::kStage, the same rule as K1's) and
// otherwise reads their fragments from device memory, where they stay
// resident in L2, so every width runs.  wgrad covers
// dW1 [C, H] and dW2 [H, C] with 128 x 128 tiles masked at the edges.
//
// The f32 twin (off the training path) multiplies on the CUDA cores with the
// weights read through L2, like K1's; the backward products read W1^T and
// W2^T by column, so the interface takes each weight in one orientation.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -DKERNEL_C=128 -DKERNEL_H=384 -o libfused_mlp_bwd.so fused_mlp_bwd.cu
// Plain C interface for ctypes; no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "tail_common.cuh"

namespace {

using namespace nvcuda;
using namespace tailk;

constexpr int NQ = (H + THREADS - 1) / THREADS;  // hidden units a thread owns (f32)
constexpr int NDB1 = NT1 > NQ ? NT1 : NQ;

// One vector partial: dg1, dbl1, db1, db2, dg2, dbl2.
constexpr int OFF_DG1 = 0, OFF_DBL1 = C, OFF_DB1 = 2 * C, OFF_DB2 = 2 * C + H,
              OFF_DG2 = 3 * C + H, OFF_DBL2 = 4 * C + H, NVEC = 5 * C + H;
// The gradient buffer, in the order of the Pallas kernel's outputs:
// dg1[C] dbl1[C] dw1[C,H] db1[H] dw2[H,C] db2[C] dg2[C] dbl2[C].
constexpr int G_DG1 = 0, G_DBL1 = C, G_DW1 = 2 * C, G_DB1 = 2 * C + C * H,
              G_DW2 = G_DB1 + H, G_DB2 = G_DW2 + H * C, G_DG2 = G_DB2 + C,
              G_DBL2 = G_DG2 + C, G_TOTAL = G_DBL2 + C;

// wgrad: 128 x 128 output tiles (masked at the edges of dW1 [C, H] and
// dW2 [H, C]), 64-row slabs.
constexpr int TILE = 128;
constexpr int KB = 64;
constexpr int TC = (C + TILE - 1) / TILE;  // tiles along C
constexpr int TH = (H + TILE - 1) / TILE;  // tiles along H
constexpr int TILES = TC * TH;             // output tiles of each weight gradient

template <typename T>
struct RowSmem {
  static constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  static constexpr size_t x = size_t(BM) * LDX * sizeof(T);
  static constexpr size_t h = size_t(BM) * LDH * sizeof(T);
  static constexpr size_t stage = size_t(STAGE) * sizeof(float);
  static constexpr size_t w1_staged = size_t(HP) * LDW1 * sizeof(T);
  static constexpr size_t w2_staged = size_t(CP) * LDW2 * sizeof(T);
  // stage both bf16 weights when they fit beside the tile's buffers; else
  // the fragments are read from device memory (the weights stay in L2)
  static constexpr bool kStage =
      kTensorCores && w1_staged + w2_staged + x + h + stage <= SMEM_MAX;
  static constexpr size_t w1 = kStage ? w1_staged : 0;
  static constexpr size_t w2 = kStage ? w2_staged : 0;
  static constexpr size_t total = w1 + w2 + x + h + stage;
  // leading dimensions of the weights where the products read them
  static constexpr int ld1 = kStage ? LDW1 : CP;
  static constexpr int ld2 = kStage ? LDW2 : HP;
};

static_assert(RowSmem<__nv_bfloat16>::w1 % 128 == 0 && RowSmem<__nv_bfloat16>::w2 % 128 == 0 &&
              RowSmem<__nv_bfloat16>::x % 128 == 0 && RowSmem<__nv_bfloat16>::h % 128 == 0,
              "shared buffers must stay 128-byte aligned");
static_assert(RowSmem<float>::x % 128 == 0 && RowSmem<float>::h % 128 == 0,
              "shared buffers must stay 128-byte aligned");

// ---------------------------------------------------------------------------
// 1. rows: recompute forward, backward per row, ds, the product operands and
//    the vector partials.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
rows_kernel(const T* __restrict__ s, const T* __restrict__ dout, const float* __restrict__ g1,
            const float* __restrict__ bl1, const T* __restrict__ w1t,
            const float* __restrict__ b1, const T* __restrict__ w2t,
            const float* __restrict__ b2, const float* __restrict__ g2,
            const float* __restrict__ bl2, T* __restrict__ ds, T* __restrict__ x_out,
            T* __restrict__ h_out, T* __restrict__ dm_out, T* __restrict__ dh_out,
            float* __restrict__ vec_partial, long long rows) {
  using S = RowSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* w1st = reinterpret_cast<T*>(smem);
  T* w2st = reinterpret_cast<T*>(smem + S::w1);
  T* xs = reinterpret_cast<T*>(smem + S::w1 + S::w2);          // x, then dm
  T* hs = reinterpret_cast<T*>(smem + S::w1 + S::w2 + S::x);   // h, then dh
  float* stage = reinterpret_cast<float*>(smem + S::w1 + S::w2 + S::x + S::h);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if constexpr (S::kStage) {
    stage_rows<HP, CP, LDW1>(w1st, w1t, tid);
    stage_rows<CP, HP, LDW2>(w2st, w2t, tid);
  }
  // where the products read the weights: staged, or in device memory
  const T* w1s = S::kStage ? w1st : w1t;
  const T* w2s = S::kStage ? w2st : w2t;
  constexpr int LDA1 = S::ld1, LDA2 = S::ld2;
  // The padded columns of x / dm stay zero (see fused_mlp.cu).
  if constexpr (CP > C) {  // keep the guard: unguarded, this dead loop slowed this kernel
    for (int r = 0; r < BM; ++r)
      for (int c = C + tid; c < CP; c += THREADS) xs[r * LDX + c] = from_float<T>(0.0f);
  }

  float rg1[NCH][VEC], rbl1[NCH][VEC], rg2[NCH][VEC], rbl2[NCH][VEC], rb2[NCH][VEC];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = col_of(ch, lane) + i;
      const bool ok = col_ok(ch, lane);
      rg1[ch][i] = ok ? g1[c] : 0.0f;
      rbl1[ch][i] = ok ? bl1[c] : 0.0f;
      rg2[ch][i] = ok ? g2[c] : 0.0f;
      rbl2[ch][i] = ok ? bl2[c] : 0.0f;
      rb2[ch][i] = ok ? b2[c] : 0.0f;
    }
  // This lane's sums over the warp's rows of every tile it visits.
  float a_dg1[NCH][VEC] = {}, a_dbl1[NCH][VEC] = {}, a_db2[NCH][VEC] = {}, a_dg2[NCH][VEC] = {},
        a_dbl2[NCH][VEC] = {};
  // db1: tensor-core path, column (warp + t * WARPS) * 16 + (lane & 15) over
  // the rows of parity lane >> 4; CUDA-core path, columns tid + q * THREADS.
  float a_db1[NDB1] = {};

  const long long n_tiles = (rows + BM - 1) / BM;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * BM;

    // ---- 1. x = LN1(s) in f32; rounded x to shared memory and to x_out.
    float xv[ROWS_PER_WARP][NCH][VEC], xh1[ROWS_PER_WARP][NCH][VEC], rstd1[ROWS_PER_WARP];
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) {
      const int r = warp * ROWS_PER_WARP + j;
      const long long row = row0 + r;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int i = 0; i < VEC; ++i) xv[j][ch][i] = xh1[j][ch][i] = 0.0f;
      rstd1[j] = 0.0f;
      if (row < rows) {  // uniform across the warp
        float v[NCH][VEC];
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) v[ch][i] = 0.0f;
          if (col_ok(ch, lane)) loadv(s + row * C + col_of(ch, lane), v[ch]);
        }
        rstd1[j] = ln_stats(v, xh1[j], lane);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) xv[j][ch][i] = xh1[j][ch][i] * rg1[ch][i] + rbl1[ch][i];
          if (col_ok(ch, lane)) storev(x_out + row * C + col_of(ch, lane), xv[j][ch]);
        }
      }
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
        if (col_ok(ch, lane)) storev(xs + r * LDX + col_of(ch, lane), xv[j][ch]);
    }
    __syncthreads();

    // ---- 2. h = relu(round(x) @ W1 + b1), rounded, to shared memory and h_out.
    if constexpr (S::kTensorCores) {
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
            wmma::load_matrix_sync(b, w1s + n0 * LDA1 + k, LDA1);
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
          const T hv = from_float<T>(HP == H || n < H ? fmaxf(scratch[e] + b1[n], 0.0f) : 0.0f);
          hs[r * LDH + n] = hv;
          if ((HP == H || n < H) && row0 + r < rows) h_out[(row0 + r) * H + n] = hv;
        }
        __syncwarp();
      }
    } else {
      for (int e = tid; e < BM * H; e += THREADS) {
        const int r = e / H, n = e % H;
        const T* xrow = xs + r * LDX;
        const T* wrow = w1t + size_t(n) * CP;
        float acc = 0.0f;
#pragma unroll 8
        for (int k = 0; k < C; ++k) acc = fmaf(to_float(xrow[k]), to_float(__ldg(wrow + k)), acc);
        const T hv = from_float<T>(fmaxf(acc + b1[n], 0.0f));
        hs[r * LDH + n] = hv;
        if (row0 + r < rows) h_out[(row0 + r) * H + n] = hv;
      }
    }
    __syncthreads();

    // ---- 3. m = round(h) @ W2 (b2 is added below), f32 into the stage.
    if constexpr (S::kTensorCores) {
#pragma unroll
      for (int t = 0; t < NT2; ++t) {
        if (!ct_ok(warp + t * WARPS)) continue;  // uniform across the warp
        const int n0 = (warp + t * WARPS) * 16;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0, acc1;
        wmma::fill_fragment(acc0, 0.0f);
        wmma::fill_fragment(acc1, 0.0f);
#pragma unroll
        for (int k = 0; k + 32 <= HP; k += 32) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a0, a1;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b0, b1f;
          wmma::load_matrix_sync(a0, hs + k, LDH);
          wmma::load_matrix_sync(b0, w2s + n0 * LDA2 + k, LDA2);
          wmma::load_matrix_sync(a1, hs + k + 16, LDH);
          wmma::load_matrix_sync(b1f, w2s + n0 * LDA2 + k + 16, LDA2);
          wmma::mma_sync(acc0, a0, b0, acc0);
          wmma::mma_sync(acc1, a1, b1f, acc1);
        }
        if constexpr (HP % 32 != 0) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a0;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b0;
          wmma::load_matrix_sync(a0, hs + HP - 16, LDH);
          wmma::load_matrix_sync(b0, w2s + n0 * LDA2 + HP - 16, LDA2);
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
        const T* wrow = w2t + size_t(n) * HP;
        float acc = 0.0f;
#pragma unroll 8
        for (int k = 0; k < H; ++k) acc = fmaf(to_float(hrow[k]), to_float(__ldg(wrow + k)), acc);
        stage[r * LDS + n] = acc;
      }
    }
    __syncthreads();

    // ---- 4. r = x + (m + b2); dr = LN2'(dout); rounded dm (= dr) over x in
    //         shared memory (x is dead after step 2) and to dm_out.
    float dr[ROWS_PER_WARP][NCH][VEC];
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) {
      const int r = warp * ROWS_PER_WARP + j;
      const long long row = row0 + r;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int i = 0; i < VEC; ++i) dr[j][ch][i] = 0.0f;
      if (row < rows) {  // uniform across the warp
        float rv[NCH][VEC], rhat[NCH][VEC], go[NCH][VEC];
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            rv[ch][i] = col_ok(ch, lane)
                            ? xv[j][ch][i] + (stage[r * LDS + col_of(ch, lane) + i] + rb2[ch][i])
                            : 0.0f;
        const float rstd2 = ln_stats(rv, rhat, lane);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) go[ch][i] = 0.0f;
          if (col_ok(ch, lane)) loadv(dout + row * C + col_of(ch, lane), go[ch]);
        }
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            a_dg2[ch][i] += go[ch][i] * rhat[ch][i];
            a_dbl2[ch][i] += go[ch][i];
          }
        ln_bwd(go, rhat, rstd2, rg2, dr[j], lane);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) a_db2[ch][i] += dr[j][ch][i];
          if (col_ok(ch, lane)) storev(dm_out + row * C + col_of(ch, lane), dr[j][ch]);
        }
      }
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
        if (col_ok(ch, lane)) storev(xs + r * LDX + col_of(ch, lane), dr[j][ch]);
    }
    __syncthreads();

    // ---- 5. dh = (round(dm) @ W2^T) * (h > 0), rounded, over h in shared
    //         memory and to dh_out; db1 sums the f32 dh.
    if constexpr (S::kTensorCores) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT1];
#pragma unroll
      for (int t = 0; t < NT1; ++t) wmma::fill_fragment(acc[t], 0.0f);
#pragma unroll
      for (int k = 0; k < CP; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, xs + k, LDX);
#pragma unroll
        for (int t = 0; t < NT1; ++t) {
          if (ht_ok(warp + t * WARPS)) {
            const int n0 = (warp + t * WARPS) * 16;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
            wmma::load_matrix_sync(b, w2s + k * LDA2 + n0, LDA2);
            wmma::mma_sync(acc[t], a, b, acc[t]);
          }
        }
      }
      float* scratch = stage + warp * 256;
#pragma unroll
      for (int t = 0; t < NT1; ++t) {
        if (!ht_ok(warp + t * WARPS)) continue;
        const int n0 = (warp + t * WARPS) * 16;
        wmma::store_matrix_sync(scratch, acc[t], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = e >> 4, n = n0 + (e & 15);
          // padded hidden units hold h = 0, so their dh is 0
          const float dh = to_float(hs[r * LDH + n]) > 0.0f ? scratch[e] : 0.0f;
          const T dhv = from_float<T>(dh);
          hs[r * LDH + n] = dhv;
          if (row0 + r < rows) {
            a_db1[t] += dh;
            if (HP == H || n < H) dh_out[(row0 + r) * H + n] = dhv;
          }
        }
        __syncwarp();
      }
    } else {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int n = tid + q * THREADS;
        if (n < H) {
          const T* wcol = w2t + n;  // W2[n, k] = W2^T[k, n]
          for (int r = 0; r < BM; ++r) {
            const T* mrow = xs + r * LDX;
            float acc = 0.0f;
#pragma unroll 8
            for (int k = 0; k < C; ++k)
              acc = fmaf(to_float(mrow[k]), to_float(__ldg(wcol + size_t(k) * HP)), acc);
            const float dh = to_float(hs[r * LDH + n]) > 0.0f ? acc : 0.0f;
            hs[r * LDH + n] = from_float<T>(dh);
            if (row0 + r < rows) {
              a_db1[q] += dh;
              dh_out[(row0 + r) * H + n] = from_float<T>(dh);
            }
          }
        }
      }
    }
    __syncthreads();

    // ---- 6. round(dh) @ W1^T, f32 into the stage.
    if constexpr (S::kTensorCores) {
#pragma unroll
      for (int t = 0; t < NT2; ++t) {
        if (!ct_ok(warp + t * WARPS)) continue;
        const int n0 = (warp + t * WARPS) * 16;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0, acc1;
        wmma::fill_fragment(acc0, 0.0f);
        wmma::fill_fragment(acc1, 0.0f);
#pragma unroll
        for (int k = 0; k + 32 <= HP; k += 32) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a0, a1;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b0, b1f;
          wmma::load_matrix_sync(a0, hs + k, LDH);
          wmma::load_matrix_sync(b0, w1s + k * LDA1 + n0, LDA1);
          wmma::load_matrix_sync(a1, hs + k + 16, LDH);
          wmma::load_matrix_sync(b1f, w1s + (k + 16) * LDA1 + n0, LDA1);
          wmma::mma_sync(acc0, a0, b0, acc0);
          wmma::mma_sync(acc1, a1, b1f, acc1);
        }
        if constexpr (HP % 32 != 0) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a0;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b0;
          wmma::load_matrix_sync(a0, hs + HP - 16, LDH);
          wmma::load_matrix_sync(b0, w1s + (HP - 16) * LDA1 + n0, LDA1);
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
        const T* wcol = w1t + n;  // W1[n, k] = W1^T[k, n]
        float acc = 0.0f;
#pragma unroll 8
        for (int k = 0; k < H; ++k)
          acc = fmaf(to_float(hrow[k]), to_float(__ldg(wcol + size_t(k) * CP)), acc);
        stage[r * LDS + n] = acc;
      }
    }
    __syncthreads();

    // ---- 7. dx = dr + that; ds = LN1'(dx), rounded, to ds.
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) {
      const int r = warp * ROWS_PER_WARP + j;
      const long long row = row0 + r;
      if (row < rows) {  // uniform across the warp
        float dx[NCH][VEC], dsv[NCH][VEC];
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            dx[ch][i] = col_ok(ch, lane)
                            ? dr[j][ch][i] + stage[r * LDS + col_of(ch, lane) + i]
                            : 0.0f;
            a_dg1[ch][i] += dx[ch][i] * xh1[j][ch][i];
            a_dbl1[ch][i] += dx[ch][i];
          }
        ln_bwd(dx, xh1[j], rstd1[j], rg1, dsv, lane);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
          if (col_ok(ch, lane)) storev(ds + row * C + col_of(ch, lane), dsv[ch]);
      }
    }
    // No barrier needed here: the next tile's first writes (x over dm, then
    // the stage and h) all follow barriers that come after the last reads.
  }

  // ---- this warp's vector partial (the buffer is zeroed by the caller; each
  //      db1 column is written by exactly one warp of the block).
  float* vp = vec_partial + (size_t(blockIdx.x) * WARPS + warp) * NVEC;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    if (!col_ok(ch, lane)) continue;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = col_of(ch, lane) + i;
      vp[OFF_DG1 + c] = a_dg1[ch][i];
      vp[OFF_DBL1 + c] = a_dbl1[ch][i];
      vp[OFF_DB2 + c] = a_db2[ch][i];
      vp[OFF_DG2 + c] = a_dg2[ch][i];
      vp[OFF_DBL2 + c] = a_dbl2[ch][i];
    }
  }
  if constexpr (S::kTensorCores) {
#pragma unroll
    for (int t = 0; t < NT1; ++t) {
      const float v = a_db1[t] + __shfl_xor_sync(0xffffffffu, a_db1[t], 16);
      const int n = (warp + t * WARPS) * 16 + lane;
      if (lane < 16 && ht_ok(warp + t * WARPS) && (HP == H || n < H)) vp[OFF_DB1 + n] = v;
    }
  } else {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int n = tid + q * THREADS;
      if (n < H) vp[OFF_DB1 + n] = a_db1[q];
    }
  }
}

// ---------------------------------------------------------------------------
// 2. wgrad: out[z][chunk] = A_z^T B_z over the chunk's rows, for
//    z = 0: A = x [rows, C], B = dh [rows, H] (dW1 [C, H]);
//    z = 1: A = h [rows, H], B = dm [rows, C] (dW2 [H, C]).
//    blockIdx.x picks the 128 x 128 output tile, blockIdx.y the chunk.
// ---------------------------------------------------------------------------
constexpr int LDK = TILE + 8;  // slab leading dimension (elements)

template <typename T>
struct WgradSmem {
  static constexpr size_t slab = size_t(KB) * LDK * sizeof(T);
  static constexpr size_t total = 2 * slab;
};
static_assert(WgradSmem<__nv_bfloat16>::slab >= WARPS * 256 * sizeof(float),
              "the A slab doubles as the warps' f32 output scratch");

// One KB x 128 slab of columns [col0, col0 + 128) of `src` [rows, ld]: rows
// [r0, r0 + KB) of the chunk, zeros past `r_end` and past column `ld` (a
// tile crosses the edge of dW1 / dW2 only where C or H is no multiple of
// 128).  16-byte loads where both widths allow them.
template <typename T>
__device__ __forceinline__ void load_slab(T* dst, const T* __restrict__ src, int ld, int col0,
                                          long long r0, long long r_end, int tid) {
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte load
  constexpr bool kWhole = C % TILE == 0 && H % TILE == 0;
  if constexpr (C % V == 0 && H % V == 0) {
    constexpr int PER_ROW = TILE / V;
    for (int i = tid; i < KB * PER_ROW; i += THREADS) {
      const int r = i / PER_ROW, c = (i % PER_ROW) * V;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < r_end && (kWhole || col0 + c < ld))
        v = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + col0 + c);
      *reinterpret_cast<uint4*>(dst + r * LDK + c) = v;
    }
  } else {
    for (int i = tid; i < KB * TILE; i += THREADS) {
      const int r = i / TILE, c = i % TILE;
      dst[r * LDK + c] = (r0 + r < r_end && col0 + c < ld) ? src[(r0 + r) * ld + col0 + c]
                                                          : from_float<T>(0.0f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const T* __restrict__ x, const T* __restrict__ h, const T* __restrict__ dm,
             const T* __restrict__ dh, float* __restrict__ w_partial, long long rows,
             long long chunk_rows) {
  using S = WgradSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem);
  T* bs = reinterpret_cast<T*>(smem + S::slab);

  const int z = blockIdx.z;
  const int chunk = blockIdx.y;
  const int chunks = gridDim.y;
  const T* a = z == 0 ? x : h;
  const T* b = z == 0 ? dh : dm;
  const int m_dim = z == 0 ? C : H;  // A's width = output rows
  const int n_dim = z == 0 ? H : C;  // B's width = output columns
  const int tn_count = z == 0 ? TH : TC;
  const int tm = blockIdx.x / tn_count;
  const int tn = blockIdx.x % tn_count;
  float* out = w_partial + (size_t(z) * chunks + chunk) * (size_t(C) * H);

  const long long r_begin = chunk * chunk_rows;
  const long long r_end_raw = r_begin + chunk_rows;
  const long long r_end = r_end_raw < rows ? r_end_raw : rows;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // warp w: output rows [16w, 16w + 16) of the tile, all 128 columns.
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TILE / 16];
#pragma unroll
    for (int f = 0; f < TILE / 16; ++f) wmma::fill_fragment(acc[f], 0.0f);
    for (long long r0 = r_begin; r0 < r_end; r0 += KB) {
      load_slab(as, a, m_dim, tm * TILE, r0, r_end, tid);
      load_slab(bs, b, n_dim, tn * TILE, r0, r_end, tid);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KB; k += 16) {
        // A^T tile [16 m x 16 k]: element (m, k) at as[k * LDK + m].
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa;
        wmma::load_matrix_sync(fa, as + k * LDK + warp * 16, LDK);
#pragma unroll
        for (int f = 0; f < TILE / 16; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, bs + k * LDK + f * 16, LDK);
          wmma::mma_sync(acc[f], fa, fb, acc[f]);
        }
      }
      __syncthreads();
    }
    const int row_base = tm * TILE + warp * 16;
    if constexpr (C % TILE == 0 && H % TILE == 0) {  // every tile is whole
#pragma unroll
      for (int f = 0; f < TILE / 16; ++f)
        wmma::store_matrix_sync(out + size_t(row_base) * n_dim + tn * TILE + f * 16, acc[f],
                                n_dim, wmma::mem_row_major);
    } else {
      // Through this warp's 16 x 16 f32 scratch (over the A slab, dead
      // after the last barrier), masked at the edges of the gradient.
      const int lane = tid & 31;
      float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
#pragma unroll
      for (int f = 0; f < TILE / 16; ++f) {
        wmma::store_matrix_sync(scratch, acc[f], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = row_base + (e >> 4), c = tn * TILE + f * 16 + (e & 15);
          if (r < m_dim && c < n_dim) out[size_t(r) * n_dim + c] = scratch[e];
        }
        __syncwarp();
      }
    }
  } else {
    // thread (ty, tx): output rows 8 ty .. 8 ty + 7, columns 8 tx .. 8 tx + 7.
    const int ty = tid / 16, tx = tid % 16;
    float acc[8][8] = {};
    for (long long r0 = r_begin; r0 < r_end; r0 += KB) {
      load_slab(as, a, m_dim, tm * TILE, r0, r_end, tid);
      load_slab(bs, b, n_dim, tn * TILE, r0, r_end, tid);
      __syncthreads();
      for (int k = 0; k < KB; ++k) {
        float av[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          av[i] = to_float(as[k * LDK + ty * 8 + i]);
          bv[i] = to_float(bs[k * LDK + tx * 8 + i]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = tm * TILE + ty * 8 + i;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = tn * TILE + tx * 8 + jj;
        if (r < m_dim && c < n_dim) out[size_t(r) * n_dim + c] = acc[i][jj];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. reduce: the 8 gradients from the partials, summed in a fixed order.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const float* __restrict__ vec_partial, int n_vec, const float* __restrict__ w_partial,
              int chunks, float* __restrict__ grads) {
  const int g = blockIdx.x * THREADS + threadIdx.x;
  if (g >= G_TOTAL) return;
  const float* src;
  size_t stride;
  int count;
  if (g >= G_DW1 && g < G_DB1) {
    src = w_partial + (g - G_DW1);
    stride = size_t(C) * H;
    count = chunks;
  } else if (g >= G_DW2 && g < G_DB2) {
    src = w_partial + size_t(chunks) * C * H + (g - G_DW2);
    stride = size_t(C) * H;
    count = chunks;
  } else {
    int off;
    if (g < G_DBL1) off = OFF_DG1 + (g - G_DG1);
    else if (g < G_DW1) off = OFF_DBL1 + (g - G_DBL1);
    else if (g < G_DW2) off = OFF_DB1 + (g - G_DB1);
    else if (g < G_DG2) off = OFF_DB2 + (g - G_DB2);
    else if (g < G_DBL2) off = OFF_DG2 + (g - G_DG2);
    else off = OFF_DBL2 + (g - G_DBL2);
    src = vec_partial + off;
    stride = NVEC;
    count = n_vec;
  }
  float sum = 0.0f;
  for (int i = 0; i < count; ++i) sum += src[size_t(i) * stride];
  grads[g] = sum;
}

template <typename T>
int launch(const void* s, const void* dout, const void* g1, const void* bl1, const void* w1t,
           const void* b1, const void* w2t, const void* b2, const void* g2, const void* bl2,
           void* ds, void* x_buf, void* h_buf, void* dm_buf, void* dh_buf, void* vec_partial,
           void* w_partial, void* grads, long long rows, int c, int h, int row_blocks, int chunks,
           long long chunk_rows, void* stream) {
  if (c != C || h != H || rows < 0 || row_blocks <= 0 || chunks <= 0 || chunk_rows <= 0 ||
      chunk_rows % KB != 0 || chunk_rows * chunks < rows)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rows > 0) {
    constexpr size_t smem_rows = RowSmem<T>::total;
    err = cudaFuncSetAttribute(rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem_rows));
    if (err != cudaSuccess) return int(err);
    rows_kernel<T><<<unsigned(row_blocks), THREADS, smem_rows, st>>>(
        static_cast<const T*>(s), static_cast<const T*>(dout), static_cast<const float*>(g1),
        static_cast<const float*>(bl1), static_cast<const T*>(w1t),
        static_cast<const float*>(b1), static_cast<const T*>(w2t),
        static_cast<const float*>(b2), static_cast<const float*>(g2),
        static_cast<const float*>(bl2), static_cast<T*>(ds), static_cast<T*>(x_buf),
        static_cast<T*>(h_buf), static_cast<T*>(dm_buf), static_cast<T*>(dh_buf),
        static_cast<float*>(vec_partial), rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  constexpr size_t smem_w = WgradSmem<T>::total;
  err = cudaFuncSetAttribute(wgrad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem_w));
  if (err != cudaSuccess) return int(err);
  wgrad_kernel<T><<<dim3(TILES, unsigned(chunks), 2), THREADS, smem_w, st>>>(
      static_cast<const T*>(x_buf), static_cast<const T*>(h_buf), static_cast<const T*>(dm_buf),
      static_cast<const T*>(dh_buf), static_cast<float*>(w_partial), rows, chunk_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  reduce_kernel<<<(G_TOTAL + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      static_cast<const float*>(vec_partial), row_blocks * WARPS,
      static_cast<const float*>(w_partial), chunks, static_cast<float*>(grads));
  return int(cudaGetLastError());
}

}  // namespace

// s, dout, ds and the four row buffers x, dm [rows, C] and h, dh [rows, H] in
// the stream type; w1t = W1^T [HP, CP] and w2t = W2^T [CP, HP] in the stream
// type, zero-padded to multiples of 16 (as fused_mlp.cu's); LayerNorm
// parameters and biases f32.  c and h must be the compiled
// KERNEL_C and KERNEL_H.
// vec_partial: f32 [row_blocks * 8, fused_ln_mlp_ln_bwd_sizes()[0]], zeroed;
// w_partial: f32 [2, chunks, C * H]; grads: f32 [fused_ln_mlp_ln_bwd_sizes()[1]]
// (dg1, dbl1, dw1 [C, H], db1, dw2 [H, C], db2, dg2, dbl2).  chunk_rows is a
// multiple of fused_ln_mlp_ln_bwd_sizes()[2] and chunks * chunk_rows >= rows.
// Launches on `stream`, does not synchronise, allocates nothing.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int fused_ln_mlp_ln_bwd_bf16(
    const void* s, const void* dout, const void* g1, const void* bl1, const void* w1t,
    const void* b1, const void* w2t, const void* b2, const void* g2, const void* bl2, void* ds,
    void* x_buf, void* h_buf, void* dm_buf, void* dh_buf, void* vec_partial, void* w_partial,
    void* grads, long long rows, int c, int h, int row_blocks, int chunks, long long chunk_rows,
    void* stream) {
  return launch<__nv_bfloat16>(s, dout, g1, bl1, w1t, b1, w2t, b2, g2, bl2, ds, x_buf, h_buf,
                               dm_buf, dh_buf, vec_partial, w_partial, grads, rows, c, h,
                               row_blocks, chunks, chunk_rows, stream);
}

extern "C" int fused_ln_mlp_ln_bwd_f32(
    const void* s, const void* dout, const void* g1, const void* bl1, const void* w1t,
    const void* b1, const void* w2t, const void* b2, const void* g2, const void* bl2, void* ds,
    void* x_buf, void* h_buf, void* dm_buf, void* dh_buf, void* vec_partial, void* w_partial,
    void* grads, long long rows, int c, int h, int row_blocks, int chunks, long long chunk_rows,
    void* stream) {
  return launch<float>(s, dout, g1, bl1, w1t, b1, w2t, b2, g2, bl2, ds, x_buf, h_buf, dm_buf,
                       dh_buf, vec_partial, w_partial, grads, rows, c, h, row_blocks, chunks,
                       chunk_rows, stream);
}

// {floats a vector partial, floats of the gradient buffer, rows a slab,
//  output tiles of each weight gradient}.
extern "C" void fused_ln_mlp_ln_bwd_sizes(long long out[4]) {
  out[0] = NVEC;
  out[1] = G_TOTAL;
  out[2] = KB;
  out[3] = TILES;
}

extern "C" long long fused_ln_mlp_ln_bwd_smem_bytes(int bf16) {
  return bf16 ? (long long)RowSmem<__nv_bfloat16>::total : (long long)RowSmem<float>::total;
}

extern "C" int fused_ln_mlp_ln_bwd_stages_weights(int bf16) {
  return bf16 ? int(RowSmem<__nv_bfloat16>::kStage) : int(RowSmem<float>::kStage);
}
