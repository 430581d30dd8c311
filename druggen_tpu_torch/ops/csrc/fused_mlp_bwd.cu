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
// The f32 twin (off the training path) multiplies on the CUDA cores with the
// weights read through L2, like K1's; the backward products read W1^T and
// W2^T by column, so the interface takes each weight in one orientation.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libfused_mlp_bwd.so fused_mlp_bwd.cu
// Plain C interface for ctypes; no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int C = 128;                    // stream width (dim)
constexpr int H = 384;                    // MLP hidden (3 * dim)
constexpr int BM = 16;                    // rows per tile of the rows pass
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = BM / WARPS; // LayerNorm rows owned by a warp
constexpr float EPS = 1e-5f;

// Padded leading dimensions (elements), as in fused_mlp.cu.
constexpr int LDW1 = C + 8;  // W1^T in shared memory: [H][LDW1]
constexpr int LDW2 = H + 8;  // W2^T in shared memory: [C][LDW2]
constexpr int LDX = C + 8;   // rounded x, then rounded dm:  [BM][LDX]
constexpr int LDH = H + 8;   // rounded h, then rounded dh:  [BM][LDH]
constexpr int LDS = C + 4;   // f32 product stage:           [BM][LDS]

// One vector partial: dg1, dbl1, db1, db2, dg2, dbl2.
constexpr int OFF_DG1 = 0, OFF_DBL1 = C, OFF_DB1 = 2 * C, OFF_DB2 = 2 * C + H,
              OFF_DG2 = 3 * C + H, OFF_DBL2 = 4 * C + H, NVEC = 5 * C + H;
// The gradient buffer, in the order of the Pallas kernel's outputs:
// dg1[C] dbl1[C] dw1[C,H] db1[H] dw2[H,C] db2[C] dg2[C] dbl2[C].
constexpr int G_DG1 = 0, G_DBL1 = C, G_DW1 = 2 * C, G_DB1 = 2 * C + C * H,
              G_DW2 = G_DB1 + H, G_DB2 = G_DW2 + H * C, G_DG2 = G_DB2 + C,
              G_DBL2 = G_DG2 + C, G_TOTAL = G_DBL2 + C;

// wgrad: 128 x 128 output tiles, 64-row slabs.
constexpr int TILE = 128;
constexpr int KB = 64;

static_assert(C == 32 * 4, "one warp covers a row with 4 columns a lane");
static_assert(BM % WARPS == 0 && H % (16 * WARPS) == 0 && C == 16 * WARPS,
              "tile shapes must divide among the warps");
static_assert(C == TILE && H % TILE == 0, "weight gradients split into 128 x 128 tiles");

template <typename T>
struct RowSmem {
  static constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  static constexpr size_t w1 = kTensorCores ? size_t(H) * LDW1 * sizeof(T) : 0;
  static constexpr size_t w2 = kTensorCores ? size_t(C) * LDW2 * sizeof(T) : 0;
  static constexpr size_t x = size_t(BM) * LDX * sizeof(T);
  static constexpr size_t h = size_t(BM) * LDH * sizeof(T);
  static constexpr size_t stage = size_t(BM) * LDS * sizeof(float);
  static constexpr size_t total = w1 + w2 + x + h + stage;
};

static_assert(RowSmem<__nv_bfloat16>::total <= 232448, "bf16 tile exceeds 227 KB");
static_assert(RowSmem<__nv_bfloat16>::w1 % 128 == 0 && RowSmem<__nv_bfloat16>::w2 % 128 == 0 &&
              RowSmem<__nv_bfloat16>::x % 128 == 0 && RowSmem<__nv_bfloat16>::h % 128 == 0,
              "shared buffers must stay 128-byte aligned");
static_assert(RowSmem<float>::x % 128 == 0 && RowSmem<float>::h % 128 == 0,
              "shared buffers must stay 128-byte aligned");

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

// Four consecutive elements <-> four floats.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&a);
  t.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm statistics of one C-wide row held by a warp, 4 columns a lane,
// in f32 (two-pass variance, as the Pallas kernel's _ln_fwd): xhat and rstd.
__device__ __forceinline__ float ln_stats(const float v[4], float xhat[4]) {
  const float mu = warp_sum(v[0] + v[1] + v[2] + v[3]) * (1.0f / C);
  float d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = v[i] - mu;
  const float var = warp_sum(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + d[3] * d[3]) * (1.0f / C);
  const float rstd = rsqrtf(var + EPS);
#pragma unroll
  for (int i = 0; i < 4; ++i) xhat[i] = d[i] * rstd;
  return rstd;
}

// d(input) of y = gamma * xhat + beta given the upstream dy (the Pallas
// kernel's _ln_bwd_input).
__device__ __forceinline__ void ln_bwd(const float dy[4], const float xhat[4], float rstd,
                                       const float g[4], float dx[4]) {
  float dxh[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) dxh[i] = dy[i] * g[i];
  const float m1 = warp_sum(dxh[0] + dxh[1] + dxh[2] + dxh[3]) * (1.0f / C);
  const float m2 = warp_sum(dxh[0] * xhat[0] + dxh[1] * xhat[1] + dxh[2] * xhat[2] +
                            dxh[3] * xhat[3]) * (1.0f / C);
#pragma unroll
  for (int i = 0; i < 4; ++i) dx[i] = (dxh[i] - m1 - xhat[i] * m2) * rstd;
}

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
  T* w1s = reinterpret_cast<T*>(smem);
  T* w2s = reinterpret_cast<T*>(smem + S::w1);
  T* xs = reinterpret_cast<T*>(smem + S::w1 + S::w2);          // x, then dm
  T* hs = reinterpret_cast<T*>(smem + S::w1 + S::w2 + S::x);   // h, then dh
  float* stage = reinterpret_cast<float*>(smem + S::w1 + S::w2 + S::x + S::h);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c0 = lane * 4;
  constexpr int NT = H / 16 / WARPS;  // hidden column tiles a warp owns

  if constexpr (S::kTensorCores) {
    for (int i = tid; i < H * (C / 8); i += THREADS) {
      const int r = i / (C / 8), c = (i % (C / 8)) * 8;
      *reinterpret_cast<uint4*>(w1s + r * LDW1 + c) =
          *reinterpret_cast<const uint4*>(w1t + size_t(r) * C + c);
    }
    for (int i = tid; i < C * (H / 8); i += THREADS) {
      const int r = i / (H / 8), c = (i % (H / 8)) * 8;
      *reinterpret_cast<uint4*>(w2s + r * LDW2 + c) =
          *reinterpret_cast<const uint4*>(w2t + size_t(r) * H + c);
    }
  }

  float rg1[4], rbl1[4], rg2[4], rbl2[4], rb2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rg1[i] = g1[c0 + i];
    rbl1[i] = bl1[c0 + i];
    rg2[i] = g2[c0 + i];
    rbl2[i] = bl2[c0 + i];
    rb2[i] = b2[c0 + i];
  }
  // This lane's sums over the warp's rows of every tile it visits.
  float a_dg1[4] = {}, a_dbl1[4] = {}, a_db2[4] = {}, a_dg2[4] = {}, a_dbl2[4] = {};
  // db1: tensor-core path, column (warp + t * WARPS) * 16 + (lane & 15) over
  // the rows of parity lane >> 4; CUDA-core path, columns tid and tid + 256.
  float a_db1[NT] = {};

  const long long n_tiles = (rows + BM - 1) / BM;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * BM;

    // ---- 1. x = LN1(s) in f32; rounded x to shared memory and to x_out.
    float xv[ROWS_PER_WARP][4], xh1[ROWS_PER_WARP][4], rstd1[ROWS_PER_WARP];
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) {
      const int r = warp * ROWS_PER_WARP + j;
      const long long row = row0 + r;
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[j][i] = xh1[j][i] = 0.0f;
      rstd1[j] = 0.0f;
      if (row < rows) {  // uniform across the warp
        float v[4];
        load4(s + row * C + c0, v);
        rstd1[j] = ln_stats(v, xh1[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[j][i] = xh1[j][i] * rg1[i] + rbl1[i];
        store4(x_out + row * C + c0, xv[j]);
      }
      store4(xs + r * LDX + c0, xv[j]);
    }
    __syncthreads();

    // ---- 2. h = relu(round(x) @ W1 + b1), rounded, to shared memory and h_out.
    if constexpr (S::kTensorCores) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) wmma::fill_fragment(acc[t], 0.0f);
#pragma unroll
      for (int k = 0; k < C; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, xs + k, LDX);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int n0 = (warp + t * WARPS) * 16;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
          wmma::load_matrix_sync(b, w1s + n0 * LDW1 + k, LDW1);
          wmma::mma_sync(acc[t], a, b, acc[t]);
        }
      }
      float* scratch = stage + warp * 256;  // this warp's 16x16 f32 tile
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int n0 = (warp + t * WARPS) * 16;
        wmma::store_matrix_sync(scratch, acc[t], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = e >> 4, n = n0 + (e & 15);
          const T hv = from_float<T>(fmaxf(scratch[e] + b1[n], 0.0f));
          hs[r * LDH + n] = hv;
          if (row0 + r < rows) h_out[(row0 + r) * H + n] = hv;
        }
        __syncwarp();
      }
    } else {
      for (int e = tid; e < BM * H; e += THREADS) {
        const int r = e / H, n = e % H;
        const T* xrow = xs + r * LDX;
        const T* wrow = w1t + size_t(n) * C;
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
      const int n0 = warp * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0, acc1;
      wmma::fill_fragment(acc0, 0.0f);
      wmma::fill_fragment(acc1, 0.0f);
#pragma unroll
      for (int k = 0; k < H; k += 32) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a0, a1;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b0, b1f;
        wmma::load_matrix_sync(a0, hs + k, LDH);
        wmma::load_matrix_sync(b0, w2s + n0 * LDW2 + k, LDW2);
        wmma::load_matrix_sync(a1, hs + k + 16, LDH);
        wmma::load_matrix_sync(b1f, w2s + n0 * LDW2 + k + 16, LDW2);
        wmma::mma_sync(acc0, a0, b0, acc0);
        wmma::mma_sync(acc1, a1, b1f, acc1);
      }
#pragma unroll
      for (int i = 0; i < acc0.num_elements; ++i) acc0.x[i] += acc1.x[i];
      wmma::store_matrix_sync(stage + n0, acc0, LDS, wmma::mem_row_major);
    } else {
      for (int e = tid; e < BM * C; e += THREADS) {
        const int r = e / C, n = e % C;
        const T* hrow = hs + r * LDH;
        const T* wrow = w2t + size_t(n) * H;
        float acc = 0.0f;
#pragma unroll 8
        for (int k = 0; k < H; ++k) acc = fmaf(to_float(hrow[k]), to_float(__ldg(wrow + k)), acc);
        stage[r * LDS + n] = acc;
      }
    }
    __syncthreads();

    // ---- 4. r = x + (m + b2); dr = LN2'(dout); rounded dm (= dr) over x in
    //         shared memory (x is dead after step 2) and to dm_out.
    float dr[ROWS_PER_WARP][4];
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) {
      const int r = warp * ROWS_PER_WARP + j;
      const long long row = row0 + r;
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[j][i] = 0.0f;
      if (row < rows) {  // uniform across the warp
        float rv[4], rhat[4], go[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) rv[i] = xv[j][i] + (stage[r * LDS + c0 + i] + rb2[i]);
        const float rstd2 = ln_stats(rv, rhat);
        load4(dout + row * C + c0, go);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a_dg2[i] += go[i] * rhat[i];
          a_dbl2[i] += go[i];
        }
        ln_bwd(go, rhat, rstd2, rg2, dr[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) a_db2[i] += dr[j][i];
        store4(dm_out + row * C + c0, dr[j]);
      }
      store4(xs + r * LDX + c0, dr[j]);
    }
    __syncthreads();

    // ---- 5. dh = (round(dm) @ W2^T) * (h > 0), rounded, over h in shared
    //         memory and to dh_out; db1 sums the f32 dh.
    if constexpr (S::kTensorCores) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) wmma::fill_fragment(acc[t], 0.0f);
#pragma unroll
      for (int k = 0; k < C; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, xs + k, LDX);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int n0 = (warp + t * WARPS) * 16;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, w2s + k * LDW2 + n0, LDW2);
          wmma::mma_sync(acc[t], a, b, acc[t]);
        }
      }
      float* scratch = stage + warp * 256;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int n0 = (warp + t * WARPS) * 16;
        wmma::store_matrix_sync(scratch, acc[t], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = e >> 4, n = n0 + (e & 15);
          const float dh = to_float(hs[r * LDH + n]) > 0.0f ? scratch[e] : 0.0f;
          const T dhv = from_float<T>(dh);
          hs[r * LDH + n] = dhv;
          if (row0 + r < rows) {
            a_db1[t] += dh;
            dh_out[(row0 + r) * H + n] = dhv;
          }
        }
        __syncwarp();
      }
    } else {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = tid + q * THREADS;
        if (n < H) {
          const T* wcol = w2t + n;  // W2[n, k] = W2^T[k, n]
          for (int r = 0; r < BM; ++r) {
            const T* mrow = xs + r * LDX;
            float acc = 0.0f;
#pragma unroll 8
            for (int k = 0; k < C; ++k)
              acc = fmaf(to_float(mrow[k]), to_float(__ldg(wcol + size_t(k) * H)), acc);
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
      const int n0 = warp * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0, acc1;
      wmma::fill_fragment(acc0, 0.0f);
      wmma::fill_fragment(acc1, 0.0f);
#pragma unroll
      for (int k = 0; k < H; k += 32) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a0, a1;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b0, b1f;
        wmma::load_matrix_sync(a0, hs + k, LDH);
        wmma::load_matrix_sync(b0, w1s + k * LDW1 + n0, LDW1);
        wmma::load_matrix_sync(a1, hs + k + 16, LDH);
        wmma::load_matrix_sync(b1f, w1s + (k + 16) * LDW1 + n0, LDW1);
        wmma::mma_sync(acc0, a0, b0, acc0);
        wmma::mma_sync(acc1, a1, b1f, acc1);
      }
#pragma unroll
      for (int i = 0; i < acc0.num_elements; ++i) acc0.x[i] += acc1.x[i];
      wmma::store_matrix_sync(stage + n0, acc0, LDS, wmma::mem_row_major);
    } else {
      for (int e = tid; e < BM * C; e += THREADS) {
        const int r = e / C, n = e % C;
        const T* hrow = hs + r * LDH;
        const T* wcol = w1t + n;  // W1[n, k] = W1^T[k, n]
        float acc = 0.0f;
#pragma unroll 8
        for (int k = 0; k < H; ++k)
          acc = fmaf(to_float(hrow[k]), to_float(__ldg(wcol + size_t(k) * C)), acc);
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
        float dx[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dx[i] = dr[j][i] + stage[r * LDS + c0 + i];
          a_dg1[i] += dx[i] * xh1[j][i];
          a_dbl1[i] += dx[i];
        }
        ln_bwd(dx, xh1[j], rstd1[j], rg1, dsv);
        store4(ds + row * C + c0, dsv);
      }
    }
    // No barrier needed here: the next tile's first writes (x over dm, then
    // the stage and h) all follow barriers that come after the last reads.
  }

  // ---- this warp's vector partial (the buffer is zeroed by the caller; each
  //      db1 column is written by exactly one warp of the block).
  float* vp = vec_partial + (size_t(blockIdx.x) * WARPS + warp) * NVEC;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    vp[OFF_DG1 + c0 + i] = a_dg1[i];
    vp[OFF_DBL1 + c0 + i] = a_dbl1[i];
    vp[OFF_DB2 + c0 + i] = a_db2[i];
    vp[OFF_DG2 + c0 + i] = a_dg2[i];
    vp[OFF_DBL2 + c0 + i] = a_dbl2[i];
  }
  if constexpr (S::kTensorCores) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float v = a_db1[t] + __shfl_xor_sync(0xffffffffu, a_db1[t], 16);
      if (lane < 16) vp[OFF_DB1 + (warp + t * WARPS) * 16 + lane] = v;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
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

// One KB x 128 slab of columns [col0, col0 + 128) of `src` [rows, ld]:
// rows [r0, r0 + KB) of the chunk, zeros past `r_end`.
template <typename T>
__device__ __forceinline__ void load_slab(T* dst, const T* __restrict__ src, int ld, int col0,
                                          long long r0, long long r_end, int tid) {
  constexpr int VEC = 16 / sizeof(T);  // elements a 16-byte load
  constexpr int PER_ROW = TILE / VEC;
  for (int i = tid; i < KB * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < r_end) v = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + col0 + c);
    *reinterpret_cast<uint4*>(dst + r * LDK + c) = v;
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
  const int tm = z == 0 ? 0 : blockIdx.x;
  const int tn = z == 0 ? blockIdx.x : 0;
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
#pragma unroll
    for (int f = 0; f < TILE / 16; ++f) {
      wmma::store_matrix_sync(out + size_t(tm * TILE + warp * 16) * n_dim + tn * TILE + f * 16,
                              acc[f], n_dim, wmma::mem_row_major);
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
      float* o = out + size_t(tm * TILE + ty * 8 + i) * n_dim + tn * TILE + tx * 8;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) o[jj] = acc[i][jj];
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
  wgrad_kernel<T><<<dim3(H / TILE, unsigned(chunks), 2), THREADS, smem_w, st>>>(
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
// the stream type; w1t = W1^T [H, C] and w2t = W2^T [C, H] in the stream
// type; LayerNorm parameters and biases f32.
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

// {floats a vector partial, floats of the gradient buffer, rows a slab}.
extern "C" void fused_ln_mlp_ln_bwd_sizes(long long out[3]) {
  out[0] = NVEC;
  out[1] = G_TOTAL;
  out[2] = KB;
}

extern "C" long long fused_ln_mlp_ln_bwd_smem_bytes(int bf16) {
  return bf16 ? (long long)RowSmem<__nv_bfloat16>::total : (long long)RowSmem<float>::total;
}
