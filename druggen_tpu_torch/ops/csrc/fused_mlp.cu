// Fused LN -> MLP -> residual -> LN row kernel (the edge-stream tail), forward.
//
// Replaces the TPU kernel druggen_tpu/ops/fused_mlp.py::_fwd_kernel.  Each
// row of the [rows, C] edge stream becomes
//
//     x   = LN1(s)                                  (f32)
//     h   = relu(round_T(x) @ W1 + b1)              (f32 accumulate)
//     m   = round_T(h) @ W2 + b2                    (f32 accumulate)
//     out = round_T(LN2(x + m))                     (residual on the f32 x)
//
// with the same rounding points as the Pallas kernel; eps 1e-5.
//
// What bounds it on an H100 SXM: at the serving shape (512 graphs of 45
// atoms, rows = 1,036,800, C = 128, H = 384) the kernel must read s once and
// write out once, 0.531 GB, i.e. 0.158 ms at 3.35 TB/s; its two products are
// 2 * 2 * rows * C * H = 203.9 GFLOP, i.e. 0.206 ms at 989 TFLOP/s in bf16.
// So it is bound by the tensor cores' operations, not by memory.
//
// What the design does about it: the 3C-wide hidden never leaves the chip
// (it lives in shared memory, 16 rows at a time), so device memory sees only
// s and out.  In bf16 the products run on the tensor cores (WMMA, bf16 in,
// f32 accumulate), and both weight matrices are staged once per block into
// shared memory (padded rows, no bank conflicts for the fragment loads);
// blocks are persistent (one per SM) and walk over row tiles, so the weights
// are read from device memory once per SM and not once per tile; each warp
// loads its rows of the next tile while the current one is multiplied.  The f32
// twin (off the serving path) keeps the weights in L2 and multiplies on the
// CUDA cores.  wgmma, TMA and a pipelined producer warp are later work.
//
// Ragged last tile: rows past the end are masked (zeros in, nothing stored).
//
// Widths.  C (the stream width) and H (the MLP hidden) are compile-time
// constants set by the build (-DKERNEL_C=... -DKERNEL_H=..., default 128 and
// 384); the wrapper builds one library for each width a run meets.  A row is
// held by one warp, VEC columns a lane at a time in NCH chunks; the products
// run on 16 x 16 WMMA tiles over C and H padded to multiples of 16 with zeros
// in shared memory.  The bf16 block stages both weights, so a width runs
// here only while Smem<bf16>::total fits one SM's 227 KB (232,448 bytes):
// 230,144 B at 128/384, 70,144 B at 64/192; for a wider width the wrapper
// raises, naming the limit (fused_ln_mlp_ln_fwd_smem_bytes below is what it
// reads).  The f32 twin stages no weights.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -DKERNEL_C=128 -DKERNEL_H=384 -o libfused_mlp.so fused_mlp.cu
// Plain C interface for ctypes; no PyTorch headers.

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
constexpr int CT = CP / 16;               // output column tiles
constexpr int NT1 = (HT + WARPS - 1) / WARPS;  // fc1 tiles a warp owns
constexpr int NT2 = (CT + WARPS - 1) / WARPS;  // fc2 tiles a warp owns
// Whether every lane's columns and every warp's tiles exist: then the
// guards below are compile-time constants (true at the published widths).
constexpr bool kFullRow = C == NCH * 32 * VEC;
constexpr bool kFullHT = HT % WARPS == 0;
constexpr bool kFullCT = CT % WARPS == 0;

// Padded leading dimensions (elements): a row shift of 16 bytes keeps the
// 8-row fragment loads off a single bank group.
constexpr int LDW1 = CP + 8;  // W1^T in shared memory: [HP][LDW1]
constexpr int LDW2 = HP + 8;  // W2^T in shared memory: [CP][LDW2]
constexpr int LDX = CP + 8;   // rounded LN1 output:    [BM][LDX]
constexpr int LDH = HP + 8;   // rounded hidden:        [BM][LDH]
constexpr int LDS = CP + 4;   // f32 product stage:     [BM][LDS]
constexpr int STAGE = BM * LDS > WARPS * 256 ? BM * LDS : WARPS * 256;  // floats

static_assert(C > 0 && H > 0 && BM % WARPS == 0, "tile shapes must divide among the warps");

template <typename T>
struct Smem {
  static constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  static constexpr size_t w1 = kTensorCores ? size_t(HP) * LDW1 * sizeof(T) : 0;
  static constexpr size_t w2 = kTensorCores ? size_t(CP) * LDW2 * sizeof(T) : 0;
  static constexpr size_t x = size_t(BM) * LDX * sizeof(T);
  static constexpr size_t h = size_t(BM) * LDH * sizeof(T);
  static constexpr size_t stage = size_t(STAGE) * sizeof(float);
  static constexpr size_t total = w1 + w2 + x + h + stage;
};

static_assert(Smem<__nv_bfloat16>::w1 % 128 == 0 && Smem<__nv_bfloat16>::w2 % 128 == 0 &&
              Smem<__nv_bfloat16>::x % 128 == 0 && Smem<__nv_bfloat16>::h % 128 == 0,
              "shared buffers must stay 128-byte aligned");
static_assert(Smem<float>::x % 128 == 0 && Smem<float>::h % 128 == 0,
              "shared buffers must stay 128-byte aligned");

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }  // the f32 twin's operands

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
__device__ __forceinline__ bool ct_ok(int tile) { return kFullCT || tile < CT; }

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

// The columns this lane holds of the warp's rows of row tile `tile`
// (zeros past the end of the rows and of the row).
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ s, long long tile, int warp,
                                          int lane, long long rows,
                                          float v[ROWS_PER_WARP][NCH][VEC]) {
#pragma unroll
  for (int j = 0; j < ROWS_PER_WARP; ++j) {
    const long long row = tile * BM + warp * ROWS_PER_WARP + j;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[j][ch][i] = 0.0f;
      if (row < rows && col_ok(ch, lane)) loadv(s + row * C + col_of(ch, lane), v[j][ch]);
    }
  }
}

// dst[r * ld + c] = src[r * C_SRC + c] for r < R_SRC, c < C_SRC; zeros for
// the padded rows r < R_DST and columns c < C_DST.  16-byte copies where the
// rows allow it.
template <int R_SRC, int C_SRC, int R_DST, int C_DST, int LD>
__device__ __forceinline__ void stage_padded(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                             int tid) {
  if constexpr (C_SRC % 8 == 0) {
    for (int i = tid; i < R_SRC * (C_SRC / 8); i += THREADS) {
      const int r = i / (C_SRC / 8), c = (i % (C_SRC / 8)) * 8;
      *reinterpret_cast<uint4*>(dst + r * LD + c) =
          *reinterpret_cast<const uint4*>(src + size_t(r) * C_SRC + c);
    }
  } else {
    for (int i = tid; i < R_SRC * C_SRC; i += THREADS)
      dst[(i / C_SRC) * LD + i % C_SRC] = src[i];
  }
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  if constexpr (C_DST > C_SRC) {
    for (int r = 0; r < R_DST; ++r)
      for (int c = C_SRC + tid; c < C_DST; c += THREADS) dst[r * LD + c] = zero;
  }
  if constexpr (R_DST > R_SRC) {
    for (int r = R_SRC; r < R_DST; ++r)
      for (int c = tid; c < C_SRC; c += THREADS) dst[r * LD + c] = zero;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_ln_mlp_ln_fwd_kernel(const T* __restrict__ s, const float* __restrict__ g1,
                           const float* __restrict__ bl1, const T* __restrict__ w1t,
                           const float* __restrict__ b1, const T* __restrict__ w2t,
                           const float* __restrict__ b2, const float* __restrict__ g2,
                           const float* __restrict__ bl2, T* __restrict__ out, long long rows) {
  using S = Smem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* w1s = reinterpret_cast<T*>(smem);
  T* w2s = reinterpret_cast<T*>(smem + S::w1);
  T* xs = reinterpret_cast<T*>(smem + S::w1 + S::w2);
  T* hs = reinterpret_cast<T*>(smem + S::w1 + S::w2 + S::x);
  float* stage = reinterpret_cast<float*>(smem + S::w1 + S::w2 + S::x + S::h);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if constexpr (S::kTensorCores) {
    // Stage W1^T [H][C] and W2^T [C][H] once per block, zero-padded to
    // [HP][CP] and [CP][HP].
    stage_padded<H, C, HP, CP, LDW1>(w1s, w1t, tid);
    stage_padded<C, H, CP, HP, LDW2>(w2s, w2t, tid);
  }
  // The padded columns of the rounded LN1 output stay zero (the products
  // read them against zero weights; uninitialised bits could be NaN).
  if constexpr (CP > C) {  // keep the guard (see fused_mlp_bwd.cu)
    for (int r = 0; r < BM; ++r)
      for (int c = C + tid; c < CP; c += THREADS) xs[r * LDX + c] = from_float<T>(0.0f);
  }

  // This lane's columns of the LayerNorm parameters and of b2.
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

  const long long n_tiles = (rows + BM - 1) / BM;
  // This warp's rows of the next tile, loaded one tile ahead so that the
  // device-memory latency hides behind the current tile's products.
  float sr[ROWS_PER_WARP][NCH][VEC];
  load_rows(s, blockIdx.x, warp, lane, rows, sr);
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * BM;

    // ---- 1. LN1 in f32; x kept in registers for the residual, rounded
    //         copy to shared memory for fc1.  Rows past the end are zero.
    float xr[ROWS_PER_WARP][NCH][VEC];
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j)
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int i = 0; i < VEC; ++i) xr[j][ch][i] = sr[j][ch][i];
    load_rows(s, tile + gridDim.x, warp, lane, rows, sr);
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) {
      const int r = warp * ROWS_PER_WARP + j;
      if (row0 + r < rows) layer_norm_row(xr[j], rg1, rbl1, lane);  // uniform across the warp
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
        if (col_ok(ch, lane)) storev(xs + r * LDX + col_of(ch, lane), xr[j][ch]);
    }
    __syncthreads();

    // ---- 2. h = relu(x @ W1 + b1), rounded to T, into shared memory
    //         (zero in the padded hidden columns).
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
            wmma::load_matrix_sync(b, w1s + n0 * LDW1 + k, LDW1);
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
          hs[r * LDH + n] = from_float<T>(HP == H || n < H ? fmaxf(scratch[e] + b1[n], 0.0f) : 0.0f);
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
        hs[r * LDH + n] = from_float<T>(fmaxf(acc + b1[n], 0.0f));
      }
    }
    __syncthreads();

    // ---- 3. m = h @ W2 (b2 is added in the epilogue), f32 into the stage.
    if constexpr (S::kTensorCores) {
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
          wmma::load_matrix_sync(b0, w2s + n0 * LDW2 + k, LDW2);
          wmma::load_matrix_sync(a1, hs + k + 16, LDH);
          wmma::load_matrix_sync(b1f, w2s + n0 * LDW2 + k + 16, LDW2);
          wmma::mma_sync(acc0, a0, b0, acc0);
          wmma::mma_sync(acc1, a1, b1f, acc1);
        }
        if constexpr (HP % 32 != 0) {  // the last 16 of the hidden
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a0;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b0;
          wmma::load_matrix_sync(a0, hs + HP - 16, LDH);
          wmma::load_matrix_sync(b0, w2s + n0 * LDW2 + HP - 16, LDW2);
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
        const T* wrow = w2t + size_t(n) * H;
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
      const long long row = row0 + r;
      if (row < rows) {  // uniform across the warp
        float v[NCH][VEC];
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const int c = col_of(ch, lane) + i;
            v[ch][i] = col_ok(ch, lane) ? xr[j][ch][i] + (stage[r * LDS + c] + rb2[ch][i]) : 0.0f;
          }
        layer_norm_row(v, rg2, rbl2, lane);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
          if (col_ok(ch, lane)) storev(out + row * C + col_of(ch, lane), v[ch]);
      }
    }
    // No barrier needed here: the next tile's first writes (xs, then the
    // stage and hs) all follow its own first __syncthreads.
  }
}

template <typename T>
int launch(const void* s, const void* g1, const void* bl1, const void* w1t, const void* b1,
           const void* w2t, const void* b2, const void* g2, const void* bl2, void* out,
           long long rows, int c, int h, int num_sms, void* stream) {
  if (c != C || h != H || num_sms <= 0 || rows < 0) return int(cudaErrorInvalidValue);
  if (rows == 0) return int(cudaSuccess);
  constexpr size_t smem = Smem<T>::total;
  cudaError_t err = cudaFuncSetAttribute(fused_ln_mlp_ln_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long n_tiles = (rows + BM - 1) / BM;
  // bf16: one persistent block per SM (its weights fill shared memory);
  // f32: a few smaller blocks per SM.
  const long long per_sm = Smem<T>::kTensorCores ? 1 : 4;
  const long long grid = n_tiles < num_sms * per_sm ? n_tiles : num_sms * per_sm;
  fused_ln_mlp_ln_fwd_kernel<T><<<unsigned(grid), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(s), static_cast<const float*>(g1), static_cast<const float*>(bl1),
      static_cast<const T*>(w1t), static_cast<const float*>(b1), static_cast<const T*>(w2t),
      static_cast<const float*>(b2), static_cast<const float*>(g2), static_cast<const float*>(bl2),
      static_cast<T*>(out), rows);
  return int(cudaGetLastError());
}

}  // namespace

// s, out: [rows, C] in the stream type; w1t: W1^T [H, C] and w2t: W2^T [C, H]
// in the stream type (nn.Linear layout); LayerNorm parameters and biases f32.
// c and h must be the compiled KERNEL_C and KERNEL_H.  Launches on `stream`,
// does not synchronise, allocates nothing.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int fused_ln_mlp_ln_fwd_bf16(const void* s, const void* g1, const void* bl1,
                                        const void* w1t, const void* b1, const void* w2t,
                                        const void* b2, const void* g2, const void* bl2,
                                        void* out, long long rows, int c, int h, int num_sms,
                                        void* stream) {
  return launch<__nv_bfloat16>(s, g1, bl1, w1t, b1, w2t, b2, g2, bl2, out, rows, c, h, num_sms,
                               stream);
}

extern "C" long long fused_ln_mlp_ln_fwd_smem_bytes(int bf16) {
  return bf16 ? (long long)Smem<__nv_bfloat16>::total : (long long)Smem<float>::total;
}

extern "C" int fused_ln_mlp_ln_fwd_f32(const void* s, const void* g1, const void* bl1,
                                       const void* w1t, const void* b1, const void* w2t,
                                       const void* b2, const void* g2, const void* bl2,
                                       void* out, long long rows, int c, int h, int num_sms,
                                       void* stream) {
  return launch<float>(s, g1, bl1, w1t, b1, w2t, b2, g2, bl2, out, rows, c, h, num_sms, stream);
}
