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
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libfused_mlp.so fused_mlp.cu
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
constexpr int BM = 16;                    // rows per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = BM / WARPS; // LayerNorm rows owned by a warp
constexpr float EPS = 1e-5f;

// Padded leading dimensions (elements): a row shift of 16 bytes keeps the
// 8-row fragment loads off a single bank group.
constexpr int LDW1 = C + 8;  // W1^T in shared memory: [H][LDW1]
constexpr int LDW2 = H + 8;  // W2^T in shared memory: [C][LDW2]
constexpr int LDX = C + 8;   // rounded LN1 output:    [BM][LDX]
constexpr int LDH = H + 8;   // rounded hidden:        [BM][LDH]
constexpr int LDS = C + 4;   // f32 product stage:     [BM][LDS]

static_assert(C == 32 * 4, "one warp covers a row with 4 columns a lane");
static_assert(BM % WARPS == 0 && H % (16 * WARPS) == 0 && C == 16 * WARPS,
              "tile shapes must divide among the warps");

template <typename T>
struct Smem {
  static constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  static constexpr size_t w1 = kTensorCores ? size_t(H) * LDW1 * sizeof(T) : 0;
  static constexpr size_t w2 = kTensorCores ? size_t(C) * LDW2 * sizeof(T) : 0;
  static constexpr size_t x = size_t(BM) * LDX * sizeof(T);
  static constexpr size_t h = size_t(BM) * LDH * sizeof(T);
  static constexpr size_t stage = size_t(BM) * LDS * sizeof(float);
  static constexpr size_t total = w1 + w2 + x + h + stage;
};

static_assert(Smem<__nv_bfloat16>::total <= 232448, "bf16 tile exceeds 227 KB");
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

// LayerNorm of one C-wide row held by a warp, 4 columns per lane, in f32
// (two-pass variance, as the Pallas kernel's _ln_fwd).
__device__ __forceinline__ void layer_norm4(float v[4], const float g[4], const float b[4]) {
  const float mu = warp_sum(v[0] + v[1] + v[2] + v[3]) * (1.0f / C);
  float d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = v[i] - mu;
  const float var = warp_sum(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + d[3] * d[3]) * (1.0f / C);
  const float rstd = rsqrtf(var + EPS);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = d[i] * rstd * g[i] + b[i];
}

// The 4 columns this lane holds of the warp's rows of row tile `tile`
// (zeros past the end).
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ s, long long tile, int warp,
                                          int c0, long long rows, float v[ROWS_PER_WARP][4]) {
#pragma unroll
  for (int j = 0; j < ROWS_PER_WARP; ++j) {
    const long long row = tile * BM + warp * ROWS_PER_WARP + j;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[j][i] = 0.0f;
    if (row < rows) load4(s + row * C + c0, v[j]);
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
  const int c0 = lane * 4;

  if constexpr (S::kTensorCores) {
    // Stage W1^T [H][C] and W2^T [C][H] once per block, 16 bytes a thread.
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

  // This lane's columns of the LayerNorm parameters and of b2.
  float rg1[4], rbl1[4], rg2[4], rbl2[4], rb2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rg1[i] = g1[c0 + i];
    rbl1[i] = bl1[c0 + i];
    rg2[i] = g2[c0 + i];
    rbl2[i] = bl2[c0 + i];
    rb2[i] = b2[c0 + i];
  }

  const long long n_tiles = (rows + BM - 1) / BM;
  // This warp's rows of the next tile, loaded one tile ahead so that the
  // device-memory latency hides behind the current tile's products.
  float sr[ROWS_PER_WARP][4];
  load_rows(s, blockIdx.x, warp, c0, rows, sr);
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * BM;

    // ---- 1. LN1 in f32; x kept in registers for the residual, rounded
    //         copy to shared memory for fc1.  Rows past the end are zero.
    float xr[ROWS_PER_WARP][4];
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) xr[j][i] = sr[j][i];
    }
    load_rows(s, tile + gridDim.x, warp, c0, rows, sr);
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) {
      const int r = warp * ROWS_PER_WARP + j;
      if (row0 + r < rows) layer_norm4(xr[j], rg1, rbl1);  // uniform across the warp
      store4(xs + r * LDX + c0, xr[j]);
    }
    __syncthreads();

    // ---- 2. h = relu(x @ W1 + b1), rounded to T, into shared memory.
    if constexpr (S::kTensorCores) {
      constexpr int NT = H / 16 / WARPS;  // output column tiles per warp
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
          hs[r * LDH + n] = from_float<T>(fmaxf(scratch[e] + b1[n], 0.0f));
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
        for (int k = 0; k < C; ++k) acc = fmaf(float(xrow[k]), float(__ldg(wrow + k)), acc);
        hs[r * LDH + n] = from_float<T>(fmaxf(acc + b1[n], 0.0f));
      }
    }
    __syncthreads();

    // ---- 3. m = h @ W2 (b2 is added in the epilogue), f32 into the stage.
    if constexpr (S::kTensorCores) {
      const int n0 = warp * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0, acc1;
      wmma::fill_fragment(acc0, 0.0f);
      wmma::fill_fragment(acc1, 0.0f);
#pragma unroll
      for (int k = 0; k < H; k += 32) {  // two independent chains
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
        for (int k = 0; k < H; ++k) acc = fmaf(float(hrow[k]), float(__ldg(wrow + k)), acc);
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
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = xr[j][i] + (stage[r * LDS + c0 + i] + rb2[i]);
        layer_norm4(v, rg2, rbl2);
        store4(out + row * C + c0, v);
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
// Launches on `stream`, does not synchronise, allocates nothing.  Returns the
// cudaError_t of the launch (0 on success).
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
