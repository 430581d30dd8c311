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
// with the same rounding points as the Pallas kernel; eps 1e-5.  The tile
// routine is tailk::tail_tile (tail_common.cuh), which K7 shares.
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
// f32 accumulate).  Blocks are persistent (one per SM in bf16) and walk over
// row tiles; each warp loads its rows of the next tile while the current one
// is multiplied.  Where both bf16 weights fit one SM's 227 KB beside the
// tile's buffers (Smem<bf16>::kStage: 230,144 B at 128/384, 70,144 B at
// 64/192) the block stages them once and reads every fragment from shared
// memory; at a wider width (128/512: 264,448 B; 256/768) the fragments are
// read from device memory, where the weights stay resident in L2, so every
// width runs.  The f32 twin keeps the weights in L2 and multiplies on the
// CUDA cores.  wgmma, TMA and a pipelined producer warp are later work.
//
// Ragged last tile: rows past the end are masked (zeros in, nothing stored).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -DKERNEL_C=128 -DKERNEL_H=384 -o libfused_mlp.so fused_mlp.cu
// Plain C interface for ctypes; no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tail_common.cuh"

namespace {

using namespace tailk;

template <typename T>
struct Smem {
  static constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  // stage both weights when they fit beside the tile's buffers
  static constexpr bool kStage = kTensorCores && STAGED_W + Bufs<T>::total <= SMEM_MAX;
  static constexpr size_t w = kStage ? STAGED_W : 0;
  static constexpr size_t total = w + Bufs<T>::total;
};

// The warp's rows of row tile `tile` (zeros past the end of the rows and of
// the row).
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_ln_mlp_ln_fwd_kernel(const T* __restrict__ s, const float* __restrict__ g1,
                           const float* __restrict__ bl1, const T* __restrict__ w1t,
                           const float* __restrict__ b1, const T* __restrict__ w2t,
                           const float* __restrict__ b2, const float* __restrict__ g2,
                           const float* __restrict__ bl2, T* __restrict__ out, long long rows) {
  using S = Smem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem + S::w);
  T* hs = reinterpret_cast<T*>(smem + S::w + Bufs<T>::x);
  float* stage = reinterpret_cast<float*>(smem + S::w + Bufs<T>::x + Bufs<T>::h);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // The weights: staged once per block, or read where they are (L2).
  T* w1s = reinterpret_cast<T*>(smem);
  T* w2s = reinterpret_cast<T*>(smem + size_t(HP) * LDW1 * sizeof(T));
  if constexpr (S::kStage) {
    stage_rows<HP, CP, LDW1>(w1s, w1t, tid);
    stage_rows<CP, HP, LDW2>(w2s, w2t, tid);
  }
  init_bufs(xs, tid);
  LaneParams p;
  load_lane_params(p, g1, bl1, b1, b2, g2, bl2, lane);

  const long long n_tiles = (rows + BM - 1) / BM;
  // This warp's rows of the next tile, loaded one tile ahead so that the
  // device-memory latency hides behind the current tile's products.
  float sr[ROWS_PER_WARP][NCH][VEC];
  load_rows(s, blockIdx.x, warp, lane, rows, sr);
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * BM;
    float xr[ROWS_PER_WARP][NCH][VEC];
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j)
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int i = 0; i < VEC; ++i) xr[j][ch][i] = sr[j][ch][i];
    load_rows(s, tile + gridDim.x, warp, lane, rows, sr);
    const long long left = rows - row0;
    const int valid = left < BM ? int(left) : BM;
    if constexpr (S::kStage)
      tail_tile<T, LDW1, LDW2>(xr, valid, p, w1s, w2s, xs, hs, stage, out + row0 * C);
    else
      tail_tile<T, CP, HP>(xr, valid, p, w1t, w2t, xs, hs, stage, out + row0 * C);
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
  // bf16 with staged weights: one persistent block per SM; otherwise a few
  // smaller blocks per SM.
  const long long per_sm = Smem<T>::kStage ? 1 : (Smem<T>::kTensorCores ? 2 : 4);
  const long long grid = n_tiles < num_sms * per_sm ? n_tiles : num_sms * per_sm;
  fused_ln_mlp_ln_fwd_kernel<T><<<unsigned(grid), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(s), static_cast<const float*>(g1), static_cast<const float*>(bl1),
      static_cast<const T*>(w1t), static_cast<const float*>(b1), static_cast<const T*>(w2t),
      static_cast<const float*>(b2), static_cast<const float*>(g2), static_cast<const float*>(bl2),
      static_cast<T*>(out), rows);
  return int(cudaGetLastError());
}

}  // namespace

// s, out: [rows, C] in the stream type; w1t: W1^T [HP, CP] and w2t: W2^T
// [CP, HP] in the stream type (nn.Linear layout, zero-padded to multiples of
// 16); LayerNorm parameters and biases f32.
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

extern "C" int fused_ln_mlp_ln_fwd_f32(const void* s, const void* g1, const void* bl1,
                                       const void* w1t, const void* b1, const void* w2t,
                                       const void* b2, const void* g2, const void* bl2,
                                       void* out, long long rows, int c, int h, int num_sms,
                                       void* stream) {
  return launch<float>(s, g1, bl1, w1t, b1, w2t, b2, g2, bl2, out, rows, c, h, num_sms, stream);
}

// Dynamic shared memory a block takes, and whether it stages the weights.
extern "C" long long fused_ln_mlp_ln_fwd_smem_bytes(int bf16) {
  return bf16 ? (long long)Smem<__nv_bfloat16>::total : (long long)Smem<float>::total;
}

extern "C" int fused_ln_mlp_ln_fwd_stages_weights(int bf16) {
  return bf16 ? int(Smem<__nv_bfloat16>::kStage) : int(Smem<float>::kStage);
}
