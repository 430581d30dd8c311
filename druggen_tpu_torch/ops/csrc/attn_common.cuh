// Device helpers shared by the CUDA-core routes of the fused edge-attention
// kernels K5 (fused_attention.cu) and K6 (fused_attention_bwd.cu) and of the
// megablock kernels K7 (fused_block.cu) and K8 (fused_block_bwd.cu): the
// tile constants, the stream-type conversions and the 48 x 128 f32 FMA
// product tile.  Included by those four sources; the build hashes it with
// every source.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int RC = 48;   // rows of a product chunk: 6 a thread, 8 row groups
constexpr int RPT = 6;
constexpr int CT = 128;  // channels of a product tile: 4 a lane, 32 lanes
constexpr int KC = 32;   // depth of a staged chunk

constexpr size_t GEMM_SMEM = size_t(RC) * KC * 4 + size_t(KC) * CT * 4;

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

// acc[r][c] = sum_k A[row0 + ty + 8 r][k] * B[k][n0 + 4 tx + c] over k < K
// (f32 FMA in order of k), for the block's 48 x 128 tile; rows of A at or
// past m_rows read as zero.  A: [rows, lda] in TA (device or shared memory);
// B: [K, ldb] f32.  Starts and ends with the staging buffers free.
template <typename TA>
__device__ __forceinline__ void gemm_tile(const TA* A, int lda, long long row0, long long m_rows,
                                          const float* __restrict__ B, int ldb, int n0, int K,
                                          float* smem, float acc[RPT][4]) {
  float(*as)[KC] = reinterpret_cast<float(*)[KC]>(smem);
  float(*bs)[CT] = reinterpret_cast<float(*)[CT]>(smem + RC * KC);
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += KC) {
    for (int e = tid; e < RC * KC; e += THREADS) {
      const int r = e / KC, kk = e % KC;
      as[r][kk] = row0 + r < m_rows ? to_float(A[(row0 + r) * lda + k0 + kk]) : 0.0f;
    }
    for (int e = tid; e < KC * CT / 4; e += THREADS) {
      const int kk = e / (CT / 4), c4 = (e % (CT / 4)) * 4;
      *reinterpret_cast<float4*>(&bs[kk][c4]) =
          *reinterpret_cast<const float4*>(B + size_t(k0 + kk) * ldb + n0 + c4);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&bs[kk][4 * tx]);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float a = as[ty + 8 * r][kk];
        acc[r][0] = fmaf(a, b.x, acc[r][0]);
        acc[r][1] = fmaf(a, b.y, acc[r][1]);
        acc[r][2] = fmaf(a, b.z, acc[r][2]);
        acc[r][3] = fmaf(a, b.w, acc[r][3]);
      }
    }
    __syncthreads();
  }
}

}  // namespace
