// Edge-modulated attention, the v2 op without projections, forward (K3).
//
// Replaces the TPU kernel druggen_tpu/ops/fused_attention.py::_fwd_kernel
// (called by _fwd_pallas).  For each graph b and query atom i, over the keys
// j < N and the D channels (heads x dk):
//
//     t[j]         = ((q[b,i] * k[b,j]) * inv_sqrt_dk) * (e[b,i,j] + 1) * e[b,i,j]
//     edge_pre[b,i,j] = round_T(t[j])
//     node[b,i]    = round_T(sum_j s[j] v[b,j]),  s = softmax over j of t, per channel
//
// all in f32 from the stream-type (T) inputs, with the Pallas kernel's order
// of operations (s = exp(t - max) / sum, then the weighted sum).
//
// What bounds it on an H100 SXM: at the training shape (512 graphs of 45
// atoms, D = 128, bf16) it must read e (0.265 GB) and write edge_pre (0.265
// GB) besides the small q, k, v and node: 0.53 GB, 0.16 ms at 3.35 TB/s; its
// ~10 operations an element are 1e-2 ms at the f32 rate.  So the bytes bound
// it.
//
// Design.  One warp per query row (b, i), eight a block; a lane owns four
// channels of each 128-channel chunk, so every load and store of an edge row
// is a 16-byte (f32) or 8-byte (bf16) vector and a warp moves whole rows.
// Three passes over the keys (the maximum with edge_pre stored, the sum of
// the exponentials, the weighted sum of v) recompute t from e instead of
// keeping it: the warp's e rows (N x 128 channels) stay in L1 and L2 between
// the passes, so device memory sees e once.  No shared memory, any N.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libfused_attention_v2.so fused_attention_v2.cu
// Plain C interface for ctypes; no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attn_common.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = THREADS / 32;   // one warp a query row

// t of four channels (the Pallas _fwd_kernel's order of operations).
__device__ __forceinline__ void modulate4(const float q[4], const float k[4], const float e[4],
                                          float inv_sqrt_dk, float t[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float base = (q[c] * k[c]) * inv_sqrt_dk;
    t[c] = (base * (e[c] + 1.0f)) * e[c];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_v2_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ e, T* __restrict__ edge_pre, T* __restrict__ node,
                   long long rows, int n, int d, float inv_sqrt_dk) {
  const long long g = blockIdx.x * (long long)ROWS_PER_BLOCK + (threadIdx.x >> 5);  // b * n + i
  if (g >= rows) return;                      // uniform across the warp
  const int lane = threadIdx.x & 31;
  const long long b = g / n;
  const T* kb = k + b * n * d;
  const T* vb = v + b * n * d;
  const T* eg = e + g * n * d;                // rows (b, i, j)
  T* out = edge_pre + g * n * d;
  for (int c0 = 4 * lane; c0 < d; c0 += CT) {
    float qv[4], kv[4], ev[4], tv[4];
    load4(q + g * d + c0, qv);
    float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    for (int j = 0; j < n; ++j) {
      load4(kb + size_t(j) * d + c0, kv);
      load4(eg + size_t(j) * d + c0, ev);
      modulate4(qv, kv, ev, inv_sqrt_dk, tv);
      store4(out + size_t(j) * d + c0, tv);
#pragma unroll
      for (int c = 0; c < 4; ++c) m[c] = fmaxf(m[c], tv[c]);
    }
    float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = 0; j < n; ++j) {
      load4(kb + size_t(j) * d + c0, kv);
      load4(eg + size_t(j) * d + c0, ev);
      modulate4(qv, kv, ev, inv_sqrt_dk, tv);
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[c] += expf(tv[c] - m[c]);
    }
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, vv[4];
    for (int j = 0; j < n; ++j) {
      load4(kb + size_t(j) * d + c0, kv);
      load4(eg + size_t(j) * d + c0, ev);
      load4(vb + size_t(j) * d + c0, vv);
      modulate4(qv, kv, ev, inv_sqrt_dk, tv);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = fmaf(expf(tv[c] - m[c]) / sum[c], vv[c], acc[c]);
    }
    store4(node + g * d + c0, acc);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* e, void* edge_pre, void* node,
           long long batch, int n, int d, float inv_sqrt_dk, void* stream) {
  if (batch < 0 || n <= 0 || d <= 0 || d % CT != 0) return int(cudaErrorInvalidValue);
  if (batch == 0) return int(cudaSuccess);
  const long long rows = batch * n;
  const long long blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  attn_v2_fwd_kernel<T><<<unsigned(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(e), static_cast<T*>(edge_pre), static_cast<T*>(node), rows, n, d,
      inv_sqrt_dk);
  return int(cudaGetLastError());
}

}  // namespace

// q, k, v, node: [batch, n, d]; e, edge_pre: [batch, n, n, d]; all in the
// stream type.  d a multiple of 128.  Launches on `stream`, does not
// synchronise, allocates nothing.  Returns the cudaError_t of the launch.
extern "C" int edge_attention_v2_fwd_bf16(const void* q, const void* k, const void* v,
                                          const void* e, void* edge_pre, void* node,
                                          long long batch, int n, int d, float inv_sqrt_dk,
                                          void* stream) {
  return launch<__nv_bfloat16>(q, k, v, e, edge_pre, node, batch, n, d, inv_sqrt_dk, stream);
}

extern "C" int edge_attention_v2_fwd_f32(const void* q, const void* k, const void* v,
                                         const void* e, void* edge_pre, void* node,
                                         long long batch, int n, int d, float inv_sqrt_dk,
                                         void* stream) {
  return launch<float>(q, k, v, e, edge_pre, node, batch, n, d, inv_sqrt_dk, stream);
}
