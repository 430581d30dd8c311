// Edge-modulated attention, the v2 op without projections, backward (K4).
//
// Replaces the TPU kernel druggen_tpu/ops/fused_attention.py::_bwd_kernel
// (called by _bwd_pallas).  Given the forward's inputs and the cotangents
// ge (of edge_pre) and gn (of node_agg), it recomputes, in f32 from the
// stream-type (T) inputs,
//
//     base = (q_i k_j) inv_sqrt_dk, mod = (e + 1) e, t = base mod,
//     s = softmax over j of t (per channel), ds_in = gn_i v_j,
//     dot_i = sum_j s ds_in, dt = ge + s (ds_in - dot_i), dbase = dt mod,
//
// and returns, rounded to T,
//
//     de = (dt base)(2 e + 1),  dq_i = (sum_j dbase k_j) inv_sqrt_dk,
//     dk_j = (sum_i dbase q_i) inv_sqrt_dk,  dv_j = sum_i s gn_i.
//
// What bounds it on an H100 SXM: at the training shape (512 graphs of 45
// atoms, D = 128, bf16) it must read e and ge and write de, three edge-sized
// tensors of 0.265 GB, besides the node-sized ones: 0.80 GB, 0.24 ms at
// 3.35 TB/s; its ~30 operations an element are ~0.03 ms at the f32 rate.
// So the bytes bound it.
//
// Why this design.  dq and de are sums over the keys j of one query row;
// dk and dv are sums over the query rows i of one key.  On the TPU the grid
// runs in order on one core and the Pallas kernel reduces both within one
// graph's block.  Here two launches, each a warp per row and eight a block
// (a lane owns four channels of each 128-channel chunk), with no float
// atomics (the same inputs give the same bits on every run):
//
//   1. rows  a warp per query row (b, i): the softmax's max, sum and dot_i
//            over j, then de (stored) and dq; the three statistics per
//            channel go to an f32 scratch [3, B N, D].
//   2. cols  a warp per key row (b, j): over i, s and dt again from the
//            statistics (the same operations, so the same bits), dk and dv.
//
// Device memory sees e and ge twice (once a launch) and writes de once:
// ~1.7x the bytes of the bound, the price of no atomics and no per-graph
// buffer in shared memory.  Any N.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libfused_attention_v2_bwd.so fused_attention_v2_bwd.cu
// Plain C interface for ctypes; no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attn_common.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = THREADS / 32;   // one warp a row

// base and mod of four channels.
__device__ __forceinline__ void base_mod4(const float q[4], const float k[4], const float e[4],
                                          float inv_sqrt_dk, float base[4], float mod[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    base[c] = (q[c] * k[c]) * inv_sqrt_dk;
    mod[c] = (e[c] + 1.0f) * e[c];
  }
}

// ---------------------------------------------------------------------------
// 1. rows: a warp per query row g = b * n + i.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_v2_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ e, const T* __restrict__ ge,
                        const T* __restrict__ gn, T* __restrict__ dq, T* __restrict__ de,
                        float* __restrict__ stats, long long rows, int n, int d,
                        float inv_sqrt_dk) {
  const long long g = blockIdx.x * (long long)ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (g >= rows) return;                      // uniform across the warp
  const int lane = threadIdx.x & 31;
  const long long b = g / n;
  const T* kb = k + b * n * d;
  const T* vb = v + b * n * d;
  const T* eg = e + g * n * d;
  const T* geg = ge + g * n * d;
  T* deg = de + g * n * d;
  for (int c0 = 4 * lane; c0 < d; c0 += CT) {
    float qv[4], gv[4], kv[4], ev[4], vv[4], base[4], mod[4];
    load4(q + g * d + c0, qv);
    load4(gn + g * d + c0, gv);
    float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    for (int j = 0; j < n; ++j) {
      load4(kb + size_t(j) * d + c0, kv);
      load4(eg + size_t(j) * d + c0, ev);
      base_mod4(qv, kv, ev, inv_sqrt_dk, base, mod);
#pragma unroll
      for (int c = 0; c < 4; ++c) m[c] = fmaxf(m[c], base[c] * mod[c]);
    }
    float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = 0; j < n; ++j) {
      load4(kb + size_t(j) * d + c0, kv);
      load4(eg + size_t(j) * d + c0, ev);
      base_mod4(qv, kv, ev, inv_sqrt_dk, base, mod);
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[c] += expf(base[c] * mod[c] - m[c]);
    }
    float dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = 0; j < n; ++j) {
      load4(kb + size_t(j) * d + c0, kv);
      load4(eg + size_t(j) * d + c0, ev);
      load4(vb + size_t(j) * d + c0, vv);
      base_mod4(qv, kv, ev, inv_sqrt_dk, base, mod);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float s = expf(base[c] * mod[c] - m[c]) / sum[c];
        dot[c] = fmaf(s, gv[c] * vv[c], dot[c]);
      }
    }
    float dqv[4] = {0.0f, 0.0f, 0.0f, 0.0f}, gev[4], dev[4];
    for (int j = 0; j < n; ++j) {
      load4(kb + size_t(j) * d + c0, kv);
      load4(eg + size_t(j) * d + c0, ev);
      load4(vb + size_t(j) * d + c0, vv);
      load4(geg + size_t(j) * d + c0, gev);
      base_mod4(qv, kv, ev, inv_sqrt_dk, base, mod);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float s = expf(base[c] * mod[c] - m[c]) / sum[c];
        const float dt = gev[c] + s * (gv[c] * vv[c] - dot[c]);
        dev[c] = (dt * base[c]) * (2.0f * ev[c] + 1.0f);
        dqv[c] = fmaf(dt * mod[c], kv[c], dqv[c]);
      }
      store4(deg + size_t(j) * d + c0, dev);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) dqv[c] *= inv_sqrt_dk;
    store4(dq + g * d + c0, dqv);
    store4(stats + g * d + c0, m);
    store4(stats + (rows + g) * d + c0, sum);
    store4(stats + (2 * rows + g) * d + c0, dot);
  }
}

// ---------------------------------------------------------------------------
// 2. cols: a warp per key row h = b * n + j; sums over the query rows i.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_v2_bwd_cols_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ e, const T* __restrict__ ge,
                        const T* __restrict__ gn, const float* __restrict__ stats,
                        T* __restrict__ dk, T* __restrict__ dv, long long rows, int n, int d,
                        float inv_sqrt_dk) {
  const long long h = blockIdx.x * (long long)ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (h >= rows) return;                      // uniform across the warp
  const int lane = threadIdx.x & 31;
  const long long b = h / n;
  const int j = int(h % n);
  for (int c0 = 4 * lane; c0 < d; c0 += CT) {
    float kv[4], vv[4], qv[4], gv[4], ev[4], gev[4], m[4], sum[4], dot[4], base[4], mod[4];
    load4(k + h * d + c0, kv);
    load4(v + h * d + c0, vv);
    float dkv[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dvv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = 0; i < n; ++i) {
      const long long g = b * n + i;          // query row (b, i)
      const long long er = g * n + j;         // edge row (b, i, j)
      load4(q + g * d + c0, qv);
      load4(gn + g * d + c0, gv);
      load4(e + er * d + c0, ev);
      load4(ge + er * d + c0, gev);
      load4(stats + g * d + c0, m);
      load4(stats + (rows + g) * d + c0, sum);
      load4(stats + (2 * rows + g) * d + c0, dot);
      base_mod4(qv, kv, ev, inv_sqrt_dk, base, mod);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float s = expf(base[c] * mod[c] - m[c]) / sum[c];
        const float dt = gev[c] + s * (gv[c] * vv[c] - dot[c]);
        dkv[c] = fmaf(dt * mod[c], qv[c], dkv[c]);
        dvv[c] = fmaf(s, gv[c], dvv[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) dkv[c] *= inv_sqrt_dk;
    store4(dk + h * d + c0, dkv);
    store4(dv + h * d + c0, dvv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* e, const void* ge,
           const void* gn, void* dq, void* dk, void* dv, void* de, void* stats, long long batch,
           int n, int d, float inv_sqrt_dk, void* stream) {
  if (batch < 0 || n <= 0 || d <= 0 || d % CT != 0) return int(cudaErrorInvalidValue);
  if (batch == 0) return int(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = batch * n;
  const unsigned blocks = unsigned((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  attn_v2_bwd_rows_kernel<T><<<blocks, THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(e), static_cast<const T*>(ge), static_cast<const T*>(gn),
      static_cast<T*>(dq), static_cast<T*>(de), static_cast<float*>(stats), rows, n, d,
      inv_sqrt_dk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  attn_v2_bwd_cols_kernel<T><<<blocks, THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(e), static_cast<const T*>(ge), static_cast<const T*>(gn),
      static_cast<const float*>(stats), static_cast<T*>(dk), static_cast<T*>(dv), rows, n, d,
      inv_sqrt_dk);
  return int(cudaGetLastError());
}

}  // namespace

// q, k, v, gn, dq, dk, dv: [batch, n, d]; e, ge, de: [batch, n, n, d]; all
// in the stream type.  stats: f32 scratch [3, batch * n, d].  d a multiple
// of 128.  Launches two kernels on `stream`, does not synchronise, allocates
// nothing.  Returns the first cudaError_t of the launches (0 on success).
#define EDGE_ATTENTION_V2_BWD(NAME, TYPE)                                                       \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* e,               \
                      const void* ge, const void* gn, void* dq, void* dk, void* dv, void* de,   \
                      void* stats, long long batch, int n, int d, float inv_sqrt_dk,            \
                      void* stream) {                                                           \
    return launch<TYPE>(q, k, v, e, ge, gn, dq, dk, dv, de, stats, batch, n, d, inv_sqrt_dk,    \
                        stream);                                                                \
  }
EDGE_ATTENTION_V2_BWD(edge_attention_v2_bwd_bf16, __nv_bfloat16)
EDGE_ATTENTION_V2_BWD(edge_attention_v2_bwd_f32, float)
