// Edge-modulated attention with the edge projections in the kernel, forward (K5).
//
// Replaces the TPU kernel druggen_tpu/ops/fused_attention.py::_fwd3_kernel
// (called by _fwd3_pallas).  For each graph b and query atom i, over the
// keys j < N and the D channels (heads x dk):
//
//     e[j]        = eraw[b,i,j] @ We + be                      (f32 x f32)
//     t[j]        = (((q[b,i] * k[b,j]) * inv_sqrt_dk) * (e[j] + 1)) * e[j]
//     t_out[b,i,j] = round_T(t[j])                             (the residual)
//     edge[b,i,j] = round_T(t[j] @ Woe + boe)                  (f32 t)
//     s[j]        = softmax over j of t[j], per channel         (f32 t)
//     node[b,i]   = round_T(sum_j s[j] * v[b,j])
//
// with the Pallas kernel's rounding points: q, k, v and eraw are read in the
// stream type T and widened to f32; We, be, Woe and boe are the f32
// parameters; both projections are f32 x f32 products with f32 sums; edge_out
// and the softmax use the f32 t, and t is rounded only for the residual that
// the backward reads.
//
// Arithmetic: FFMA.  The projections run on the CUDA cores in full f32 (one
// fused multiply-add a term), not TF32 nor split-f32 on the tensor cores, so
// every product is exact and only the order of the f32 sums differs from a
// plain f32 matmul.  What bounds it on an H100 SXM: at the training shape
// (512 graphs of 45 atoms, rows R = 1,036,800, D = 128, bf16 stream) the two
// products are 2 * 2 * R * D^2 = 67.9 GFLOP, 1.01 ms at 67 TFLOP/s of f32
// FMA; the bytes (eraw in, edge_out and t out, 0.82 GB) take 0.245 ms at
// 3.35 TB/s.  So the f32 operations bound it.
//
// Design.  One block of 256 threads owns one (b, i): the N x D slab of
// eraw rows (b, i, :).  Everything after the e product is local to a
// channel, and the softmax runs over the keys j, which are the slab's rows,
// so the block needs no other block's data.  The products are tiled
// 48 rows x 128 channels (6 x 4 outputs a thread), streaming 32-deep chunks
// of the row operand and of the f32 weight through shared memory; the
// weights are read from L2 by every block and never sit whole in shared
// memory (two f32 D x D weights are 512 KB at D = 256).  The f32 t of the
// slab stays in shared memory (N x D x 4 bytes) as the operand of the
// second product and the input of the per-channel softmax.  Ragged N
// (any N) is masked: rows past N are zero in and never stored.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libfused_attention.so fused_attention.cu
// Plain C interface for ctypes; no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attn_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ eraw, const float* __restrict__ we,
                const float* __restrict__ be, const float* __restrict__ woe,
                const float* __restrict__ boe, T* __restrict__ edge_out, T* __restrict__ node_out,
                T* __restrict__ t_out, int n, int d, float inv_sqrt_dk) {
  extern __shared__ __align__(128) float smem[];
  float* ts = smem + GEMM_SMEM / 4;  // f32 t of the slab: [n][d]

  const long long g = blockIdx.x;    // b * n + i
  const long long b = g / n;
  const T* er = eraw + g * n * d;    // rows (b, i, j), j < n
  const T* qi = q + g * d;
  const T* kb = k + b * n * d;
  const T* vb = v + b * n * d;
  const long long out0 = g * n;      // first output row (b, i, 0)
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;

  // ---- 1. e = eraw @ We + be; t; the rounded t out and the f32 t kept.
  for (int n0 = 0; n0 < d; n0 += CT) {
    const int c0 = n0 + 4 * tx;
    float qv[4], bev[4];
    load4(qi + c0, qv);
    load4(be + c0, bev);
    for (int row0 = 0; row0 < n; row0 += RC) {
      float acc[RPT][4];
      gemm_tile(er, d, row0, n, we, d, n0, d, smem, acc);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int j = row0 + ty + 8 * r;
        if (j >= n) continue;
        float kv[4], tv[4];
        load4(kb + size_t(j) * d + c0, kv);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float e = acc[r][c] + bev[c];
          float t = qv[c] * kv[c];
          t = t * inv_sqrt_dk;
          t = t * (e + 1.0f);
          tv[c] = t * e;
        }
        store4(ts + size_t(j) * d + c0, tv);
        store4(t_out + (out0 + j) * d + c0, tv);
      }
    }
  }
  __syncthreads();

  // ---- 2. per-channel softmax over the keys j; node = sum_j s * v.
  for (int c = tid; c < d; c += THREADS) {
    float m = -INFINITY;
    for (int j = 0; j < n; ++j) m = fmaxf(m, ts[j * d + c]);
    float sum = 0.0f;
    for (int j = 0; j < n; ++j) sum += expf(ts[j * d + c] - m);
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) {
      const float s = expf(ts[j * d + c] - m) / sum;
      acc = fmaf(s, to_float(vb[size_t(j) * d + c]), acc);
    }
    node_out[g * d + c] = from_float<T>(acc);
  }

  // ---- 3. edge_out = t @ Woe + boe from the f32 t.
  for (int n0 = 0; n0 < d; n0 += CT) {
    const int c0 = n0 + 4 * tx;
    float bov[4];
    load4(boe + c0, bov);
    for (int row0 = 0; row0 < n; row0 += RC) {
      float acc[RPT][4];
      gemm_tile(ts, d, row0, n, woe, d, n0, d, smem, acc);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int j = row0 + ty + 8 * r;
        if (j >= n) continue;
        float ov[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) ov[c] = acc[r][c] + bov[c];
        store4(edge_out + (out0 + j) * d + c0, ov);
      }
    }
  }
}

size_t fwd_smem(int n, int d) { return GEMM_SMEM + size_t(n) * d * 4; }

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* eraw, const void* we,
           const void* be, const void* woe, const void* boe, void* edge_out, void* node_out,
           void* t_out, long long batch, int n, int d, float inv_sqrt_dk, void* stream) {
  if (batch < 0 || n <= 0 || d <= 0 || d % CT != 0) return int(cudaErrorInvalidValue);
  if (batch == 0) return int(cudaSuccess);
  const size_t smem = fwd_smem(n, d);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  attn_fwd_kernel<T><<<unsigned(batch * n), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(eraw), static_cast<const float*>(we), static_cast<const float*>(be),
      static_cast<const float*>(woe), static_cast<const float*>(boe), static_cast<T*>(edge_out),
      static_cast<T*>(node_out), static_cast<T*>(t_out), n, d, inv_sqrt_dk);
  return int(cudaGetLastError());
}

}  // namespace

// q, k, v, node_out: [batch, n, d]; eraw, edge_out, t_out: [batch, n, n, d],
// all in the stream type; we, woe: [d, d] f32 ([in, out], x @ W); be, boe:
// [d] f32.  d a multiple of 128.  Launches on `stream`, does not synchronise,
// allocates nothing.  Returns the cudaError_t of the launch (0 on success).
extern "C" int edge_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                       const void* eraw, const void* we, const void* be,
                                       const void* woe, const void* boe, void* edge_out,
                                       void* node_out, void* t_out, long long batch, int n, int d,
                                       float inv_sqrt_dk, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, eraw, we, be, woe, boe, edge_out, node_out, t_out, batch,
                               n, d, inv_sqrt_dk, stream);
}

extern "C" int edge_attention_fwd_f32(const void* q, const void* k, const void* v,
                                      const void* eraw, const void* we, const void* be,
                                      const void* woe, const void* boe, void* edge_out,
                                      void* node_out, void* t_out, long long batch, int n, int d,
                                      float inv_sqrt_dk, void* stream) {
  return launch<float>(q, k, v, eraw, we, be, woe, boe, edge_out, node_out, t_out, batch, n, d,
                       inv_sqrt_dk, stream);
}

extern "C" long long edge_attention_fwd_smem_bytes(int n, int d) {
  return (long long)fwd_smem(n, d);
}
