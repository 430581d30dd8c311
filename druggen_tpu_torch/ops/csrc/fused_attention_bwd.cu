// Edge-modulated attention with the edge projections in the kernel, backward (K6).
//
// Replaces the TPU kernel druggen_tpu/ops/fused_attention.py::_bwd3_kernel
// (called by _bwd3_pallas).  Given the forward's inputs, its rounded t
// residual and the cotangents ge (of edge_out) and gn (of node_agg), it
// recomputes e = eraw @ We + be and the softmax s from the rounded t, and
// returns
//
//     dq, dk, dv [B, N, D], d_eraw [B, N, N, D]   in the stream type
//     dWe, dbe, dWoe, dboe                        f32, summed over every row
//
// with the Pallas kernel's rounding points (all f32 from the T-typed inputs):
//     dWoe = t^T ge, dboe = sum ge, dt = ge @ Woe^T + s * (gn_i v_j - dot),
//     dot = sum_j s * gn_i v_j, base = (q_i k_j) * inv_sqrt_dk,
//     mod = (e + 1) e, dbase = dt mod, de = (dt base) (2 e + 1),
//     dWe = eraw^T de, dbe = sum de, d_eraw = round_T(de @ We^T),
//     dq_i = round_T(sum_j dbase k_j * inv), dk_j = round_T(sum_i dbase q_i * inv),
//     dv_j = round_T(sum_i s gn_i).
//
// Arithmetic: FFMA, as in fused_attention.cu (full f32 products, f32 sums).
// What bounds it on an H100 SXM: at the training shape (R = 1,036,800 rows,
// D = 128, bf16) it does five products of 2 * R * D^2 = 34.0 GFLOP each
// (e recomputed, ge Woe^T, de We^T, eraw^T de, t^T ge): 170 GFLOP, 2.54 ms
// at 67 TFLOP/s of f32 FMA; it must read eraw, t and ge and write d_eraw,
// 1.06 GB, 0.32 ms at 3.35 TB/s.  So the f32 operations bound it.
//
// Why this design.  On the TPU the grid runs in order on one core, so the
// Pallas kernel adds each graph's weight gradients into its output refs and
// keeps dk/dv of a graph in registers across its query rows.  On the card
// blocks run in parallel and in no order.  The backward therefore runs as
// four deterministic launches (no float atomics: the same inputs give the
// same bits on every run):
//
//   1. rows    one block per (graph b, 128-channel tile), looping over the
//              query rows i: the e and ge Woe^T products of the tile (48 x
//              128 FFMA tiles, operands streamed through shared memory), then
//              per channel the softmax from the rounded t, dt, de, dq; dk and
//              dv of the graph sum over i in shared memory.  de is written
//              once in f32 (the operand of dWe and d_eraw: 0.53 GB at the
//              training shape), and the block's dbe / dboe sums go to a
//              per-graph partial.
//   2. deraw   d_eraw = de @ We^T, one 48 x 128 tile a block.
//   3. wgrad   dWe = eraw^T de and dWoe = t^T ge as a split-K product: each
//              block owns one 128 x 128 output tile and a contiguous run of
//              rows, streaming 32-row slabs of both operands through shared
//              memory, and writes its f32 partial tile.
//   4. reduce  sums the partials in a fixed order into the four gradients.
//
// Ragged N (any N) is masked in every launch: rows past the end are zero in
// and never stored.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libfused_attention_bwd.so fused_attention_bwd.cu
// Plain C interface for ctypes; no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attn_common.cuh"

namespace {

constexpr int WT = 128;  // wgrad output tile (WT x WT)
constexpr int KB = 32;   // wgrad rows a slab

constexpr size_t WGRAD_SMEM = 2 * size_t(KB) * WT * 4;

// ---------------------------------------------------------------------------
// 1. rows: block (b, channel tile), loop over the query rows i.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ eraw, const float* __restrict__ we,
                     const float* __restrict__ be, const float* __restrict__ woe_t,
                     const T* __restrict__ t_res, const T* __restrict__ ge,
                     const T* __restrict__ gn, T* __restrict__ dq, T* __restrict__ dk,
                     T* __restrict__ dv, float* __restrict__ de_buf,
                     float* __restrict__ bias_partial, int n, int d, float inv_sqrt_dk) {
  extern __shared__ __align__(128) float smem[];
  float* es = smem + GEMM_SMEM / 4;  // e of the tile:        [n][CT]
  float* dts = es + n * CT;          // ge @ Woe^T of the tile [n][CT]
  float* dks = dts + n * CT;         // sum_i dbase q_i        [n][CT]
  float* dvs = dks + n * CT;         // sum_i s gn_i           [n][CT]

  const long long b = blockIdx.x;
  const int n0 = blockIdx.y * CT;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int c0 = n0 + 4 * tx;        // this thread's product columns
  const int col = n0 + tid;          // this thread's channel in the column stage
  for (int e = tid; e < n * CT; e += THREADS) dks[e] = dvs[e] = 0.0f;
  float bev[4];
  load4(be + c0, bev);
  float dbe = 0.0f, dboe = 0.0f;

  for (int i = 0; i < n; ++i) {
    const long long g = b * n + i;   // the slab of rows (b, i, j)
    for (int row0 = 0; row0 < n; row0 += RC) {
      float acc[RPT][4];
      gemm_tile(eraw + g * n * d, d, row0, n, we, d, n0, d, smem, acc);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int j = row0 + ty + 8 * r;
        if (j >= n) continue;
        float ev[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) ev[c] = acc[r][c] + bev[c];
        store4(es + j * CT + 4 * tx, ev);
      }
      gemm_tile(ge + g * n * d, d, row0, n, woe_t, d, n0, d, smem, acc);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int j = row0 + ty + 8 * r;
        if (j < n) store4(dts + j * CT + 4 * tx, acc[r]);
      }
    }
    __syncthreads();

    if (tid < CT) {
      const long long row = g * n;   // row (b, i, 0)
      const float qc = to_float(q[g * d + col]);
      const float gc = to_float(gn[g * d + col]);
      float m = -INFINITY;
      for (int j = 0; j < n; ++j) m = fmaxf(m, to_float(t_res[(row + j) * d + col]));
      float sum = 0.0f;
      for (int j = 0; j < n; ++j) sum += expf(to_float(t_res[(row + j) * d + col]) - m);
      float dot = 0.0f;
      for (int j = 0; j < n; ++j) {
        const float s = expf(to_float(t_res[(row + j) * d + col]) - m) / sum;
        dot = fmaf(s, gc * to_float(v[(b * n + j) * d + col]), dot);
      }
      float dqc = 0.0f;
      for (int j = 0; j < n; ++j) {
        const float s = expf(to_float(t_res[(row + j) * d + col]) - m) / sum;
        const float kc = to_float(k[(b * n + j) * d + col]);
        const float ds_in = gc * to_float(v[(b * n + j) * d + col]);
        const float dt = dts[j * CT + tid] + s * (ds_in - dot);
        const float e = es[j * CT + tid];
        const float base = (qc * kc) * inv_sqrt_dk;
        const float dbase = dt * ((e + 1.0f) * e);
        const float de = (dt * base) * (2.0f * e + 1.0f);
        de_buf[(row + j) * d + col] = de;
        dbe += de;
        dboe += to_float(ge[(row + j) * d + col]);
        dqc = fmaf(dbase, kc, dqc);
        dks[j * CT + tid] = fmaf(dbase, qc, dks[j * CT + tid]);
        dvs[j * CT + tid] = fmaf(s, gc, dvs[j * CT + tid]);
      }
      dq[g * d + col] = from_float<T>(dqc * inv_sqrt_dk);
    }
    __syncthreads();
  }

  if (tid < CT) {
    for (int j = 0; j < n; ++j) {
      dk[(b * n + j) * d + col] = from_float<T>(dks[j * CT + tid] * inv_sqrt_dk);
      dv[(b * n + j) * d + col] = from_float<T>(dvs[j * CT + tid]);
    }
    bias_partial[(2 * b) * d + col] = dbe;
    bias_partial[(2 * b + 1) * d + col] = dboe;
  }
}

// ---------------------------------------------------------------------------
// 2. deraw: d_eraw = de @ We^T, one 48-row x 128-channel tile a block.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_deraw_kernel(const float* __restrict__ de_buf, const float* __restrict__ we_t,
                      T* __restrict__ deraw, long long rows, int d) {
  extern __shared__ __align__(128) float smem[];
  const long long row0 = blockIdx.x * (long long)RC;
  const int n0 = blockIdx.y * CT;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  float acc[RPT][4];
  gemm_tile(de_buf, d, row0, rows, we_t, d, n0, d, smem, acc);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const long long row = row0 + ty + 8 * r;
    if (row < rows) store4(deraw + row * d + n0 + 4 * tx, acc[r]);
  }
}

// ---------------------------------------------------------------------------
// 3. wgrad: out[z][chunk] = A_z^T B_z over the chunk's rows, for
//    z = 0: A = eraw, B = de (dWe); z = 1: A = t, B = ge (dWoe); all [rows, d].
//    blockIdx.x picks the WT x WT output tile, blockIdx.y the chunk.
// ---------------------------------------------------------------------------
template <typename TB>
__device__ __forceinline__ void load_wslab(float* dst, const TB* __restrict__ src, int d, int col0,
                                           long long r0, long long r_end, int tid) {
  for (int e = tid; e < KB * WT; e += THREADS) {
    const int r = e / WT, c = e % WT;
    dst[r * WT + c] = r0 + r < r_end ? to_float(src[(r0 + r) * d + col0 + c]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_wgrad_kernel(const T* __restrict__ eraw, const float* __restrict__ de_buf,
                      const T* __restrict__ t_res, const T* __restrict__ ge,
                      float* __restrict__ w_partial, long long rows, long long chunk_rows,
                      int d) {
  extern __shared__ __align__(128) float smem[];
  float* as = smem;            // [KB][WT]
  float* bs = smem + KB * WT;  // [KB][WT]
  const int z = blockIdx.z;
  const int chunk = blockIdx.y;
  const int tiles_n = d / WT;
  const int tm = blockIdx.x / tiles_n, tn = blockIdx.x % tiles_n;
  float* out = w_partial + (size_t(z) * gridDim.y + chunk) * (size_t(d) * d);
  const long long r_begin = chunk * chunk_rows;
  const long long r_end_raw = r_begin + chunk_rows;
  const long long r_end = r_end_raw < rows ? r_end_raw : rows;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // output rows 8 ty.., columns 8 tx..
  float acc[8][8] = {};
  for (long long r0 = r_begin; r0 < r_end; r0 += KB) {
    if (z == 0) {
      load_wslab(as, eraw, d, tm * WT, r0, r_end, tid);
      load_wslab(bs, de_buf, d, tn * WT, r0, r_end, tid);
    } else {
      load_wslab(as, t_res, d, tm * WT, r0, r_end, tid);
      load_wslab(bs, ge, d, tn * WT, r0, r_end, tid);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KB; ++kk) {
      float av[8], bv[8];
      load4(as + kk * WT + ty * 8, av);
      load4(as + kk * WT + ty * 8 + 4, av + 4);
      load4(bs + kk * WT + tx * 8, bv);
      load4(bs + kk * WT + tx * 8 + 4, bv + 4);
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    float* o = out + size_t(tm * WT + ty * 8 + a) * d + tn * WT + tx * 8;
    store4(o, acc[a]);
    store4(o + 4, acc[a] + 4);
  }
}

// ---------------------------------------------------------------------------
// 4. reduce: grads = [dWe (d x d), dbe (d), dWoe (d x d), dboe (d)], each a
//    fixed-order sum of its partials.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
attn_bwd_reduce_kernel(const float* __restrict__ w_partial, int chunks,
                       const float* __restrict__ bias_partial, long long batch, int d,
                       float* __restrict__ grads) {
  const long long g = blockIdx.x * (long long)THREADS + threadIdx.x;
  const long long dd = (long long)d * d;
  if (g >= 2 * dd + 2 * d) return;
  const float* src;
  long long stride, count;
  if (g < dd) {                       // dWe
    src = w_partial + g;
    stride = dd;
    count = chunks;
  } else if (g < dd + d) {            // dbe
    src = bias_partial + (g - dd);
    stride = 2LL * d;
    count = batch;
  } else if (g < 2 * dd + d) {        // dWoe
    src = w_partial + (long long)chunks * dd + (g - dd - d);
    stride = dd;
    count = chunks;
  } else {                            // dboe
    src = bias_partial + d + (g - 2 * dd - d);
    stride = 2LL * d;
    count = batch;
  }
  float sum = 0.0f;
  for (long long i = 0; i < count; ++i) sum += src[i * stride];
  grads[g] = sum;
}

size_t rows_smem(int n) { return GEMM_SMEM + 4 * size_t(n) * CT * 4; }

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* eraw, const void* we,
           const void* we_t, const void* be, const void* woe_t, const void* t_res,
           const void* ge, const void* gn, void* dq, void* dk, void* dv, void* deraw,
           void* de_buf, void* bias_partial, void* w_partial, void* grads, long long batch,
           int n, int d, float inv_sqrt_dk, int chunks, long long chunk_rows, void* stream) {
  const long long rows = batch * n * n;
  if (batch <= 0 || n <= 0 || d <= 0 || d % CT != 0 || d % WT != 0 || chunks <= 0 ||
      chunk_rows <= 0 || chunk_rows % KB != 0 || chunk_rows * chunks < rows)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem_rows = rows_smem(n);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_rows_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem_rows));
  if (err != cudaSuccess) return int(err);
  attn_bwd_rows_kernel<T><<<dim3(unsigned(batch), unsigned(d / CT)), THREADS, smem_rows, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(eraw), static_cast<const float*>(we), static_cast<const float*>(be),
      static_cast<const float*>(woe_t), static_cast<const T*>(t_res), static_cast<const T*>(ge),
      static_cast<const T*>(gn), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(de_buf), static_cast<float*>(bias_partial), n, d, inv_sqrt_dk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  attn_bwd_deraw_kernel<T>
      <<<dim3(unsigned((rows + RC - 1) / RC), unsigned(d / CT)), THREADS, GEMM_SMEM, st>>>(
          static_cast<const float*>(de_buf), static_cast<const float*>(we_t),
          static_cast<T*>(deraw), rows, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(attn_bwd_wgrad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(WGRAD_SMEM));
  if (err != cudaSuccess) return int(err);
  const unsigned tiles = unsigned((d / WT) * (d / WT));
  attn_bwd_wgrad_kernel<T><<<dim3(tiles, unsigned(chunks), 2), THREADS, WGRAD_SMEM, st>>>(
      static_cast<const T*>(eraw), static_cast<const float*>(de_buf), static_cast<const T*>(t_res),
      static_cast<const T*>(ge), static_cast<float*>(w_partial), rows, chunk_rows, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const long long total = 2LL * d * d + 2LL * d;
  attn_bwd_reduce_kernel<<<unsigned((total + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      static_cast<const float*>(w_partial), chunks, static_cast<const float*>(bias_partial),
      batch, d, static_cast<float*>(grads));
  return int(cudaGetLastError());
}

}  // namespace

// q, k, v, gn, dq, dk, dv: [batch, n, d]; eraw, t_res (the forward's rounded
// t), ge, deraw: [batch, n, n, d]; all in the stream type.  we: We [d, d]
// f32 ([in, out]); we_t = We^T and woe_t = Woe^T, f32 contiguous; be [d] f32.
// de_buf: f32 [batch * n * n, d]; bias_partial: f32 [batch, 2, d];
// w_partial: f32 [2, chunks, d * d]; grads: f32 [2 d^2 + 2 d], written as
// (dWe [d, d], dbe, dWoe [d, d], dboe).  d a multiple of 128; chunk_rows a
// multiple of edge_attention_bwd_slab_rows() with chunks * chunk_rows >=
// batch * n * n.  Launches on `stream`, does not synchronise, allocates
// nothing.  Returns the cudaError_t of the launches (0 on success).
extern "C" int edge_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* eraw, const void* we,
    const void* we_t, const void* be, const void* woe_t, const void* t_res, const void* ge,
    const void* gn, void* dq, void* dk, void* dv, void* deraw, void* de_buf, void* bias_partial,
    void* w_partial, void* grads, long long batch, int n, int d, float inv_sqrt_dk, int chunks,
    long long chunk_rows, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, eraw, we, we_t, be, woe_t, t_res, ge, gn, dq, dk, dv,
                               deraw, de_buf, bias_partial, w_partial, grads, batch, n, d,
                               inv_sqrt_dk, chunks, chunk_rows, stream);
}

extern "C" int edge_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* eraw, const void* we,
    const void* we_t, const void* be, const void* woe_t, const void* t_res, const void* ge,
    const void* gn, void* dq, void* dk, void* dv, void* deraw, void* de_buf, void* bias_partial,
    void* w_partial, void* grads, long long batch, int n, int d, float inv_sqrt_dk, int chunks,
    long long chunk_rows, void* stream) {
  return launch<float>(q, k, v, eraw, we, we_t, be, woe_t, t_res, ge, gn, dq, dk, dv, deraw,
                       de_buf, bias_partial, w_partial, grads, batch, n, d, inv_sqrt_dk, chunks,
                       chunk_rows, stream);
}

extern "C" long long edge_attention_bwd_smem_bytes(int n) { return (long long)rows_smem(n); }

extern "C" int edge_attention_bwd_slab_rows() { return KB; }
