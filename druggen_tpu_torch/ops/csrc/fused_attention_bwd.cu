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
// No float atomics on either route: the same inputs give the same bits on
// every run.  Two routes (ops/fused_attention.py::launch_plan chooses):
//
// bf16 at D = 128, N <= 64 (the use_pallas training path): five launches,
// every product on wgmma and exact term by term (attn_hopper.cuh has the
// plan; We and Woe staged as three bf16 pieces each):
//   1. attn_bwd_stats_wgmma  the softmax statistics of the rounded t per
//      slab (b, i) and channel: max, 1 / sum and dot = sum_j s (gn_i v_j),
//      one thread a (slab, column pair), the keys in order.
//   2. attn_bwd_rows_wgmma   persistent blocks, a block an SM over a
//      contiguous run of slabs (b, i, :), two warpgroups taking them in
//      turn, one 64-row tile a slab.  Per slab: s (gn v_j - dot) from the
//      rounded t and the statistics, dt = ge Woe^T (ge as A registers,
//      three passes over Woe's pieces, the transpose bit) + that, e = eraw
//      We again (the eraw tile by TMA), dbase and de (both stored in f32:
//      the node pass's and the wgrad pass's operands), dq by a column
//      reduction, and d_eraw = de We^T (de's three pieces in registers x
//      We's, six products) stored in bf16 from the accumulator.  With the
//      statistics computed before, the one column reduction (dq) follows
//      the e product and uses the warpgroup's tile, which is what lets two
//      warpgroups fit beside the 192 KB of staged weight pieces.
//   3. attn_bwd_node_wgmma   dk_j = inv sum_i dbase_ij q_i and dv_j = sum_i
//      s_ij gn_i over each graph's query atoms in order, s from the rounded
//      t and the statistics: one thread a (b, j, column pair).  The graph's
//      f32 dk and dv sums (46 KB at N 45) do not fit beside the staged
//      weight pieces, so the rows pass does not keep them.
//   4. attn_bwd_wgrad_wgmma  dWe = eraw^T de (de as three bf16 pieces, three
//      passes) and dWoe = t^T ge (both exact in bf16, one pass) as split-K
//      products: a block of two warpgroups owns one 128 x 128 gradient and a
//      run of rows; each 64-row stage is converted into swizzled panels on
//      the CUDA cores while the other stage's products run, into a fresh
//      accumulator that is then added to an f32 register total (so the
//      tensor cores' accumulation spans 64 rows, not the whole run); dbe and
//      dboe are column sums of the same stages.
//   5. attn_bwd_reduce_wgmma the partials summed in a fixed order.
// What bounds it on an H100 SXM at the training shape (R = 1,036,800 rows,
// D = 128, bf16): five products of 2 R D^2 = 34.0 GFLOP each, priced at the
// faster route their operand types allow: t^T ge exact in bf16, 0.034 ms at
// 989 TFLOP/s; e, ge Woe^T and eraw^T de (a bf16-exact operand times an f32
// one), 0.309 ms at 989 / 3; de We^T (f32 x f32), 0.206 ms at 165: 0.549
// ms.  It must read eraw, t and ge and write d_eraw, 1.06 GB, 0.32 ms at
// 3.35 TB/s.  So the operations bound it; this route also writes and reads
// de and dbase in f32 (2.1 GB of traffic, ~0.64 ms at 3.35 TB/s) and reads
// t a second time for the statistics.
//
// f32, other widths and N > 64: FFMA on the CUDA cores (full f32 products,
// f32 sums), four launches:
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
// Its bound on that route: 170 GFLOP at 67 TFLOP/s of f32 FMA, 2.54 ms.
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
#include <cstring>

#include "attn_common.cuh"
#include "attn_hopper.cuh"

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


// ---------------------------------------------------------------------------
// bf16 on Hopper (D = 128, N <= 64): rows, node, wgrad, reduce
// ---------------------------------------------------------------------------
#if ATTN_HOPPER
namespace k6h {
using namespace ahop;
using bf16 = __nv_bfloat16;

// Device pointers, in the order of the host's pointer array.
struct HArgs {
  // bf16 inputs: q, k, v, gn [B, N, C]; eraw, t_res, ge [B, N, N, C]
  const void *q, *k, *v, *gn, *eraw, *t_res, *ge;
  // f32 parameters: We, Woe [C in][C out]; be [C]
  const float *we, *woe, *be;
  // f32 scratch: de, dbase [R, C]; the slabs' softmax max, 1 / sum and
  // sum_j s (gn_i v_j) [B N, C]
  float *de, *dbase, *stat_m, *stat_rl, *stat_dot;
  // bf16 outputs
  void *dq, *dk, *dv, *deraw;
  // f32: weight partials [2][chunks][C C], column-sum partials [chunks][2 C],
  // the gradients (dWe, dbe, dWoe, dboe)
  float *w_partial, *v_partial, *grads;
};
constexpr int N_HPTRS = sizeof(HArgs) / sizeof(void*);
static_assert(sizeof(HArgs) == N_HPTRS * sizeof(void*), "HArgs holds pointers only");

struct RowsParams {
  HArgs a;
  long long slabs;  // batch * n
  int n;
  float inv;
};

// 1. stats: per slab (b, i) and channel, the softmax of the rounded t over
// the keys: m = max_j t, 1 / l with l = sum_j exp(t - m), and dot = sum_j s
// (gn_i v_j) with s = exp(t - m) (1 / l), each summed over j in order.
// One thread a (slab, column pair).
constexpr int PAIR_THREADS = 256;
__global__ void __launch_bounds__(PAIR_THREADS)
attn_bwd_stats_wgmma(const __grid_constant__ HArgs a, long long slabs, int n) {
  const long long idx = blockIdx.x * (long long)PAIR_THREADS + threadIdx.x;
  if (idx >= slabs * (C / 2)) return;
  const int c = 2 * int(idx % (C / 2));
  const long long g = idx / (C / 2);
  const long long b = g / n;
  const bf16* t = static_cast<const bf16*>(a.t_res) + g * n * C + c;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * n * C + c;
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int j = 0; j < n; ++j) {
    const float2 tv = ld_pair(t + size_t(j) * C);
    m0 = fmaxf(m0, tv.x);
    m1 = fmaxf(m1, tv.y);
  }
  float l0 = 0.0f, l1 = 0.0f;
  for (int j = 0; j < n; ++j) {
    const float2 tv = ld_pair(t + size_t(j) * C);
    l0 += expf(tv.x - m0);
    l1 += expf(tv.y - m1);
  }
  const float rl0 = 1.0f / l0, rl1 = 1.0f / l1;
  const float2 gv = ld_pair(static_cast<const bf16*>(a.gn) + g * C + c);
  float d0 = 0.0f, d1 = 0.0f;
  for (int j = 0; j < n; ++j) {
    const float2 tv = ld_pair(t + size_t(j) * C);
    const float2 vv = ld_pair(vb + size_t(j) * C);
    d0 += (expf(tv.x - m0) * rl0) * (gv.x * vv.x);
    d1 += (expf(tv.y - m1) * rl1) * (gv.y * vv.y);
  }
  *reinterpret_cast<float2*>(a.stat_m + g * C + c) = make_float2(m0, m1);
  *reinterpret_cast<float2*>(a.stat_rl + g * C + c) = make_float2(rl0, rl1);
  *reinterpret_cast<float2*>(a.stat_dot + g * C + c) = make_float2(d0, d1);
}

// 2. The rows pass: per slab (b, i, :) dt, e, dbase, de, dq and d_eraw, two
// warpgroups a block taking the block's slabs in turn.  Writes dbase and de
// for the later launches.
__global__ void __launch_bounds__(WARPGROUPS * NT, 1)
attn_bwd_rows_wgmma(const __grid_constant__ CUtensorMap e_map, const __grid_constant__ RowsParams rp) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const HArgs& a = rp.a;
  const Warpgroup wgp(smem);
  const Lane& ln = wgp.ln;
  uint8_t* we_p = smem + OFF_WE;
  uint8_t* woe_p = smem + OFF_WOE;
  float* st_o = wgp.red + 4 * C;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* gn = static_cast<const bf16*>(a.gn);
  const int n = rp.n;
  const SlabRange sr(rp.slabs);
  if (wgp.leader()) {
    mbar_init(wgp.full, 1);
    fence_barrier_init();
    if (sr.begin + wgp.wg < sr.end) load_slab(wgp.tile, &e_map, wgp.full, (sr.begin + wgp.wg) * n);
  }
  stage_pieces(we_p, a.we);
  stage_pieces(woe_p, a.woe);
  fence_proxy_async();
  __syncthreads();

  uint32_t it = 0;
  for (long long g = sr.begin + wgp.wg; g < sr.end; g += WARPGROUPS, ++it) {
    const long long b = g / n;
    const long long row0 = g * n;
    const bf16* kb = k + b * n * C;
    const bf16* vb = v + b * n * C;
    float acc[4 * JC], w[4 * JC];

    // ---- A. s = exp(t - m) (1 / l) from the rounded t and the slab's
    //         statistics; w = s (gn_i v_j - dot), 0 on the rows past n
    load_pairs(static_cast<const bf16*>(a.t_res), row0, n, w, ln);
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      const int c = ln.col(j);
      const float2 mv = *reinterpret_cast<const float2*>(a.stat_m + g * C + c);
      const float2 lv = *reinterpret_cast<const float2*>(a.stat_rl + g * C + c);
      const float2 dv = *reinterpret_cast<const float2*>(a.stat_dot + g * C + c);
      const float2 gv = ld_pair(gn + g * C + c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = ln.row(half);
        const float2 vv = r < n ? ld_pair(vb + size_t(r) * C + c) : make_float2(0.0f, 0.0f);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * half + e;
          const float s = expf(w[i] - (e ? mv.y : mv.x)) * (e ? lv.y : lv.x);
          const float x = s * ((e ? gv.y : gv.x) * (e ? vv.y : vv.x) - (e ? dv.y : dv.x));
          w[i] = r < n ? x : 0.0f;
        }
      }
    }

    // ---- B. dt = ge Woe^T + w: ge's rows as A registers, Woe's pieces
    {
      uint32_t ga[CP / 16][4];
      load_a_regs(static_cast<const bf16*>(a.ge), row0, n, ga, ln);
      mma_regs_w3<1>(acc, ga, woe_p);
    }
#pragma unroll
    for (int i = 0; i < 4 * JC; ++i) acc[i] = acc[i] + w[i];

    // ---- C. e = eraw We again (the tile); then dbase (in w) and de (in acc)
    mbar_wait(wgp.full, it & 1);
    mma_tile_w3<0>(w, wgp.tile, we_p);
    wg_sync(wgp.bar);  // the warpgroup's products have read the tile: it holds the reductions now
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      const int c = ln.col(j);
      const float2 qv = ld_pair(q + g * C + c);
      const float2 bv = *reinterpret_cast<const float2*>(a.be + c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = ln.row(half);
        const float2 kv = r < n ? ld_pair(kb + size_t(r) * C + c) : make_float2(0.0f, 0.0f);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * half + e;
          const float ev = w[i] + (e ? bv.y : bv.x);
          const float base = ((e ? qv.y : qv.x) * (e ? kv.y : kv.x)) * rp.inv;
          const float dt = acc[i];
          w[i] = dt * ((ev + 1.0f) * ev);             // dbase
          acc[i] = (dt * base) * (2.0f * ev + 1.0f);  // de
        }
      }
    }
    store_f32_rows(a.dbase, row0, n, w, ln);
    store_f32_rows(a.de, row0, n, acc, ln);

    // ---- D. dq_i = inv sum_j dbase k_j; then the tile's next slab
    wg_col_reduce<false>(
        [&](int j, int e, int half) {
          const int r = ln.row(half);
          const float2 kv = r < n ? ld_pair(kb + size_t(r) * C + ln.col(j)) : make_float2(0.0f, 0.0f);
          return w[4 * j + 2 * half + e] * (e ? kv.y : kv.x);
        },
        wgp.red, st_o, ln, wgp.bar);
    static_cast<bf16*>(a.dq)[g * C + ln.t] = __float2bfloat16_rn(st_o[ln.t] * rp.inv);
    fence_proxy_async();  // the reduction's writes before the next slab's eraw lands there
    wg_sync(wgp.bar);
    if (wgp.leader() && g + WARPGROUPS < sr.end)
      load_slab(wgp.tile, &e_map, wgp.full, (g + WARPGROUPS) * n);

    // ---- E. d_eraw = de We^T: de's pieces x We's pieces
    {
      Pieces dp;
      split_acc(acc, dp);
      mma_pieces_w6<1>(acc, dp, we_p);
    }
    store_bf16_rows(static_cast<bf16*>(a.deraw), row0, n, acc, ln);
  }
}

// 3. dk_j = inv sum_i dbase_ij q_i and dv_j = sum_i s_ij gn_i, summed over
// the query atoms i of the graph in order; s recomputed from the rounded t
// and the slab's statistics as the rows pass computed it.  One thread a
// (b, j, column pair).
__global__ void __launch_bounds__(PAIR_THREADS)
attn_bwd_node_wgmma(const __grid_constant__ HArgs a, long long batch, int n, float inv) {
  const long long idx = blockIdx.x * (long long)PAIR_THREADS + threadIdx.x;
  if (idx >= batch * n * (C / 2)) return;
  const int c = 2 * int(idx % (C / 2));
  const long long bj = idx / (C / 2);
  const long long b = bj / n;
  const int j = int(bj % n);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* gn = static_cast<const bf16*>(a.gn);
  const bf16* t = static_cast<const bf16*>(a.t_res);
  float dk0 = 0.0f, dk1 = 0.0f, dv0 = 0.0f, dv1 = 0.0f;
  for (int i = 0; i < n; ++i) {
    const long long gi = b * n + i;
    const long long row = gi * n + j;
    const float2 dbv = *reinterpret_cast<const float2*>(a.dbase + row * C + c);
    const float2 tv = ld_pair(t + row * C + c);
    const float2 mv = *reinterpret_cast<const float2*>(a.stat_m + gi * C + c);
    const float2 lv = *reinterpret_cast<const float2*>(a.stat_rl + gi * C + c);
    const float2 qv = ld_pair(q + gi * C + c);
    const float2 gv = ld_pair(gn + gi * C + c);
    dk0 += dbv.x * qv.x;
    dk1 += dbv.y * qv.y;
    dv0 += (expf(tv.x - mv.x) * lv.x) * gv.x;
    dv1 += (expf(tv.y - mv.y) * lv.y) * gv.y;
  }
  *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dk) + bj * C + c) = pack_bf16(dk0 * inv, dk1 * inv);
  *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dv) + bj * C + c) = pack_bf16(dv0, dv1);
}

// 4. wgrad: out[z][chunk] = A_z^T B_z over the chunk's rows (M = N = C):
//   z 0: eraw^T de (dWe; de as three bf16 pieces), 1: t^T ge (dWoe; both
//   bf16).  blockIdx.x is z, blockIdx.y the row chunk; warpgroup w owns the
//   output rows 64 w ...  A stage is A (one bf16 piece) and B (three pieces
//   for de, one for ge) in swizzled panels of 64 rows x 64 columns.
constexpr int WN = 128;                        // output tile columns (= C)
constexpr int WKB = 64;                        // rows a stage
constexpr size_t W_PANEL = size_t(WKB) * 128;  // 64 rows x 64 columns, bf16
constexpr size_t W_PIECE = 2 * W_PANEL;        // 128 columns
constexpr size_t W_STAGE = 4 * W_PIECE;        // A | B's three pieces
constexpr size_t WGRAD_SMEM = 2 * W_STAGE + ALIGN_SLACK;
constexpr int WTHREADS = 256;
constexpr int W_TILES = 2;
static_assert(WN == C && WGRAD_SMEM <= SMEM_MAX, "the wgrad tile is C x C");

__device__ __forceinline__ size_t w_off(int r, int c8) {
  return size_t(c8 >> 6) * W_PANEL + sw_off(r, c8 & 63);
}

// Eight f32 of a stage row as three bf16 pieces, 16 bytes each.
__device__ __forceinline__ void put8(uint8_t* oper, int r, int c8, const float (&x)[8]) {
  uint32_t pa[4], pb[4], pc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float a0, b0, c0, a1, b1, c1;
    split3(x[2 * i], a0, b0, c0);
    split3(x[2 * i + 1], a1, b1, c1);
    pa[i] = pack_bf16(a0, a1);
    pb[i] = pack_bf16(b0, b1);
    pc[i] = pack_bf16(c0, c1);
  }
  const size_t off = w_off(r, c8);
  *reinterpret_cast<uint4*>(oper + off) = make_uint4(pa[0], pa[1], pa[2], pa[3]);
  *reinterpret_cast<uint4*>(oper + W_PIECE + off) = make_uint4(pb[0], pb[1], pb[2], pb[3]);
  *reinterpret_cast<uint4*>(oper + 2 * W_PIECE + off) = make_uint4(pc[0], pc[1], pc[2], pc[3]);
}

// One 64-row stage of both operands into `stage` (every thread; 16-byte
// groups, all loads issued first).  A thread's groups share one 8-column
// group c8 = 8 (tid % 16), so it adds what it converts of B into colsum.
__device__ __forceinline__ void wgrad_stage(uint8_t* stage, const HArgs& a, int z, long long r0,
                                            long long r_end, float (&colsum)[8]) {
  constexpr int GROUPS = WKB * (WN / 8) / WTHREADS;  // of each operand, a thread
  const bf16* asrc = static_cast<const bf16*>(z == 0 ? a.eraw : a.t_res);
  const bf16* ge = static_cast<const bf16*>(a.ge);
  const int c8 = (threadIdx.x % (WN / 8)) * 8;
  uint4 xa[GROUPS], xg[GROUPS];
  float xb[GROUPS][8];
#pragma unroll
  for (int i = 0; i < GROUPS; ++i) {
    const long long row = r0 + (threadIdx.x + i * WTHREADS) / (WN / 8);
    const bool ok = row < r_end;
    xa[i] = xg[i] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int e = 0; e < 8; ++e) xb[i][e] = 0.0f;
    if (ok) {
      xa[i] = *reinterpret_cast<const uint4*>(asrc + row * C + c8);
      if (z == 0) {
        const float4 lo = *reinterpret_cast<const float4*>(a.de + row * C + c8);
        const float4 hi = *reinterpret_cast<const float4*>(a.de + row * C + c8 + 4);
        xb[i][0] = lo.x, xb[i][1] = lo.y, xb[i][2] = lo.z, xb[i][3] = lo.w;
        xb[i][4] = hi.x, xb[i][5] = hi.y, xb[i][6] = hi.z, xb[i][7] = hi.w;
      } else {
        xg[i] = *reinterpret_cast<const uint4*>(ge + row * C + c8);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < GROUPS; ++i) {
    const int r = (threadIdx.x + i * WTHREADS) / (WN / 8);
    *reinterpret_cast<uint4*>(stage + w_off(r, c8)) = xa[i];
    if (z == 0) {
#pragma unroll
      for (int e = 0; e < 8; ++e) colsum[e] += xb[i][e];
      put8(stage + W_PIECE, r, c8, xb[i]);
    } else {
      const uint32_t u[4] = {xg[i].x, xg[i].y, xg[i].z, xg[i].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16(u[e]);
        colsum[2 * e] += f.x;
        colsum[2 * e + 1] += f.y;
      }
      *reinterpret_cast<uint4*>(stage + W_PIECE + w_off(r, c8)) = xg[i];
    }
  }
}

__global__ void __launch_bounds__(WTHREADS, 1)
attn_bwd_wgrad_wgmma(const __grid_constant__ HArgs a, long long rows_total, long long chunk_rows) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const int z = blockIdx.x;
  const int wg = threadIdx.x >> 7;
  const Lane ln(threadIdx.x & 127);
  const long long r_begin = blockIdx.y * chunk_rows;
  const long long r_end = r_begin + chunk_rows < rows_total ? r_begin + chunk_rows : rows_total;
  const int n_k = r_end > r_begin ? int((r_end - r_begin + WKB - 1) / WKB) : 0;
  float colsum[8] = {};
  float total[WN / 2], acc[WN / 2];
  zero(total);
  if (n_k > 0) {
    wgrad_stage(smem, a, z, r_begin, r_end, colsum);
    fence_proxy_async();
    __syncthreads();
  }
  for (int kstep = 0; kstep < n_k; ++kstep) {
    const uint8_t* A = smem + size_t(kstep & 1) * W_STAGE + size_t(wg) * W_PANEL;
    const uint8_t* Bm = smem + size_t(kstep & 1) * W_STAGE + W_PIECE;
    zero(acc);
    fence_regs(acc);
    wgmma_fence();
    // B's pieces, the smallest first (ge is one piece)
#pragma unroll
    for (int piece = 2; piece >= 0; --piece) {
      if (z == 1 && piece != 0) continue;
#pragma unroll
      for (int kk = 0; kk < WKB / 16; ++kk)
        Mma<WN>::ss<1, 1>(acc, desc(A + kk * 2048, W_PANEL, 1024),
                          desc(Bm + size_t(piece) * W_PIECE + kk * 2048, W_PANEL, 1024));
    }
    wgmma_commit();
    if (kstep + 1 < n_k)
      wgrad_stage(smem + size_t((kstep + 1) & 1) * W_STAGE, a, z, r_begin + (kstep + 1) * WKB,
                  r_end, colsum);
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) total[i] += acc[i];
    fence_proxy_async();
    __syncthreads();
  }
  float* out = a.w_partial + ((long long)z * gridDim.y + blockIdx.y) * C * C;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = 64 * wg + ln.row(half);
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
      *reinterpret_cast<float2*>(out + (long long)m * C + ln.col(j)) =
          make_float2(total[4 * j + 2 * half], total[4 * j + 2 * half + 1]);
  }
  // the column sums: the 16 threads of a column group in a fixed order (the
  // stages are free)
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 8; ++i) red[(threadIdx.x >> 4) * WN + (threadIdx.x & 15) * 8 + i] = colsum[i];
  __syncthreads();
  if (threadIdx.x < WN) {
    float sum = 0.0f;
    for (int t = 0; t < WTHREADS / 16; ++t) sum += red[t * WN + threadIdx.x];
    a.v_partial[(long long)blockIdx.y * 2 * C + z * C + threadIdx.x] = sum;
  }
}

// 5. reduce: grads = [dWe (C x C), dbe (C), dWoe (C x C), dboe (C)], each a
// fixed-order sum of its partials.
constexpr int RTHREADS = 256;
__global__ void __launch_bounds__(RTHREADS)
attn_bwd_reduce_wgmma(const __grid_constant__ HArgs a, int chunks) {
  const long long g = blockIdx.x * (long long)RTHREADS + threadIdx.x;
  constexpr long long CC = (long long)C * C;
  if (g >= 2 * CC + 2 * C) return;
  const float* src;
  long long stride;
  if (g < CC) {                  // dWe
    src = a.w_partial + g;
    stride = CC;
  } else if (g < CC + C) {       // dbe
    src = a.v_partial + (g - CC);
    stride = 2 * C;
  } else if (g < 2 * CC + C) {   // dWoe
    src = a.w_partial + chunks * CC + (g - CC - C);
    stride = CC;
  } else {                       // dboe
    src = a.v_partial + C + (g - 2 * CC - C);
    stride = 2 * C;
  }
  float sum = 0.0f;
  for (int i = 0; i < chunks; ++i) sum += src[i * stride];
  a.grads[g] = sum;
}
}  // namespace k6h
#endif  // ATTN_HOPPER

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

// The Hopper route (bf16, D = 128, 1 <= n <= 64).  ptrs: the device
// pointers of k6h::HArgs, in its order (q, k, v, gn [batch, n, 128] and
// eraw, t_res, ge [batch, n, n, 128] bf16; we, woe [128, 128] f32 ([in,
// out]), be [128] f32; de, dbase [R, 128] f32; stat_m, stat_rl, stat_dot
// [batch n, 128] f32; dq, dk, dv, deraw bf16; w_partial [2, chunks, 128 x
// 128], v_partial [chunks, 256], grads [2 x 128^2 + 256] f32).  grid and the
// wgrad pass's row chunks from ops/fused_attention.py::launch_plan
// (chunk_rows a multiple of 64 with chunks * chunk_rows >= batch n n).  Five
// launches on `stream` (stats, rows, node, wgrad, reduce); does not
// synchronise, allocates nothing.  Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for arguments that do not match).
extern "C" int edge_attention_bwd_bf16_wgmma(const void* const* ptrs, long long batch, int n,
                                             int d, float inv_sqrt_dk, int grid, int chunks,
                                             long long chunk_rows, void* stream) {
#if ATTN_HOPPER
  using namespace k6h;
  const long long rows = batch * n * n;
  if (batch <= 0 || n <= 0 || n > MAX_N || d != C || grid <= 0 || chunks <= 0 ||
      chunk_rows <= 0 || chunk_rows % WKB != 0 || chunk_rows * chunks < rows)
    return int(cudaErrorInvalidValue);
  HArgs a;
  std::memcpy(&a, ptrs, sizeof(HArgs));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap e_map;
  if (!make_map(&e_map, a.eraw, rows, C, BM)) return int(cudaErrorInvalidValue);
  const long long pair_blocks = (batch * n * (C / 2) + PAIR_THREADS - 1) / PAIR_THREADS;
  attn_bwd_stats_wgmma<<<unsigned(pair_blocks), PAIR_THREADS, 0, st>>>(a, batch * n, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(attn_bwd_rows_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(SMEM));
  if (err != cudaSuccess) return int(err);
  const RowsParams rp{a, batch * n, n, inv_sqrt_dk};
  attn_bwd_rows_wgmma<<<unsigned(grid), WARPGROUPS * NT, SMEM, st>>>(e_map, rp);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  attn_bwd_node_wgmma<<<unsigned(pair_blocks), PAIR_THREADS, 0, st>>>(a, batch, n, inv_sqrt_dk);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(attn_bwd_wgrad_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(k6h::WGRAD_SMEM));
  if (err != cudaSuccess) return int(err);
  attn_bwd_wgrad_wgmma<<<dim3(unsigned(W_TILES), unsigned(chunks)), WTHREADS, k6h::WGRAD_SMEM, st>>>(
      a, rows, chunk_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const long long total = 2LL * C * C + 2LL * C;
  attn_bwd_reduce_wgmma<<<unsigned((total + RTHREADS - 1) / RTHREADS), RTHREADS, 0, st>>>(a, chunks);
  return int(cudaGetLastError());
#else
  (void)ptrs, (void)batch, (void)n, (void)d, (void)inv_sqrt_dk, (void)grid, (void)chunks;
  (void)chunk_rows, (void)stream;
  return int(cudaErrorInvalidValue);
#endif
}

// The Hopper route's plan as the library computes it: {pointers in HArgs,
// dynamic shared memory of a rows-pass block and of a wgrad block, wgrad
// output tiles a row chunk, rows a wgrad stage}.
extern "C" void edge_attention_bwd_wgmma_plan(long long out[5]) {
#if ATTN_HOPPER
  out[0] = k6h::N_HPTRS;
  out[1] = (long long)ahop::SMEM;
  out[2] = (long long)k6h::WGRAD_SMEM;
  out[3] = k6h::W_TILES;
  out[4] = k6h::WKB;
#else
  out[0] = out[1] = out[2] = out[3] = out[4] = 0;
#endif
}
