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
// Two routes (ops/fused_attention.py::launch_plan chooses):
//
// bf16 at D = 128, N <= 64 (the use_pallas training path): the Hopper kernel
// attn_fwd_wgmma (attn_hopper.cuh has the plan).  Every product on wgmma and
// exact term by term: We and Woe are staged once a block as three bf16
// pieces each; e = eraw We is three passes (eraw is exact in bf16), t Woe
// the six significant piece products of t's pieces (in registers) and
// Woe's.  A block an SM over a contiguous run of slabs (b, i, :), two
// warpgroups taking them in turn, one 64-row tile a slab, the eraw rows by
// TMA; the softmax over the keys as column reductions of the tile
// (branch-free expf, one reciprocal a channel).  What bounds it on an H100
// SXM at the training shape (512 graphs of 45 atoms, rows R = 1,036,800,
// D = 128): e = 2 R D^2 = 34.0 GFLOP of bf16-exact x f32 products, 0.103 ms
// at 989 / 3 TFLOP/s; t Woe 34.0 GFLOP of f32 x f32, 0.206 ms at 165; the
// bytes (eraw in, edge_out and t out, 0.82 GB) 0.245 ms at 3.35 TB/s.  So
// the operations bound it, 0.309 ms; the 64-row tile pads N 45 to 64 (1.42x
// the products).
//
// f32, other widths and N > 64: FFMA on the CUDA cores (full f32 products,
// one fused multiply-add a term, f32 sums in another order than a plain f32
// matmul).  One block of 256 threads owns one (b, i): the N x D slab of
// eraw rows (b, i, :).  Everything after the e product is local to a
// channel, and the softmax runs over the keys j, which are the slab's rows,
// so the block needs no other block's data.  The products are tiled
// 48 rows x 128 channels (6 x 4 outputs a thread), streaming 32-deep chunks
// of the row operand and of the f32 weight through shared memory; the
// weights are read from L2 by every block and never sit whole in shared
// memory (two f32 D x D weights are 512 KB at D = 256).  The f32 t of the
// slab stays in shared memory (N x D x 4 bytes) as the operand of the
// second product and the input of the per-channel softmax.  Ragged N
// (any N) is masked: rows past N are zero in and never stored.  Its bound
// on that route: 67.9 GFLOP at 67 TFLOP/s of f32 FMA, 1.01 ms.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libfused_attention.so fused_attention.cu
// Plain C interface for ctypes; no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attn_common.cuh"
#include "attn_hopper.cuh"

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


// ---------------------------------------------------------------------------
// bf16 on Hopper (D = 128, N <= 64)
// ---------------------------------------------------------------------------
#if ATTN_HOPPER
namespace k5h {
using namespace ahop;
using bf16 = __nv_bfloat16;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* we;   // We [C in][C out], f32
  const float* be;
  const float* woe;  // Woe [C in][C out], f32
  const float* boe;
  bf16* edge_out;
  bf16* node;
  bf16* t_out;
  long long slabs;   // batch * n
  int n;
  float inv;
};

__global__ void __launch_bounds__(WARPGROUPS * NT, 1)
attn_fwd_wgmma(const __grid_constant__ CUtensorMap e_map, const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const Warpgroup wgp(smem);
  const Lane& ln = wgp.ln;
  uint8_t* we_p = smem + OFF_WE;
  uint8_t* woe_p = smem + OFF_WOE;
  float* st_m = wgp.red + 4 * C;
  float* st_l = st_m + C;  // the sum, then its reciprocal
  float* st_o = st_l + 2 * C;
  const int n = p.n;
  const SlabRange sr(p.slabs);
  if (wgp.leader()) {
    mbar_init(wgp.full, 1);
    fence_barrier_init();
    if (sr.begin + wgp.wg < sr.end) load_slab(wgp.tile, &e_map, wgp.full, (sr.begin + wgp.wg) * n);
  }
  stage_pieces(we_p, p.we);
  stage_pieces(woe_p, p.woe);
  fence_proxy_async();
  __syncthreads();

  uint32_t it = 0;
  for (long long g = sr.begin + wgp.wg; g < sr.end; g += WARPGROUPS, ++it) {
    const long long b = g / n;
    const long long row0 = g * n;
    const bf16* vb = p.v + b * n * C;
    float acc[4 * JC];
    mbar_wait(wgp.full, it & 1);

    // ---- 1. e = eraw We (three passes over We's pieces); t, its rounded
    //         copy out
    mma_tile_w3<0>(acc, wgp.tile, we_p);
    wg_sync(wgp.bar);  // the warpgroup's products have read the tile: it holds the reductions now
    attn_t(acc, p.q + g * C, p.k + b * n * C, p.be, n, p.inv, ln);
    store_bf16_rows(p.t_out, row0, n, acc, ln);

    // ---- 2. the softmax over the keys per channel, from the f32 t (kept
    //         for the product): m, l = sum exp(t - m), node = sum_j (exp(t -
    //         m) / l) v_j, the exponentials recomputed in place of a copy
    wg_col_reduce<true>(
        [&](int j, int e, int half) { return ln.row(half) < n ? acc[4 * j + 2 * half + e] : -INFINITY; },
        wgp.red, st_m, ln, wgp.bar);
    wg_col_reduce<false>(
        [&](int j, int e, int half) {
          const float x = expf(acc[4 * j + 2 * half + e] - st_m[ln.col(j, e)]);
          return ln.row(half) < n ? x : 0.0f;
        },
        wgp.red, st_l, ln, wgp.bar);
    wg_col_reduce<false>(
        [&](int j, int e, int half) {
          const int r = ln.row(half), c = ln.col(j, e);
          const float x = expf(acc[4 * j + 2 * half + e] - st_m[c]) * st_l[C + c];
          const float2 vv = r < n ? ld_pair(vb + size_t(r) * C + ln.col(j)) : make_float2(0.0f, 0.0f);
          return x * (e ? vv.y : vv.x);
        },
        wgp.red, st_o, ln, wgp.bar);
    p.node[g * C + ln.t] = __float2bfloat16_rn(st_o[ln.t]);
    fence_proxy_async();  // the reductions' writes before the next slab's eraw lands there
    wg_sync(wgp.bar);
    if (wgp.leader() && g + WARPGROUPS < sr.end)
      load_slab(wgp.tile, &e_map, wgp.full, (g + WARPGROUPS) * n);

    // ---- 3. edge_out = t Woe + boe: t's pieces x Woe's pieces
    {
      Pieces tp;
      split_acc(acc, tp);
      mma_pieces_w6<0>(acc, tp, woe_p);
    }
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      const float2 bo = *reinterpret_cast<const float2*>(p.boe + ln.col(j));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        acc[4 * j + 2 * half] += bo.x;
        acc[4 * j + 2 * half + 1] += bo.y;
      }
    }
    store_bf16_rows(p.edge_out, row0, n, acc, ln);
  }
}
}  // namespace k5h
#endif  // ATTN_HOPPER

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

// The Hopper route (bf16, D = 128, 1 <= n <= 64).  q, k, v, node_out:
// [batch, n, 128]; eraw, edge_out, t_out: [batch, n, n, 128], bf16; we, woe:
// [128, 128] f32 ([in, out], x @ W: the raw parameters, split into bf16
// pieces by the kernel); be, boe: [128] f32.  grid from
// ops/fused_attention.py::launch_plan; the block takes
// edge_attention_fwd_wgmma_smem_bytes() of shared memory.  Launches on
// `stream`, does not synchronise, allocates nothing.  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for arguments that do not
// match).
extern "C" int edge_attention_fwd_bf16_wgmma(const void* q, const void* k, const void* v,
                                             const void* eraw, const void* we, const void* be,
                                             const void* woe, const void* boe, void* edge_out,
                                             void* node_out, void* t_out, long long batch, int n,
                                             int d, float inv_sqrt_dk, int grid, void* stream) {
#if ATTN_HOPPER
  using namespace k5h;
  if (batch < 0 || n <= 0 || n > MAX_N || d != C || grid <= 0) return int(cudaErrorInvalidValue);
  if (batch == 0) return int(cudaSuccess);
  CUtensorMap e_map;
  if (!make_map(&e_map, eraw, batch * n * n, C, BM)) return int(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(attn_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(SMEM));
  if (err != cudaSuccess) return int(err);
  auto F = [](const void* x) { return static_cast<const float*>(x); };
  auto B = [](const void* x) { return static_cast<const bf16*>(x); };
  const Params p{B(q),   B(k),     B(v),
                 F(we),  F(be),    F(woe),
                 F(boe), static_cast<bf16*>(edge_out), static_cast<bf16*>(node_out),
                 static_cast<bf16*>(t_out), batch * n, n, inv_sqrt_dk};
  attn_fwd_wgmma<<<unsigned(grid), WARPGROUPS * NT, SMEM, static_cast<cudaStream_t>(stream)>>>(
      e_map, p);
  return int(cudaGetLastError());
#else
  (void)q, (void)k, (void)v, (void)eraw, (void)we, (void)be, (void)woe, (void)boe, (void)edge_out;
  (void)node_out, (void)t_out, (void)batch, (void)n, (void)d, (void)inv_sqrt_dk, (void)grid;
  (void)stream;
  return int(cudaErrorInvalidValue);
#endif
}

// Dynamic shared memory of a Hopper-route block.
extern "C" long long edge_attention_fwd_wgmma_smem_bytes(void) {
#if ATTN_HOPPER
  return (long long)ahop::SMEM;
#else
  return 0;
#endif
}
