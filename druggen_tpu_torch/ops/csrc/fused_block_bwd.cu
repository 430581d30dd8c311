// Fused encoder-block edge stream ("megablock"), backward (K8).
//
// Replaces the TPU kernel druggen_tpu/ops/fused_block.py::_bwd_kernel
// (called by _run_bwd).  Given the forward's inputs q, k, v [B, N, C] and
// y [B, N, N, C] and the cotangents gy (of y_out) and gn (of node), it
// recomputes the forward of fused_block.cu from y and returns
//
//     dq, dk, dv [B, N, C], dy [B, N, N, C]          in the stream type
//     dWe dbe dWoe dboe dg4 db4 dW1 db1 dW2 db2 dg6 db6   f32, over all rows
//
// with the Pallas kernel's rounding points, which differ from the forward's:
// We, Woe, W1 and W2 are the stream-type-rounded weights in f32; the
// recompute keeps u and h unrounded in f32 (so the ReLU mask comes from the
// f32 pre-activation); every gradient is f32 until the final casts:
//
//     e = y We + be; p = (q_i k_j) inv; t = p (e + 1) e; y1 = t Woe + boe
//     tt = y + y1; u = LN4(tt); hpre = u W1 + b1; h = relu(hpre)
//     r = u + h W2 + b2; out = LN6(r)
//     dr = LN6'(gy); dh = dr W2^T; dhpre = dh [hpre > 0]; du = dr + dhpre W1^T
//     dtt = LN4'(du); dt = dtt Woe^T + s (gn_i v_j - sum_j s gn_i v_j)
//     dp = dt (e + 1) e; de = dt p (2 e + 1); dy = dtt + de We^T
//     dq_i = sum_j dp k_j inv; dk_j = sum_i dp q_i inv; dv_j = sum_i s gn_i
//     dWe = y^T de, dWoe = t^T dtt, dW1 = u^T dhpre, dW2 = h^T dr, and the
//     vector gradients summed over the rows.
//
// What bounds it on an H100 SXM: at the training shape (R = 1,036,800 rows,
// C = 128, H = 384, bf16) it does twelve products, 2 R (6 C^2 + 6 C H) =
// 815.3 GFLOP.  The e recompute (2 R C^2 = 34.0 GFLOP) has two bf16-exact
// operands: 0.034 ms at 989 TFLOP/s.  Eight more (y1, hpre, m, dh, du, dt,
// dy, dWe: 2 R (4 C^2 + 4 C H) = 543.6 GFLOP) multiply an f32 operand by a
// bf16-exact one, exact as three bf16 passes at 989 / 3 TFLOP/s: 1.649 ms.
// dWoe, dW1 and dW2 (2 R (C^2 + 2 C H) = 237.8 GFLOP) are f32 x f32, at
// 3xTF32's 165 TFLOP/s (the faster of it and six bf16 passes): 1.441 ms.
// It must read y, gy and write dy (plus the node tensors), 0.80 GB, 0.24 ms
// at 3.35 TB/s.  So the operations bound it, 3.12 ms.
//
// bf16 at C = 128, H a multiple of 128, N <= 64 (the training path): seven
// launches, every product on wgmma (block_hopper.cuh has the plan), no
// float atomics (the same inputs give the same bits on every run).
//
// The rows launches (1a-1d) are persistent blocks of one warpgroup per SM,
// each block a contiguous run of slabs (b, i, :), one slab at a time as a
// 64-row tile; every f32 left operand goes to the tensor cores as three
// bf16 pieces (in shared memory, or for a 64-hidden chunk in registers);
// an f32 tile kept in pieces reads back exactly; the column reductions
// over the tile (the softmax's max, sum and sum_j s gn v; dq) and the
// LayerNorm sums are shuffles in a fixed order.  The recompute and the
// backward are four launches and not one because one kernel holding all of
// it needs more than 255 registers a thread: it spilled ~1.5 KB a thread,
// past what L1 holds beside 220 KB of shared memory, and ran at 355,000
// cycles a slab; split, the four take ~169,000 together (clock64 traces
// on the H100).  What passes between them is what the wgrad pass reads
// anyway, plus small per-row and per-slab values:
//   1a. block_bwd_fwd_attn_wgmma   y (TMA) -> e -> t -> the softmax's
//       statistics -> y1 = t Woe -> LN4.  Writes t, LN4's xhat and 1 / std,
//       the slabs' max, 1 / sum and sum_j (gn v_j) s.
//   1b. block_bwd_fwd_mlp_wgmma    u = xhat g4 + b4 -> h = relu(u W1 + b1)
//       and m = h W2 chunk by chunk (W1^T, W2^T through a TMA ring) -> LN6's
//       backward.  Writes h, the ReLU mask (a bit a unit) and dr.
//   1c. block_bwd_mlp_wgmma        dr -> dhpre = (dr W2^T) [hpre > 0], du =
//       dr + dhpre W1^T -> LN4's backward.  Writes dhpre and dtt.
//   1d. block_bwd_attn_wgmma       dtt -> dt = dtt Woe^T + s (gn v_j -
//       dot) -> e again (y by TMA) -> dp, de -> dq; dy = dtt + de We^T.
//       Writes de, dp, dq and dy.
//   2. block_bwd_node   dk_j = inv sum_i dp_ij q_i and dv_j = sum_i s_ij
//      gn_i over the query atoms of each graph, in order: one thread a
//      (b, j, column pair).
//   3. block_bwd_wgrad_wgmma   dWe = y^T de, dWoe = t^T dtt, dW1 = u^T
//      dhpre, dW2^T = dr^T h as split-K products: a block of two
//      warpgroups owns a 128 x 128 output tile and a run of rows; each
//      64-row stage is split into bf16 pieces on the CUDA cores (all its
//      loads issued first) into one of two stage buffers while the other's
//      products run (three piece products for y^T de, six for f32 x f32);
//      the bias gradients are column sums of the same stages.  The floor of
//      this route is the operands' traffic: 5.84 GB written and read once is
//      3.5 ms at 3.35 TB/s.
//   4. block_bwd_reduce_wgmma   the partials summed in a fixed order.
// Device scratch at the training shape: 6.50 GB (the CUDA-core route's:
// 6.91 GB).
//
// Other widths, N > 64, and the f32 twin: the CUDA-core route below, three
// launches.  Every product runs as K5's 48 x 128 f32 FFMA tiles
// (attn_common.cuh): full f32 products, f32 sums in another order.
//
//   1. rows    one block per graph b, looping over its query rows i.  Per
//              slab (b, i, :) it recomputes the forward and runs the
//              backward phase by phase; each phase's f32 rows go to device
//              memory once (e, t, u, LN4's xhat and rstd, h, dr, dhpre, dtt,
//              de), and row-wise LayerNorm phases take the 48-row chunks
//              through a shared-memory stage.  dk and dv of the graph sum
//              over i in a per-graph f32 buffer that only this block
//              touches; each warp keeps its own sums of the vector
//              gradients and writes them once.
//   2. wgrad   dWe = y^T de, dWoe = t^T dtt, dW1 = u^T dhpre, dW2 = h^T dr as
//              split-K products: a block owns one 128 x 128 output tile and a
//              run of rows, streams 32-row slabs of both operands through
//              shared memory and writes its f32 partial tile.
//   3. reduce  sums the partials in a fixed order into the 12 gradients.
//
// Ragged N is masked in every launch.
//
// Widths: C and H are compile-time constants (-DKERNEL_C=... -DKERNEL_H=...,
// default 128 and 384), one library a width, as K7; both multiples of 128.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -DKERNEL_C=128 -DKERNEL_H=384 -o libfused_block_bwd.so fused_block_bwd.cu
// Plain C interface for ctypes; no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstring>

#include "attn_common.cuh"
#include "block_hopper.cuh"
#include "tail_common.cuh"

namespace {

constexpr int D = tailk::C;
constexpr int HID = tailk::H;
constexpr int NCH = tailk::NCH, VEC = tailk::VEC;
using tailk::ln_bwd;
using tailk::ln_stats;
constexpr int WARPS = THREADS / 32;
static_assert(D % CT == 0 && HID % CT == 0, "C and H must be multiples of 128");
constexpr int TD = D / CT, THD = HID / CT;  // 128-channel tiles of C and H

// One vector partial (a warp's sums): dbe dboe dg4 db4 db1 db2 dg6 db6.
constexpr int V_DBE = 0, V_DBOE = D, V_DG4 = 2 * D, V_DB4 = 3 * D, V_DB1 = 4 * D,
              V_DB2 = 4 * D + HID, V_DG6 = 5 * D + HID, V_DB6 = 6 * D + HID,
              NVEC = 7 * D + HID;
// The gradient buffer, in the order of the Pallas kernel's outputs.
constexpr long long G_DWE = 0, G_DBE = G_DWE + D * D, G_DWOE = G_DBE + D,
                    G_DBOE = G_DWOE + D * D, G_DG4 = G_DBOE + D, G_DB4 = G_DG4 + D,
                    G_DW1 = G_DB4 + D, G_DB1 = G_DW1 + (long long)D * HID,
                    G_DW2 = G_DB1 + HID, G_DB2 = G_DW2 + (long long)HID * D,
                    G_DG6 = G_DB2 + D, G_DB6 = G_DG6 + D, G_TOTAL = G_DB6 + D;

// Device pointers, in the order of the host's pointer array.
struct Args {
  // inputs in the stream type
  const void *q, *k, *v, *y, *gy, *gn;
  // f32 parameters; the four weights hold stream-type-rounded values, [in, out]
  const float *we, *be, *woe, *boe, *g4, *b4, *w1, *b1, *w2, *b2, *g6, *b6;
  // f32 transposes: We^T, Woe^T [C, C], W1^T [H, C], W2^T [C, H]
  const float *we_t, *woe_t, *w1_t, *w2_t;
  // f32 row scratch: [R, C] except h, dhp [R, H] and rstd4 [R]
  float *e, *t, *u, *xh4, *rstd4, *h, *dm, *dhp, *dtt, *de;
  // f32 per-graph sums [B, N, C]
  float *dk_acc, *dv_acc;
  // outputs in the stream type
  void *dq, *dk, *dv, *dy;
  // f32: vector partials [B * WARPS, NVEC], weight partials, the gradients
  float *vec_partial, *w_partial, *grads;
};
constexpr int N_PTRS = sizeof(Args) / sizeof(void*);
static_assert(sizeof(Args) == N_PTRS * sizeof(void*), "Args holds pointers only");

// A row of D values at p (f32 or T) into this lane's columns.
template <typename TP>
__device__ __forceinline__ void load_row(const TP* p, float v[NCH][VEC], int lane) {
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) tailk::loadv(p + tailk::col_of(ch, lane), v[ch]);
}
__device__ __forceinline__ void store_row(float* p, const float v[NCH][VEC], int lane) {
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) tailk::storev(p + tailk::col_of(ch, lane), v[ch]);
}

size_t rows_smem() { return GEMM_SMEM + size_t(RC) * D * 4 + 4 * size_t(D) * 4; }

// ---------------------------------------------------------------------------
// 1. rows: block b, loop over the query rows i.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS) block_bwd_rows_kernel(Args a, int n, float inv) {
  extern __shared__ __align__(128) float smem[];
  float* rs = smem + GEMM_SMEM / 4;  // row stage of a chunk: [RC][D]
  float* smx = rs + RC * D;          // per-channel softmax max, sum, dot, dq
  float* ssum = smx + D;
  float* sdot = ssum + D;
  float* sdq = sdot + D;

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* y = static_cast<const T*>(a.y);
  const T* gy = static_cast<const T*>(a.gy);
  const T* gn = static_cast<const T*>(a.gn);
  const long long b = blockIdx.x;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;  // ty: the warp
  const T* kb = k + b * n * D;
  const T* vb = v + b * n * D;
  float* dk_acc = a.dk_acc + b * n * D;
  float* dv_acc = a.dv_acc + b * n * D;

  for (int e = tid; e < n * D; e += THREADS) dk_acc[e] = dv_acc[e] = 0.0f;

  float g4[NCH][VEC], g6[NCH][VEC];
  load_row(a.g4, g4, tx);
  load_row(a.g6, g6, tx);
  // this warp's sums over the rows it visits (lane columns), and this
  // thread's over the rows of its product tiles (columns n0 + 4 tx + c)
  float s_dg6[NCH][VEC] = {}, s_db6[NCH][VEC] = {}, s_db2[NCH][VEC] = {},
        s_dg4[NCH][VEC] = {}, s_db4[NCH][VEC] = {}, s_dboe[NCH][VEC] = {};
  float s_dbe[TD][4] = {}, s_db1[THD][4] = {};
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    const long long g = b * n + i;   // the slab of rows (b, i, j)
    const long long ro = g * n;      // its first row
    const T* yr = y + ro * D;
    const T* gyr = gy + ro * D;
    const T* qi = q + g * D;
    const T* gni = gn + g * D;
    float* er = a.e + ro * D;
    float* tr = a.t + ro * D;
    float* ur = a.u + ro * D;
    float* xh4r = a.xh4 + ro * D;
    float* rstd4r = a.rstd4 + ro;
    float* hr = a.h + ro * HID;
    float* dmr = a.dm + ro * D;
    float* dhpr = a.dhp + ro * HID;
    float* dttr = a.dtt + ro * D;
    float* der = a.de + ro * D;

    // ---- A. e = y @ We + be; t.
    for (int n0 = 0; n0 < D; n0 += CT) {
      const int c0 = n0 + 4 * tx;
      float qv[4], bev[4];
      load4(qi + c0, qv);
      load4(a.be + c0, bev);
      for (int row0 = 0; row0 < n; row0 += RC) {
        float acc[RPT][4];
        gemm_tile(yr, D, row0, n, a.we, D, n0, D, smem, acc);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int j = row0 + ty + 8 * r;
          if (j >= n) continue;
          float kv[4], ev[4], tv[4];
          load4(kb + size_t(j) * D + c0, kv);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            ev[c] = acc[r][c] + bev[c];
            const float p = (qv[c] * kv[c]) * inv;
            tv[c] = (p * (ev[c] + 1.0f)) * ev[c];
          }
          store4(er + size_t(j) * D + c0, ev);
          store4(tr + size_t(j) * D + c0, tv);
        }
      }
    }
    __syncthreads();

    // ---- B. per channel: the softmax's max and sum, dot = sum_j s gn_i v_j,
    //         and dv_j += s gn_i.
    for (int c = tid; c < D; c += THREADS) {
      float m = -INFINITY;
      for (int j = 0; j < n; ++j) m = fmaxf(m, tr[size_t(j) * D + c]);
      float sum = 0.0f;
      for (int j = 0; j < n; ++j) sum += expf(tr[size_t(j) * D + c] - m);
      const float gc = to_float(gni[c]);
      float dot = 0.0f;
      for (int j = 0; j < n; ++j) {
        const float s = expf(tr[size_t(j) * D + c] - m) / sum;
        dot += (gc * to_float(vb[size_t(j) * D + c])) * s;
        dv_acc[j * D + c] += s * gc;
      }
      smx[c] = m;
      ssum[c] = sum;
      sdot[c] = dot;
      sdq[c] = 0.0f;
    }

    // ---- C. tt = y + (t @ Woe + boe); u = LN4(tt), its xhat and rstd.
    for (int row0 = 0; row0 < n; row0 += RC) {
      for (int n0 = 0; n0 < D; n0 += CT) {
        const int c0 = n0 + 4 * tx;
        float bov[4];
        load4(a.boe + c0, bov);
        float acc[RPT][4];
        gemm_tile(tr, D, row0, n, a.woe, D, n0, D, smem, acc);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int j = row0 + ty + 8 * r;
          if (j >= n) continue;
          float yv[4], ov[4];
          load4(yr + size_t(j) * D + c0, yv);
#pragma unroll
          for (int c = 0; c < 4; ++c) ov[c] = yv[c] + (acc[r][c] + bov[c]);
          store4(rs + size_t(j - row0) * D + c0, ov);
        }
      }
      __syncthreads();
      const int rows_here = n - row0 < RC ? n - row0 : RC;
      for (int jj = ty; jj < rows_here; jj += WARPS) {
        const long long j = row0 + jj;
        float tt[NCH][VEC], xh[NCH][VEC], uv[NCH][VEC], b4[NCH][VEC];
        load_row(rs + size_t(jj) * D, tt, tx);
        const float rstd = ln_stats(tt, xh, tx);
        load_row(a.b4, b4, tx);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
          for (int e = 0; e < VEC; ++e) uv[ch][e] = xh[ch][e] * g4[ch][e] + b4[ch][e];
        store_row(xh4r + j * D, xh, tx);
        store_row(ur + j * D, uv, tx);
        if (tx == 0) rstd4r[j] = rstd;
      }
      __syncthreads();
    }

    // ---- D. h = relu(u @ W1 + b1).
    for (int n0 = 0; n0 < HID; n0 += CT) {
      const int c0 = n0 + 4 * tx;
      float b1v[4];
      load4(a.b1 + c0, b1v);
      for (int row0 = 0; row0 < n; row0 += RC) {
        float acc[RPT][4];
        gemm_tile(ur, D, row0, n, a.w1, HID, n0, D, smem, acc);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int j = row0 + ty + 8 * r;
          if (j >= n) continue;
          float hv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) hv[c] = fmaxf(acc[r][c] + b1v[c], 0.0f);
          store4(hr + size_t(j) * HID + c0, hv);
        }
      }
    }
    __syncthreads();

    // ---- E. r = u + (h @ W2 + b2); LN6 backward: dr, into dm.
    for (int row0 = 0; row0 < n; row0 += RC) {
      for (int n0 = 0; n0 < D; n0 += CT) {
        const int c0 = n0 + 4 * tx;
        float b2v[4];
        load4(a.b2 + c0, b2v);
        float acc[RPT][4];
        gemm_tile(hr, HID, row0, n, a.w2, D, n0, HID, smem, acc);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int j = row0 + ty + 8 * r;
          if (j >= n) continue;
          float uv[4], ov[4];
          load4(ur + size_t(j) * D + c0, uv);
#pragma unroll
          for (int c = 0; c < 4; ++c) ov[c] = uv[c] + (acc[r][c] + b2v[c]);
          store4(rs + size_t(j - row0) * D + c0, ov);
        }
      }
      __syncthreads();
      const int rows_here = n - row0 < RC ? n - row0 : RC;
      for (int jj = ty; jj < rows_here; jj += WARPS) {
        const long long j = row0 + jj;
        float rv[NCH][VEC], xh[NCH][VEC], go[NCH][VEC], dr[NCH][VEC];
        load_row(rs + size_t(jj) * D, rv, tx);
        const float rstd = ln_stats(rv, xh, tx);
        load_row(gyr + j * D, go, tx);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            s_dg6[ch][e] += go[ch][e] * xh[ch][e];
            s_db6[ch][e] += go[ch][e];
          }
        ln_bwd(go, xh, rstd, g6, dr, tx);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
          for (int e = 0; e < VEC; ++e) s_db2[ch][e] += dr[ch][e];
        store_row(dmr + j * D, dr, tx);
      }
      __syncthreads();
    }

    // ---- F. dhpre = (dr @ W2^T) [hpre > 0].
#pragma unroll
    for (int n0 = 0; n0 < HID; n0 += CT) {
      const int c0 = n0 + 4 * tx;
      for (int row0 = 0; row0 < n; row0 += RC) {
        float acc[RPT][4];
        gemm_tile(dmr, D, row0, n, a.w2_t, HID, n0, D, smem, acc);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int j = row0 + ty + 8 * r;
          if (j >= n) continue;
          float hv[4], dv4[4];
          load4(hr + size_t(j) * HID + c0, hv);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            dv4[c] = hv[c] > 0.0f ? acc[r][c] : 0.0f;
            s_db1[n0 / CT][c] += dv4[c];
          }
          store4(dhpr + size_t(j) * HID + c0, dv4);
        }
      }
    }
    __syncthreads();

    // ---- G. du = dr + dhpre @ W1^T; dtt = LN4'(du).
    for (int row0 = 0; row0 < n; row0 += RC) {
      for (int n0 = 0; n0 < D; n0 += CT) {
        const int c0 = n0 + 4 * tx;
        float acc[RPT][4];
        gemm_tile(dhpr, HID, row0, n, a.w1_t, D, n0, HID, smem, acc);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int j = row0 + ty + 8 * r;
          if (j >= n) continue;
          float drv[4], ov[4];
          load4(dmr + size_t(j) * D + c0, drv);
#pragma unroll
          for (int c = 0; c < 4; ++c) ov[c] = drv[c] + acc[r][c];
          store4(rs + size_t(j - row0) * D + c0, ov);
        }
      }
      __syncthreads();
      const int rows_here = n - row0 < RC ? n - row0 : RC;
      for (int jj = ty; jj < rows_here; jj += WARPS) {
        const long long j = row0 + jj;
        float du[NCH][VEC], xh[NCH][VEC], dtt[NCH][VEC];
        load_row(rs + size_t(jj) * D, du, tx);
        load_row(xh4r + j * D, xh, tx);
        const float rstd = rstd4r[j];
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            s_dg4[ch][e] += du[ch][e] * xh[ch][e];
            s_db4[ch][e] += du[ch][e];
          }
        ln_bwd(du, xh, rstd, g4, dtt, tx);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
          for (int e = 0; e < VEC; ++e) s_dboe[ch][e] += dtt[ch][e];
        store_row(dttr + j * D, dtt, tx);
      }
      __syncthreads();
    }

    // ---- H. dt = dtt @ Woe^T + s (gn_i v_j - dot); dp and de; dq and dk.
    for (int row0 = 0; row0 < n; row0 += RC) {
#pragma unroll
      for (int n0 = 0; n0 < D; n0 += CT) {
        const int c0 = n0 + 4 * tx;
        float qv[4], gv[4];
        load4(qi + c0, qv);
        load4(gni + c0, gv);
        float acc[RPT][4];
        gemm_tile(dttr, D, row0, n, a.woe_t, D, n0, D, smem, acc);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int j = row0 + ty + 8 * r;
          if (j >= n) continue;
          float kv[4], vv[4], tv[4], ev[4], dev[4], dpv[4];
          load4(kb + size_t(j) * D + c0, kv);
          load4(vb + size_t(j) * D + c0, vv);
          load4(tr + size_t(j) * D + c0, tv);
          load4(er + size_t(j) * D + c0, ev);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int ch = c0 + c;
            const float s = expf(tv[c] - smx[ch]) / ssum[ch];
            const float ds_in = gv[c] * vv[c];
            const float dt = acc[r][c] + s * (ds_in - sdot[ch]);
            const float p = (qv[c] * kv[c]) * inv;
            dpv[c] = (dt * (ev[c] + 1.0f)) * ev[c];
            dev[c] = (dt * p) * (2.0f * ev[c] + 1.0f);
            s_dbe[n0 / CT][c] += dev[c];
          }
          store4(der + size_t(j) * D + c0, dev);
          store4(rs + size_t(j - row0) * D + c0, dpv);
        }
      }
      __syncthreads();
      const int rows_here = n - row0 < RC ? n - row0 : RC;
      for (int c = tid; c < D; c += THREADS) {
        const float qc = to_float(qi[c]);
        float dqc = sdq[c];
        for (int jj = 0; jj < rows_here; ++jj) {
          const int j = row0 + jj;
          const float dp = rs[jj * D + c];
          dqc = fmaf(dp, to_float(kb[size_t(j) * D + c]), dqc);
          dk_acc[j * D + c] = fmaf(dp, qc, dk_acc[j * D + c]);
        }
        sdq[c] = dqc;
      }
      __syncthreads();
    }
    for (int c = tid; c < D; c += THREADS)
      static_cast<T*>(a.dq)[g * D + c] = from_float<T>(sdq[c] * inv);

    // ---- I. dy = dtt + de @ We^T.
    for (int row0 = 0; row0 < n; row0 += RC) {
      for (int n0 = 0; n0 < D; n0 += CT) {
        const int c0 = n0 + 4 * tx;
        float acc[RPT][4];
        gemm_tile(der, D, row0, n, a.we_t, D, n0, D, smem, acc);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int j = row0 + ty + 8 * r;
          if (j >= n) continue;
          float dtv[4], ov[4];
          load4(dttr + size_t(j) * D + c0, dtv);
#pragma unroll
          for (int c = 0; c < 4; ++c) ov[c] = dtv[c] + acc[r][c];
          store4(static_cast<T*>(a.dy) + (ro + j) * D + c0, ov);
        }
      }
    }
    __syncthreads();
  }

  // ---- dk, dv of the graph; this warp's vector partial.
  for (int c = tid; c < D; c += THREADS)
    for (int j = 0; j < n; ++j) {
      static_cast<T*>(a.dk)[(b * n + j) * D + c] = from_float<T>(dk_acc[j * D + c] * inv);
      static_cast<T*>(a.dv)[(b * n + j) * D + c] = from_float<T>(dv_acc[j * D + c]);
    }
  float* vp = a.vec_partial + (size_t(b) * WARPS + ty) * NVEC;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int c = tailk::col_of(ch, tx) + e;
      vp[V_DG6 + c] = s_dg6[ch][e];
      vp[V_DB6 + c] = s_db6[ch][e];
      vp[V_DB2 + c] = s_db2[ch][e];
      vp[V_DG4 + c] = s_dg4[ch][e];
      vp[V_DB4 + c] = s_db4[ch][e];
      vp[V_DBOE + c] = s_dboe[ch][e];
    }
#pragma unroll
  for (int t = 0; t < TD; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) vp[V_DBE + t * CT + 4 * tx + c] = s_dbe[t][c];
#pragma unroll
  for (int t = 0; t < THD; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) vp[V_DB1 + t * CT + 4 * tx + c] = s_db1[t][c];
}

// ---------------------------------------------------------------------------
// 2. wgrad: out[z][chunk] = A_z^T B_z over the chunk's rows, for
//    z = 0: y^T de (dWe [C, C]); 1: t^T dtt (dWoe [C, C]);
//    2: u^T dhpre (dW1 [C, H]); 3: h^T dr (dW2 [H, C]).
//    blockIdx.x picks the 128 x 128 output tile, blockIdx.y the chunk.
// ---------------------------------------------------------------------------
constexpr int WT = 128;  // output tile
constexpr int KB = 32;   // rows a slab
constexpr size_t WGRAD_SMEM = 2 * size_t(KB) * WT * 4;

__host__ __device__ constexpr int m_dim(int z) { return z == 3 ? HID : D; }
__host__ __device__ constexpr int n_dim(int z) { return z == 2 ? HID : D; }
__host__ __device__ constexpr long long w_size(int z) { return (long long)m_dim(z) * n_dim(z); }
// offset of product z's partials in w_partial [sum_z chunks * w_size(z)]
__host__ __device__ constexpr long long w_offset(int z, int chunks) {
  return z == 0 ? 0 : w_offset(z - 1, chunks) + chunks * w_size(z - 1);
}

template <typename TB>
__device__ __forceinline__ void load_wslab(float* dst, const TB* src, int ld, int col0,
                                           long long r0, long long r_end, int tid) {
  for (int e = tid; e < KB * WT; e += THREADS) {
    const int r = e / WT, c = e % WT;
    dst[r * WT + c] = r0 + r < r_end ? to_float(src[(r0 + r) * ld + col0 + c]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
block_bwd_wgrad_kernel(Args a, long long rows, long long chunk_rows) {
  extern __shared__ __align__(128) float smem[];
  float* as = smem;            // [KB][WT]
  float* bs = smem + KB * WT;  // [KB][WT]
  const int z = blockIdx.z;
  const int chunk = blockIdx.y;
  const int chunks = gridDim.y;
  const int md = m_dim(z), nd = n_dim(z);
  const int tiles_n = nd / WT;
  if (int(blockIdx.x) >= (md / WT) * tiles_n) return;
  const int tm = blockIdx.x / tiles_n, tn = blockIdx.x % tiles_n;
  const float* bsrc = z == 0 ? a.de : z == 1 ? a.dtt : z == 2 ? a.dhp : a.dm;
  const float* asrc = z == 1 ? a.t : z == 2 ? a.u : a.h;   // z == 0: y
  float* out = a.w_partial + w_offset(z, chunks) + chunk * w_size(z);
  const long long r_begin = chunk * chunk_rows;
  const long long r_end_raw = r_begin + chunk_rows;
  const long long r_end = r_end_raw < rows ? r_end_raw : rows;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // output rows 8 ty.., columns 8 tx..
  float acc[8][8] = {};
  for (long long r0 = r_begin; r0 < r_end; r0 += KB) {
    if (z == 0)
      load_wslab(as, static_cast<const T*>(a.y), md, tm * WT, r0, r_end, tid);
    else
      load_wslab(as, asrc, md, tm * WT, r0, r_end, tid);
    load_wslab(bs, bsrc, nd, tn * WT, r0, r_end, tid);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KB; ++kk) {
      float av[8], bv[8];
      load4(as + kk * WT + ty * 8, av);
      load4(as + kk * WT + ty * 8 + 4, av + 4);
      load4(bs + kk * WT + tx * 8, bv);
      load4(bs + kk * WT + tx * 8 + 4, bv + 4);
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[x][c] = fmaf(av[x], bv[c], acc[x][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    float* o = out + size_t(tm * WT + ty * 8 + x) * nd + tn * WT + tx * 8;
    store4(o, acc[x]);
    store4(o + 4, acc[x] + 4);
  }
}

// ---------------------------------------------------------------------------
// 3. reduce: each gradient a fixed-order sum of its partials.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
block_bwd_reduce_kernel(Args a, int chunks, long long n_vec) {
  const long long g = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (g >= G_TOTAL) return;
  const float* src;
  long long stride, count;
  int z = -1;
  long long idx = 0;
  if (g < G_DBE) { z = 0; idx = g - G_DWE; }
  else if (g >= G_DWOE && g < G_DBOE) { z = 1; idx = g - G_DWOE; }
  else if (g >= G_DW1 && g < G_DB1) { z = 2; idx = g - G_DW1; }
  else if (g >= G_DW2 && g < G_DB2) { z = 3; idx = g - G_DW2; }
  if (z >= 0) {
    src = a.w_partial + w_offset(z, chunks) + idx;
    stride = w_size(z);
    count = chunks;
  } else {
    int off;
    if (g < G_DWOE) off = V_DBE + int(g - G_DBE);
    else if (g < G_DG4) off = V_DBOE + int(g - G_DBOE);
    else if (g < G_DB4) off = V_DG4 + int(g - G_DG4);
    else if (g < G_DW1) off = V_DB4 + int(g - G_DB4);
    else if (g < G_DW2) off = V_DB1 + int(g - G_DB1);
    else if (g < G_DG6) off = V_DB2 + int(g - G_DB2);
    else if (g < G_DB6) off = V_DG6 + int(g - G_DG6);
    else off = V_DB6 + int(g - G_DB6);
    src = a.vec_partial + off;
    stride = NVEC;
    count = n_vec;
  }
  float sum = 0.0f;
  for (long long p = 0; p < count; ++p) sum += src[p * stride];
  a.grads[g] = sum;
}

template <typename T>
int launch(const void* const* ptrs, long long batch, int n, int d, int h, float inv, int chunks,
           long long chunk_rows, void* stream) {
  const long long rows = batch * n * n;
  if (batch <= 0 || n <= 0 || d != D || h != HID || chunks <= 0 || chunk_rows <= 0 ||
      chunk_rows % KB != 0 || chunk_rows * chunks < rows)
    return int(cudaErrorInvalidValue);
  Args a;
  std::memcpy(&a, ptrs, sizeof(Args));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem_rows = rows_smem();
  cudaError_t err = cudaFuncSetAttribute(block_bwd_rows_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem_rows));
  if (err != cudaSuccess) return int(err);
  block_bwd_rows_kernel<T><<<unsigned(batch), THREADS, smem_rows, st>>>(a, n, inv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(block_bwd_wgrad_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(WGRAD_SMEM));
  if (err != cudaSuccess) return int(err);
  const unsigned tiles = unsigned(TD * (THD > TD ? THD : TD));
  block_bwd_wgrad_kernel<T><<<dim3(tiles, unsigned(chunks), 4), THREADS, WGRAD_SMEM, st>>>(
      a, rows, chunk_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  block_bwd_reduce_kernel<<<unsigned((G_TOTAL + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      a, chunks, batch * WARPS);
  return int(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// bf16 on Hopper (C = 128, N <= 64): rows, node, wgrad, reduce
// ---------------------------------------------------------------------------
#if BLOCK_HOPPER
namespace k8 {
using namespace blk;
using bf16 = __nv_bfloat16;
// A rows-pass vector partial (one a warp): dg4 db4 dg6 db6.  A wgrad vector
// partial (one a row chunk): the column sums of de, dtt, dhpre and dr (dbe,
// dboe, db1, db2).
constexpr int R_DG4 = 0, R_DB4 = C, R_DG6 = 2 * C, R_DB6 = 3 * C, VR = 4 * C;
constexpr int W_DBE = 0, W_DBOE = C, W_DB1 = 2 * C, W_DB2 = 2 * C + H, VW = 3 * C + H;

// Device pointers, in the order of the host's pointer array.
struct HArgs {
  // inputs, bf16: q, k, v, gn [B, N, C]; y, gy [B, N, N, C]
  const void *q, *k, *v, *y, *gy, *gn;
  // bf16 weights: We^T, Woe^T [C, C]; W1^T [HP, CP], W2^T [CP, HP] (K1's layout)
  const void *we_t, *woe_t, *w1t, *w2t;
  // f32 vectors
  const float *be, *boe, *g4, *b4, *b1, *b2, *g6, *b6;
  // f32 rows written by the rows launches for the later launches: t, LN4's
  // xhat, dr, dtt, de, dp [R, C]; h, dhpre [R, H]; the slabs' softmax max,
  // 1 / sum and sum_j (gn v_j) s [B N, C]; LN4's 1 / std [R]
  float *t, *xh4, *dr, *dtt, *de, *dp, *h, *dhp, *stat_m, *stat_l, *stat_dot, *rstd4;
  // the ReLU mask, a 32-bit word a thread and hidden chunk [B N][H / 64][128]
  uint32_t* live;
  // outputs, bf16
  void *dq, *dk, *dv, *dy;
  // f32: vector partials [grid * 4, VR] and [chunks, VW], weight partials,
  // the gradients
  float *vec_partial, *wvec_partial, *w_partial, *grads;
};
constexpr int N_HPTRS = sizeof(HArgs) / sizeof(void*);
static_assert(sizeof(HArgs) == N_HPTRS * sizeof(void*), "HArgs holds pointers only");

struct RowsParams {
  HArgs a;
  long long slabs;  // batch * n
  int n;
  float inv;
};

// acc[i][e] += the warp's column sums of f(j, e, half) over its 16 rows,
// reduce-scattered (warp_scatter<JC>): this lane's J / 8 column pairs.
template <typename F>
__device__ __forceinline__ void vsum_c(F&& f, float (&acc)[JC / 8][2]) {
  float u[JC / 2][2];
  warp_scatter<JC, false>([&](int j, int e) { return f(j, e, 0) + f(j, e, 1); }, u);
#pragma unroll
  for (int i = 0; i < JC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) acc[i][e] += u[i][e];
}

// dx = ((dxh - mean dxh) - xhat mean(dxh xhat)) rstd with dxh = dy g, in
// place of dy (the Pallas kernels' LayerNorm backward), rows over a quad.
__device__ __forceinline__ void ln_back(float (&dy)[4 * JC], const float (&xh)[4 * JC],
                                        const float (&rstd)[2], const float* __restrict__ g,
                                        const Lane& ln) {
  float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < JC; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float gv = __ldg(g + ln.col(j, e));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * j + 2 * half + e;
        dy[i] = dy[i] * gv;
        s1[half] += dy[i];
        s2[half] += dy[i] * xh[i];
      }
    }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    s1[half] = quad_sum(s1[half]) * (1.0f / C);
    s2[half] = quad_sum(s2[half]) * (1.0f / C);
  }
#pragma unroll
  for (int j = 0; j < JC; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * half + e;
        dy[i] = ((dy[i] - s1[half]) - xh[i] * s2[half]) * rstd[half];
      }
}

// Issue (and commit) a chunk's first product into a zeroed 64-column
// accumulator, from the f32 tile whose three pieces are in P: TB 0: u W1[:,
// j] (forward); TB 1: dr W2^T[:, j] (backward).
template <int TB>
__device__ __forceinline__ void issue_first(float (&acc1)[32], const uint8_t* P, const Chunk& ch) {
  zero(acc1);
  fence_regs(acc1);
  wgmma_fence();
#pragma unroll
  for (int piece = 2; piece >= 0; --piece)
#pragma unroll
    for (int kk = 0; kk < CP / 16; ++kk)
      Mma<64>::ss<0, TB>(acc1, a_tile(P + piece * TILE_BYTES, kk), TB ? b_w2t(ch, kk) : b_w1(ch, kk));
  wgmma_commit();
}

// Shared set-up of the rows launches: the staged square weights, the
// mbarriers, this block's run of slabs and the first loads.  Every buffer is
// an offset from the one base (rows:: in block_hopper.cuh).
struct RowsBlock {
  uint8_t* smem;
  SlabRange sr;
  long long chunks;  // ring loads this block consumes

  __device__ __forceinline__ uint8_t* we_s() const { return smem + rows::OFF_WE; }
  __device__ __forceinline__ uint8_t* woe_s() const { return smem + rows::OFF_WOE; }
  __device__ __forceinline__ uint8_t* y_buf() const { return smem + rows::OFF_Y; }
  __device__ __forceinline__ uint8_t* P() const { return smem + rows::OFF_P; }
  __device__ __forceinline__ float* S() const { return reinterpret_cast<float*>(smem + rows::OFF_S); }
  __device__ __forceinline__ uint8_t* ring() const { return smem + rows::OFF_RING; }
  // column reductions: scratch [4][C], then a result and its reciprocal
  // [2][C], the slab's softmax max [C], sum and 1 / sum [2][C], sum_j (gn
  // v_j) s [C]
  __device__ __forceinline__ float* red() const { return reinterpret_cast<float*>(smem + rows::OFF_RED); }
  __device__ __forceinline__ float* st_o() const { return red() + 4 * C; }
  __device__ __forceinline__ float* st_m() const { return red() + 6 * C; }
  __device__ __forceinline__ float* st_l() const { return red() + 7 * C; }
  __device__ __forceinline__ float* st_dot() const { return red() + 9 * C; }
  __device__ __forceinline__ uint64_t* full_y() const {
    return reinterpret_cast<uint64_t*>(smem + rows::OFF_BAR);
  }
  __device__ __forceinline__ uint64_t* ring_full() const { return full_y() + 1; }

  // y_map null: the launch reads no y tile and stages no square weight;
  // w1_map null: it streams no W1/W2 chunk.
  __device__ __forceinline__ RowsBlock(uint8_t* base, const HArgs& a, long long slabs, int n,
                                       const CUtensorMap* y_map, const CUtensorMap* w1_map,
                                       const CUtensorMap* w2_map)
      : smem(base), sr(slabs), chunks(w1_map ? (sr.end - sr.begin) * NJ : 0) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < 1 + rows::RING; ++i) mbar_init(full_y() + i, 1);
      fence_barrier_init();
    }
    if (y_map) {
      stage_square(we_s(), static_cast<const bf16*>(a.we_t));
      stage_square(woe_s(), static_cast<const bf16*>(a.woe_t));
      fence_proxy_async();
    }
    __syncthreads();
    if (threadIdx.x == 0 && sr.end > sr.begin) {
      if (y_map) load_slab(y_buf(), y_map, full_y(), sr.begin * n);
      for (int c = 0; c < rows::RING && c < chunks; ++c)
        load_chunk(ring() + size_t(c) * CHUNK_BYTES, ring_full() + c, w1_map, w2_map, c % NJ);
    }
  }
};

// This warp's reduce-scattered sums of two C-wide vectors into its
// vector-partial row at the offsets o1 and o2.
__device__ __forceinline__ void write_vsums(const HArgs& a, const Lane& ln, int o1,
                                            const float (&s1)[JC / 8][2], int o2,
                                            const float (&s2)[JC / 8][2]) {
  float* vp = a.vec_partial + (size_t(blockIdx.x) * 4 + ln.warp) * VR;
#pragma unroll
  for (int i = 0; i < JC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * scattered_j<JC>(i) + 2 * ln.q + e;
      vp[o1 + c] = s1[i][e];
      vp[o2 + c] = s2[i][e];
    }
}

// 1a. The recompute of the attention half of K7's forward, with the
// backward's rounding points: e, t, the softmax's statistics, y1 and LN4.
// Writes t, LN4's xhat and 1 / std, and the slabs' statistics.
__global__ void __launch_bounds__(NT, 1)
block_bwd_fwd_attn_wgmma(const __grid_constant__ CUtensorMap y_map,
                          const __grid_constant__ CUtensorMap w1_map,
                          const __grid_constant__ CUtensorMap w2_map,
                          const __grid_constant__ RowsParams rp) {
  extern __shared__ uint8_t smem_raw[];
  const HArgs& a = rp.a;
  const int n = rp.n;
  RowsBlock rb(aligned_smem(smem_raw), a, rp.slabs, n, &y_map, nullptr, nullptr);
  const Lane ln(threadIdx.x);
  const bf16* gn = static_cast<const bf16*>(a.gn);

  uint32_t it = 0;
  for (long long g = rb.sr.begin; g < rb.sr.end; ++g, ++it) {
    const long long b = g / n;
    const long long row0 = g * n;
    float acc[4 * JC], w[4 * JC];
    mbar_wait(rb.full_y(), it & 1);

    // ---- A. e = y We; t (stored for dWoe and the later launches; its
    //         pieces into P for y1)
    mma_tile_sq(acc, rb.y_buf(), rb.we_s());
    attn_t(acc, static_cast<const bf16*>(a.q) + g * C, static_cast<const bf16*>(a.k) + b * n * C,
           a.be, n, rp.inv, ln);
    store_rows_s(rb.S(), a.t, C, 0, row0, n, acc, ln);
    store_pieces(rb.P(), acc, ln);

    // ---- B. the softmax per channel: m, ex = exp(t - m) in place of t,
    //         l = sum ex, s = ex / l; dot = sum_j (gn v_j) s
    load_pairs(static_cast<const bf16*>(a.v), b * n, n, w, ln);
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      const float2 gv = ld_pair(gn + g * C + ln.col(j));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        w[4 * j + 2 * half] = gv.x * w[4 * j + 2 * half];  // ds_in = gn v_j
        w[4 * j + 2 * half + 1] = gv.y * w[4 * j + 2 * half + 1];
      }
    }
    col_reduce<true>(
        [&](int j, int e, int half) { return ln.row(half) < n ? acc[4 * j + 2 * half + e] : -INFINITY; },
        rb.red(), rb.st_m(), ln);
    softmax_ex(acc, rb.st_m(), n, ln);
    col_reduce<false>([&](int j, int e, int half) { return acc[4 * j + 2 * half + e]; }, rb.red(),
                      rb.st_l(), ln);
    col_reduce<false>(
        [&](int j, int e, int half) {
          const int i = 4 * j + 2 * half + e;
          return w[i] * (acc[i] * rb.st_l()[C + ln.col(j, e)]);
        },
        rb.red(), rb.st_dot(), ln);
    a.stat_m[g * C + threadIdx.x] = rb.st_m()[threadIdx.x];
    a.stat_l[g * C + threadIdx.x] = rb.st_l()[C + threadIdx.x];
    a.stat_dot[g * C + threadIdx.x] = rb.st_dot()[threadIdx.x];

    // ---- C. y1 = t Woe; LN4: xhat and 1 / std (stored)
    fence_proxy_async();
    __syncthreads();
    mma_pieces_sq<0>(acc, rb.P(), rb.woe_s());
    float mu[2], rstd[2];
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      const float2 bo = *reinterpret_cast<const float2*>(a.boe + ln.col(j));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 yv = tile_pair(rb.y_buf(), ln, j, half);
        w[4 * j + 2 * half] = yv.x + (acc[4 * j + 2 * half] + bo.x);
        w[4 * j + 2 * half + 1] = yv.y + (acc[4 * j + 2 * half + 1] + bo.y);
      }
    }
    row_stats(w, ln, mu, rstd);
#pragma unroll
    for (int i = 0; i < 4 * JC; ++i) {
      const int half = (i >> 1) & 1;
      w[i] = __fmul_rn(__fsub_rn(w[i], mu[half]), rstd[half]);
    }
    if (ln.q == 0)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        if (ln.row(half) < n) a.rstd4[row0 + ln.row(half)] = rstd[half];
    store_rows_s(rb.S(), a.xh4, C, 0, row0, n, w, ln);  // ends past a barrier: y and P are read
    if (threadIdx.x == 0 && g + 1 < rb.sr.end) load_slab(rb.y_buf(), &y_map, rb.full_y(), (g + 1) * n);
  }
}

// 1b. The recompute of the MLP half, from LN4's xhat: u = xhat g4 + b4 (as
// 1a computed it), h = relu(u W1 + b1), r = u + h W2 + b2, and LN6's
// backward.  Writes h, the ReLU mask bits and dr, and the sums of dg6 and
// db6.
__global__ void __launch_bounds__(NT, 1)
block_bwd_fwd_mlp_wgmma(const __grid_constant__ CUtensorMap y_map,
                        const __grid_constant__ CUtensorMap w1_map,
                        const __grid_constant__ CUtensorMap w2_map,
                        const __grid_constant__ RowsParams rp) {
  extern __shared__ uint8_t smem_raw[];
  const HArgs& a = rp.a;
  const int n = rp.n;
  RowsBlock rb(aligned_smem(smem_raw), a, rp.slabs, n, nullptr, &w1_map, &w2_map);
  const Lane ln(threadIdx.x);
  float s_dg6[JC / 8][2] = {}, s_db6[JC / 8][2] = {};

  long long nc = 0;  // ring position
  for (long long g = rb.sr.begin; g < rb.sr.end; ++g) {
    const long long row0 = g * n;
    float acc[4 * JC], w[4 * JC];
    float mu[2], rstd[2];
    load_rows_s(rb.S(), a.xh4, C, 0, row0, n, w, ln);
#pragma unroll
    for (int j = 0; j < JC; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = ln.col(j, e);
        const float gv = __ldg(a.g4 + c), bv = __ldg(a.b4 + c);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          w[4 * j + 2 * half + e] = __fmaf_rn(w[4 * j + 2 * half + e], gv, bv);
      }
    store_pieces(rb.P(), w, ln);  // u
    fence_proxy_async();
    __syncthreads();

    // ---- D. the hidden in chunks: h = relu(u W1 + b1) (stored), m = h W2
    zero(acc);
    for (int j = 0; j < NJ; ++j, ++nc) {
      mbar_wait(rb.ring_full() + nc % rows::RING, uint32_t(nc / rows::RING) & 1);
      const Chunk ch = ring_chunk(rb.ring() + size_t(nc % rows::RING) * CHUNK_BYTES);
      float acc1[32];
      issue_first<0>(acc1, rb.P(), ch);
      wgmma_wait<0>();
      fence_regs(acc1);
      uint32_t bits = 0;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float bb = __ldg(a.b1 + j * HJ + ln.col(jj, e));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = 4 * jj + 2 * half + e;
            const float x = acc1[i] + bb;
            const bool on = x > 0.0f;
            bits |= uint32_t(on) << i;
            acc1[i] = on ? x : 0.0f;
          }
        }
      a.live[(g * NJ + j) * NT + threadIdx.x] = bits;  // the ReLU mask, for the rows launch
      uint32_t hp[3][4][4];
      split_regs(acc1, hp);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int piece = 2; piece >= 0; --piece)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) Mma<CP>::rs<0>(acc, hp[piece][kk], b_w2(ch, kk));
      wgmma_commit();
      store_rows_s(rb.S(), a.h, H, j * HJ, row0, n, acc1, ln);  // while the product runs
      wgmma_wait<0>();
      fence_regs(acc);
      refill_ring(rb.ring(), rb.ring_full(), rows::RING, nc, rb.chunks, &w1_map, &w2_map);
    }

    // ---- E. r = u + (m + b2); LN6 backward: dr (stored)
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(a.b2 + ln.col(j));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 uv = load_exact(rb.P(), tile_off(ln.row(half), j, ln.q));
        w[4 * j + 2 * half] = uv.x + (acc[4 * j + 2 * half] + bb.x);
        w[4 * j + 2 * half + 1] = uv.y + (acc[4 * j + 2 * half + 1] + bb.y);
      }
    }
    row_stats(w, ln, mu, rstd);
    load_pairs(static_cast<const bf16*>(a.gy), row0, n, acc, ln);  // gy, 0 past n
#pragma unroll
    for (int i = 0; i < 4 * JC; ++i) {
      const int half = (i >> 1) & 1;
      w[i] = __fmul_rn(__fsub_rn(w[i], mu[half]), rstd[half]);  // xhat6
    }
    vsum_c([&](int j, int e, int half) { return acc[4 * j + 2 * half + e] * w[4 * j + 2 * half + e]; },
           s_dg6);
    vsum_c([&](int j, int e, int half) { return acc[4 * j + 2 * half + e]; }, s_db6);
    ln_back(acc, w, rstd, a.g6, ln);  // dr
    store_rows_s(rb.S(), a.dr, C, 0, row0, n, acc, ln);  // ends past a barrier: P is read
  }
  write_vsums(a, ln, R_DG6, s_dg6, R_DB6, s_db6);
}

// 1c. The backward from dr through fc2, the ReLU, fc1 and LN4.  Writes
// dhpre and dtt and the sums of dg4 and db4.
__global__ void __launch_bounds__(NT, 1)
block_bwd_mlp_wgmma(const __grid_constant__ CUtensorMap y_map,
                    const __grid_constant__ CUtensorMap w1_map,
                    const __grid_constant__ CUtensorMap w2_map,
                    const __grid_constant__ RowsParams rp) {
  extern __shared__ uint8_t smem_raw[];
  const HArgs& a = rp.a;
  const int n = rp.n;
  RowsBlock rb(aligned_smem(smem_raw), a, rp.slabs, n, nullptr, &w1_map, &w2_map);
  const Lane ln(threadIdx.x);
  float s_dg4[JC / 8][2] = {}, s_db4[JC / 8][2] = {};

  uint32_t it = 0;
  long long nc = 0;  // ring position
  for (long long g = rb.sr.begin; g < rb.sr.end; ++g, ++it) {
    const long long row0 = g * n;
    float acc[4 * JC], w[4 * JC];

    // ---- F. dr's pieces into P; dhpre = (dr W2^T) [hpre > 0] (stored, the
    //         mask from the recompute's bits); du = dhpre W1^T
    load_rows_s(rb.S(), a.dr, C, 0, row0, n, acc, ln);
    store_pieces(rb.P(), acc, ln);
    fence_proxy_async();
    __syncthreads();
    zero(w);
    for (int j = 0; j < NJ; ++j, ++nc) {
      const uint32_t bits = a.live[(g * NJ + j) * NT + threadIdx.x];
      mbar_wait(rb.ring_full() + nc % rows::RING, uint32_t(nc / rows::RING) & 1);
      const Chunk ch = ring_chunk(rb.ring() + size_t(nc % rows::RING) * CHUNK_BYTES);
      float acc1[32];
      issue_first<1>(acc1, rb.P(), ch);
      wgmma_wait<0>();
      fence_regs(acc1);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc1[i] = (bits >> i) & 1u ? acc1[i] : 0.0f;
      uint32_t dp3[3][4][4];
      split_regs(acc1, dp3);
      fence_regs(w);
      wgmma_fence();
#pragma unroll
      for (int piece = 2; piece >= 0; --piece)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) Mma<CP>::rs<1>(w, dp3[piece][kk], b_w1t(ch, kk));
      wgmma_commit();
      store_rows_s(rb.S(), a.dhp, H, j * HJ, row0, n, acc1, ln);  // while the product runs
      wgmma_wait<0>();
      fence_regs(w);
      refill_ring(rb.ring(), rb.ring_full(), rows::RING, nc, rb.chunks, &w1_map, &w2_map);
    }

    // ---- G. du = dr + dhpre W1^T; LN4 backward: dtt (stored; pieces in P)
#pragma unroll
    for (int j = 0; j < JC; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 dv2 = load_exact(rb.P(), tile_off(ln.row(half), j, ln.q));
        w[4 * j + 2 * half] = dv2.x + w[4 * j + 2 * half];
        w[4 * j + 2 * half + 1] = dv2.y + w[4 * j + 2 * half + 1];
      }
    load_rows_s(rb.S(), a.xh4, C, 0, row0, n, acc, ln);  // LN4's xhat
    float rstd[2];
#pragma unroll
    for (int half = 0; half < 2; ++half)
      rstd[half] = ln.row(half) < n ? a.rstd4[row0 + ln.row(half)] : 0.0f;
    vsum_c([&](int j, int e, int half) { return w[4 * j + 2 * half + e] * acc[4 * j + 2 * half + e]; },
           s_dg4);
    vsum_c([&](int j, int e, int half) { return w[4 * j + 2 * half + e]; }, s_db4);
    ln_back(w, acc, rstd, a.g4, ln);  // dtt
    store_rows_s(rb.S(), a.dtt, C, 0, row0, n, w, ln);  // ends past a barrier: P is read
  }
  write_vsums(a, ln, R_DG4, s_dg4, R_DB4, s_db4);
}

// 1d. The backward through the softmax and the modulation, from dtt:
// dt = dtt Woe^T + s (gn v_j - dot), e recomputed, dp and de, dq, and dy =
// dtt + de We^T.  Writes de, dp, dq and dy.
__global__ void __launch_bounds__(NT, 1)
block_bwd_attn_wgmma(const __grid_constant__ CUtensorMap y_map,
                     const __grid_constant__ CUtensorMap w1_map,
                     const __grid_constant__ CUtensorMap w2_map,
                     const __grid_constant__ RowsParams rp) {
  extern __shared__ uint8_t smem_raw[];
  const HArgs& a = rp.a;
  const int n = rp.n;
  RowsBlock rb(aligned_smem(smem_raw), a, rp.slabs, n, &y_map, nullptr, nullptr);
  const Lane ln(threadIdx.x);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* gn = static_cast<const bf16*>(a.gn);

  uint32_t it = 0;
  for (long long g = rb.sr.begin; g < rb.sr.end; ++g, ++it) {
    const long long b = g / n;
    const long long row0 = g * n;
    const bf16* kb = k + b * n * C;
    float acc[4 * JC], w[4 * JC];
    load_rows_s(rb.S(), a.dtt, C, 0, row0, n, acc, ln);
    store_pieces(rb.P(), acc, ln);
    fence_proxy_async();
    __syncthreads();

    // ---- H. dt = dtt Woe^T + s (gn v_j - dot); e again; dp, de (stored); dq
    {
      float* sg = rb.red();  // gn_i and the slab's statistics, by column
      sg[threadIdx.x] = __bfloat162float(gn[g * C + threadIdx.x]);
      sg[C + threadIdx.x] = a.stat_m[g * C + threadIdx.x];
      sg[2 * C + threadIdx.x] = a.stat_l[g * C + threadIdx.x];
      sg[3 * C + threadIdx.x] = a.stat_dot[g * C + threadIdx.x];
      load_rows_s(rb.S(), a.t, C, 0, row0, n, w, ln);  // its barriers order sg too
#pragma unroll
      for (int j = 0; j < JC; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = ln.row(half);
          const float2 vv = r < n ? ld_pair(static_cast<const bf16*>(a.v) + (b * n + r) * C + ln.col(j))
                                  : make_float2(0.0f, 0.0f);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = ln.col(j, e), i = 4 * j + 2 * half + e;
            const float s = expf(w[i] - sg[C + c]) * sg[2 * C + c];
            const float ds_in = sg[c] * (e ? vv.y : vv.x);
            w[i] = r < n ? s * (ds_in - sg[3 * C + c]) : 0.0f;
          }
        }
    }
    mma_pieces_sq<1>(acc, rb.P(), rb.woe_s());
#pragma unroll
    for (int i = 0; i < 4 * JC; ++i) w[i] = acc[i] + w[i];  // dt
    mbar_wait(rb.full_y(), it & 1);  // this slab's y, for e
    mma_tile_sq(acc, rb.y_buf(), rb.we_s());  // y We
    __syncthreads();                      // y read: bring the next slab's
    if (threadIdx.x == 0 && g + 1 < rb.sr.end) load_slab(rb.y_buf(), &y_map, rb.full_y(), (g + 1) * n);
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      const int c = ln.col(j);
      const float2 qv = ld_pair(static_cast<const bf16*>(a.q) + g * C + c);
      const float2 bv = *reinterpret_cast<const float2*>(a.be + c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = ln.row(half);
        const float2 kv = r < n ? ld_pair(kb + size_t(r) * C + c) : make_float2(0.0f, 0.0f);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * half + e;
          const float ev = acc[i] + (e ? bv.y : bv.x);
          const float p = ((e ? qv.y : qv.x) * (e ? kv.y : kv.x)) * rp.inv;
          const float dt = w[i];
          w[i] = (dt * (ev + 1.0f)) * ev;        // dp
          acc[i] = (dt * p) * (2.0f * ev + 1.0f);  // de
        }
      }
    }
    store_rows_s(rb.S(), a.de, C, 0, row0, n, acc, ln);
    store_rows_s(rb.S(), a.dp, C, 0, row0, n, w, ln);
    store_pieces(rb.P(), acc, ln);  // dtt's pieces were read by the dt product
    load_pairs(kb, 0, n, acc, ln);  // k_j, 0 past n
    col_reduce<false>([&](int j, int e, int half) { return w[4 * j + 2 * half + e] * acc[4 * j + 2 * half + e]; },
                      rb.red(), rb.st_o(), ln);
    static_cast<bf16*>(a.dq)[g * C + threadIdx.x] = __float2bfloat16_rn(rb.st_o()[threadIdx.x] * rp.inv);
    fence_proxy_async();
    __syncthreads();

    // ---- I. dy = dtt + de We^T
    mma_pieces_sq<1>(w, rb.P(), rb.we_s());
    load_rows_s(rb.S(), a.dtt, C, 0, row0, n, acc, ln);
#pragma unroll
    for (int i = 0; i < 4 * JC; ++i) acc[i] = acc[i] + w[i];
    store_bf16_rows(static_cast<bf16*>(a.dy), row0, n, acc, ln);
    __syncthreads();  // the dy product is done with P
  }
}

// dk_j = inv sum_i dp_ij q_i and dv_j = sum_i s_ij gn_i, summed over the
// query atoms i of the graph in order; s recomputed from t and the slab's
// statistics as the rows pass computed it.  One thread a (b, j, column pair).
constexpr int NODE_THREADS = 256;
__global__ void __launch_bounds__(NODE_THREADS)
block_bwd_node(const __grid_constant__ HArgs a, long long batch, int n, float inv) {
  const long long idx = blockIdx.x * (long long)NODE_THREADS + threadIdx.x;
  if (idx >= batch * n * (C / 2)) return;
  const int c = 2 * int(idx % (C / 2));
  const long long bj = idx / (C / 2);
  const long long b = bj / n;
  const int j = int(bj % n);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* gn = static_cast<const bf16*>(a.gn);
  float dk0 = 0.0f, dk1 = 0.0f, dv0 = 0.0f, dv1 = 0.0f;
  for (int i = 0; i < n; ++i) {
    const long long gi = b * n + i;
    const long long row = gi * n + j;
    const float2 dpv = *reinterpret_cast<const float2*>(a.dp + row * C + c);
    const float2 tv = *reinterpret_cast<const float2*>(a.t + row * C + c);
    const float2 mv = *reinterpret_cast<const float2*>(a.stat_m + gi * C + c);
    const float2 lv = *reinterpret_cast<const float2*>(a.stat_l + gi * C + c);
    const float2 qv = ld_pair(q + gi * C + c);
    const float2 gv = ld_pair(gn + gi * C + c);
    dk0 += dpv.x * qv.x;
    dk1 += dpv.y * qv.y;
    dv0 += (expf(tv.x - mv.x) * lv.x) * gv.x;  // stat_l holds 1 / sum
    dv1 += (expf(tv.y - mv.y) * lv.y) * gv.y;
  }
  *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dk) + bj * C + c) = pack_bf16(dk0 * inv, dk1 * inv);
  *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dv) + bj * C + c) = pack_bf16(dv0, dv1);
}

// wgrad: out[z][chunk] = A_z^T B_z over the chunk's rows, M = C:
//   z 0: y^T de (dWe), 1: t^T dtt (dWoe), 2: u^T dhpre (dW1, u = xhat4 g4 +
//   b4 as the rows pass computed it), 3: dr^T h (dW2^T).
// A block of two warpgroups owns a C x 128 output tile (warpgroup w its
// rows 64 w ..) and a run of rows.  Each 64-row stage: the f32 operands
// are split into three bf16 pieces (y is one) while they are copied into
// swizzled panels, on the CUDA cores, into one of two stage buffers while
// the other's products run; then the significant piece products (three
// for y^T de, six for f32 x f32: hi hi, hi mid, mid hi, hi lo, mid mid,
// lo hi) as wgmma with both operands MN-major, into one f32 accumulator.
constexpr int WN = 128;                           // output tile columns
constexpr int WKB = 64;                           // rows a stage
constexpr size_t W_PANEL = size_t(WKB) * 128;     // 64 rows x 64 columns, bf16
constexpr size_t W_PIECE = 2 * W_PANEL;           // 128 columns
constexpr size_t W_OPER = 3 * W_PIECE;            // three pieces
constexpr size_t W_STAGE = 2 * W_OPER;            // A and B
constexpr size_t WGRAD_SMEM = 2 * W_STAGE + ALIGN_SLACK;
constexpr int WTHREADS = 256;
constexpr int T_C = C / WN, T_H = H / WN;
constexpr int W_TILES = 2 * T_C + 2 * T_H;
static_assert(C % WN == 0 && H % WN == 0, "the wgrad tiles take C and H multiples of 128");
static_assert(WGRAD_SMEM <= SMEM_MAX, "wgrad shared memory over the limit");

__host__ __device__ constexpr int wg_z(int tile) {
  return tile < T_C ? 0 : tile < 2 * T_C ? 1 : tile < 2 * T_C + T_H ? 2 : 3;
}
__host__ __device__ constexpr int wg_n(int z) { return z < 2 ? C : H; }
// Offset of product z's partials in w_partial: [chunks][C][C] twice, then
// [chunks][C][H] twice.
__host__ __device__ constexpr long long wg_off(int z, int chunks) {
  return (long long)chunks * C * ((z > 0 ? C : 0) + (z > 1 ? C : 0) + (z > 2 ? H : 0));
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
  const size_t off = size_t(c8 >> 6) * W_PANEL + sw_off(r, c8 & 63);
  *reinterpret_cast<uint4*>(oper + off) = make_uint4(pa[0], pa[1], pa[2], pa[3]);
  *reinterpret_cast<uint4*>(oper + W_PIECE + off) = make_uint4(pb[0], pb[1], pb[2], pb[3]);
  *reinterpret_cast<uint4*>(oper + 2 * W_PIECE + off) = make_uint4(pc[0], pc[1], pc[2], pc[3]);
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
  x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
}

// One 64-row stage of both operands into `stage` (every thread; 16-byte
// groups).  A thread's groups share one 8-column group c8 = 8 (tid % 16)
// of each operand, so it adds what it converts of the operand whose column
// sums this block takes (sum_b: 1 B, 0 A, -1 none) into colsum.
__device__ __forceinline__ void wgrad_stage(uint8_t* stage, const HArgs& a, int z, int n0,
                                            long long r0, long long r_end, int sum_b,
                                            float (&colsum)[8]) {
  constexpr int GROUPS = WKB * (WN / 8) / WTHREADS;  // of each operand, a thread
  const float* asrc = z == 1 ? a.t : z == 2 ? a.xh4 : a.dr;
  const float* bsrc = z == 0 ? a.de : z == 1 ? a.dtt : z == 2 ? a.dhp : a.h;
  const int ldb = wg_n(z);
  const int c8 = (threadIdx.x % (WN / 8)) * 8;
  // every load of the stage first, then the splits
  float xa[GROUPS][8], xb[GROUPS][8];
  uint4 ya[GROUPS];
#pragma unroll
  for (int i = 0; i < GROUPS; ++i) {
    const int r = (threadIdx.x + i * WTHREADS) / (WN / 8);
    const long long row = r0 + r;
    const bool ok = row < r_end;
#pragma unroll
    for (int e = 0; e < 8; ++e) xa[i][e] = xb[i][e] = 0.0f;
    ya[i] = make_uint4(0u, 0u, 0u, 0u);
    if (ok) {
      load8(bsrc + row * ldb + n0 + c8, xb[i]);
      if (z == 0)
        ya[i] = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.y) + row * C + c8);
      else
        load8(asrc + row * C + c8, xa[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < GROUPS; ++i) {
    const int r = (threadIdx.x + i * WTHREADS) / (WN / 8);
    const bool ok = r0 + r < r_end;
    if (z == 0) {  // y, bf16: one piece
      *reinterpret_cast<uint4*>(stage + size_t(c8 >> 6) * W_PANEL + sw_off(r, c8 & 63)) = ya[i];
    } else {
      if (z == 2 && ok)  // u = xhat4 g4 + b4, as the rows pass computed it
#pragma unroll
        for (int e = 0; e < 8; ++e) xa[i][e] = __fmaf_rn(xa[i][e], __ldg(a.g4 + c8 + e), __ldg(a.b4 + c8 + e));
      if (sum_b == 0)
#pragma unroll
        for (int e = 0; e < 8; ++e) colsum[e] += xa[i][e];
      put8(stage, r, c8, xa[i]);
    }
    if (sum_b == 1)
#pragma unroll
      for (int e = 0; e < 8; ++e) colsum[e] += xb[i][e];
    put8(stage + W_OPER, r, c8, xb[i]);
  }
}

__global__ void __launch_bounds__(WTHREADS, 1)
block_bwd_wgrad_wgmma(const __grid_constant__ HArgs a, long long rows_total,
                      long long chunk_rows) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const int tile = blockIdx.x;
  const int z = wg_z(tile);
  const int n0 = (tile - (z == 0 ? 0 : z == 1 ? T_C : z == 2 ? 2 * T_C : 2 * T_C + T_H)) * WN;
  const int wg = threadIdx.x >> 7;
  const Lane ln(threadIdx.x & 127);
  const long long r_begin = blockIdx.y * chunk_rows;
  const long long r_end = r_begin + chunk_rows < rows_total ? r_begin + chunk_rows : rows_total;
  const int n_k = r_end > r_begin ? int((r_end - r_begin + WKB - 1) / WKB) : 0;
  // the bias gradients as column sums: of B (de, dtt, dhpre) for z 0-2, of
  // A (dr) for z 3's first tile; -1: none
  const int sum_b = z < 3 ? 1 : n0 == 0 ? 0 : -1;
  float colsum[8] = {};

  float acc[WN / 2];
  zero(acc);
  if (n_k > 0) {
    wgrad_stage(smem, a, z, n0, r_begin, r_end, sum_b, colsum);
    fence_proxy_async();
    __syncthreads();
  }
  for (int kstep = 0; kstep < n_k; ++kstep) {
    const uint8_t* A = smem + size_t(kstep & 1) * W_STAGE + size_t(wg) * W_PANEL;
    const uint8_t* Bm = smem + size_t(kstep & 1) * W_STAGE + W_OPER;
    fence_regs(acc);
    wgmma_fence();
    // piece products (A piece, B piece), the smallest first; y is one
    // piece, so dWe takes the three with A piece 0
#pragma unroll
    for (int pi = 0; pi < 6; ++pi) {
      const int pa = pi == 0 ? 2 : pi == 1 || pi == 3 ? 1 : 0;
      const int pb = pi == 2 ? 2 : pi == 1 || pi == 4 ? 1 : 0;
      if (z == 0 && pa != 0) continue;
#pragma unroll
      for (int kk = 0; kk < WKB / 16; ++kk)
        Mma<WN>::ss<1, 1>(acc, desc(A + size_t(pa) * W_PIECE + kk * 2048, W_PANEL, 1024),
                          desc(Bm + size_t(pb) * W_PIECE + kk * 2048, W_PANEL, 1024));
    }
    wgmma_commit();
    if (kstep + 1 < n_k)
      wgrad_stage(smem + size_t((kstep + 1) & 1) * W_STAGE, a, z, n0, r_begin + (kstep + 1) * WKB,
                  r_end, sum_b, colsum);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_proxy_async();
    __syncthreads();
  }
  const int nz = wg_n(z);
  float* out = a.w_partial + wg_off(z, gridDim.y) + (long long)blockIdx.y * C * nz;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = 64 * wg + ln.row(half);
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
      *reinterpret_cast<float2*>(out + (long long)m * nz + n0 + ln.col(j)) =
          make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
  if (sum_b < 0) return;
  // the 16 threads of a column group in a fixed order (the stages are free)
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 8; ++i) red[(threadIdx.x >> 4) * WN + (threadIdx.x & 15) * 8 + i] = colsum[i];
  __syncthreads();
  if (threadIdx.x < WN) {
    float sum = 0.0f;
    for (int t = 0; t < WTHREADS / 16; ++t) sum += red[t * WN + threadIdx.x];
    const int off = z == 0 ? W_DBE : z == 1 ? W_DBOE : z == 2 ? W_DB1 + n0 : W_DB2;
    a.wvec_partial[(long long)blockIdx.y * VW + off + threadIdx.x] = sum;
  }
}

// reduce: each gradient a fixed-order sum of its partials (dW2 from the
// dW2^T partials).
constexpr int RTHREADS = 256;
__global__ void __launch_bounds__(RTHREADS)
block_bwd_reduce_wgmma(const __grid_constant__ HArgs a, int chunks, int n_vec) {
  const long long g = blockIdx.x * (long long)RTHREADS + threadIdx.x;
  if (g >= G_TOTAL) return;
  const float* src;
  long long stride, count;
  if (g < G_DBE || (g >= G_DWOE && g < G_DBOE) || (g >= G_DW1 && g < G_DB1) ||
      (g >= G_DW2 && g < G_DB2)) {
    int z;
    long long idx;
    if (g < G_DBE) z = 0, idx = g - G_DWE;
    else if (g < G_DBOE) z = 1, idx = g - G_DWOE;
    else if (g < G_DB1) z = 2, idx = g - G_DW1;
    else {
      z = 3;
      const long long i = g - G_DW2;  // dW2 [H, C] from dW2^T [C, H]
      idx = (i % C) * H + i / C;
    }
    src = a.w_partial + wg_off(z, chunks) + idx;
    stride = (long long)C * wg_n(z);
    count = chunks;
  } else if ((g >= G_DBE && g < G_DWOE) || (g >= G_DBOE && g < G_DG4) ||
             (g >= G_DB1 && g < G_DW2) || (g >= G_DB2 && g < G_DG6)) {
    int off;  // column sums taken by the wgrad pass, one partial a row chunk
    if (g < G_DWOE) off = W_DBE + int(g - G_DBE);
    else if (g < G_DG4) off = W_DBOE + int(g - G_DBOE);
    else if (g < G_DW2) off = W_DB1 + int(g - G_DB1);
    else off = W_DB2 + int(g - G_DB2);
    src = a.wvec_partial + off;
    stride = VW;
    count = chunks;
  } else {
    int off;  // the rows pass's LayerNorm sums, one partial a warp
    if (g < G_DB4) off = R_DG4 + int(g - G_DG4);
    else if (g < G_DW1) off = R_DB4 + int(g - G_DB4);
    else if (g < G_DB6) off = R_DG6 + int(g - G_DG6);
    else off = R_DB6 + int(g - G_DB6);
    src = a.vec_partial + off;
    stride = VR;
    count = n_vec;
  }
  float sum = 0.0f;
  for (long long i = 0; i < count; ++i) sum += src[i * stride];
  a.grads[g] = sum;
}
}  // namespace k8
#endif  // BLOCK_HOPPER

}  // namespace

// ptrs: the device pointers of Args above, in its order (fused_block_bwd_sizes
// gives their count and the scratch sizes).  q, k, v, gn, dq, dk, dv: [batch,
// n, C]; y, gy, dy: [batch, n, n, C]; all in the stream type.  d and h must be
// the compiled KERNEL_C and KERNEL_H; chunk_rows a multiple of the slab rows
// with chunks * chunk_rows >= batch * n * n.  Launches on `stream`, does not
// synchronise, allocates nothing.  Returns the cudaError_t of the launches
// (0 on success).
extern "C" int fused_block_bwd_bf16(const void* const* ptrs, long long batch, int n, int d,
                                    int h, float inv_sqrt_dk, int chunks, long long chunk_rows,
                                    void* stream) {
  return launch<__nv_bfloat16>(ptrs, batch, n, d, h, inv_sqrt_dk, chunks, chunk_rows, stream);
}

extern "C" int fused_block_bwd_f32(const void* const* ptrs, long long batch, int n, int d,
                                   int h, float inv_sqrt_dk, int chunks, long long chunk_rows,
                                   void* stream) {
  return launch<float>(ptrs, batch, n, d, h, inv_sqrt_dk, chunks, chunk_rows, stream);
}

// {pointers in Args, floats a vector partial (one a warp, 8 warps a graph),
//  floats of the gradient buffer, rows a wgrad slab, 128 x 128 output tiles
//  of all four weight gradients together}.
extern "C" void fused_block_bwd_sizes(long long out[5]) {
  out[0] = N_PTRS;
  out[1] = NVEC;
  out[2] = G_TOTAL;
  out[3] = KB;
  out[4] = 2 * TD * TD + 2 * TD * THD;
}

extern "C" long long fused_block_bwd_smem_bytes() { return (long long)rows_smem(); }

// The Hopper route (bf16, C = 128, H a multiple of 128, 1 <= n <= 64).
// ptrs: the device pointers of k8::HArgs, in its order (q, k, v, y, gy, gn,
// we_t, woe_t, w1t, w2t, be, boe, g4, b4, b1, b2, g6, b6, t, xh4, dr, dtt,
// de, dp [R, C] f32, h, dhp [R, H] f32, stat_m, stat_l, stat_dot [batch n,
// C] f32, rstd4 [R] f32, live [batch n H / 64 128] 32-bit, dq, dk, dv, dy,
// vec_partial [grid * 4, 4 C], wvec_partial [chunks, 3 C + H], w_partial
// [chunks (2 C^2 + 2 C H)], grads); grid and the wgrad pass's row chunks
// from ops/fused_block.py::launch_plan (chunk_rows a multiple of 64 with
// chunks * chunk_rows >= batch n n).  Seven launches on `stream` (the four
// rows launches, node, wgrad, reduce); does not synchronise, allocates
// nothing.  Returns the cudaError_t of the launches (cudaErrorInvalidValue
// for arguments that do not match, and always on a width this route does
// not take).
extern "C" int fused_block_bwd_bf16_wgmma(const void* const* ptrs, long long batch, int n, int d,
                                          int h, float inv_sqrt_dk, int grid, int chunks,
                                          long long chunk_rows, void* stream) {
#if BLOCK_HOPPER
  using namespace k8;
  const long long rows = batch * n * n;
  if (batch <= 0 || n <= 0 || n > MAX_N || d != C || h != H || grid <= 0 || chunks <= 0 ||
      chunk_rows <= 0 || chunk_rows % WKB != 0 || chunk_rows * chunks < rows)
    return int(cudaErrorInvalidValue);
  HArgs a;
  std::memcpy(&a, ptrs, sizeof(HArgs));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap y_map, w1_map, w2_map;
  if (!make_map(&y_map, a.y, rows, C, BM) || !make_map(&w1_map, a.w1t, HP, CP, HJ) ||
      !make_map(&w2_map, a.w2t, CP, HP, CP))
    return int(cudaErrorInvalidValue);
  const RowsParams rp{a, batch * n, n, inv_sqrt_dk};
  cudaError_t err;
  for (auto kernel : {block_bwd_fwd_attn_wgmma, block_bwd_fwd_mlp_wgmma, block_bwd_mlp_wgmma,
                      block_bwd_attn_wgmma}) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(blk::rows::SMEM));
    if (err != cudaSuccess) return int(err);
    kernel<<<unsigned(grid), NT, blk::rows::SMEM, st>>>(y_map, w1_map, w2_map, rp);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  const long long node_threads = batch * n * (C / 2);
  block_bwd_node<<<unsigned((node_threads + NODE_THREADS - 1) / NODE_THREADS), NODE_THREADS, 0,
                   st>>>(a, batch, n, inv_sqrt_dk);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(block_bwd_wgrad_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(k8::WGRAD_SMEM));
  if (err != cudaSuccess) return int(err);
  block_bwd_wgrad_wgmma<<<dim3(unsigned(W_TILES), unsigned(chunks)), WTHREADS, k8::WGRAD_SMEM, st>>>(
      a, rows, chunk_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  block_bwd_reduce_wgmma<<<unsigned((G_TOTAL + RTHREADS - 1) / RTHREADS), RTHREADS, 0, st>>>(
      a, chunks, grid * 4);
  return int(cudaGetLastError());
#else
  (void)ptrs, (void)batch, (void)n, (void)d, (void)h, (void)inv_sqrt_dk, (void)grid;
  (void)chunks, (void)chunk_rows, (void)stream;
  return int(cudaErrorInvalidValue);  // this width takes the CUDA-core route
#endif
}

// The Hopper route's plan as the library computes it: {pointers in HArgs,
// dynamic shared memory of a rows-pass block and of a wgrad block, wgrad
// output tiles a row chunk}; zeros where the width does not take that route.
extern "C" void fused_block_bwd_wgmma_plan(long long out[4]) {
#if BLOCK_HOPPER
  out[0] = k8::N_HPTRS;
  out[1] = (long long)blk::rows::SMEM;
  out[2] = (long long)k8::WGRAD_SMEM;
  out[3] = k8::W_TILES;
#else
  out[0] = out[1] = out[2] = out[3] = 0;
#endif
}
