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
// Arithmetic: FFMA.  Every product has an f32 operand (only the e recompute
// has two bf16-valued ones), so all of them run as K5's 48 x 128 FFMA tiles
// (attn_common.cuh): full f32 products, f32 sums in another order.
//
// What bounds it on an H100 SXM: at the training shape (R = 1,036,800 rows,
// C = 128, H = 384) it does twelve products, 2 R (6 C^2 + 6 C H) = 815.3
// GFLOP: 4.94 ms at 3xTF32's 165 TFLOP/s, 12.2 ms at 67 TFLOP/s of f32 FMA;
// it must read y, gy and write dy (plus the node tensors), 0.80 GB, 0.24 ms
// at 3.35 TB/s.  So the f32 operations bound it.
//
// Why this design.  On the TPU the grid runs in order on one core, so the
// Pallas kernel adds each graph's parameter gradients into its output refs
// and keeps dk/dv of a graph across its query rows.  On the card blocks run
// in parallel and in no order, so the backward runs as three deterministic
// launches (no float atomics: the same inputs give the same bits on every
// run):
//
//   1. rows    one block per graph b, looping over its query rows i.  Per
//              slab (b, i, :) it recomputes the forward and runs the
//              backward phase by phase; each phase's f32 rows go to device
//              memory once (e, t, u, LN4's xhat and rstd, h, dr, dhpre, dtt,
//              de: 5.8 GB at the training shape, most of it read back by the
//              same block from L2), and row-wise LayerNorm phases take the
//              48-row chunks through a shared-memory stage.  dk and dv of
//              the graph sum over i in a per-graph f32 buffer that only this
//              block touches; each warp keeps its own sums of the vector
//              gradients and writes them once.
//   2. wgrad   dWe = y^T de, dWoe = t^T dtt, dW1 = u^T dhpre, dW2 = h^T dr as
//              split-K products: a block owns one 128 x 128 output tile and a
//              run of rows, streams 32-row slabs of both operands through
//              shared memory and writes its f32 partial tile.
//   3. reduce  sums the partials in a fixed order into the 12 gradients.
//
// Ragged N (any N) is masked in every launch.
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
