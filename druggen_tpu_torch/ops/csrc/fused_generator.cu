// The whole Generator forward (K9).
//
// Replaces the TPU kernel druggen_tpu/ops/fused_generator.py::_kernel (called
// by fused_generator_logits): for each graph, from the one-hot inputs z_n
// [N, m_dim] and z_e [N, N, b_dim] (z_e vertex-symmetric) to the logits,
//
//     x = relu(relu(z_n W_nf1 + b) W_nf2 + b)      y = relu(relu(z_e W_ef1 + b) W_ef2 + b)
//     per depth:
//       x1 = LN1(x); q, k, v = x1 Wq.., e = y We + be
//       t[i,j] = q_i * k_j * scale * (e[i,j] + 1) * e[i,j]
//       y1 = t Woe + boe                                 (before the softmax)
//       agg_i = sum_j p[i,j] v_j / sum_j p[i,j],  p = exp(t - max_j t), per channel
//       x2 = LN3(x1 + (agg Won + bon)); x = LN5(x2 + fc2(relu(fc1(x2))))
//       y2 = LN4(y + y1);               y = LN6(y2 + fc2(relu(fc1(y2))))
//     node logits = x W_rn + b, edge logits = y W_re + b
//
// with the Pallas kernel's rounding points: weights, biases and LayerNorm
// parameters are stream-type (T) values; every product has T operands, an
// f32 sum and the f32 bias and is rounded to T; a LayerNorm runs in f32
// from its T input and is rounded; the modulate chain is rounded after
// every operation (scale is a T constant); every residual add is rounded;
// the softmax is f32 from the rounded t and agg is rounded.  In f32 every
// rounding is the identity.  ReLU after the input MLPs and in the block MLPs
// whatever the configured activation, as the Pallas kernel.  eps 1e-5.
//
// What bounds it on an H100 SXM: at the serving shape (512 graphs of 45
// atoms, dim C = 128, hidden H = 384, depth 1, b_dim 5, m_dim 8) each of the
// 1,036,800 edge rows takes 2 (5*64 + 64*128 + 2*128^2 + 2*128*384 + 128*5) =
// 280,448 FLOP (input MLP, e, out_e, MLP2, readout), 290.8 GFLOP in all, and
// the node stream 8.0 GFLOP: 0.30 ms at 989 TFLOP/s in bf16.  The bytes it
// must move are the one-hot inputs and the logits, ~21 MB, 6 us.  So the
// operations bound it.  In f32 every product needs f32 accuracy: 1.81 ms at
// 3xTF32's 165 TFLOP/s, 4.5 ms on f32 FMA.
//
// Design.  Nothing edge-sized leaves the chip at depth 1: the one-hot rows
// come in and the logits go out.  Two kernels:
//   node  one block per graph: the input MLP of z_n (first), or out_n, the
//         residual and LN3 -> MLP -> LN5 of the previous depth (later); then
//         LN1 and q, k, v of the next depth to device memory (5 x [B, N, C],
//         L2-resident), or the node readout after the last depth.
//   edge  one block per (graph, query atom i): the N edge rows (i, j) in
//         16-row WMMA tiles through the input MLP (first depth) -> e -> the
//         modulate chain -> the per-channel softmax and aggregation over j
//         (agg_i to device memory) -> out_e -> residual -> LN4 -> MLP2 ->
//         LN6 (tailk::tail_tile with K9's rounding policy) -> the edge
//         readout (last depth), or the rows to device memory for the next
//         depth.
// k and v of every atom are needed by every query atom's block, and the next
// depth's k and v need every atom's aggregation: so a depth is one edge
// launch between two node launches, and a forward is 2 * depth + 1 launches
// from one call (the wrapper counts one a forward).  On the bf16 Hopper
// route (ops/fused_generator.py hopper_route: dim 128, N <= 64) the edge
// pass is fused_generator_hopper.cu's two launches instead, and the node
// pass runs alone (fused_generator_node_*); this file's edge kernel serves
// f32, the other widths and N > 64.  Products: bf16 WMMA
// (bf16 in, f32 accumulate), each warp a 16 x 16 output tile at a time,
// the A operand from shared memory and the weight fragments from device
// memory, where all the weights (~0.7 MB in bf16 at 128/384) stay resident
// in L2; the f32 twin multiplies on the CUDA cores (FFMA).  Ragged N (any
// N) is masked: rows past N are zero and never stored.  Widths: C and H are
// compile-time constants (-DKERNEL_C=... -DKERNEL_H=..., one library a
// width), m_dim and b_dim come at run time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -DKERNEL_C=128 -DKERNEL_H=384 -o libfused_generator.so fused_generator.cu
// Plain C interface for ctypes; no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "gen_weights.cuh"
#include "tail_common.cuh"

namespace {

using namespace tailk;
using namespace genw;
using namespace nvcuda;

constexpr int HID_IN = 64;         // hidden width of the two input MLPs
constexpr int LDI = HID_IN + 8;    // its rows in shared memory
constexpr int LDC = CP + 8;        // a C-wide stream row in shared memory
static_assert(C % 16 == 0, "the stream width must be a multiple of 16");

template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_float(from_float<T>(v)); }

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Shared memory of a block: the one-hot rows, the input MLP's hidden, two
// C-wide stream buffers of np rows, a 16 x 16 f32 tile a warp, and the tail
// routine's buffers.  Both kernels take this shape (np = pad16(N), kz =
// pad16 of the one-hot width).
template <typename T>
struct Layout {
  size_t zin, hin, s0, s1, wscr, tail, total;
  __host__ __device__ Layout(int np, int kz) {
    size_t o = 0;
    zin = o; o = align128(o + size_t(np) * kz * sizeof(T));
    hin = o; o = align128(o + size_t(np) * LDI * sizeof(T));
    s0 = o; o = align128(o + size_t(np) * LDC * sizeof(T));
    s1 = o; o = align128(o + size_t(np) * LDC * sizeof(T));
    wscr = o; o = align128(o + size_t(WARPS) * 256 * sizeof(float));
    tail = o; o = align128(o + Bufs<T>::total);
    total = o;
  }
};

// epi(r, c, sum_k A[r][k] W^T[c][k]) for every r < rows and c < npad.
// A: [pad16(rows)][lda] in T (shared memory); wt: W^T [npad][kpad] in T;
// kpad and npad multiples of 16.  bf16: WMMA 16 x 16 tiles, one a warp at a
// time, through the warp's 256-float tile of wscr; f32: FFMA.  The caller
// separates it from the writes of A and the reads of what epi writes with
// __syncthreads.
template <typename T, typename Epi>
__device__ __forceinline__ void block_mm(const T* A, int lda, int rows, const T* __restrict__ wt,
                                         int kpad, int npad, float* wscr, Epi epi) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int row_tiles = (rows + 15) / 16;
    const int tiles = row_tiles * (npad / 16);
    float* scratch = wscr + warp * 256;
    for (int tile = warp; tile < tiles; tile += WARPS) {
      const int rt = tile % row_tiles, ct = tile / row_tiles;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int k = 0; k < kpad; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, A + rt * 16 * lda + k, lda);
        wmma::load_matrix_sync(b, wt + size_t(ct) * 16 * kpad + k, kpad);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = rt * 16 + (e >> 4);
        if (r < rows) epi(r, ct * 16 + (e & 15), scratch[e]);
      }
      __syncwarp();
    }
  } else {
    // neighbouring threads take neighbouring rows of one output column, so
    // a warp's weight reads are one broadcast address
    for (int e = tid; e < rows * npad; e += THREADS) {
      const int r = e % rows, c = e / rows;
      const T* a = A + r * lda;
      const T* w = wt + size_t(c) * kpad;
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < kpad; ++k) acc = fmaf(to_float(a[k]), to_float(__ldg(w + k)), acc);
      epi(r, c, acc);
    }
  }
}

// Zero the block's dynamic shared memory (every padding row and column).
__device__ __forceinline__ void zero_smem(unsigned char* smem, size_t bytes) {
  for (size_t e = threadIdx.x; e < bytes / 16; e += THREADS)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0u, 0u, 0u, 0u);
}

// out[r] = relu(round(relu(round(z[r] W1 + b1)) W2 + b2)) for the n one-hot
// rows z[r] (kin wide, device memory) of an input MLP; out: [np][LDC].
template <typename T>
__device__ void input_mlp(const T* __restrict__ z, int n, int kin, int kz, T* zin, T* hin, T* out,
                          const T* w1, const float* b1, const T* w2, const float* b2, float* wscr) {
  for (int e = threadIdx.x; e < n * kin; e += THREADS) zin[(e / kin) * kz + e % kin] = z[e];
  __syncthreads();
  block_mm<T>(zin, kz, n, w1, kz, HID_IN, wscr, [&](int r, int c, float acc) {
    hin[r * LDI + c] = from_float<T>(fmaxf(rnd<T>(acc + b1[c]), 0.0f));
  });
  __syncthreads();
  block_mm<T>(hin, LDI, n, w2, HID_IN, CP, wscr, [&](int r, int c, float acc) {
    if (c < C) out[r * LDC + c] = from_float<T>(fmaxf(rnd<T>(acc + b2[c]), 0.0f));
  });
  __syncthreads();
}

// out = LN_b(round(x + round(fc2(relu(fc1(x))))), x = LN_a(in), on the n
// rows of in, 16 at a time (tailk::tail_tile with K9's rounding policy).
// in, out: [np][LDC], different buffers.  Ends without a barrier.
template <typename T>
__device__ void tail_rows(const T* in, T* out, int n, const LaneParams& p, const T* w1, const T* w2,
                          unsigned char* tail) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* xs = reinterpret_cast<T*>(tail);
  T* hs = reinterpret_cast<T*>(tail + Bufs<T>::x);
  float* stage = reinterpret_cast<float*>(tail + Bufs<T>::x + Bufs<T>::h);
  for (int r0 = 0; r0 < n; r0 += BM) {
    const int valid = n - r0 < BM ? n - r0 : BM;
    float xr[ROWS_PER_WARP][NCH][VEC];
#pragma unroll
    for (int jj = 0; jj < ROWS_PER_WARP; ++jj) {
      const int r = warp * ROWS_PER_WARP + jj;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) xr[jj][ch][i] = 0.0f;
        if (r < valid && col_ok(ch, lane)) loadv(in + (r0 + r) * LDC + col_of(ch, lane), xr[jj][ch]);
      }
    }
    tail_tile<T, CP, HP, true, LDC>(xr, valid, p, w1, w2, xs, hs, stage, out + r0 * LDC);
  }
}

// ---------------------------------------------------------------------------
// node: one block per graph b; stage d of 0..depth.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
gen_node_kernel(const T* __restrict__ zn, Weights w, T* __restrict__ x1g, T* __restrict__ qg,
                T* __restrict__ kg, T* __restrict__ vg, const T* __restrict__ aggg,
                T* __restrict__ out_n, int n, int m_dim, int depth, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kz = pad16(m_dim);
  const Layout<T> L(pad16(n), kz);
  zero_smem(smem, L.total);
  __syncthreads();
  T* zin = reinterpret_cast<T*>(smem + L.zin);
  T* hin = reinterpret_cast<T*>(smem + L.hin);
  T* x = reinterpret_cast<T*>(smem + L.s0);    // the node stream
  T* x1 = reinterpret_cast<T*>(smem + L.s1);   // LN1's output, then x1 + node_mha
  float* wscr = reinterpret_cast<float*>(smem + L.wscr);
  const long long row0 = blockIdx.x * (long long)n;   // (b, 0)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (d == 0) {
    input_mlp<T>(zn + row0 * m_dim, n, m_dim, kz, zin, hin, x, mat<T>(w, MAT_NF1),
                 vec(w, VEC_NF1), mat<T>(w, MAT_NF2), vec(w, VEC_NF2), wscr);
  } else {
    // the previous depth's node update: x2 = LN3(x1 + out_n(agg)), then the MLP and LN5
    const int mb = MAT_BLOCK + MATS_PER_BLOCK * (d - 1), vb = VEC_BLOCK + VECS_PER_BLOCK * (d - 1);
    for (int e = tid; e < n * C; e += THREADS) {
      x1[(e / C) * LDC + e % C] = x1g[row0 * C + e];
      x[(e / C) * LDC + e % C] = aggg[row0 * C + e];
    }
    __syncthreads();
    const float* bon = vec(w, vb + V_ON);
    block_mm<T>(x, LDC, n, mat<T>(w, mb + W_ON), CP, CP, wscr, [&](int r, int c, float acc) {
      if (c < C) x1[r * LDC + c] = from_float<T>(to_float(x1[r * LDC + c]) + rnd<T>(acc + bon[c]));
    });
    __syncthreads();
    LaneParams p;
    load_lane_params(p, vec(w, vb + V_LN3S), vec(w, vb + V_LN3B), vec(w, vb + V_M1),
                     vec(w, vb + V_M2), vec(w, vb + V_LN5S), vec(w, vb + V_LN5B), lane);
    tail_rows<T>(x1, x, n, p, mat<T>(w, mb + W_M1), mat<T>(w, mb + W_M2), smem + L.tail);
    __syncthreads();
  }

  if (d < depth) {
    // LN1, a warp a row, rounded; then q, k, v of this depth
    const int mb = MAT_BLOCK + MATS_PER_BLOCK * d, vb = VEC_BLOCK + VECS_PER_BLOCK * d;
    const float* g1 = vec(w, vb + V_LN1S);
    const float* b1 = vec(w, vb + V_LN1B);
    float gv[NCH][VEC], bv[NCH][VEC];
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const bool ok = col_ok(ch, lane);
        gv[ch][i] = ok ? g1[col_of(ch, lane) + i] : 0.0f;
        bv[ch][i] = ok ? b1[col_of(ch, lane) + i] : 0.0f;
      }
    for (int r = warp; r < n; r += WARPS) {
      float v[NCH][VEC];
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[ch][i] = 0.0f;
        if (col_ok(ch, lane)) loadv(x + r * LDC + col_of(ch, lane), v[ch]);
      }
      layer_norm_row(v, gv, bv, lane);
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
        if (col_ok(ch, lane)) {
          storev(x1 + r * LDC + col_of(ch, lane), v[ch]);
          storev(x1g + (row0 + r) * C + col_of(ch, lane), v[ch]);
        }
    }
    __syncthreads();
    T* outs[3] = {qg, kg, vg};
    for (int m = 0; m < 3; ++m) {
      const float* bias = vec(w, vb + V_Q + m);
      T* out = outs[m];
      block_mm<T>(x1, LDC, n, mat<T>(w, mb + W_Q + m), CP, CP, wscr, [&](int r, int c, float acc) {
        if (c < C) out[(row0 + r) * C + c] = from_float<T>(acc + bias[c]);
      });
    }
  } else {
    const float* brn = vec(w, VEC_BLOCK + VECS_PER_BLOCK * depth);
    block_mm<T>(x, LDC, n, mat<T>(w, MAT_BLOCK + MATS_PER_BLOCK * depth), CP, pad16(m_dim), wscr,
                [&](int r, int c, float acc) {
                  if (c < m_dim) out_n[(row0 + r) * m_dim + c] = from_float<T>(acc + brn[c]);
                });
  }
}

// ---------------------------------------------------------------------------
// edge: one block per (graph b, query atom i), the rows (b, i, j), j < n;
// depth d of 0..depth-1.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
gen_edge_kernel(const T* __restrict__ ze, Weights w, const T* __restrict__ qg,
                const T* __restrict__ kg, const T* __restrict__ vg, T* __restrict__ aggg, T* ys,
                T* __restrict__ out_e, int n, int b_dim, int depth, int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kz = pad16(b_dim);
  const Layout<T> L(pad16(n), kz);
  zero_smem(smem, L.total);
  __syncthreads();
  T* zin = reinterpret_cast<T*>(smem + L.zin);
  T* hin = reinterpret_cast<T*>(smem + L.hin);
  T* y = reinterpret_cast<T*>(smem + L.s0);   // the edge rows, then y + y1
  T* t = reinterpret_cast<T*>(smem + L.s1);   // e, then t, then the tail's output
  float* wscr = reinterpret_cast<float*>(smem + L.wscr);
  const long long g = blockIdx.x;             // b * n + i
  const long long b = g / n;
  const long long row0 = g * n;               // edge row (b, i, 0)
  const int tid = threadIdx.x, lane = tid & 31;
  const int mb = MAT_BLOCK + MATS_PER_BLOCK * d, vb = VEC_BLOCK + VECS_PER_BLOCK * d;

  // ---- 1. the edge rows: the input MLP (z_e symmetric, so no (e + e^T)/2),
  //         or the previous depth's output
  if (d == 0) {
    input_mlp<T>(ze + row0 * b_dim, n, b_dim, kz, zin, hin, y, mat<T>(w, MAT_EF1),
                 vec(w, VEC_EF1), mat<T>(w, MAT_EF2), vec(w, VEC_EF2), wscr);
  } else {
    for (int e = tid; e < n * C; e += THREADS) y[(e / C) * LDC + e % C] = ys[row0 * C + e];
    __syncthreads();
  }

  // ---- 2. e = round(y We + be)
  const float* be = vec(w, vb + V_E);
  block_mm<T>(y, LDC, n, mat<T>(w, mb + W_E), CP, CP, wscr, [&](int r, int c, float acc) {
    if (c < C) t[r * LDC + c] = from_float<T>(acc + be[c]);
  });
  __syncthreads();

  // ---- 3. the modulate chain, rounded after every operation
  const T* qi = qg + g * C;
  const T* kb = kg + b * n * C;
  for (int e = tid; e < n * C; e += THREADS) {
    const int j = e / C, c = e % C;
    const float ev = to_float(t[j * LDC + c]);
    float a = rnd<T>(to_float(qi[c]) * to_float(kb[j * C + c]));
    a = rnd<T>(a * scale);
    a = rnd<T>(a * rnd<T>(ev + 1.0f));
    t[j * LDC + c] = from_float<T>(a * ev);
  }
  __syncthreads();

  // ---- 4. per channel: softmax over the keys j (f32) and the aggregation
  const T* vb_ = vg + b * n * C;
  for (int c = tid; c < C; c += THREADS) {
    float m = -INFINITY;
    for (int j = 0; j < n; ++j) m = fmaxf(m, to_float(t[j * LDC + c]));
    float sum = 0.0f, acc = 0.0f;
    for (int j = 0; j < n; ++j) {
      const float p = expf(to_float(t[j * LDC + c]) - m);
      sum += p;
      acc += p * to_float(vb_[j * C + c]);
    }
    aggg[g * C + c] = from_float<T>(acc / sum);
  }

  // ---- 5. y + round(t Woe + boe), rounded, into y
  const float* boe = vec(w, vb + V_OE);
  block_mm<T>(t, LDC, n, mat<T>(w, mb + W_OE), CP, CP, wscr, [&](int r, int c, float acc) {
    if (c < C) y[r * LDC + c] = from_float<T>(to_float(y[r * LDC + c]) + rnd<T>(acc + boe[c]));
  });
  __syncthreads();

  // ---- 6. LN4 -> MLP2 -> LN6 into t
  LaneParams p;
  load_lane_params(p, vec(w, vb + V_LN4S), vec(w, vb + V_LN4B), vec(w, vb + V_P1),
                   vec(w, vb + V_P2), vec(w, vb + V_LN6S), vec(w, vb + V_LN6B), lane);
  tail_rows<T>(y, t, n, p, mat<T>(w, mb + W_P1), mat<T>(w, mb + W_P2), smem + L.tail);
  __syncthreads();

  // ---- 7. the edge readout, or the rows for the next depth
  if (d == depth - 1) {
    const float* bre = vec(w, VEC_BLOCK + VECS_PER_BLOCK * depth + 1);
    block_mm<T>(t, LDC, n, mat<T>(w, MAT_BLOCK + MATS_PER_BLOCK * depth + 1), CP, pad16(b_dim),
                wscr, [&](int r, int c, float acc) {
                  if (c < b_dim) out_e[(row0 + r) * b_dim + c] = from_float<T>(acc + bre[c]);
                });
  } else {
    for (int e = tid; e < n * C; e += THREADS) ys[row0 * C + e] = t[(e / C) * LDC + e % C];
  }
}

template <typename T>
size_t node_smem(int n, int m_dim) { return Layout<T>(pad16(n), pad16(m_dim)).total; }
template <typename T>
size_t edge_smem(int n, int b_dim) { return Layout<T>(pad16(n), pad16(b_dim)).total; }

// Node pass d of 0..depth: one block per graph.
template <typename T>
cudaError_t launch_node(const void* zn, const Weights& w, void* out_n, void* x1, void* q, void* k,
                        void* v, void* agg, long long batch, int n, int m_dim, int depth, int d,
                        cudaStream_t st) {
  const size_t smem = node_smem<T>(n, m_dim);
  cudaError_t err = cudaFuncSetAttribute(gen_node_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  gen_node_kernel<T><<<unsigned(batch), THREADS, smem, st>>>(
      static_cast<const T*>(zn), w, static_cast<T*>(x1), static_cast<T*>(q), static_cast<T*>(k),
      static_cast<T*>(v), static_cast<const T*>(agg), static_cast<T*>(out_n), n, m_dim, depth, d);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* zn, const void* ze, const void* wts, const void* vecs, const void* woff,
           const void* voff, void* out_n, void* out_e, void* x1, void* q, void* k, void* v,
           void* agg, void* ys, long long batch, int n, int m_dim, int b_dim, int c, int h,
           int depth, float scale, void* stream) {
  if (batch < 0 || n <= 0 || m_dim <= 0 || b_dim <= 0 || c != C || h != H || depth <= 0)
    return int(cudaErrorInvalidValue);
  if (batch == 0) return int(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem_e = edge_smem<T>(n, b_dim);
  cudaError_t err = cudaFuncSetAttribute(gen_edge_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_e));
  if (err != cudaSuccess) return int(err);
  const Weights w{wts, static_cast<const float*>(vecs), static_cast<const long long*>(woff),
                  static_cast<const long long*>(voff)};
  for (int d = 0; d <= depth; ++d) {
    err = launch_node<T>(zn, w, out_n, x1, q, k, v, agg, batch, n, m_dim, depth, d, st);
    if (err != cudaSuccess) return int(err);
    if (d == depth) break;
    gen_edge_kernel<T><<<unsigned(batch * n), THREADS, smem_e, st>>>(
        static_cast<const T*>(ze), w, static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(agg), static_cast<T*>(ys),
        static_cast<T*>(out_e), n, b_dim, depth, d, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  return int(cudaSuccess);
}

}  // namespace

// zn: [batch, n, m_dim], ze: [batch, n, n, b_dim] (vertex-symmetric), out_n:
// [batch, n, m_dim], out_e: [batch, n, n, b_dim], all in the stream type.
// wts / vecs / woff / voff: the packed parameters (fused_generator.py
// _Packed).  x1, q, k, v, agg: scratch [batch, n, c] in the stream type; ys:
// scratch [batch, n, n, c] when depth > 1 (unused at depth 1).  c and h must
// be the compiled KERNEL_C and KERNEL_H; scale = 1/sqrt(c / heads) as a
// stream-type value.  Launches 2 * depth + 1 kernels on `stream`, does not
// synchronise, allocates nothing.  Returns the first cudaError_t of the
// launches (0 on success).
#define FUSED_GENERATOR(NAME, TYPE)                                                             \
  extern "C" int NAME(const void* zn, const void* ze, const void* wts, const void* vecs,        \
                      const void* woff, const void* voff, void* out_n, void* out_e, void* x1,   \
                      void* q, void* k, void* v, void* agg, void* ys, long long batch, int n,   \
                      int m_dim, int b_dim, int c, int h, int depth, float scale,               \
                      void* stream) {                                                           \
    return launch<TYPE>(zn, ze, wts, vecs, woff, voff, out_n, out_e, x1, q, k, v, agg, ys,      \
                        batch, n, m_dim, b_dim, c, h, depth, scale, stream);                    \
  }
FUSED_GENERATOR(fused_generator_bf16, __nv_bfloat16)
FUSED_GENERATOR(fused_generator_f32, float)

// Node pass d of 0..depth alone, bf16 (the Hopper route of
// ops/fused_generator.py runs it between its edge launches): the arguments
// of fused_generator_bf16 that it reads.  One launch on `stream`.
extern "C" int fused_generator_node_bf16(const void* zn, const void* wts, const void* vecs,
                                         const void* woff, const void* voff, void* out_n,
                                         void* x1, void* q, void* k, void* v, void* agg,
                                         long long batch, int n, int m_dim, int c, int h,
                                         int depth, int d, void* stream) {
  if (batch < 0 || n <= 0 || m_dim <= 0 || c != C || h != H || depth <= 0 || d < 0 || d > depth)
    return int(cudaErrorInvalidValue);
  if (batch == 0) return int(cudaSuccess);
  const Weights w{wts, static_cast<const float*>(vecs), static_cast<const long long*>(woff),
                  static_cast<const long long*>(voff)};
  return int(launch_node<__nv_bfloat16>(zn, w, out_n, x1, q, k, v, agg, batch, n, m_dim, depth,
                                        d, static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory of the larger of the two kernels' blocks.
extern "C" long long fused_generator_smem_bytes(int n, int m_dim, int b_dim, int bf16) {
  const size_t a = bf16 ? node_smem<__nv_bfloat16>(n, m_dim) : node_smem<float>(n, m_dim);
  const size_t b = bf16 ? edge_smem<__nv_bfloat16>(n, b_dim) : edge_smem<float>(n, b_dim);
  return (long long)(a > b ? a : b);
}

// Dynamic shared memory of a bf16 node-pass block alone.
extern "C" long long fused_generator_node_smem_bytes(int n, int m_dim) {
  return (long long)node_smem<__nv_bfloat16>(n, m_dim);
}
