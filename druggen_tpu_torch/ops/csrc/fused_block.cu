// Fused encoder-block edge stream ("megablock"), forward (K7).
//
// Replaces the TPU kernel druggen_tpu/ops/fused_block.py::_fwd_kernel
// (called by _run_fwd).  For each graph b and query atom i, over the keys
// j < N and the C channels (heads x dk):
//
//     e[j]       = y[b,i,j] @ We + be                 (round_T(We), f32 sums)
//     t[j]       = (((q[b,i] * k[b,j]) * inv_sqrt_dk) * (e[j] + 1)) * e[j]
//     y1[j]      = t[j] @ Woe + boe                   (f32 t, round_T(Woe))
//     node[b,i]  = round_T(sum_j softmax_j(t)[j] * v[b,j])   (per channel)
//     u[j]       = LN4(y[b,i,j] + y1[j])              (f32)
//     y_out[b,i,j] = round_T(LN6(u + fc2(relu(fc1(round_T(u))))))
//
// with the Pallas kernel's rounding points: q, k, v and y are read in the
// stream type T and widened to f32; We and Woe are rounded to T and
// multiplied in f32; t, y1, the softmax and y + y1 stay f32; u is rounded to
// T before fc1 and the hidden before fc2 (f32 accumulators); LN6 in f32; the
// LayerNorm parameters and biases are f32.  eps 1e-5.
//
// Arithmetic.  The e and out_e products run as K5's (fused_attention.cu):
// f32 FFMA tiles of 48 rows x 128 channels with their operands streamed
// through shared memory, so every product term is exact.  The tail (LN4 ->
// fc1 -> relu -> fc2 -> residual -> LN6) is tailk::tail_tile of
// tail_common.cuh, the routine K1 runs: in bf16 WMMA (bf16 in, f32
// accumulate) with both weights read from device memory, where they stay
// resident in L2 (the four weight matrices are 256 KB in bf16 at the
// published widths, more than one SM's 227 KB); in f32 FFMA.
//
// What bounds it on an H100 SXM: at the training shape (512 graphs of 45
// atoms, rows R = 1,036,800, C = 128, H = 384, bf16) the products with
// operands that are exact in bf16 (e, fc1, fc2) are 2 R (C^2 + 2 C H) =
// 237.9 GFLOP, 0.241 ms at 989 TFLOP/s; t @ Woe has a true f32 operand,
// 2 R C^2 = 34.0 GFLOP, 0.206 ms at 3xTF32's 165 TFLOP/s (0.51 ms on f32
// FMA); the bytes (y in, y_out out) are 0.53 GB, 0.158 ms at 3.35 TB/s.  So
// the operations bound it, ~0.45 ms.  This first version runs the two
// projections on FFMA (1.0 ms at 67 TFLOP/s) and the tail on WMMA.
//
// Design.  One block of 256 threads owns one (b, i): the N x C slab of y
// rows (b, i, :), as K5.  The slab's f32 t stays in shared memory (N x C x
// 4 bytes) as the operand of the out_e product and the input of the
// per-channel softmax; the product y + y1 of each 48-row chunk goes to a
// 48 x C f32 stage, from which the tail takes 16-row tiles.  Only y is read
// and only y_out and node are written: nothing edge-sized goes to device
// memory in between.  Ragged N (any N) is masked: rows past N are zero in
// and never stored.
//
// Widths: C and H are compile-time constants (-DKERNEL_C=... -DKERNEL_H=...,
// default 128 and 384), one library a width, as K1; C a multiple of 128.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -DKERNEL_C=128 -DKERNEL_H=384 -o libfused_block.so fused_block.cu
// Plain C interface for ctypes; no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attn_common.cuh"
#include "tail_common.cuh"

namespace {

constexpr int D = tailk::C;
constexpr int HID = tailk::H;
static_assert(D % CT == 0, "the channel width must be a multiple of 128");
static_assert(THREADS == tailk::THREADS, "one block shape for both routines");

template <typename T>
size_t fwd_smem(int n) {
  return GEMM_SMEM + size_t(n) * D * 4 + size_t(RC) * D * 4 + tailk::Bufs<T>::total;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
block_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ y, const float* __restrict__ we,
                 const float* __restrict__ be, const float* __restrict__ woe,
                 const float* __restrict__ boe, const float* __restrict__ g4,
                 const float* __restrict__ b4, const T* __restrict__ w1t,
                 const float* __restrict__ b1, const T* __restrict__ w2t,
                 const float* __restrict__ b2, const float* __restrict__ g6,
                 const float* __restrict__ b6, T* __restrict__ y_out, T* __restrict__ node_out,
                 int n, float inv_sqrt_dk) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* gsm = reinterpret_cast<float*>(smem);                 // product staging
  float* ts = reinterpret_cast<float*>(smem + GEMM_SMEM);      // f32 t: [n][D]
  float* tts = ts + size_t(n) * D;                             // y + y1 of a chunk: [RC][D]
  unsigned char* tail_bufs = reinterpret_cast<unsigned char*>(tts + size_t(RC) * D);
  T* xs = reinterpret_cast<T*>(tail_bufs);
  T* hs = reinterpret_cast<T*>(tail_bufs + tailk::Bufs<T>::x);
  float* stage = reinterpret_cast<float*>(tail_bufs + tailk::Bufs<T>::x + tailk::Bufs<T>::h);

  const long long g = blockIdx.x;    // b * n + i
  const long long b = g / n;
  const T* yr = y + g * n * D;       // rows (b, i, j), j < n
  const T* qi = q + g * D;
  const T* kb = k + b * n * D;
  const T* vb = v + b * n * D;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;

  tailk::init_bufs(xs, tid);
  tailk::LaneParams p;
  tailk::load_lane_params(p, g4, b4, b1, b2, g6, b6, tx);

  // ---- 1. e = y @ We + be; t, kept in f32.
  for (int n0 = 0; n0 < D; n0 += CT) {
    const int c0 = n0 + 4 * tx;
    float qv[4], bev[4];
    load4(qi + c0, qv);
    load4(be + c0, bev);
    for (int row0 = 0; row0 < n; row0 += RC) {
      float acc[RPT][4];
      gemm_tile(yr, D, row0, n, we, D, n0, D, gsm, acc);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int j = row0 + ty + 8 * r;
        if (j >= n) continue;
        float kv[4], tv[4];
        load4(kb + size_t(j) * D + c0, kv);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float e = acc[r][c] + bev[c];
          float t = qv[c] * kv[c];
          t = t * inv_sqrt_dk;
          t = t * (e + 1.0f);
          tv[c] = t * e;
        }
        store4(ts + size_t(j) * D + c0, tv);
      }
    }
  }
  __syncthreads();

  // ---- 2. per-channel softmax over the keys j; node = sum_j s * v.
  for (int c = tid; c < D; c += THREADS) {
    float m = -INFINITY;
    for (int j = 0; j < n; ++j) m = fmaxf(m, ts[j * D + c]);
    float sum = 0.0f;
    for (int j = 0; j < n; ++j) sum += expf(ts[j * D + c] - m);
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) {
      const float s = expf(ts[j * D + c] - m) / sum;
      acc = fmaf(s, to_float(vb[size_t(j) * D + c]), acc);
    }
    node_out[g * D + c] = from_float<T>(acc);
  }

  // ---- 3. per 48-row chunk: tt = y + (t @ Woe + boe) from the f32 t, then
  //         the tail on 16-row tiles of tt.
  for (int row0 = 0; row0 < n; row0 += RC) {
    for (int n0 = 0; n0 < D; n0 += CT) {
      const int c0 = n0 + 4 * tx;
      float bov[4];
      load4(boe + c0, bov);
      float acc[RPT][4];
      gemm_tile(ts, D, row0, n, woe, D, n0, D, gsm, acc);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int j = row0 + ty + 8 * r;
        if (j >= n) continue;
        float yv[4], ov[4];
        load4(yr + size_t(j) * D + c0, yv);
#pragma unroll
        for (int c = 0; c < 4; ++c) ov[c] = yv[c] + (acc[r][c] + bov[c]);
        store4(tts + size_t(j - row0) * D + c0, ov);
      }
    }
    __syncthreads();
    const int rows_here = n - row0 < RC ? n - row0 : RC;
    for (int sub = 0; sub < rows_here; sub += tailk::BM) {
      const int valid = rows_here - sub < tailk::BM ? rows_here - sub : tailk::BM;
      float xr[tailk::ROWS_PER_WARP][tailk::NCH][tailk::VEC];
#pragma unroll
      for (int jj = 0; jj < tailk::ROWS_PER_WARP; ++jj) {
        const int r = ty * tailk::ROWS_PER_WARP + jj;
#pragma unroll
        for (int ch = 0; ch < tailk::NCH; ++ch) {
#pragma unroll
          for (int i = 0; i < tailk::VEC; ++i) xr[jj][ch][i] = 0.0f;
          if (r < valid && tailk::col_ok(ch, tx))
            tailk::loadv(tts + size_t(sub + r) * D + tailk::col_of(ch, tx), xr[jj][ch]);
        }
      }
      tailk::tail_tile<T, tailk::CP, tailk::HP>(xr, valid, p, w1t, w2t, xs, hs, stage,
                                                y_out + (g * n + row0 + sub) * D);
    }
    // The next chunk's stores to tts follow the barriers of its products;
    // every read of tts above came before the first barrier of its tile.
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* y, const void* we,
           const void* be, const void* woe, const void* boe, const void* g4, const void* b4,
           const void* w1t, const void* b1, const void* w2t, const void* b2, const void* g6,
           const void* b6, void* y_out, void* node_out, long long batch, int n, int d, int h,
           float inv_sqrt_dk, void* stream) {
  if (batch < 0 || n <= 0 || d != D || h != HID) return int(cudaErrorInvalidValue);
  if (batch == 0) return int(cudaSuccess);
  const size_t smem = fwd_smem<T>(n);
  cudaError_t err = cudaFuncSetAttribute(block_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  block_fwd_kernel<T><<<unsigned(batch * n), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(y), static_cast<const float*>(we), static_cast<const float*>(be),
      static_cast<const float*>(woe), static_cast<const float*>(boe),
      static_cast<const float*>(g4), static_cast<const float*>(b4), static_cast<const T*>(w1t),
      static_cast<const float*>(b1), static_cast<const T*>(w2t), static_cast<const float*>(b2),
      static_cast<const float*>(g6), static_cast<const float*>(b6), static_cast<T*>(y_out),
      static_cast<T*>(node_out), n, inv_sqrt_dk);
  return int(cudaGetLastError());
}

}  // namespace

// q, k, v, node_out: [batch, n, C]; y, y_out: [batch, n, n, C], all in the
// stream type.  we, woe: [C, C] f32 ([in, out], x @ W) holding values rounded
// to the stream type; w1t = W1^T [HP, CP] and w2t = W2^T [CP, HP] in the
// stream type, zero-padded to multiples of 16 (as fused_mlp.cu's); be, boe,
// g4, b4, b1, b2, g6, b6 f32.  d and h must be the compiled KERNEL_C and
// KERNEL_H.  Launches on `stream`, does not synchronise, allocates nothing.
// Returns the cudaError_t of the launch (0 on success).
#define FUSED_BLOCK_FWD(NAME, TYPE)                                                              \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* y,               \
                      const void* we, const void* be, const void* woe, const void* boe,         \
                      const void* g4, const void* b4, const void* w1t, const void* b1,          \
                      const void* w2t, const void* b2, const void* g6, const void* b6,          \
                      void* y_out, void* node_out, long long batch, int n, int d, int h,        \
                      float inv_sqrt_dk, void* stream) {                                        \
    return launch<TYPE>(q, k, v, y, we, be, woe, boe, g4, b4, w1t, b1, w2t, b2, g6, b6, y_out,  \
                        node_out, batch, n, d, h, inv_sqrt_dk, stream);                         \
  }
FUSED_BLOCK_FWD(fused_block_fwd_bf16, __nv_bfloat16)
FUSED_BLOCK_FWD(fused_block_fwd_f32, float)

extern "C" long long fused_block_fwd_smem_bytes(int n, int bf16) {
  return bf16 ? (long long)fwd_smem<__nv_bfloat16>(n) : (long long)fwd_smem<float>(n);
}
