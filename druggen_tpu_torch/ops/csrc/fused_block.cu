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
// What bounds it on an H100 SXM: at the training shape (512 graphs of 45
// atoms, rows R = 1,036,800, C = 128, H = 384, bf16) the products with
// operands that are exact in bf16 (e, fc1, fc2) are 2 R (C^2 + 2 C H) =
// 237.9 GFLOP, 0.241 ms at 989 TFLOP/s; t @ Woe has an f32 operand times a
// bf16-exact weight, 2 R C^2 = 34.0 GFLOP, exact as three bf16 passes at
// 989 / 3 TFLOP/s: 0.103 ms; the bytes (y in, y_out out) are 0.53 GB,
// 0.158 ms at 3.35 TB/s.  So the operations bound it, ~0.34 ms.
//
// bf16 at C = 128, N <= 64 (the training path): a Hopper kernel
// (block_hopper.cuh has the plan).  A persistent block of one warpgroup per
// SM stages We^T and Woe^T once; W1^T and W2^T stream through a TMA ring
// of 64-hidden chunks.  The warpgroup owns one slab (b, i, :) at a time as
// a 64-row tile that TMA brings from y (rows j >= N masked).  Per slab:
//   1. e = y We: one bf16 wgmma pass; t in the accumulator.
//   2. the per-channel softmax over the keys and node_agg: column
//      reductions over the tile (shuffles, then the four warps in a fixed
//      order through shared memory); exp without a branch around it, and the
//      division by the sum as one reciprocal a channel (within an ulp of the
//      Pallas kernel's division; a division an element took ~250 cycles at
//      one warp a scheduler, a clock64 trace on the H100).
//   3. y1 = t Woe: t split into three bf16 pieces in shared memory (exact),
//      three wgmma passes into one f32 accumulator; + y (from the tile) +
//      boe; LN4 in f32 (rows over a quad of lanes); the tile buffer is free
//      and TMA brings the next slab's y.
//   4. round(u) as fc1's A operand in shared memory; the hidden in chunks
//      of 64 as K1's: acc1 = round(u) W1[:, j], + b1, relu, rounded in
//      registers as the A operand of acc2 += h_j W2[j, :].
//   5. y_out = LN6(u + acc2 + b2) from the f32 u kept in registers; 16-byte
//      stores of the N valid rows.
// Nothing edge-sized goes to device memory but y in and y_out out.
//
// Other widths, N > 64, and the f32 twin: the CUDA-core route below.  One
// block of 256 threads owns one (b, i): the e and out_e products run as
// K5's f32 FFMA tiles of 48 rows x 128 channels (every product term exact),
// the slab's f32 t stays in shared memory, and the tail is
// tailk::tail_tile (tail_common.cuh: bf16 WMMA with the weights read
// through L2, f32 FFMA).
//
// Widths: C and H are compile-time constants (-DKERNEL_C=... -DKERNEL_H=...,
// default 128 and 384), one library a width; C a multiple of 128.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -DKERNEL_C=128 -DKERNEL_H=384 -o libfused_block.so fused_block.cu
// Plain C interface for ctypes; no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attn_common.cuh"
#include "block_hopper.cuh"
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


// ---------------------------------------------------------------------------
// bf16 on Hopper (C = 128, N <= 64)
// ---------------------------------------------------------------------------
#if BLOCK_HOPPER
namespace k7 {
using namespace blk;
using bf16 = __nv_bfloat16;
using fwd::OFF_BAR;
using fwd::OFF_P;
using fwd::OFF_RED;
using fwd::OFF_RING;
using fwd::OFF_WE;
using fwd::OFF_WOE;
using fwd::OFF_Y;
using fwd::RING;
using fwd::SMEM;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* we_t;   // We^T [C][C]
  const bf16* woe_t;  // Woe^T [C][C]
  const float* be;
  const float* boe;
  const float* g4;
  const float* b4;
  const float* b1;
  const float* b2;
  const float* g6;
  const float* b6;
  bf16* y_out;
  bf16* node;
  long long slabs;  // batch * n
  int n;
  float inv;
};

__global__ void __launch_bounds__(NT, 1)
block_fwd_wgmma(const __grid_constant__ CUtensorMap y_map, const __grid_constant__ CUtensorMap w1_map,
                const __grid_constant__ CUtensorMap w2_map, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const Lane ln(threadIdx.x);
  const bool leader = threadIdx.x == 0;
  uint8_t* we_s = smem + OFF_WE;
  uint8_t* woe_s = smem + OFF_WOE;
  uint8_t* y_buf = smem + OFF_Y;
  uint8_t* P = smem + OFF_P;
  uint8_t* ring = smem + OFF_RING;
  uint64_t* full_y = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* ring_full = full_y + 1;
  float* red = reinterpret_cast<float*>(smem + OFF_RED);  // column-reduction scratch
  float* st_m = red + 4 * C;
  float* st_l = st_m + C;      // the sum, then its reciprocal
  float* st_o = st_l + 2 * C;
  if (leader) {
    for (int i = 0; i < 1 + RING; ++i) mbar_init(full_y + i, 1);
    fence_barrier_init();
  }
  stage_square(we_s, p.we_t);
  stage_square(woe_s, p.woe_t);
  fence_proxy_async();
  __syncthreads();

  const int n = p.n;
  const SlabRange sr(p.slabs);
  const long long chunks = (sr.end - sr.begin) * NJ;  // ring loads this block consumes
  if (leader && sr.end > sr.begin) {
    load_slab(y_buf, &y_map, full_y, sr.begin * n);
    for (int c = 0; c < RING && c < chunks; ++c)
      load_chunk(ring + size_t(c) * CHUNK_BYTES, ring_full + c, &w1_map, &w2_map, c % NJ);
  }

  uint32_t it = 0;
  long long nc = 0;  // ring position
  for (long long g = sr.begin; g < sr.end; ++g, ++it) {
    const long long b = g / n;
    const long long row0 = g * n;
    mbar_wait(full_y, it & 1);

    // ---- 1. e = y We; t
    float acc[4 * JC];
    mma_tile_sq(acc, y_buf, we_s);
    attn_t(acc, p.q + g * C, p.k + b * n * C, p.be, n, p.inv, ln);

    // ---- 2. t's pieces into P (the A operand of y1); the softmax over the
    //         keys per channel: m, ex = exp(t - m) in place of t, l = sum ex;
    //         node = sum_j (ex / l) v_j
    store_pieces(P, acc, ln);
    float u[4 * JC];
    load_pairs(p.v, b * n, n, u, ln);  // v_j
    col_reduce<true>(
        [&](int j, int e, int half) { return ln.row(half) < n ? acc[4 * j + 2 * half + e] : -INFINITY; },
        red, st_m, ln);
    softmax_ex(acc, st_m, n, ln);
    col_reduce<false>([&](int j, int e, int half) { return acc[4 * j + 2 * half + e]; }, red, st_l,
                      ln);
    col_reduce<false>(
        [&](int j, int e, int half) {
          const int i = 4 * j + 2 * half + e;
          return acc[i] * st_l[C + ln.col(j, e)] * u[i];
        },
        red, st_o, ln);
    p.node[g * C + threadIdx.x] = __float2bfloat16_rn(st_o[threadIdx.x]);

    // ---- 3. y1 = t Woe (three bf16 pieces of t); u = LN4(y + y1 + boe)
    fence_proxy_async();
    __syncthreads();
    mma_pieces_sq<0>(acc, P, woe_s);
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      const float2 bo = *reinterpret_cast<const float2*>(p.boe + ln.col(j));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 yv = tile_pair(y_buf, ln, j, half);
        u[4 * j + 2 * half] = yv.x + (acc[4 * j + 2 * half] + bo.x);
        u[4 * j + 2 * half + 1] = yv.y + (acc[4 * j + 2 * half + 1] + bo.y);
      }
    }
    {
      float mu[2], rstd[2];
      row_stats(u, ln, mu, rstd);
#pragma unroll
      for (int j = 0; j < JC; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = ln.col(j, e);
          const float gv = __ldg(p.g4 + c), bv = __ldg(p.b4 + c);
#pragma unroll
          for (int half = 0; half < 2; ++half)
            u[4 * j + 2 * half + e] = ln_apply(u[4 * j + 2 * half + e], mu[half], rstd[half], gv, bv);
        }
    }
    __syncthreads();  // y and P read: bring the next slab's y, write round(u)
    if (leader && g + 1 < sr.end) load_slab(y_buf, &y_map, full_y, (g + 1) * n);
#pragma unroll
    for (int j = 0; j < JC; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<uint32_t*>(P + tile_off(ln.row(half), j, ln.q)) =
            pack_bf16(u[4 * j + 2 * half], u[4 * j + 2 * half + 1]);
    fence_proxy_async();
    __syncthreads();

    // ---- 4. the hidden in chunks of 64 (K1's loop)
    zero(acc);  // acc2 = m
    for (int j = 0; j < NJ; ++j, ++nc) {
      mbar_wait(ring_full + nc % RING, uint32_t(nc / RING) & 1);
      const Chunk ch = ring_chunk(ring + size_t(nc % RING) * CHUNK_BYTES);
      float acc1[32];
      zero(acc1);
      fence_regs(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CP / 16; ++kk) Mma<64>::ss<0, 0>(acc1, a_tile(P, kk), b_w1(ch, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc1);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float bb = __ldg(p.b1 + j * HJ + ln.col(jj, e));
          acc1[4 * jj + e] = fmaxf(acc1[4 * jj + e] + bb, 0.0f);
          acc1[4 * jj + 2 + e] = fmaxf(acc1[4 * jj + 2 + e] + bb, 0.0f);
        }
      uint32_t ha[4][4];
      to_a_regs(acc1, ha);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Mma<CP>::rs<0>(acc, ha[kk], b_w2(ch, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      refill_ring(ring, ring_full, RING, nc, chunks, &w1_map, &w2_map);
    }

    // ---- 5. y_out = LN6(u + (m + b2))
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(p.b2 + ln.col(j));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        u[4 * j + 2 * half] = u[4 * j + 2 * half] + (acc[4 * j + 2 * half] + bb.x);
        u[4 * j + 2 * half + 1] = u[4 * j + 2 * half + 1] + (acc[4 * j + 2 * half + 1] + bb.y);
      }
    }
    {
      float mu[2], rstd[2];
      row_stats(u, ln, mu, rstd);
#pragma unroll
      for (int j = 0; j < JC; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = ln.col(j, e);
          const float gv = __ldg(p.g6 + c), bv = __ldg(p.b6 + c);
#pragma unroll
          for (int half = 0; half < 2; ++half)
            u[4 * j + 2 * half + e] = ln_apply(u[4 * j + 2 * half + e], mu[half], rstd[half], gv, bv);
        }
    }
    store_bf16_rows(p.y_out, row0, n, u, ln);
  }
}
}  // namespace k7
#endif  // BLOCK_HOPPER

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

// The Hopper route (bf16, C = 128, 1 <= n <= 64).  q, k, v, node_out:
// [batch, n, C]; y, y_out: [batch, n, n, C], bf16.  we_t = We^T and woe_t =
// Woe^T: [C, C] bf16 (the [out, in] layout); w1t = W1^T [HP, CP] and w2t =
// W2^T [CP, HP] bf16 padded to multiples of 64 (K1's layout); be, boe, g4,
// b4, b1, b2, g6, b6 f32.  grid comes from ops/fused_block.py::launch_plan;
// the block takes fused_block_fwd_wgmma_smem_bytes() of shared memory.
// Launches on `stream`, does not
// synchronise, allocates nothing.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments that do not match, and always on a
// width this route does not take).
extern "C" int fused_block_fwd_bf16_wgmma(const void* q, const void* k, const void* v,
                                          const void* y, const void* we_t, const void* be,
                                          const void* woe_t, const void* boe, const void* g4,
                                          const void* b4, const void* w1t, const void* b1,
                                          const void* w2t, const void* b2, const void* g6,
                                          const void* b6, void* y_out, void* node_out,
                                          long long batch, int n, int d, int h, float inv_sqrt_dk,
                                          int grid, void* stream) {
#if BLOCK_HOPPER
  using namespace k7;
  if (batch < 0 || n <= 0 || n > MAX_N || d != C || h != H || grid <= 0)
    return int(cudaErrorInvalidValue);
  if (batch == 0) return int(cudaSuccess);
  CUtensorMap y_map, w1_map, w2_map;
  if (!make_map(&y_map, y, batch * n * n, C, BM) || !make_map(&w1_map, w1t, HP, CP, HJ) ||
      !make_map(&w2_map, w2t, CP, HP, CP))
    return int(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(block_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (err != cudaSuccess) return int(err);
  auto F = [](const void* x) { return static_cast<const float*>(x); };
  auto B = [](const void* x) { return static_cast<const bf16*>(x); };
  const Params p{B(q),   B(k),    B(v),   B(we_t), B(woe_t), F(be),
                 F(boe), F(g4),   F(b4),  F(b1),   F(b2),    F(g6),
                 F(b6),  static_cast<bf16*>(y_out), static_cast<bf16*>(node_out),
                 batch * n, n, inv_sqrt_dk};
  block_fwd_wgmma<<<unsigned(grid), NT, SMEM, static_cast<cudaStream_t>(stream)>>>(y_map, w1_map,
                                                                                   w2_map, p);
  return int(cudaGetLastError());
#else
  (void)q, (void)k, (void)v, (void)y, (void)we_t, (void)be, (void)woe_t, (void)boe, (void)g4;
  (void)b4, (void)w1t, (void)b1, (void)w2t, (void)b2, (void)g6, (void)b6, (void)y_out;
  (void)node_out, (void)batch, (void)n, (void)d, (void)h, (void)inv_sqrt_dk, (void)grid;
  (void)stream;
  return int(cudaErrorInvalidValue);  // this width takes the CUDA-core route
#endif
}

// Dynamic shared memory of a Hopper-route block (0 where the width does not
// take that route).
extern "C" long long fused_block_fwd_wgmma_smem_bytes(void) {
#if BLOCK_HOPPER
  return (long long)blk::fwd::SMEM;
#else
  return 0;
#endif
}
