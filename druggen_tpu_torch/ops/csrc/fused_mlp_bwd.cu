// Fused LN -> MLP -> residual -> LN row kernel (the edge-stream tail), backward.
//
// Replaces the TPU kernel druggen_tpu/ops/fused_mlp.py::_bwd_kernel
// (_bwd_pallas).  Given the forward's input s [rows, C] and the output
// cotangent dout, it recomputes the forward of fused_mlp.cu and returns
//
//     ds                          [rows, C] in the stream type
//     dg1 dbl1 dw1 db1 dw2 db2 dg2 dbl2   the 8 parameter gradients, f32,
//                                         summed over all rows
//
// with the Pallas kernel's rounding points: forward as in K1; dr = LN2'(dout);
// dh = (round_T(dr) @ W2^T) * (h_pre > 0); dx = dr + round_T(dh) @ W1^T;
// ds = round_T(LN1'(dx)); dw1 = round_T(x)^T round_T(dh),
// dw2 = round_T(h)^T round_T(dr), the vector gradients summed in f32.
//
// What bounds it on an H100 SXM: at the training shape (512 graphs of 45
// atoms, rows = 1,036,800, C = 128, H = 384) it does six products of
// 2 * rows * C * H = 101.9 GFLOP each (two forward products recomputed, four
// backward), 611.5 GFLOP, i.e. 0.618 ms at 989 TFLOP/s in bf16; it must read
// s and dout and write ds, 0.80 GB, i.e. 0.24 ms at 3.35 TB/s.  So the
// tensor cores' operations bound it.
//
// Three deterministic launches (no float atomics: the same inputs give the
// same bits on every run).  The f32 weight gradients (dW1 + dW2 = 384 KB at
// 128/384) fit neither one SM's shared memory beside the staged weights nor
// its registers, so the rows pass writes the four bf16 operands of the
// weight-gradient products and a second launch multiplies them:
//
//   1. tail_bwd_rows_wgmma — bf16, a persistent block per SM (tail_hopper.cuh
//      has the plan).  W1^T and W2^T are staged once in wgmma's swizzled
//      layout; the one copy of each serves the recomputed forward (K-major B
//      operands) and the backward (the same bytes read MN-major, wgmma's
//      transpose bit).  Two consumer warpgroups each own a 64-row tile and
//      pass two shared buffers between them: S (s by TMA, then round(x) in
//      place as the A operand of x W1 and stored to the x operand by TMA) and
//      D (dout by TMA, then round(dm) in place as the A operand of dm W2^T,
//      stored by TMA).  A warpgroup holds S through its forward and D
//      through its backward, so one's forward overlaps the other's backward.
//      The hidden runs in chunks of 64 whose accumulators become the bf16 A
//      operand of the next product in registers: h_j -> h_j W2[j, :] and
//      dh_j -> dh_j W1^T[j, :] (dx accumulates on top of dr).  The vector
//      gradients are summed over each warp's rows by shuffles in a fixed
//      order and kept in registers (mode B: shared memory); the block sums
//      its warps' in a fixed order into one partial at the end.  h and dh go
//      to device memory from registers, 16 bytes a store after a transpose
//      over each quad of lanes.
//   2. tail_bwd_wgrad_wgmma — dW1 = X^T dH [C, H] and dW2^T = dM^T H [C, H]
//      as a split-K GEMM over row chunks: four warpgroups own 64 x NW output
//      tiles that together cover the whole C x H output at 128/384, so each
//      operand is read once (2.1 GB); a TMA ring of 64-row stages feeds
//      wgmma with both operands MN-major; f32 partials per chunk.
//   3. tail_bwd_reduce — the partials summed in a fixed order into the 8
//      gradients.
// Shared memory at 128/384: rows pass 196,608 B of weights + S 16,384 + D
// 16,384 + 4 mbarriers + 1,024 B of alignment slack = 230,432 B; wgrad 3
// stages of 65,536 B + slack = 197,656 B.  Registers a consumer thread of the
// rows pass (mode A, C = 128): the C-wide accumulator 64 (m, then dr and
// dx), s 32, the chunk's accumulator 32 and its A operand 16, the vector
// sums 32, the ReLU masks 6; wgrad: the 64 x 192 accumulator 96 of 128.
// Traffic beyond the bound's 0.80 GB: the four operands written (2.1 GB)
// and read once (2.1 GB), ~26 MB of f32 weight partials at 132 SMs.
//
// Widths the single-pass rows pass does not take (C not a multiple of 8, or
// C padded to 64 above 256) run the split path of tail_split.cuh in its
// place: seven launches (LN1, four wgmma GEMMs, LN2's and LN1's backward)
// that pass z, dr and dx through one f32 [rows, CP] buffer and write the
// same four bf16 operands, one vector partial a 64-row tile; then the same
// wgrad and reduce launches.
//
// The f32 twin (off the training path) keeps the CUDA-core design: a rows
// pass of 16-row tiles with the weights read through L2, a split-K wgrad of
// 128 x 128 tiles (64-row slabs), and the reduce.
//
// Ragged last tile: TMA reads zeros past the end of the rows, whose
// gradients are then zero, and nothing is stored there.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -DKERNEL_C=128 -DKERNEL_H=384 -o libfused_mlp_bwd.so fused_mlp_bwd.cu
// Plain C interface for ctypes; no PyTorch headers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tail_common.cuh"
#include "tail_hopper.cuh"
#if !TAIL_FUSED
#include "tail_split.cuh"
#endif

namespace {

// The gradient buffer, in the order of the Pallas kernel's outputs:
// dg1[C] dbl1[C] dw1[C,H] db1[H] dw2[H,C] db2[C] dg2[C] dbl2[C].
constexpr int GC = KERNEL_C, GH = KERNEL_H;
constexpr int G_DG1 = 0, G_DBL1 = GC, G_DW1 = 2 * GC, G_DB1 = 2 * GC + GC * GH,
              G_DW2 = G_DB1 + GH, G_DB2 = G_DW2 + GH * GC, G_DG2 = G_DB2 + GC,
              G_DBL2 = G_DG2 + GC, G_TOTAL = G_DBL2 + GC;
// One vector partial: hop::NVEC floats, dg1, dbl1, db1, db2, dg2, dbl2 at
// hop::OFF_*.
constexpr int RTHREADS = 256;

// ---------------------------------------------------------------------------
// 3. reduce: the 8 gradients from the partials, summed in a fixed order.
//    w_partial holds dW1 [z = 0] and dW2 [z = 1] per chunk: the f32 twin's
//    as [C * H] and [H * C]; the bf16 kernel's both as [CP][HP] (dW2
//    transposed).
// ---------------------------------------------------------------------------
template <bool kHopper>
__global__ void __launch_bounds__(RTHREADS)
tail_bwd_reduce(const float* __restrict__ vec_partial, int n_vec,
                const float* __restrict__ w_partial, int chunks, float* __restrict__ grads) {
  const int g = blockIdx.x * RTHREADS + threadIdx.x;
  if (g >= G_TOTAL) return;
  constexpr size_t slab = kHopper ? size_t(hop::CP) * hop::HP : size_t(GC) * GH;
  const float* src;
  size_t stride;
  int count;
  if (g >= G_DW1 && g < G_DB1) {
    const int i = g - G_DW1;  // dW1 [C, H]
    src = w_partial + (kHopper ? size_t(i / GH) * hop::HP + i % GH : size_t(i));
    stride = slab;
    count = chunks;
  } else if (g >= G_DW2 && g < G_DB2) {
    const int i = g - G_DW2;  // dW2 [H, C]
    src = w_partial + size_t(chunks) * slab +
          (kHopper ? size_t(i / GC) * hop::CP + i % GC : size_t(i));
    stride = slab;
    count = chunks;
  } else {
    int off;
    if (g < G_DBL1) off = hop::OFF_DG1 + (g - G_DG1);
    else if (g < G_DW1) off = hop::OFF_DBL1 + (g - G_DBL1);
    else if (g < G_DW2) off = hop::OFF_DB1 + (g - G_DB1);
    else if (g < G_DG2) off = hop::OFF_DB2 + (g - G_DB2);
    else if (g < G_DBL2) off = hop::OFF_DG2 + (g - G_DG2);
    else off = hop::OFF_DBL2 + (g - G_DBL2);
    src = vec_partial + off;
    stride = hop::NVEC;
    count = n_vec;
  }
  float sum = 0.0f;
  for (int i = 0; i < count; ++i) sum += src[size_t(i) * stride];
  grads[g] = sum;
}

// ---------------------------------------------------------------------------
// f32 twin
// ---------------------------------------------------------------------------
namespace f32 {
using namespace tailk;
using hop::NVEC;
using hop::OFF_DB1;
using hop::OFF_DB2;
using hop::OFF_DBL1;
using hop::OFF_DBL2;
using hop::OFF_DG1;
using hop::OFF_DG2;

constexpr int NQ = (H + THREADS - 1) / THREADS;  // hidden units a thread owns

struct RowSmem {
  static constexpr size_t x = size_t(BM) * LDX * sizeof(float);
  static constexpr size_t h = size_t(BM) * LDH * sizeof(float);
  static constexpr size_t stage = size_t(STAGE) * sizeof(float);
  static constexpr size_t total = x + h + stage;
};
static_assert(RowSmem::x % 128 == 0 && RowSmem::h % 128 == 0,
              "shared buffers must stay 128-byte aligned");

// rows: recompute forward, backward per row, ds, the product operands and
// the vector partials (one a warp).
__global__ void __launch_bounds__(THREADS)
tail_bwd_rows_f32(const float* __restrict__ s, const float* __restrict__ dout,
                  const float* __restrict__ g1, const float* __restrict__ bl1,
                  const float* __restrict__ w1t, const float* __restrict__ b1,
                  const float* __restrict__ w2t, const float* __restrict__ b2,
                  const float* __restrict__ g2, const float* __restrict__ bl2,
                  float* __restrict__ ds, float* __restrict__ x_out, float* __restrict__ h_out,
                  float* __restrict__ dm_out, float* __restrict__ dh_out,
                  float* __restrict__ vec_partial, long long rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);                           // x, then dm
  float* hs = reinterpret_cast<float*>(smem + RowSmem::x);              // h, then dh
  float* stage = reinterpret_cast<float*>(smem + RowSmem::x + RowSmem::h);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if constexpr (CP > C) {  // the padded columns of x / dm stay zero
    for (int r = 0; r < BM; ++r)
      for (int c = C + tid; c < CP; c += THREADS) xs[r * LDX + c] = 0.0f;
  }

  float rg1[NCH][VEC], rbl1[NCH][VEC], rg2[NCH][VEC], rb2[NCH][VEC];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = col_of(ch, lane) + i;
      const bool ok = col_ok(ch, lane);
      rg1[ch][i] = ok ? g1[c] : 0.0f;
      rbl1[ch][i] = ok ? bl1[c] : 0.0f;
      rg2[ch][i] = ok ? g2[c] : 0.0f;
      rb2[ch][i] = ok ? b2[c] : 0.0f;
    }
  float a_dg1[NCH][VEC] = {}, a_dbl1[NCH][VEC] = {}, a_db2[NCH][VEC] = {}, a_dg2[NCH][VEC] = {},
        a_dbl2[NCH][VEC] = {};
  float a_db1[NQ] = {};  // columns tid + q * THREADS

  const long long n_tiles = (rows + BM - 1) / BM;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * BM;

    // ---- 1. x = LN1(s) in f32; x to shared memory and to x_out.
    float xv[ROWS_PER_WARP][NCH][VEC], xh1[ROWS_PER_WARP][NCH][VEC], rstd1[ROWS_PER_WARP];
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) {
      const int r = warp * ROWS_PER_WARP + j;
      const long long row = row0 + r;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int i = 0; i < VEC; ++i) xv[j][ch][i] = xh1[j][ch][i] = 0.0f;
      rstd1[j] = 0.0f;
      if (row < rows) {  // uniform across the warp
        float v[NCH][VEC];
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) v[ch][i] = 0.0f;
          if (col_ok(ch, lane)) loadv(s + row * C + col_of(ch, lane), v[ch]);
        }
        rstd1[j] = ln_stats(v, xh1[j], lane);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) xv[j][ch][i] = xh1[j][ch][i] * rg1[ch][i] + rbl1[ch][i];
          if (col_ok(ch, lane)) storev(x_out + row * C + col_of(ch, lane), xv[j][ch]);
        }
      }
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
        if (col_ok(ch, lane)) storev(xs + r * LDX + col_of(ch, lane), xv[j][ch]);
    }
    __syncthreads();

    // ---- 2. h = relu(x @ W1 + b1), to shared memory and h_out.
    for (int e = tid; e < BM * H; e += THREADS) {
      const int r = e / H, n = e % H;
      const float* xrow = xs + r * LDX;
      const float* wrow = w1t + size_t(n) * CP;
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < C; ++k) acc = fmaf(xrow[k], __ldg(wrow + k), acc);
      const float hv = fmaxf(acc + b1[n], 0.0f);
      hs[r * LDH + n] = hv;
      if (row0 + r < rows) h_out[(row0 + r) * H + n] = hv;
    }
    __syncthreads();

    // ---- 3. m = h @ W2 (b2 is added below), into the stage.
    for (int e = tid; e < BM * C; e += THREADS) {
      const int r = e / C, n = e % C;
      const float* hrow = hs + r * LDH;
      const float* wrow = w2t + size_t(n) * HP;
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) acc = fmaf(hrow[k], __ldg(wrow + k), acc);
      stage[r * LDS + n] = acc;
    }
    __syncthreads();

    // ---- 4. r = x + (m + b2); dr = LN2'(dout), over x in shared memory
    //         (x is dead after step 2) and to dm_out.
    float dr[ROWS_PER_WARP][NCH][VEC];
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) {
      const int r = warp * ROWS_PER_WARP + j;
      const long long row = row0 + r;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int i = 0; i < VEC; ++i) dr[j][ch][i] = 0.0f;
      if (row < rows) {  // uniform across the warp
        float rv[NCH][VEC], rhat[NCH][VEC], go[NCH][VEC];
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            rv[ch][i] = col_ok(ch, lane)
                            ? xv[j][ch][i] + (stage[r * LDS + col_of(ch, lane) + i] + rb2[ch][i])
                            : 0.0f;
        const float rstd2 = ln_stats(rv, rhat, lane);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) go[ch][i] = 0.0f;
          if (col_ok(ch, lane)) loadv(dout + row * C + col_of(ch, lane), go[ch]);
        }
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            a_dg2[ch][i] += go[ch][i] * rhat[ch][i];
            a_dbl2[ch][i] += go[ch][i];
          }
        ln_bwd(go, rhat, rstd2, rg2, dr[j], lane);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) a_db2[ch][i] += dr[j][ch][i];
          if (col_ok(ch, lane)) storev(dm_out + row * C + col_of(ch, lane), dr[j][ch]);
        }
      }
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
        if (col_ok(ch, lane)) storev(xs + r * LDX + col_of(ch, lane), dr[j][ch]);
    }
    __syncthreads();

    // ---- 5. dh = (dm @ W2^T) * (h > 0), over h in shared memory and to
    //         dh_out; db1 sums dh.
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int n = tid + q * THREADS;
      if (n < H) {
        const float* wcol = w2t + n;  // W2[n, k] = W2^T[k, n]
        for (int r = 0; r < BM; ++r) {
          const float* mrow = xs + r * LDX;
          float acc = 0.0f;
#pragma unroll 8
          for (int k = 0; k < C; ++k) acc = fmaf(mrow[k], __ldg(wcol + size_t(k) * HP), acc);
          const float dh = hs[r * LDH + n] > 0.0f ? acc : 0.0f;
          hs[r * LDH + n] = dh;
          if (row0 + r < rows) {
            a_db1[q] += dh;
            dh_out[(row0 + r) * H + n] = dh;
          }
        }
      }
    }
    __syncthreads();

    // ---- 6. dh @ W1^T, into the stage.
    for (int e = tid; e < BM * C; e += THREADS) {
      const int r = e / C, n = e % C;
      const float* hrow = hs + r * LDH;
      const float* wcol = w1t + n;  // W1[n, k] = W1^T[k, n]
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) acc = fmaf(hrow[k], __ldg(wcol + size_t(k) * CP), acc);
      stage[r * LDS + n] = acc;
    }
    __syncthreads();

    // ---- 7. dx = dr + that; ds = LN1'(dx), to ds.
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) {
      const int r = warp * ROWS_PER_WARP + j;
      const long long row = row0 + r;
      if (row < rows) {  // uniform across the warp
        float dx[NCH][VEC], dsv[NCH][VEC];
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            dx[ch][i] = col_ok(ch, lane)
                            ? dr[j][ch][i] + stage[r * LDS + col_of(ch, lane) + i]
                            : 0.0f;
            a_dg1[ch][i] += dx[ch][i] * xh1[j][ch][i];
            a_dbl1[ch][i] += dx[ch][i];
          }
        ln_bwd(dx, xh1[j], rstd1[j], rg1, dsv, lane);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
          if (col_ok(ch, lane)) storev(ds + row * C + col_of(ch, lane), dsv[ch]);
      }
    }
    // No barrier needed here: the next tile's first writes (x over dm, then
    // the stage and h) all follow barriers that come after the last reads.
  }

  float* vp = vec_partial + (size_t(blockIdx.x) * WARPS + warp) * NVEC;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    if (!col_ok(ch, lane)) continue;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = col_of(ch, lane) + i;
      vp[OFF_DG1 + c] = a_dg1[ch][i];
      vp[OFF_DBL1 + c] = a_dbl1[ch][i];
      vp[OFF_DB2 + c] = a_db2[ch][i];
      vp[OFF_DG2 + c] = a_dg2[ch][i];
      vp[OFF_DBL2 + c] = a_dbl2[ch][i];
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int n = tid + q * THREADS;
    if (n < H) vp[OFF_DB1 + n] = a_db1[q];
  }
}

// wgrad: out[z][chunk] = A_z^T B_z over the chunk's rows, for z = 0: A = x
// [rows, C], B = dh [rows, H] (dW1 [C, H]); z = 1: A = h [rows, H], B = dm
// [rows, C] (dW2 [H, C]).  blockIdx.x picks the 128 x 128 output tile,
// blockIdx.y the chunk.
constexpr int TILE = 128;
constexpr int KB = 64;
constexpr int TC = (C + TILE - 1) / TILE;
constexpr int TH = (H + TILE - 1) / TILE;
constexpr int TILES = TC * TH;
constexpr int LDK = TILE + 8;
constexpr size_t WGRAD_SMEM = 2 * size_t(KB) * LDK * sizeof(float);

// One KB x 128 slab of columns [col0, col0 + 128) of `src` [rows, ld]: rows
// [r0, r0 + KB) of the chunk, zeros past `r_end` and past column `ld`.
__device__ __forceinline__ void load_slab(float* dst, const float* __restrict__ src, int ld,
                                          int col0, long long r0, long long r_end, int tid) {
  for (int i = tid; i < KB * TILE; i += THREADS) {
    const int r = i / TILE, c = i % TILE;
    dst[r * LDK + c] = (r0 + r < r_end && col0 + c < ld) ? src[(r0 + r) * ld + col0 + c] : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
tail_bwd_wgrad_f32(const float* __restrict__ x, const float* __restrict__ h,
                   const float* __restrict__ dm, const float* __restrict__ dh,
                   float* __restrict__ w_partial, long long rows, long long chunk_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* as = reinterpret_cast<float*>(smem);
  float* bs = as + KB * LDK;
  const int z = blockIdx.z;
  const int chunk = blockIdx.y;
  const int chunks = gridDim.y;
  const float* a = z == 0 ? x : h;
  const float* b = z == 0 ? dh : dm;
  const int m_dim = z == 0 ? C : H;  // A's width = output rows
  const int n_dim = z == 0 ? H : C;  // B's width = output columns
  const int tn_count = z == 0 ? TH : TC;
  const int tm = blockIdx.x / tn_count;
  const int tn = blockIdx.x % tn_count;
  float* out = w_partial + (size_t(z) * chunks + chunk) * (size_t(C) * H);
  const long long r_begin = chunk * chunk_rows;
  const long long r_end_raw = r_begin + chunk_rows;
  const long long r_end = r_end_raw < rows ? r_end_raw : rows;
  const int tid = threadIdx.x;
  // thread (ty, tx): output rows 8 ty .. 8 ty + 7, columns 8 tx .. 8 tx + 7.
  const int ty = tid / 16, tx = tid % 16;
  float acc[8][8] = {};
  for (long long r0 = r_begin; r0 < r_end; r0 += KB) {
    load_slab(as, a, m_dim, tm * TILE, r0, r_end, tid);
    load_slab(bs, b, n_dim, tn * TILE, r0, r_end, tid);
    __syncthreads();
    for (int k = 0; k < KB; ++k) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        av[i] = as[k * LDK + ty * 8 + i];
        bv[i] = bs[k * LDK + tx * 8 + i];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tm * TILE + ty * 8 + i;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = tn * TILE + tx * 8 + jj;
      if (r < m_dim && c < n_dim) out[size_t(r) * n_dim + c] = acc[i][jj];
    }
  }
}
}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 on Hopper: 1. rows pass
// ---------------------------------------------------------------------------
namespace k2 {
using namespace hop;
using bf16 = __nv_bfloat16;
#if TAIL_FUSED

struct Params {
  const float* g1;
  const float* bl1;
  const float* b1;  // padded to HP
  const float* b2;
  const float* g2;
  const float* bl2;
  const bf16* w1t;  // W1^T [HP][CP]
  const bf16* w2t;  // W2^T [CP][HP]
  bf16* ds;         // [rows][C]
  bf16* h_out;      // [rows][HP]
  bf16* dh_out;     // [rows][HP]
  float* vec_partial;  // [gridDim.x][NVEC]
  long long rows;
};

// Shared memory, bytes from the aligned base: [staged weights] [S] [D]
// (mode B: [X] [the warps' vector sums]) [per warpgroup: weight ring]
// [mbarriers].
constexpr size_t STAGED = 2 * W_BYTES;
constexpr size_t V_BYTES = kModeA ? 0 : align1k(4 * size_t(NVEC) * 4);
constexpr size_t BUFS = (kModeA ? 2 : 3) * TILE_BYTES + V_BYTES;
constexpr bool kStage = STAGED + BUFS + 256 + ALIGN_SLACK <= SMEM_MAX;
constexpr int RING = kStage ? 0 : ring_stages(BUFS);
constexpr int RINGS = RING > 0 ? RING : 1;  // RING as a divisor (unused when staged)
constexpr size_t OFF_S = kStage ? STAGED : 0;
constexpr size_t OFF_D = OFF_S + TILE_BYTES;
constexpr size_t OFF_X = OFF_D + TILE_BYTES;
constexpr size_t OFF_V = OFF_X + TILE_BYTES;
constexpr size_t OFF_RING = OFF_S + BUFS;
constexpr size_t OFF_BAR = OFF_RING + size_t(NWG) * RING * CHUNK_BYTES;
constexpr int NBAR = NWG * (2 + RING);
constexpr size_t SMEM = OFF_BAR + size_t(NBAR) * 8 + ALIGN_SLACK;
static_assert(kStage || RING >= 1, "no room for the weight ring");
static_assert(SMEM <= SMEM_MAX, "shared memory over the limit");

// The vector gradients of one warp, summed over its rows of every tile.
// Mode A keeps them in registers: after warp_col_scatter each lane holds
// JC / 8 column pairs of each C-wide vector and one pair of each hidden
// chunk; mode B adds them into the warp's region of shared memory.
enum { V_DG1, V_DBL1, V_DB2, V_DG2, V_DBL2 };
__host__ __device__ constexpr int voff(int k) {
  return k == V_DG1 ? OFF_DG1 : k == V_DBL1 ? OFF_DBL1 : k == V_DB2 ? OFF_DB2 : k == V_DG2 ? OFF_DG2 : OFF_DBL2;
}

struct VecSums {
  float c[kModeA ? 5 : 1][kModeA ? JC / 8 : 1][2];
  float h[kModeA ? NJ : 1][2];
  float* smem;  // mode B: this warp's NVEC floats

  __device__ __forceinline__ void init(float* warp_region) {
    smem = warp_region;
    if constexpr (kModeA) {
#pragma unroll
      for (int k = 0; k < 5; ++k)
#pragma unroll
        for (int i = 0; i < JC / 8; ++i) c[k][i][0] = c[k][i][1] = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) h[j][0] = h[j][1] = 0.0f;
    } else {
      for (int i = threadIdx.x & 31; i < NVEC; i += 32) smem[i] = 0.0f;
      __syncwarp();
    }
  }
  // f(j, e): the thread's two rows' sum at column 8 j + 2 q + e.
  template <int K, typename F>
  __device__ __forceinline__ void add_c(F&& f, int q) {
    float u[JC / 2][2];
    warp_col_scatter_of<JC>(f, u);
#pragma unroll
    for (int i = 0; i < JC / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (kModeA) {
          c[K][i][e] += u[i][e];
        } else {
          const int col = 8 * scattered_j<JC>(i) + 2 * q + e;
          if (c_ok(col)) smem[voff(K) + col] += u[i][e];
        }
      }
  }
  // Hidden chunk j (64 columns).
  __device__ __forceinline__ void add_h(float (&u)[8][2], int j, int q) {
    warp_col_scatter<8>(u);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if constexpr (kModeA) {
        h[j][e] += u[0][e];
      } else {
        const int col = j * HJ + 8 * scattered_j<8>(0) + 2 * q + e;
        if (col < H) smem[OFF_DB1 + col] += u[0][e];
      }
    }
  }
  __device__ __forceinline__ void flush(float* __restrict__ vp, int q) {
    if constexpr (kModeA) {
#pragma unroll
      for (int k = 0; k < 5; ++k)
#pragma unroll
        for (int i = 0; i < JC / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * scattered_j<JC>(i) + 2 * q + e;
            if (c_ok(col)) vp[voff(k) + col] = c[k][i][e];
          }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * HJ + 8 * scattered_j<8>(0) + 2 * q + e;
          if (col < H) vp[OFF_DB1 + col] = h[j][e];
        }
    } else {
      __syncwarp();
      for (int i = threadIdx.x & 31; i < NVEC; i += 32) vp[i] = smem[i];
    }
  }
};

__device__ __forceinline__ float s_at(const uint32_t (&sp)[JC][2], const uint8_t* s_buf,
                                      const Lane& ln, int j, int half, int e) {
  uint32_t raw;
  if constexpr (kModeA)
    raw = sp[j][half];
  else
    raw = *reinterpret_cast<const uint32_t*>(s_buf + tile_off(ln.row(half), j, ln.q));
  const float2 f = unpack_bf16(raw);
  return e ? f.y : f.x;
}

__global__ void __launch_bounds__(THREADS, 1)
tail_bwd_rows_wgmma(const __grid_constant__ CUtensorMap s_map,
                    const __grid_constant__ CUtensorMap d_map,
                    const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap dm_map,
                    const __grid_constant__ CUtensorMap w1_map,
                    const __grid_constant__ CUtensorMap w2_map, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const int wg = threadIdx.x >> 7;
  const Lane ln(threadIdx.x & 127);
  const bool leader = ln.t == 0;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* full_s = bars;             // [NWG]: S holds this warpgroup's s
  uint64_t* full_d = bars + NWG;       // [NWG]: D holds this warpgroup's dout
  uint64_t* ring_full = bars + 2 * NWG + wg * RING;
  uint8_t* s_buf = smem + OFF_S;
  uint8_t* d_buf = smem + OFF_D;
  uint8_t* x_buf = kModeA ? s_buf : smem + OFF_X;  // the x operand
  uint8_t* ring = smem + OFF_RING + size_t(wg) * RING * CHUNK_BYTES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NBAR; ++i) mbar_init(bars + i, 1);
    fence_barrier_init();
  }
  if constexpr (kStage) {
    stage_weights(smem, smem + W_BYTES, p.w1t, p.w2t);
    fence_proxy_async();
  }
  VecSums vs;
  vs.init(reinterpret_cast<float*>(smem + OFF_V) + ln.warp * NVEC);
  __syncthreads();

  const long long n_tiles = (p.rows + BM - 1) / BM;
  const long long stride = (long long)gridDim.x * NWG;
  const long long first = (long long)blockIdx.x * NWG + wg;
  const long long my_tiles = first < n_tiles ? (n_tiles - 1 - first) / stride + 1 : 0;
  const long long chunks = my_tiles * 2 * NJ;  // ring loads this warpgroup consumes
  if (threadIdx.x == 0 && first < n_tiles) {  // warpgroup 0's first tile
    load_tile(s_buf, &s_map, full_s, first);
    load_tile(d_buf, &d_map, full_d, first);
  }
  if constexpr (!kStage)
    if (leader)
      for (int n = 0; n < RING && n < chunks; ++n)
        load_chunk(ring + size_t(n) * CHUNK_BYTES, ring_full + n, &w1_map, &w2_map, n % NJ);

  uint32_t it = 0;
  long long n = 0;  // ring position
  for (long long tile = first; tile < n_tiles; tile += stride, ++it) {
    // S and D pass to the next warpgroup's tile (the next tile of the block
    // in order), or to this warpgroup's next one.
    const int next_wg = wg + 1 < NWG ? wg + 1 : 0;
    const long long next_tile = wg + 1 < NWG ? tile + 1 : tile - wg + stride;
    const bool pass_on = next_tile < n_tiles;

    // ---- 1. s, LN1 statistics, round(x) as the A operand (and to x_out)
    mbar_wait(full_s + wg, it & 1);
    float mu1[2], rstd1[2];
    uint32_t sp[JC][2];  // mode A: s as packed bf16 pairs
    {
      float v[4 * JC];
#pragma unroll
      for (int j = 0; j < JC; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t raw =
              *reinterpret_cast<const uint32_t*>(s_buf + tile_off(ln.row(half), j, ln.q));
          if constexpr (kModeA) sp[j][half] = raw;
          const float2 f = unpack_bf16(raw);
          v[4 * j + 2 * half] = f.x;
          v[4 * j + 2 * half + 1] = f.y;
        }
      row_stats(v, ln, mu1, rstd1);
#pragma unroll
      for (int j = 0; j < JC; ++j) {
        float x[2][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = ln.col(j, e);
          const float g = c_ok(c) ? __ldg(p.g1 + c) : 0.0f;
          const float b = c_ok(c) ? __ldg(p.bl1 + c) : 0.0f;
#pragma unroll
          for (int half = 0; half < 2; ++half)
            x[half][e] = ln_apply(v[4 * j + 2 * half + e], mu1[half], rstd1[half], g, b);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<uint32_t*>(x_buf + tile_off(ln.row(half), j, ln.q)) =
              pack_bf16(x[half][0], x[half][1]);
      }
      fence_proxy_async();
      wg_sync(1 + wg);
      if (leader) store_tile(&x_map, x_buf, tile);
    }

    // ---- 2. forward chunks: h_j = relu(x W1[:, j] + b1) (mask kept, h_j to
    //         h_out), acc += h_j W2[j, :]
    float acc[CP / 2];
#pragma unroll
    for (int i = 0; i < CP / 2; ++i) acc[i] = 0.0f;
    uint32_t live[NJ];
    for (int j = 0; j < NJ; ++j, ++n) {
      Chunk ch;
      if constexpr (kStage) {
        ch = staged_chunk(smem, smem + W_BYTES, j);
      } else {
        mbar_wait(ring_full + n % RINGS, uint32_t(n / RINGS) & 1);
        ch = ring_chunk(ring + size_t(n % RINGS) * CHUNK_BYTES);
      }
      float a1[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) a1[i] = 0.0f;
      fence_regs(a1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CP / 16; ++kk) Mma<64>::ss<0, 0>(a1, a_tile(x_buf, kk), b_w1(ch, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(a1);
      uint32_t bits = 0;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float b = __ldg(p.b1 + j * HJ + ln.col(jj, e));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = 4 * jj + 2 * half + e;
            const float pre = a1[i] + b;
            bits |= uint32_t(pre > 0.0f) << i;
            a1[i] = fmaxf(pre, 0.0f);
          }
        }
      live[j] = bits;
      uint32_t ha[4][4];
      to_a_regs(a1, ha);
      store_chunk(ha, p.h_out + tile * BM * HP + j * HJ, HP, ln, p.rows - tile * BM);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Mma<CP>::rs<0>(acc, ha[kk], b_w2(ch, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if constexpr (!kStage) {
        wg_sync(1 + wg);
        if (leader && n + RING < chunks)
          load_chunk(ring + size_t(n % RINGS) * CHUNK_BYTES, ring_full + n % RINGS, &w1_map,
                     &w2_map, int((n + RING) % NJ));
      }
    }
    if (leader) tma_store_wait_read();  // x_out has left S
    wg_sync(1 + wg);
    if constexpr (kModeA)  // S is free: pass it on
      if (leader && pass_on) load_tile(s_buf, &s_map, full_s + next_wg, next_tile);

    // ---- 3. r = x + (m + b2) -> rhat -> dr = LN2'(dout), in place in acc;
    //         round(dr) over dout in D as the A operand (and to dm_out)
    mbar_wait(full_d + wg, it & 1);
    {
#pragma unroll
      for (int j = 0; j < JC; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = ln.col(j, e);
          const bool ok = c_ok(c);
          const float g = ok ? __ldg(p.g1 + c) : 0.0f;
          const float b = ok ? __ldg(p.bl1 + c) : 0.0f;
          const float b2 = ok ? __ldg(p.b2 + c) : 0.0f;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float x = ln_apply(s_at(sp, s_buf, ln, j, half, e), mu1[half], rstd1[half], g, b);
            const int i = 4 * j + 2 * half + e;
            acc[i] = ok ? x + (acc[i] + b2) : 0.0f;
          }
        }
      float mu2[2], rstd2[2];
      row_stats(acc, ln, mu2, rstd2);
      // dout from D at (row half, column 8 j + 2 q + e)
      auto go_at = [&](int j, int half, int e) {
        const float2 v = unpack_bf16(
            *reinterpret_cast<const uint32_t*>(d_buf + tile_off(ln.row(half), j, ln.q)));
        return e ? v.y : v.x;
      };
      // rhat in place of r; LN2's backward sums
      float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < JC; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = ln.col(j, e);
          const bool ok = c_ok(c);
          const float g2 = ok ? __ldg(p.g2 + c) : 0.0f;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = 4 * j + 2 * half + e;
            const float rh = ok ? __fmul_rn(__fsub_rn(acc[i], mu2[half]), rstd2[half]) : 0.0f;
            acc[i] = rh;
            const float dxh = go_at(j, half, e) * g2;
            s1[half] += dxh;
            s2[half] += dxh * rh;
          }
        }
      vs.add_c<V_DG2>([&](int j, int e) {
        return go_at(j, 0, e) * acc[4 * j + e] + go_at(j, 1, e) * acc[4 * j + 2 + e];
      }, ln.q);
      vs.add_c<V_DBL2>([&](int j, int e) { return go_at(j, 0, e) + go_at(j, 1, e); }, ln.q);
      float m1[2], m2[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        m1[half] = quad_sum(s1[half]) * (1.0f / C);
        m2[half] = quad_sum(s2[half]) * (1.0f / C);
      }
      // dr in place of rhat; round(dr) over dout in D (each thread
      // overwrites only the dout pairs it has read)
#pragma unroll
      for (int j = 0; j < JC; ++j) {
        float dr[2][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = ln.col(j, e);
          const bool ok = c_ok(c);
          const float g2 = ok ? __ldg(p.g2 + c) : 0.0f;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = 4 * j + 2 * half + e;
            const float dxh = go_at(j, half, e) * g2;
            dr[half][e] = ok ? (dxh - m1[half] - acc[i] * m2[half]) * rstd2[half] : 0.0f;
            acc[i] = dr[half][e];
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<uint32_t*>(d_buf + tile_off(ln.row(half), j, ln.q)) =
              pack_bf16(dr[half][0], dr[half][1]);
      }
      vs.add_c<V_DB2>([&](int j, int e) { return acc[4 * j + e] + acc[4 * j + 2 + e]; }, ln.q);
      fence_proxy_async();
      wg_sync(1 + wg);
      if (leader) store_tile(&dm_map, d_buf, tile);
    }

    // ---- 4. backward chunks: dh_j = (dm W2^T[:, j]) * live (to dh_out; db1),
    //         acc (= dr) += dh_j W1^T[j, :]
    for (int j = 0; j < NJ; ++j, ++n) {
      Chunk ch;
      if constexpr (kStage) {
        ch = staged_chunk(smem, smem + W_BYTES, j);
      } else {
        mbar_wait(ring_full + n % RINGS, uint32_t(n / RINGS) & 1);
        ch = ring_chunk(ring + size_t(n % RINGS) * CHUNK_BYTES);
      }
      float a1[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) a1[i] = 0.0f;
      fence_regs(a1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CP / 16; ++kk) Mma<64>::ss<0, 1>(a1, a_tile(d_buf, kk), b_w2t(ch, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(a1);
      float u[8][2];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          u[jj][e] = 0.0f;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = 4 * jj + 2 * half + e;
            a1[i] = (live[j] >> i) & 1u ? a1[i] : 0.0f;
            u[jj][e] += a1[i];
          }
        }
      vs.add_h(u, j, ln.q);
      uint32_t dha[4][4];
      to_a_regs(a1, dha);
      store_chunk(dha, p.dh_out + tile * BM * HP + j * HJ, HP, ln, p.rows - tile * BM);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Mma<CP>::rs<1>(acc, dha[kk], b_w1t(ch, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if constexpr (!kStage) {
        wg_sync(1 + wg);
        if (leader && n + RING < chunks)
          load_chunk(ring + size_t(n % RINGS) * CHUNK_BYTES, ring_full + n % RINGS, &w1_map,
                     &w2_map, int((n + RING) % NJ));
      }
    }
    if (leader) tma_store_wait_read();  // dm_out has left D
    wg_sync(1 + wg);
    if (leader && pass_on) load_tile(d_buf, &d_map, full_d + next_wg, next_tile);

    // ---- 5. dx = acc; ds = LN1'(dx), to ds; dg1, dbl1
    {
      auto xh_at = [&](int j, int half, int e) {
        return c_ok(ln.col(j, e)) ? __fmul_rn(__fsub_rn(s_at(sp, s_buf, ln, j, half, e),
                                                        mu1[half]),
                                              rstd1[half])
                                  : 0.0f;
      };
      auto dx_at = [&](int j, int half, int e) {
        return c_ok(ln.col(j, e)) ? acc[4 * j + 2 * half + e] : 0.0f;
      };
      vs.add_c<V_DG1>([&](int j, int e) {
        return dx_at(j, 0, e) * xh_at(j, 0, e) + dx_at(j, 1, e) * xh_at(j, 1, e);
      }, ln.q);
      vs.add_c<V_DBL1>([&](int j, int e) { return dx_at(j, 0, e) + dx_at(j, 1, e); }, ln.q);
      float t1[2] = {0.0f, 0.0f}, t2[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < JC; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = ln.col(j, e);
          const float g = c_ok(c) ? __ldg(p.g1 + c) : 0.0f;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float dxh = dx_at(j, half, e) * g;
            t1[half] += dxh;
            t2[half] += dxh * xh_at(j, half, e);
          }
        }
      float m1[2], m2[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        m1[half] = quad_sum(t1[half]) * (1.0f / C);
        m2[half] = quad_sum(t2[half]) * (1.0f / C);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t o[JC];
#pragma unroll
        for (int j = 0; j < JC; ++j) {
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = ln.col(j, e);
            const float dxh = dx_at(j, half, e) * (c_ok(c) ? __ldg(p.g1 + c) : 0.0f);
            d[e] = (dxh - m1[half] - xh_at(j, half, e) * m2[half]) * rstd1[half];
          }
          o[j] = pack_bf16(d[0], d[1]);
        }
        uint4 og[JC / 4];
        quad_transpose(o, og);  // 16-byte stores
        const long long row = tile * BM + ln.row(half);
        if (row < p.rows) {
#pragma unroll
          for (int g = 0; g < JC / 4; ++g) {
            const int c = 8 * (4 * g + ln.q);
            if (c_ok(c)) *reinterpret_cast<uint4*>(p.ds + row * C + c) = og[g];
          }
        }
      }
    }
    if constexpr (!kModeA) {  // S is done with: bring this warpgroup's next tile
      wg_sync(1 + wg);
      if (leader && pass_on) load_tile(s_buf, &s_map, full_s + next_wg, next_tile);
    }
  }
  // One vector partial a block: the warps' partials through shared memory
  // (dead by now: no load or store is in flight), summed in a fixed order.
  static_assert(size_t(NWG) * 4 * NVEC * 4 + ALIGN_SLACK <= SMEM, "room for the warps' partials");
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
  vs.flush(part + size_t(wg * 4 + ln.warp) * NVEC, ln.q);
  __syncthreads();
  for (int i = threadIdx.x; i < NVEC; i += THREADS) {
    float sum = 0.0f;
    for (int w = 0; w < NWG * 4; ++w) sum += part[size_t(w) * NVEC + i];
    p.vec_partial[size_t(blockIdx.x) * NVEC + i] = sum;
  }
}

#endif  // TAIL_FUSED

// ---------------------------------------------------------------------------
// 2. wgrad: out[z][chunk] = A_z^T B_z over the chunk's rows, both [CP][HP]:
//    z = 0: A = x [rows][CP], B = dh [rows][HP] (dW1);
//    z = 1: A = dm [rows][CP], B = h [rows][HP] (dW2^T).
//    Warpgroup (mi, ni) of a block owns the 64 x NW output tile at rows
//    (super_m * MS + mi) * 64, columns (super_n * NS + ni) * NW; blockIdx.x
//    picks the super tile, blockIdx.y the row chunk.
// ---------------------------------------------------------------------------
constexpr int KB = 64;                   // rows a stage
static_assert(KB == BM, "x and dm are read in the boxes the rows pass stores");
constexpr int WMT = CP / 64;             // warpgroup tiles along C
constexpr int NW = HP % 192 == 0 ? 192 : (HP % 128 == 0 ? 128 : 64);
constexpr int WNT = HP / NW;             // warpgroup tiles along H
constexpr int MS = WMT % 2 == 0 ? 2 : 1;
constexpr int NS = WNT % (4 / MS) == 0 ? 4 / MS : (WNT % 2 == 0 ? 2 : 1);
constexpr int SUPER_N = WNT / NS;
constexpr int SUPER = (WMT / MS) * SUPER_N;
constexpr int WTHREADS = MS * NS * 128;
constexpr int B_PANELS = NS * NW / 64;
constexpr size_t W_STAGE = size_t(KB) * 128 * (MS + B_PANELS);
constexpr int W_STAGES_FIT = int((SMEM_MAX - ALIGN_SLACK - 256) / W_STAGE);
constexpr int W_STAGES = W_STAGES_FIT > 4 ? 4 : W_STAGES_FIT;
constexpr size_t WGRAD_SMEM = W_STAGES * W_STAGE + size_t(W_STAGES) * 8 + ALIGN_SLACK;
static_assert(W_STAGES >= 2, "no room for the wgrad ring");

__device__ __forceinline__ void wgrad_load(uint8_t* stage, uint64_t* bar, const CUtensorMap* am,
                                           const CUtensorMap* bm, int a_col0, int b_col0, int row) {
  mbar_expect_tx(bar, uint32_t(W_STAGE));
#pragma unroll
  for (int i = 0; i < MS; ++i) tma_load(stage + size_t(i) * (KB * 128), am, bar, a_col0 + 64 * i, row);
#pragma unroll
  for (int i = 0; i < B_PANELS; ++i)
    tma_load(stage + size_t(MS + i) * (KB * 128), bm, bar, b_col0 + 64 * i, row);
}

__global__ void __launch_bounds__(WTHREADS, 1)
tail_bwd_wgrad_wgmma(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap dh_map,
                     const __grid_constant__ CUtensorMap dm_map,
                     const __grid_constant__ CUtensorMap h_map, float* __restrict__ w_partial,
                     long long rows, long long chunk_rows) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + W_STAGES * W_STAGE);
  const int z = blockIdx.z;
  const CUtensorMap* am = z ? &dm_map : &x_map;
  const CUtensorMap* bm = z ? &h_map : &dh_map;
  const int a_col0 = int(blockIdx.x / SUPER_N) * MS * 64;
  const int b_col0 = int(blockIdx.x % SUPER_N) * NS * NW;
  const int w = threadIdx.x >> 7;
  const int mi = w / NS, ni = w % NS;
  const Lane ln(threadIdx.x & 127);
  const long long r_begin = blockIdx.y * chunk_rows;
  const long long r_end = r_begin + chunk_rows < rows ? r_begin + chunk_rows : rows;
  const int n_k = r_end > r_begin ? int((r_end - r_begin + KB - 1) / KB) : 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < W_STAGES; ++i) mbar_init(full + i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < W_STAGES && k < n_k; ++k)
      wgrad_load(smem + size_t(k) * W_STAGE, full + k, am, bm, a_col0, b_col0,
                 int(r_begin + k * KB));

  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;
  for (int k = 0; k < n_k; ++k) {
    const int s = k % W_STAGES;
    mbar_wait(full + s, uint32_t(k / W_STAGES) & 1);
    const uint8_t* a = smem + size_t(s) * W_STAGE + size_t(mi) * (KB * 128);
    const uint8_t* b = smem + size_t(s) * W_STAGE + size_t(MS + ni * (NW / 64)) * (KB * 128);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk)
      Mma<NW>::ss<1, 1>(acc, desc(a + kk * 2048, KB * 128, 1024), desc(b + kk * 2048, KB * 128, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // stage k - 1's products are done
    __syncthreads();
    if (threadIdx.x == 0 && k >= 1 && k - 1 + W_STAGES < n_k) {
      const int r = k - 1 + W_STAGES;
      wgrad_load(smem + size_t((k - 1) % W_STAGES) * W_STAGE, full + (k - 1) % W_STAGES, am, bm,
                 a_col0, b_col0, int(r_begin + r * KB));
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  // dW1 as [CP][HP]; dW2 as [HP][CP] (its own layout, so that the reduce
  // reads both in order)
  float* out = w_partial + (size_t(z) * gridDim.y + blockIdx.y) * (size_t(CP) * HP);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = a_col0 + mi * 64 + ln.row(half);
    const int h0 = b_col0 + ni * NW;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int h = h0 + ln.col(j);
      if (z == 0) {
        *reinterpret_cast<float2*>(out + size_t(c) * HP + h) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      } else {
        out[size_t(h) * CP + c] = acc[4 * j + 2 * half];
        out[size_t(h + 1) * CP + c] = acc[4 * j + 2 * half + 1];
      }
    }
  }
}
}  // namespace k2

}  // namespace

// s, dout, ds: [rows, C] in the stream type; w1t = W1^T and w2t = W2^T
// zero-padded (bf16: [HP, CP] / [CP, HP], multiples of 64, as fused_mlp.cu's;
// f32: multiples of 16); LayerNorm parameters and biases f32 (bf16: b1
// padded to HP).  The row operands: bf16 x, dm [rows, CP] and h, dh [rows,
// HP]; f32 x, dm [rows, C] and h, dh [rows, H].  vec_partial: f32
// [row_grid * partials a block, 5 C + H] (bf16: one a block; f32: one a
// warp, 8 a block); w_partial: f32 [2, chunks, CP * HP] (bf16: dW1 as [CP,
// HP], dW2 as [HP, CP]) or [2, chunks, C * H] (f32); grads: f32 [2 C H + 5 C
// + H] (dg1, dbl1, dw1 [C, H], db1, dw2 [H, C], db2, dg2, dbl2).  c and h
// must be the compiled KERNEL_C and KERNEL_H; the grids, chunks and shared
// memory come from ops/fused_mlp.py::launch_plan (chunk_rows a multiple of
// 64 with chunks * chunk_rows >= rows; the shared memory equal to the
// library's).  Launches on `stream`, does not synchronise, allocates
// nothing.  Returns the cudaError_t of the launches (0 on success;
// cudaErrorInvalidValue for arguments that do not match).
extern "C" int fused_ln_mlp_ln_bwd_bf16(
    const void* s, const void* dout, const void* g1, const void* bl1, const void* w1t,
    const void* b1, const void* w2t, const void* b2, const void* g2, const void* bl2, void* ds,
    void* x_buf, void* h_buf, void* dm_buf, void* dh_buf, void* vec_partial, void* w_partial,
    void* grads, long long rows, int c, int h, int row_grid, long long row_smem, int chunks,
    long long chunk_rows, int wgrad_grid, long long wgrad_smem, void* stream) {
#if TAIL_FUSED
  using namespace k2;
  if (c != C || h != H || rows < 0 || row_smem != (long long)SMEM ||
      wgrad_smem != (long long)WGRAD_SMEM || (rows > 0 && (row_grid <= 0 || chunks <= 0)) ||
      wgrad_grid != SUPER || chunk_rows <= 0 || chunk_rows % KB != 0 ||
      chunk_rows * chunks < rows)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rows > 0) {
    CUtensorMap s_map, d_map, x_map, dm_map, h_map, dh_map, w1_map, w2_map;
    if (!make_map(&s_map, s, rows, C, BM) || !make_map(&d_map, dout, rows, C, BM) ||
        !make_map(&x_map, x_buf, rows, CP, BM) || !make_map(&dm_map, dm_buf, rows, CP, BM) ||
        !make_map(&h_map, h_buf, rows, HP, KB) || !make_map(&dh_map, dh_buf, rows, HP, KB) ||
        !make_map(&w1_map, w1t, HP, CP, HJ) || !make_map(&w2_map, w2t, CP, HP, CP))
      return int(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(tail_bwd_rows_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(SMEM));
    if (err != cudaSuccess) return int(err);
    const Params p{static_cast<const float*>(g1), static_cast<const float*>(bl1),
                   static_cast<const float*>(b1), static_cast<const float*>(b2),
                   static_cast<const float*>(g2), static_cast<const float*>(bl2),
                   static_cast<const bf16*>(w1t), static_cast<const bf16*>(w2t),
                   static_cast<bf16*>(ds), static_cast<bf16*>(h_buf), static_cast<bf16*>(dh_buf),
                   static_cast<float*>(vec_partial), rows};
    tail_bwd_rows_wgmma<<<unsigned(row_grid), THREADS, SMEM, st>>>(s_map, d_map, x_map, dm_map,
                                                                   w1_map, w2_map, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    err = cudaFuncSetAttribute(tail_bwd_wgrad_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(WGRAD_SMEM));
    if (err != cudaSuccess) return int(err);
    tail_bwd_wgrad_wgmma<<<dim3(unsigned(wgrad_grid), unsigned(chunks), 2), WTHREADS, WGRAD_SMEM,
                           st>>>(x_map, dh_map, dm_map, h_map, static_cast<float*>(w_partial),
                                 rows, chunk_rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  tail_bwd_reduce<true><<<(G_TOTAL + RTHREADS - 1) / RTHREADS, RTHREADS, 0, st>>>(
      static_cast<const float*>(vec_partial), rows > 0 ? row_grid : 0,
      static_cast<const float*>(w_partial), rows > 0 ? chunks : 0, static_cast<float*>(grads));
  return int(cudaGetLastError());
#else
  (void)s, (void)dout, (void)g1, (void)bl1, (void)w1t, (void)b1, (void)w2t, (void)b2, (void)g2;
  (void)bl2, (void)ds, (void)x_buf, (void)h_buf, (void)dm_buf, (void)dh_buf, (void)vec_partial;
  (void)w_partial, (void)grads, (void)rows, (void)c, (void)h, (void)row_grid, (void)row_smem;
  (void)chunks, (void)chunk_rows, (void)wgrad_grid, (void)wgrad_smem, (void)stream;
  return int(cudaErrorInvalidValue);  // this width takes the split path
#endif
}

// The split path (widths the single-pass rows pass does not take): the rows
// pass as seven launches (tail_split.cuh) over the same row operands plus
// z_buf f32 [rows, CP] (z, then dr, then dx) and stats f32 [rows, 2], one
// vector partial a 64-row tile (vec_partial [ceil(rows / 64), 5 C + H]),
// then the same wgrad and reduce launches.
extern "C" int fused_ln_mlp_ln_bwd_bf16_split(
    const void* s, const void* dout, const void* g1, const void* bl1, const void* w1t,
    const void* b1, const void* w2t, const void* b2, const void* g2, const void* bl2, void* ds,
    void* x_buf, void* h_buf, void* dm_buf, void* dh_buf, void* z_buf, void* stats,
    void* vec_partial, void* w_partial, void* grads, long long rows, int c, int h, int chunks,
    long long chunk_rows, int wgrad_grid, long long wgrad_smem, void* stream) {
#if !TAIL_FUSED
  using namespace k2;
  using namespace split;
  if (c != C || h != H || rows < 0 || wgrad_smem != (long long)WGRAD_SMEM ||
      (rows > 0 && chunks <= 0) || wgrad_grid != SUPER || chunk_rows <= 0 ||
      chunk_rows % KB != 0 || chunk_rows * chunks < rows)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  auto B = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  cudaError_t err;
  const unsigned tiles = row_tiles(rows);
  if (rows > 0) {
    float* z = static_cast<float*>(z_buf);
    float* vp = static_cast<float*>(vec_partial);
    tail_split_ln1<<<tiles, split::RTHREADS, 0, st>>>(B(s), F(g1), F(bl1),
                                                      static_cast<__nv_bfloat16*>(x_buf),
                                                      static_cast<float2*>(stats), rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    Epi e{F(b1), nullptr, nullptr, nullptr, nullptr, nullptr, static_cast<__nv_bfloat16*>(h_buf), nullptr,
          nullptr, rows};
    if ((err = launch_gemm<EPI_H>(x_buf, w1t, e, st)) != cudaSuccess) return int(err);
    e = Epi{F(b2), B(s), static_cast<const float2*>(stats), F(g1), F(bl1), nullptr, nullptr, z,
            nullptr, rows};
    if ((err = launch_gemm<EPI_Z>(h_buf, w2t, e, st)) != cudaSuccess) return int(err);
    tail_split_ln2_bwd<<<tiles, split::RTHREADS, 0, st>>>(z, B(dout), F(g2),
                                                          static_cast<__nv_bfloat16*>(dm_buf), vp, rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    e = Epi{nullptr, nullptr, nullptr, nullptr, nullptr, B(h_buf), static_cast<__nv_bfloat16*>(dh_buf),
            nullptr, vp, rows};
    if ((err = launch_gemm<EPI_DH>(dm_buf, w2t, e, st)) != cudaSuccess) return int(err);
    e = Epi{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, z, nullptr, rows};
    if ((err = launch_gemm<EPI_DX>(dh_buf, w1t, e, st)) != cudaSuccess) return int(err);
    tail_split_ln1_bwd<<<tiles, split::RTHREADS, 0, st>>>(
        z, B(s), static_cast<const float2*>(stats), F(g1), static_cast<__nv_bfloat16*>(ds), vp, rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    CUtensorMap x_map, dm_map, h_map, dh_map;
    if (!make_map(&x_map, x_buf, rows, CP, BM) || !make_map(&dm_map, dm_buf, rows, CP, BM) ||
        !make_map(&h_map, h_buf, rows, HP, KB) || !make_map(&dh_map, dh_buf, rows, HP, KB))
      return int(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(tail_bwd_wgrad_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(WGRAD_SMEM));
    if (err != cudaSuccess) return int(err);
    tail_bwd_wgrad_wgmma<<<dim3(unsigned(wgrad_grid), unsigned(chunks), 2), WTHREADS, WGRAD_SMEM,
                           st>>>(x_map, dh_map, dm_map, h_map, static_cast<float*>(w_partial),
                                 rows, chunk_rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  tail_bwd_reduce<true><<<(G_TOTAL + ::RTHREADS - 1) / ::RTHREADS, ::RTHREADS, 0, st>>>(
      static_cast<const float*>(vec_partial), rows > 0 ? int(tiles) : 0,
      static_cast<const float*>(w_partial), rows > 0 ? chunks : 0, static_cast<float*>(grads));
  return int(cudaGetLastError());
#else
  (void)s, (void)dout, (void)g1, (void)bl1, (void)w1t, (void)b1, (void)w2t, (void)b2, (void)g2;
  (void)bl2, (void)ds, (void)x_buf, (void)h_buf, (void)dm_buf, (void)dh_buf, (void)z_buf;
  (void)stats, (void)vec_partial, (void)w_partial, (void)grads, (void)rows, (void)c, (void)h;
  (void)chunks, (void)chunk_rows, (void)wgrad_grid, (void)wgrad_smem, (void)stream;
  return int(cudaErrorInvalidValue);  // this width takes the single-pass kernels
#endif
}

extern "C" int fused_ln_mlp_ln_bwd_f32(
    const void* s, const void* dout, const void* g1, const void* bl1, const void* w1t,
    const void* b1, const void* w2t, const void* b2, const void* g2, const void* bl2, void* ds,
    void* x_buf, void* h_buf, void* dm_buf, void* dh_buf, void* vec_partial, void* w_partial,
    void* grads, long long rows, int c, int h, int row_grid, long long row_smem, int chunks,
    long long chunk_rows, int wgrad_grid, long long wgrad_smem, void* stream) {
  using namespace f32;
  if (c != C || h != H || rows < 0 || row_grid <= 0 || chunks <= 0 || chunk_rows <= 0 ||
      chunk_rows % KB != 0 || chunk_rows * chunks < rows ||
      row_smem != (long long)RowSmem::total || wgrad_smem != (long long)WGRAD_SMEM ||
      wgrad_grid != TILES)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rows > 0) {
    err = cudaFuncSetAttribute(tail_bwd_rows_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(RowSmem::total));
    if (err != cudaSuccess) return int(err);
    tail_bwd_rows_f32<<<unsigned(row_grid), THREADS, RowSmem::total, st>>>(
        static_cast<const float*>(s), static_cast<const float*>(dout),
        static_cast<const float*>(g1), static_cast<const float*>(bl1),
        static_cast<const float*>(w1t), static_cast<const float*>(b1),
        static_cast<const float*>(w2t), static_cast<const float*>(b2),
        static_cast<const float*>(g2), static_cast<const float*>(bl2), static_cast<float*>(ds),
        static_cast<float*>(x_buf), static_cast<float*>(h_buf), static_cast<float*>(dm_buf),
        static_cast<float*>(dh_buf), static_cast<float*>(vec_partial), rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  err = cudaFuncSetAttribute(tail_bwd_wgrad_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(WGRAD_SMEM));
  if (err != cudaSuccess) return int(err);
  tail_bwd_wgrad_f32<<<dim3(TILES, unsigned(chunks), 2), THREADS, WGRAD_SMEM, st>>>(
      static_cast<const float*>(x_buf), static_cast<const float*>(h_buf),
      static_cast<const float*>(dm_buf), static_cast<const float*>(dh_buf),
      static_cast<float*>(w_partial), rows, chunk_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  tail_bwd_reduce<false><<<(G_TOTAL + RTHREADS - 1) / RTHREADS, RTHREADS, 0, st>>>(
      static_cast<const float*>(vec_partial), row_grid * WARPS,
      static_cast<const float*>(w_partial), chunks, static_cast<float*>(grads));
  return int(cudaGetLastError());
}

// Dynamic shared memory of the rows pass (bf16 on the split path: its
// largest GEMM block) and of the wgrad pass, and whether the rows pass
// stages the weights.
#if TAIL_FUSED
constexpr long long kRowsSmem = k2::SMEM;
constexpr int kRowsStage = k2::kStage;
#else
constexpr long long kRowsSmem = split::SMEM;
constexpr int kRowsStage = 0;
#endif
extern "C" long long fused_ln_mlp_ln_bwd_smem_bytes(int bf16) {
  return bf16 ? kRowsSmem : (long long)f32::RowSmem::total;
}

extern "C" long long fused_ln_mlp_ln_bwd_wgrad_smem_bytes(int bf16) {
  return bf16 ? (long long)k2::WGRAD_SMEM : (long long)f32::WGRAD_SMEM;
}

extern "C" int fused_ln_mlp_ln_bwd_stages_weights(int bf16) { return bf16 ? kRowsStage : 0; }
