// K9's edge stream on Hopper: the edge-attention and edge-tail launches of
// the whole-generator kernel's bf16 route (ops/fused_generator.py
// hopper_route: bf16, C = 128, a hidden width at which K1's staged plan
// fits, N <= 64, b_dim <= 7).
//
// Replaces, with fused_generator.cu's node pass, the TPU kernel
// druggen_tpu/ops/fused_generator.py::_kernel (called by
// fused_generator_logits) on that route.  Each depth d's edge stream,
//
//     e  = round(y We + be)                     y: the input MLP of z_e (d 0)
//     t  = round(round(round(round(q_i k_j) scale) round(e + 1)) e)
//     agg_i = round(sum_j p_j v_j / sum_j p_j),  p = exp(t - max_j t) per channel
//     s  = round(y + round(t Woe + boe))
//     y' = round(LN6(round(round(LN4(s)) + round(fc2(relu(round(fc1(.))))))))
//     edge logits = round(y' W_re + b_re)       (after the last depth)
//
// with the Pallas kernel's rounding points (fused_generator.cu's header):
// every K9 product is bf16 x bf16 (the wrapper casts the weights to the
// stream type) with an f32 sum and bias, so each is one wgmma pass.
//
// What bounds it on an H100 SXM at the serving shape (512 graphs of 45
// atoms, R = 1,036,800 edge rows, C 128, H 384, b_dim 5, depth 1):
//   attention  per row the input MLP 2 (5 x 64 + 64 x 128), e and out_e
//              2 x 2 x 128^2: 82,560 FLOP, 85.6 GFLOP, 0.087 ms at 989
//              TFLOP/s; bytes: z_e (or y) in, s out, agg, q, k, v: ~0.30
//              GB at depth 0, 0.090 ms.  About even.
//   tail       per row MLP2 2 x 2 x 128 x 384 and the readout 2 x 128 x 5:
//              197,888 FLOP, 205.2 GFLOP, 0.2075 ms; s in and the logits
//              out 0.28 GB, 0.08 ms.  The operations bound it.
// Splitting the depth into these two launches writes and reads s once
// (2 x 265 MB, ~0.16 ms of bytes): the edge stream's bf16 weights (~278 KB)
// do not fit one SM's 227 KB together, and streaming W1/W2 (192 KB) from L2
// for every 64-row slab would read 23,040 x 192 KB = 4.4 GB of L2.
//
// The plan (its grids come from ops/fused_generator.py::launch_plan; the
// shared memory below is exported, not recomputed in Python):
//   attention  a persistent block an SM over a contiguous run of slabs
//              (blk::SlabRange), two warpgroups taking them in turn
//              (warpgroup w the slabs begin + w, begin + w + 2, ...).  A slab
//              is the N key rows (b, i, :) of one query atom, one 64-row
//              tile (rows j < N valid, the rest masked).  Staged once a
//              block in tail_hopper.cuh's swizzled panels:
//                We^T 32,768 | Woe^T 32,768 | W_ef2^T 16,384 | W_ef1^T
//                8,192 (a [64][128 B] panel, 16 of its columns read) | a
//                tile a warpgroup 2 x 16,384 | q, k, v of a graph a
//                warpgroup 2 x 52,224 | the biases 2,048 | 2 mbarriers
//                                               (230,416 B with the slack)
//              At depth 0 the input MLP runs from the slab's z_e rows,
//              loaded into wgmma's register A operand (one k-step of 16);
//              at later depths TMA brings the previous depth's rows into
//              the warpgroup's tile.  y stays in registers as packed bf16
//              pairs (the A operand of e = y We and the residual); the
//              modulate chain and the residual y + y1 run on bf16 pairs
//              (bf16x2 products and sums, each the correctly rounded one,
//              so the same bits as rounding an f32 operation); t is the A
//              operand of t Woe, and s goes to the flat [B N N, C]
//              scratch for the rows j < N; then the
//              softmax over the keys from t's registers: the column max,
//              p = exp(t - max) once in place, its sum and its v-weighted
//              sum (attn_hopper.cuh's wg_col_reduce in the warpgroup's
//              tile, fixed order), agg = sum_v / sum to the [B N, C]
//              scratch.  Each warpgroup copies the q, k and v rows of its
//              slab's graph into its own buffer when the graph changes
//              (once in ~N / 2 slabs; rows padded by 16 bytes, so a warp's
//              reads fall in 32 banks), and at depth 0 loads the next
//              slab's one-hot rows a slab ahead.  With two warpgroups of
//              ~240 registers a SM, the CUDA-core chains bound this launch
//              more than its products do.
//   tail       K1's staged plan (tail_hopper.cuh's ftile::tail_fwd_tiles with
//              K9's rounding policy): W1^T and W2^T staged once a block,
//              flat 64-row tiles over all B N N rows (no slab padding),
//              two warpgroups; LN4's output rounded, fc1 rounded before the
//              ReLU, fc2 rounded, the residual add rounded, LN6's output
//              rounded.  At earlier depths it writes the next depth's rows
//              over s in place (a tile is read whole before its rows are
//              written, and tiles are disjoint); at the last depth the
//              edge readout (b_dim <= 7 columns) runs in the epilogue on
//              wgmma m64n8 from LN6's registers, with W_re^T staged in the
//              2,032 B that K1's 230,416 B leave (as no-swizzle core
//              matrices whose unused rows overlap: 1,808 B; 232,224 B a
//              block).
// The attention launch at depth > 0 overwrites s in place too: a slab's
// rows are read into registers before they are written, and the rows its
// tile reads past N belong to other slabs and are masked.  A forward is
// node, attention, tail per depth, then a last node pass: 3 x depth + 1
// launches (the wrapper counts one).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -DKERNEL_C=128 -DKERNEL_H=384 -o libfused_generator_hopper.so \
//        fused_generator_hopper.cu
// Plain C interface for ctypes; no PyTorch headers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attn_hopper.cuh"
#include "gen_weights.cuh"

#define GEN_HOPPER (KERNEL_C == 128 && TAIL_FUSED)

namespace {

#if GEN_HOPPER
namespace k9h {
using namespace ahop;
using namespace genw;
using bf16 = __nv_bfloat16;

constexpr int HID_IN = 64;    // the input MLPs' hidden width
constexpr int MAX_BDIM = 16;  // one-hot width: one k-step of the input MLP
constexpr size_t WF2_BYTES = size_t(CP) * 128;      // W_ef2^T [C][64]: one panel
constexpr size_t WF1_BYTES = size_t(HID_IN) * 128;  // W_ef1^T [64][16] in a [64][128 B] panel
// A warpgroup's copy of its current graph's q, k and v rows: [3][MAX_N]
// rows of GLD bf16, the row stride padded by 16 bytes so that the eight
// rows and four column pairs a warp reads at once fall in 32 banks.
constexpr int GLD = C + 8;
constexpr size_t GRAPH_T = size_t(MAX_N) * GLD * 2;  // one tensor's rows
constexpr size_t GRAPH_BYTES = 3 * GRAPH_T;
// The block's bias vectors (f32): be, boe [C], b_ef1 [64], b_ef2 [C].
constexpr int VB_E = 0, VB_OE = C, VB_F1 = 2 * C, VB_F2 = 2 * C + HID_IN, VB_N = 3 * C + HID_IN;
constexpr size_t OFF_WE = 0, OFF_WOE = SQ_BYTES, OFF_WF2 = 2 * SQ_BYTES,
                 OFF_WF1 = OFF_WF2 + WF2_BYTES, OFF_TILE = OFF_WF1 + WF1_BYTES,
                 OFF_GRAPH = OFF_TILE + WARPGROUPS * TILE_BYTES,
                 OFF_VEC = OFF_GRAPH + WARPGROUPS * GRAPH_BYTES,
                 OFF_BAR = OFF_VEC + align1k(size_t(VB_N) * 4);
constexpr size_t ATTN_SMEM = OFF_BAR + WARPGROUPS * 8 + ALIGN_SLACK;
// The route's widths: C 128 and the hidden staged beside two tiles (mode A).
constexpr bool kRoute = ftile::kStage && kModeA && C == NT && CP == C;
static_assert(ATTN_SMEM <= SMEM_MAX, "shared memory over the limit");

// W^T [rows][cols] bf16 (row stride ld elements) into cols / 64 panels of
// [rows][128 B] (cols < 64: the first columns of one panel).  Every thread
// of the block; 16-byte copies.
__device__ __forceinline__ void stage_panels(uint8_t* dst, const bf16* __restrict__ src, int rows,
                                             int cols, int ld) {
  const int groups = cols / 8;
  for (int i = threadIdx.x; i < rows * groups; i += blockDim.x) {
    const int r = i / groups, c = (i % groups) * 8;
    *reinterpret_cast<uint4*>(dst + size_t(c >> 6) * (size_t(rows) * 128) + sw_off(r, c & 63)) =
        *reinterpret_cast<const uint4*>(src + size_t(r) * ld + c);
  }
}

// ---------------------------------------------------------------------------
// Edge attention
// ---------------------------------------------------------------------------
struct AttnParams {
  const bf16* ze;   // [R, b_dim] one-hot rows (depth 0)
  const bf16* we;   // We^T [C][C]
  const bf16* woe;  // Woe^T [C][C]
  const bf16* wf1;  // W_ef1^T [64][16]
  const bf16* wf2;  // W_ef2^T [C][64]
  const float* be;
  const float* boe;
  const float* bf1;
  const float* bf2;
  const bf16* q;    // [B N, C]
  const bf16* k;
  const bf16* v;
  bf16* agg;        // [B N, C]
  bf16* s;          // [R, C]: s out (and at depth > 0 the rows in, by TMA)
  long long slabs;  // B N
  int n;
  int b_dim;
  float scale;
};

// A warpgroup's place in the block: its tile and mbarrier, its named
// barrier, its thread's place in its tiles, its column-reduction region
// (scratch [4][C], then the results), which is its tile once y is read, and
// its graph buffer.
struct Wg {
  int wg;
  int bar;
  Lane ln;
  uint8_t* tile;
  uint64_t* full;
  float* red;
  bf16* graph;  // q, k, v rows of the graph of its current slab
  __device__ __forceinline__ explicit Wg(uint8_t* smem)
      : wg(threadIdx.x / NT), bar(1 + threadIdx.x / NT), ln(threadIdx.x % NT),
        tile(smem + OFF_TILE + size_t(threadIdx.x / NT) * TILE_BYTES),
        full(reinterpret_cast<uint64_t*>(smem + OFF_BAR) + threadIdx.x / NT),
        red(reinterpret_cast<float*>(smem + OFF_TILE + size_t(threadIdx.x / NT) * TILE_BYTES)),
        graph(reinterpret_cast<bf16*>(smem + OFF_GRAPH + size_t(threadIdx.x / NT) * GRAPH_BYTES)) {}
  __device__ __forceinline__ bool leader() const { return ln.t == 0; }
};

// The one-hot rows from flat row row0 as the A registers of the input MLP's
// one k-step (zeros past N and past b_dim).
__device__ __forceinline__ void load_z(const AttnParams& p, long long row0, const Lane& ln,
                                       uint32_t (&za)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ln.row(i & 1), c = 8 * (i >> 1) + 2 * ln.q;
    const bf16* z = p.ze + (row0 + r) * p.b_dim;
    const bool ok = r < p.n;
    za[i] = pack_bf16(ok && c < p.b_dim ? __bfloat162float(z[c]) : 0.0f,
                      ok && c + 1 < p.b_dim ? __bfloat162float(z[c + 1]) : 0.0f);
  }
}

// y = relu(round(relu(round(z W_ef1 + b)) W_ef2 + b)) of the slab's rows
// (za: load_z's registers), as the packed bf16 A registers of the next
// product.
__device__ __forceinline__ void input_mlp(const uint32_t (&za)[4], const float* vs,
                                          const uint8_t* wf1, const uint8_t* wf2, const Lane& ln,
                                          uint32_t (&ya)[CP / 16][4]) {
  float h[32];
  zero(h);
  fence_regs(h);
  wgmma_fence();
  Mma<64>::rs<0>(h, za, desc(wf1, 16, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(h);
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float b = vs[VB_F1 + ln.col(jj, e)];
      h[4 * jj + e] = fmaxf(h[4 * jj + e] + b, 0.0f);  // rounded by the packing
      h[4 * jj + 2 + e] = fmaxf(h[4 * jj + 2 + e] + b, 0.0f);
    }
  uint32_t ha[4][4];
  to_a_regs(h, ha);
  float acc[4 * JC];
  zero(acc);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) Mma<CP>::rs<0>(acc, ha[kk], desc(wf2 + kk * 32, 16, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int j = 0; j < JC; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float b = vs[VB_F2 + ln.col(j, e)];
      acc[4 * j + e] = fmaxf(acc[4 * j + e] + b, 0.0f);
      acc[4 * j + 2 + e] = fmaxf(acc[4 * j + 2 + e] + b, 0.0f);
    }
  to_a_regs(acc, ya);
}

// Graph b's q, k and v rows into a warpgroup's graph buffer (its 128
// threads, 16-byte copies).
__device__ __forceinline__ void load_graph(bf16* gbuf, const AttnParams& p, long long b,
                                           const Lane& ln) {
  const int n = p.n;
  for (int i = ln.t; i < 3 * n * (C / 8); i += NT) {
    const int m = i / (n * (C / 8)), r = (i / (C / 8)) % n, c = (i % (C / 8)) * 8;
    const bf16* src = (m == 0 ? p.q : m == 1 ? p.k : p.v) + (b * n + r) * C + c;
    *reinterpret_cast<uint4*>(gbuf + m * (GRAPH_T / 2) + r * GLD + c) =
        __ldg(reinterpret_cast<const uint4*>(src));
  }
}

// The bf16 pair at (row r, column c) of a graph buffer's tensor m (0 q,
// 1 k, 2 v), and the same as floats.
__device__ __forceinline__ __nv_bfloat162 graph_bf2(const bf16* gbuf, int m, int r, int c) {
  return *reinterpret_cast<const __nv_bfloat162*>(gbuf + m * (GRAPH_T / 2) + r * GLD + c);
}
__device__ __forceinline__ float2 graph_pair(const bf16* gbuf, int m, int r, int c) {
  return __bfloat1622float2(graph_bf2(gbuf, m, r, c));
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bits_bf2(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

// Rows r < n of a C-wide tile held as bf16 pairs in the A-register layout
// (pair (j, half) at a[j / 2][2 (j % 2) + half]) to rows row0 + r of a
// [*, C] bf16 tensor, 16 bytes a store.
__device__ __forceinline__ void store_pair_rows(bf16* dst, long long row0, int n,
                                                const uint32_t (&a)[CP / 16][4], const Lane& ln) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t o[JC];
#pragma unroll
    for (int j = 0; j < JC; ++j) o[j] = a[j >> 1][(j & 1) * 2 + half];
    uint4 og[JC / 4];
    quad_transpose(o, og);
    const int r = ln.row(half);
    if (r < n) {
#pragma unroll
      for (int g = 0; g < JC / 4; ++g)
        *reinterpret_cast<uint4*>(dst + (row0 + r) * C + 8 * (4 * g + ln.q)) = og[g];
    }
  }
}

// acc = a W for bf16 A registers a and a staged C x C weight (one pass).
__device__ __forceinline__ void mma_regs_sq(float (&acc)[4 * JC], const uint32_t (&a)[CP / 16][4],
                                            const uint8_t* ws) {
  zero(acc);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < CP / 16; ++kk) Mma<CP>::rs<0>(acc, a[kk], b_sq(ws, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

template <bool kFirst>
__global__ void __launch_bounds__(WARPGROUPS * NT, 1)
gen_attn_wgmma(const __grid_constant__ CUtensorMap y_map, const __grid_constant__ AttnParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const Wg w(smem);
  const Lane& ln = w.ln;
  const uint8_t* we_s = smem + OFF_WE;
  const uint8_t* woe_s = smem + OFF_WOE;
  float* st_m = w.red + 4 * C;
  float* st_l = st_m + C;  // the sum (then its reciprocal)
  float* st_o = st_l + 2 * C;
  const int n = p.n;
  const SlabRange sr(p.slabs);
  if (w.leader()) {
    mbar_init(w.full, 1);
    fence_barrier_init();
    if (!kFirst && sr.begin + w.wg < sr.end)
      load_slab(w.tile, &y_map, w.full, (sr.begin + w.wg) * n);
  }
  float* vs = reinterpret_cast<float*>(smem + OFF_VEC);
  stage_panels(smem + OFF_WE, p.we, C, C, C);
  stage_panels(smem + OFF_WOE, p.woe, C, C, C);
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    vs[VB_E + i] = p.be[i];
    vs[VB_OE + i] = p.boe[i];
    vs[VB_F2 + i] = p.bf2[i];
    if (i < HID_IN) vs[VB_F1 + i] = p.bf1[i];
  }
  if (kFirst) {
    stage_panels(smem + OFF_WF2, p.wf2, C, HID_IN, HID_IN);
    stage_panels(smem + OFF_WF1, p.wf1, HID_IN, MAX_BDIM, MAX_BDIM);
  }
  fence_proxy_async();
  __syncthreads();

  uint32_t it = 0;
  long long cur_graph = -1;  // the graph in the warpgroup's buffer
  uint32_t za[4];        // depth 0: the next slab's one-hot rows, loaded a slab ahead
  if (kFirst && sr.begin + w.wg < sr.end) load_z(p, (sr.begin + w.wg) * n, ln, za);
  for (long long g = sr.begin + w.wg; g < sr.end; g += WARPGROUPS, ++it) {
    const long long b = g / n;
    const int i_atom = int(g - b * n);
    const long long row0 = g * n;
    if (b != cur_graph) {  // every thread is past the last slab's reads (its final wg_sync)
      load_graph(w.graph, p, b, ln);
      wg_sync(w.bar);
      cur_graph = b;
    }
    uint32_t ya[CP / 16][4];  // y, packed bf16 pairs in the A-register layout
    if constexpr (kFirst) {
      input_mlp(za, vs, smem + OFF_WF1, smem + OFF_WF2, ln, ya);
      if (g + WARPGROUPS < sr.end) load_z(p, (g + WARPGROUPS) * n, ln, za);
    } else {
      mbar_wait(w.full, it & 1);
#pragma unroll
      for (int j = 0; j < JC; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          ya[j >> 1][(j & 1) * 2 + half] =
              *reinterpret_cast<const uint32_t*>(w.tile + tile_off(ln.row(half), j, ln.q));
      wg_sync(w.bar);  // the tile is read: it holds the reductions now
    }

    // ---- 1. e = round(y We + be); t by the modulate chain, rounded at
    //         every operation, on bf16 pairs: each bf16x2 product or sum of
    //         bf16 values is the correctly rounded one, as round(f32 op)
    //         is (exact in f32, or far from a bf16 tie where it is not);
    //         t goes straight into ta, the A operand of t Woe; 0 on the
    //         rows past n
    uint32_t ta[CP / 16][4];
    float acc[4 * JC];
    mma_regs_sq(acc, ya, we_s);
    {
      const __nv_bfloat162 scale2 = __float2bfloat162_rn(p.scale);
      const __nv_bfloat162 one2 = __float2bfloat162_rn(1.0f);
#pragma unroll
      for (int j = 0; j < JC; ++j) {
        const int c = ln.col(j);
        const __nv_bfloat162 q2 = graph_bf2(w.graph, 0, i_atom, c);
        const float2 bv = *reinterpret_cast<const float2*>(vs + VB_E + c);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = ln.row(half);
          const int i = 4 * j + 2 * half;
          const __nv_bfloat162 e2 = __floats2bfloat162_rn(acc[i] + bv.x, acc[i + 1] + bv.y);
          __nv_bfloat162 a2 = __hmul2(q2, graph_bf2(w.graph, 1, r < n ? r : 0, c));
          a2 = __hmul2(__hmul2(__hmul2(a2, scale2), __hadd2(e2, one2)), e2);
          ta[j >> 1][(j & 1) * 2 + half] = r < n ? bf2_bits(a2) : 0u;
        }
      }
    }

    // ---- 2. s = round(y + round(t Woe + boe)) for the rows j < n, on
    //         bf16 pairs in ya's registers; t stays in ta
    mma_regs_sq(acc, ta, woe_s);
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      const float2 bo = *reinterpret_cast<const float2*>(vs + VB_OE + ln.col(j));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t& y = ya[j >> 1][(j & 1) * 2 + half];
        const int i = 4 * j + 2 * half;
        y = bf2_bits(__hadd2(bits_bf2(y), __floats2bfloat162_rn(acc[i] + bo.x, acc[i + 1] + bo.y)));
      }
    }
    store_pair_rows(p.s, row0, n, ya, ln);

    // ---- 3. the softmax over the keys per channel (f32 from the rounded
    //         t) and the aggregation agg = sum_j p_j v_j / sum_j p_j: the
    //         max, then p = exp(t - max) once in place, its sum and its
    //         v-weighted sum
#pragma unroll
    for (int j = 0; j < JC; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 t = unpack_bf16(ta[j >> 1][(j & 1) * 2 + half]);
        acc[4 * j + 2 * half] = t.x;
        acc[4 * j + 2 * half + 1] = t.y;
      }
    {
      wg_col_reduce<true>(
          [&](int j, int e, int half) {
            return ln.row(half) < n ? acc[4 * j + 2 * half + e] : -INFINITY;
          },
          w.red, st_m, ln, w.bar);
#pragma unroll
      for (int j = 0; j < JC; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * half + e;
            const float x = expf(acc[i] - st_m[ln.col(j, e)]);
            acc[i] = ln.row(half) < n ? x : 0.0f;
          }
      wg_col_reduce<false>([&](int j, int e, int half) { return acc[4 * j + 2 * half + e]; },
                           w.red, st_l, ln, w.bar);
      wg_col_reduce<false>(
          [&](int j, int e, int half) {
            const int r = ln.row(half);
            const float2 vv =
                r < n ? graph_pair(w.graph, 2, r, ln.col(j)) : make_float2(0.0f, 0.0f);
            return acc[4 * j + 2 * half + e] * (e ? vv.y : vv.x);
          },
          w.red, st_o, ln, w.bar);
      p.agg[g * C + ln.t] = __float2bfloat16_rn(st_o[ln.t] / st_l[ln.t]);
    }
    fence_proxy_async();  // the reductions' writes before the next slab's rows land there
    wg_sync(w.bar);
    if (!kFirst && w.leader() && g + WARPGROUPS < sr.end)
      load_slab(w.tile, &y_map, w.full, (g + WARPGROUPS) * n);
  }
}

// ---------------------------------------------------------------------------
// Edge tail
// ---------------------------------------------------------------------------
// The edge readout runs on wgmma m64n8k16 from LN6's registers.  Its B
// operand, W_re^T [n < b_dim][C], sits in the 2,032 B that K1's layout
// leaves free, as no-swizzle core matrices (8 rows n of 8 k values, 16 bytes
// a row) with their unused rows n >= b_dim overlapping the next core: core
// (k-step kk, half h) at kk * 2 LBO + h LBO, LBO = 16 b_dim bytes.
constexpr size_t OFF_RO = ftile::OFF_BAR + size_t(ftile::NBAR) * 8;
constexpr int MAX_RO_BDIM = 7;  // b_dim whose readout weights fit
constexpr size_t RO_BYTES = size_t(2 * (CP / 16) - 1) * 16 * MAX_RO_BDIM + 128;
constexpr size_t TAIL_SMEM = OFF_RO + RO_BYTES + ALIGN_SLACK;
static_assert(TAIL_SMEM <= SMEM_MAX, "shared memory over the limit");

// wgmma m64n8k16, A from registers, B a no-swizzle K-major descriptor.
__device__ __forceinline__ void mma_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "%8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// Shared-memory descriptor without swizzle: lbo = the stride between the
// two core matrices of a k-step, sbo = between 8-row groups (one here).
__device__ __forceinline__ uint64_t desc_plain(const void* p, uint32_t lbo, uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t((lbo & 0x3FFFF) >> 4) << 16) |
         (uint64_t((sbo & 0x3FFFF) >> 4) << 32);
}

// W_re^T's rows n < b_dim (bf16 [pad16(b_dim)][C] in device memory) into
// the readout's core matrices (every thread of the block, 16-byte copies).
__device__ __forceinline__ void stage_readout(uint8_t* dst, const bf16* __restrict__ w, int b_dim) {
  const int lbo = 16 * b_dim;
  for (int i = threadIdx.x; i < b_dim * (C / 8); i += blockDim.x) {
    const int n = i / (C / 8), k0 = (i % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + (k0 >> 4) * 2 * lbo + ((k0 >> 3) & 1) * lbo + n * 16) =
        *reinterpret_cast<const uint4*>(w + size_t(n) * C + k0);
  }
}

// The edge readout in the tail's epilogue: out[row][c] = round(y W_re[:, c]
// + b_re[c]) for the LN6 output y of the row (o: the thread's bf16 pairs of
// row ln.row(half)); the other half's rows go in as zeros.  The
// accumulator gives lane q the columns 2 q and 2 q + 1.
struct Readout {
  const uint8_t* w;  // W_re^T in shared memory (stage_readout)
  const float* b;
  bf16* out;         // [rows, b_dim]
  long long rows;
  int b_dim;
  __device__ __forceinline__ void operator()(const uint32_t (&o)[JC], long long row, int half,
                                             const Lane& ln) const {
    const uint32_t lbo = 16u * uint32_t(b_dim);
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CP / 16; ++kk) {
      const uint32_t a[4] = {half ? 0u : o[2 * kk], half ? o[2 * kk] : 0u,
                             half ? 0u : o[2 * kk + 1], half ? o[2 * kk + 1] : 0u};
      mma_n8(d, a, desc_plain(w + kk * 2 * lbo, lbo, 128));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    if (row < rows) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * ln.q + e;
        if (c < b_dim) out[row * b_dim + c] = __float2bfloat16_rn(d[2 * half + e] + __ldg(b + c));
      }
    }
  }
};

template <bool kLast>
__global__ void __launch_bounds__(THREADS, 1)
gen_tail_wgmma(const __grid_constant__ CUtensorMap s_map,
               const __grid_constant__ CUtensorMap w1_map,
               const __grid_constant__ CUtensorMap w2_map, const ftile::Params p,
               const bf16* __restrict__ wre, const float* __restrict__ bre,
               bf16* __restrict__ out_e, int b_dim) {
  if constexpr (kLast) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* ro = aligned_smem(smem_raw) + OFF_RO;
    stage_readout(ro, wre, b_dim);  // the routine's fence and barrier follow
    ftile::tail_fwd_tiles<true>(&s_map, &w1_map, &w2_map, p,
                                Readout{ro, bre, out_e, p.rows, b_dim});
  } else {
    ftile::tail_fwd_tiles<true>(&s_map, &w1_map, &w2_map, p, ftile::RowStore{p.out, p.rows});
  }
}

}  // namespace k9h
#endif  // GEN_HOPPER

}  // namespace

// Depth d's edge-attention launch.  ze: [batch, n, n, b_dim] one-hots (read
// at d 0); q, k, v, agg: [batch, n, 128]; ys: [batch n n, 128], the previous
// depth's rows in (d > 0) and s out; all bf16.  wts / vecs: the packed
// parameters (ops/fused_generator.py _Packed) on the device, woff / voff
// their offsets in HOST memory.  c and h must be the compiled KERNEL_C and
// KERNEL_H; scale = 1/sqrt(c / heads) as a bf16 value; grid from
// ops/fused_generator.py::launch_plan.  One launch on `stream`; does not
// synchronise, allocates nothing.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int fused_generator_hopper_attn(const void* ze, const void* wts, const void* vecs,
                                           const long long* woff, const long long* voff,
                                           const void* q, const void* k, const void* v, void* agg,
                                           void* ys, long long batch, int n, int b_dim, int c,
                                           int h, int d, float scale, int grid, void* stream) {
#if GEN_HOPPER
  using namespace k9h;
  if (!kRoute || batch < 0 || n <= 0 || n > MAX_N || b_dim <= 0 || b_dim > MAX_BDIM || c != C ||
      h != H || d < 0 || grid <= 0)
    return int(cudaErrorInvalidValue);
  if (batch == 0) return int(cudaSuccess);
  CUtensorMap y_map;
  if (!make_map(&y_map, ys, batch * n * n, C, BM)) return int(cudaErrorInvalidValue);
  const Weights wh{wts, static_cast<const float*>(vecs), woff, voff};
  const AttnParams p{static_cast<const bf16*>(ze),
                     mat<bf16>(wh, block_mat(d, W_E)),
                     mat<bf16>(wh, block_mat(d, W_OE)),
                     mat<bf16>(wh, MAT_EF1),
                     mat<bf16>(wh, MAT_EF2),
                     vec(wh, block_vec(d, V_E)),
                     vec(wh, block_vec(d, V_OE)),
                     vec(wh, VEC_EF1),
                     vec(wh, VEC_EF2),
                     static_cast<const bf16*>(q),
                     static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v),
                     static_cast<bf16*>(agg),
                     static_cast<bf16*>(ys),
                     batch * n,
                     n,
                     b_dim,
                     scale};
  auto kernel = d == 0 ? &gen_attn_wgmma<true> : &gen_attn_wgmma<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(ATTN_SMEM));
  if (err != cudaSuccess) return int(err);
  kernel<<<unsigned(grid), WARPGROUPS * NT, ATTN_SMEM, static_cast<cudaStream_t>(stream)>>>(y_map,
                                                                                          p);
  return int(cudaGetLastError());
#else
  (void)ze, (void)wts, (void)vecs, (void)woff, (void)voff, (void)q, (void)k, (void)v, (void)agg;
  (void)ys, (void)batch, (void)n, (void)b_dim, (void)c, (void)h, (void)d, (void)scale, (void)grid;
  (void)stream;
  return int(cudaErrorInvalidValue);
#endif
}

// Depth d's edge-tail launch: LN4 -> MLP2 -> LN6 of the rows of ys [batch
// n n, 128] (bf16), written back over them (d < depth - 1), or the edge
// logits out_e [batch, n, n, b_dim] (bf16) after the last depth.  The other
// arguments as fused_generator_hopper_attn's.  One launch on `stream`.
extern "C" int fused_generator_hopper_tail(void* ys, const void* wts, const void* vecs,
                                           const long long* woff, const long long* voff,
                                           void* out_e, long long batch, int n, int b_dim, int c,
                                           int h, int depth, int d, int grid, void* stream) {
#if GEN_HOPPER
  using namespace k9h;
  if (!kRoute || batch < 0 || n <= 0 || n > MAX_N || b_dim <= 0 || b_dim > MAX_RO_BDIM ||
      c != C || h != H || depth <= 0 || d < 0 || d >= depth || grid <= 0)
    return int(cudaErrorInvalidValue);
  if (batch == 0) return int(cudaSuccess);
  const long long rows = batch * n * n;
  const Weights wh{wts, static_cast<const float*>(vecs), woff, voff};
  const bf16* w1t = mat<bf16>(wh, block_mat(d, W_P1));
  const bf16* w2t = mat<bf16>(wh, block_mat(d, W_P2));
  CUtensorMap s_map, w1_map, w2_map;
  if (!make_map(&s_map, ys, rows, C, BM) || !make_map(&w1_map, w1t, HP, CP, HJ) ||
      !make_map(&w2_map, w2t, CP, HP, CP))
    return int(cudaErrorInvalidValue);
  const ftile::Params p{vec(wh, block_vec(d, V_LN4S)), vec(wh, block_vec(d, V_LN4B)),
                        vec(wh, block_vec(d, V_P1)),   vec(wh, block_vec(d, V_P2)),
                        vec(wh, block_vec(d, V_LN6S)), vec(wh, block_vec(d, V_LN6B)),
                        w1t,                           w2t,
                        static_cast<bf16*>(ys),        rows};
  auto kernel = d == depth - 1 ? &gen_tail_wgmma<true> : &gen_tail_wgmma<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(TAIL_SMEM));
  if (err != cudaSuccess) return int(err);
  kernel<<<unsigned(grid), THREADS, TAIL_SMEM, static_cast<cudaStream_t>(stream)>>>(
      s_map, w1_map, w2_map, p, mat<bf16>(wh, readout_mat(depth, 1)),
      vec(wh, readout_vec(depth, 1)), static_cast<bf16*>(out_e), b_dim);
  return int(cudaGetLastError());
#else
  (void)ys, (void)wts, (void)vecs, (void)woff, (void)voff, (void)out_e, (void)batch, (void)n;
  (void)b_dim, (void)c, (void)h, (void)depth, (void)d, (void)grid, (void)stream;
  return int(cudaErrorInvalidValue);
#endif
}

// Whether this build takes the route (C 128 with the hidden staged beside
// two tiles), and the dynamic shared memory of an attention and a tail
// block (0 where it does not).
extern "C" int fused_generator_hopper_route(void) {
#if GEN_HOPPER
  return int(k9h::kRoute);
#else
  return 0;
#endif
}

extern "C" long long fused_generator_hopper_attn_smem_bytes(void) {
#if GEN_HOPPER
  return (long long)k9h::ATTN_SMEM;
#else
  return 0;
#endif
}

extern "C" long long fused_generator_hopper_tail_smem_bytes(void) {
#if GEN_HOPPER
  return (long long)k9h::TAIL_SMEM;
#else
  return 0;
#endif
}
