// Fused LN -> MLP -> residual -> LN row kernel (the edge-stream tail), forward.
//
// Replaces the TPU kernel druggen_tpu/ops/fused_mlp.py::_fwd_kernel
// (_fwd_pallas).  Each row of the [rows, C] edge stream becomes
//
//     x   = LN1(s)                                  (f32)
//     h   = relu(round_T(x) @ W1 + b1)              (f32 accumulate)
//     m   = round_T(h) @ W2 + b2                    (f32 accumulate)
//     out = round_T(LN2(x + m))                     (residual on the f32 x)
//
// with the same rounding points as the Pallas kernel; eps 1e-5.
//
// What bounds it on an H100 SXM: at the serving shape (512 graphs of 45
// atoms, rows = 1,036,800, C = 128, H = 384) the kernel must read s once and
// write out once, 0.531 GB, i.e. 0.158 ms at 3.35 TB/s; its two products are
// 2 * 2 * rows * C * H = 203.9 GFLOP, i.e. 0.206 ms at 989 TFLOP/s in bf16.
// So the tensor cores' operations bound it.
//
// bf16: a Hopper kernel (tail_hopper.cuh has the plan, the layouts and, in
// hop::ftile, the tile routine, which K9's edge tail shares with its own
// rounding policy).  A
// persistent block per SM stages W1^T and W2^T once in wgmma's swizzled
// layout; each consumer warpgroup owns 64-row tiles that TMA brings into its
// own buffer, one tile ahead.  Per tile:
//   1. s is read into registers in wgmma's accumulator layout (mode A: kept
//      as packed bf16 pairs, and the buffer is refilled with the next tile at
//      once); LN1 in f32 (rows spread over a quad of lanes); round(x) becomes
//      fc1's A operand in registers (mode B, C > 128: in shared memory).
//   2. The hidden runs in chunks of 64: acc1 = x W1[:, j] (wgmma), + b1,
//      relu, rounded to bf16 in registers as the A operand of acc2 += h_j
//      W2[j, :] (wgmma).  h never touches shared memory.
//   3. The epilogue rebuilds the f32 LN1 output from s and the row
//      statistics (the residual adds the f32 x, not its bf16 copy), adds
//      acc2 + b2, applies LN2 and stores bf16.
// Shared memory at 128/384, mode A: W1^T + W2^T 196,608 B, two s buffers
// 2 x 16,384 B, two mbarriers 16 B, 1,024 B of alignment slack: 230,416 B
// of 232,448.  Registers a consumer thread (mode A, C = 128): acc2 64, acc1
// 32, the x operand 32, s 32, the h operand 16.  Where the weights do not
// fit (128/512, 256/768), each warpgroup streams the chunks' rows of W1^T
// and W2^T from L2 through a TMA ring of its own (tail_hopper.cuh).
//
// Widths the single-pass kernel does not take (C not a multiple of 8, or C
// padded to 64 above 256) run the split path of tail_split.cuh: LN1, two
// wgmma GEMMs and LN2 as four launches that pass x, h and the f32 residual
// sum through device memory, with the same rounding points.
//
// f32 twin (off the training path): 16-row tiles on the CUDA cores through
// tailk::tail_tile (tail_common.cuh, shared with K7 and K9), the weights read
// through L2.
//
// Ragged last tile: TMA reads zeros past the end of the rows and nothing is
// stored there.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -DKERNEL_C=128 -DKERNEL_H=384 -o libfused_mlp.so fused_mlp.cu
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

// ---------------------------------------------------------------------------
// f32 twin
// ---------------------------------------------------------------------------
namespace f32 {
using namespace tailk;

constexpr size_t SMEM = Bufs<float>::total;

// The warp's rows of row tile `tile` (zeros past the end of the rows and of
// the row).
__device__ __forceinline__ void load_rows(const float* __restrict__ s, long long tile, int warp,
                                          int lane, long long rows,
                                          float v[ROWS_PER_WARP][NCH][VEC]) {
#pragma unroll
  for (int j = 0; j < ROWS_PER_WARP; ++j) {
    const long long row = tile * BM + warp * ROWS_PER_WARP + j;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[j][ch][i] = 0.0f;
      if (row < rows && col_ok(ch, lane)) loadv(s + row * C + col_of(ch, lane), v[j][ch]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
tail_fwd_f32(const float* __restrict__ s, const float* __restrict__ g1, const float* __restrict__ bl1,
           const float* __restrict__ w1t, const float* __restrict__ b1,
           const float* __restrict__ w2t, const float* __restrict__ b2,
           const float* __restrict__ g2, const float* __restrict__ bl2, float* __restrict__ out,
           long long rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* hs = reinterpret_cast<float*>(smem + Bufs<float>::x);
  float* stage = reinterpret_cast<float*>(smem + Bufs<float>::x + Bufs<float>::h);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  init_bufs(xs, tid);
  LaneParams p;
  load_lane_params(p, g1, bl1, b1, b2, g2, bl2, lane);
  const long long n_tiles = (rows + BM - 1) / BM;
  // This warp's rows of the next tile, loaded one tile ahead.
  float sr[ROWS_PER_WARP][NCH][VEC];
  load_rows(s, blockIdx.x, warp, lane, rows, sr);
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * BM;
    float xr[ROWS_PER_WARP][NCH][VEC];
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j)
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int i = 0; i < VEC; ++i) xr[j][ch][i] = sr[j][ch][i];
    load_rows(s, tile + gridDim.x, warp, lane, rows, sr);
    const long long left = rows - row0;
    const int valid = left < BM ? int(left) : BM;
    tail_tile<float, CP, HP>(xr, valid, p, w1t, w2t, xs, hs, stage, out + row0 * C);
  }
}
}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 on Hopper
// ---------------------------------------------------------------------------
#if TAIL_FUSED
namespace k1 {
using namespace hop;
using namespace hop::ftile;
using bf16 = __nv_bfloat16;

// The body is tail_hopper.cuh's tile routine with K1's rounding points.
__global__ void __launch_bounds__(THREADS, 1)
tail_fwd_wgmma(const __grid_constant__ CUtensorMap s_map, const __grid_constant__ CUtensorMap w1_map,
           const __grid_constant__ CUtensorMap w2_map, const Params p) {
  tail_fwd_tiles<false>(&s_map, &w1_map, &w2_map, p, RowStore{p.out, p.rows});
}
}  // namespace k1
#endif  // TAIL_FUSED

}  // namespace

// s, out: [rows, C]; w1t: W1^T and w2t: W2^T in the nn.Linear layout, each
// zero-padded (bf16: to [HP, CP] / [CP, HP], multiples of 64; f32: to
// multiples of 16); LayerNorm parameters and biases f32 (bf16: b1 padded to
// HP).  c and h must be the compiled KERNEL_C and KERNEL_H; grid and
// smem_bytes come from ops/fused_mlp.py::launch_plan and smem_bytes must
// equal fused_ln_mlp_ln_fwd_smem_bytes().  Launches on `stream`, does not
// synchronise, allocates nothing.  Returns the cudaError_t of the launch (0
// on success; cudaErrorInvalidValue for arguments that do not match).
extern "C" int fused_ln_mlp_ln_fwd_bf16(const void* s, const void* g1, const void* bl1,
                                        const void* w1t, const void* b1, const void* w2t,
                                        const void* b2, const void* g2, const void* bl2,
                                        void* out, long long rows, int c, int h, int grid,
                                        long long smem_bytes, void* stream) {
#if TAIL_FUSED
  using namespace k1;
  if (c != C || h != H || grid <= 0 || rows < 0 || smem_bytes != (long long)SMEM)
    return int(cudaErrorInvalidValue);
  if (rows == 0) return int(cudaSuccess);
  CUtensorMap s_map, w1_map, w2_map;
  if (!make_map(&s_map, s, rows, C, BM) || !make_map(&w1_map, w1t, HP, CP, HJ) ||
      !make_map(&w2_map, w2t, CP, HP, CP))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(tail_fwd_wgmma,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (err != cudaSuccess) return int(err);
  const Params p{static_cast<const float*>(g1), static_cast<const float*>(bl1),
                 static_cast<const float*>(b1), static_cast<const float*>(b2),
                 static_cast<const float*>(g2), static_cast<const float*>(bl2),
                 static_cast<const bf16*>(w1t), static_cast<const bf16*>(w2t),
                 static_cast<bf16*>(out), rows};
  tail_fwd_wgmma<<<unsigned(grid), THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      s_map, w1_map, w2_map, p);
  return int(cudaGetLastError());
#else
  (void)s, (void)g1, (void)bl1, (void)w1t, (void)b1, (void)w2t, (void)b2, (void)g2, (void)bl2;
  (void)out, (void)rows, (void)c, (void)h, (void)grid, (void)smem_bytes, (void)stream;
  return int(cudaErrorInvalidValue);  // this width takes the split path
#endif
}

// The split path (widths the single-pass kernel does not take): the same
// arguments without the launch geometry, and scratch: x_buf bf16 [rows, CP],
// h_buf bf16 [rows, HP], z_buf f32 [rows, CP], stats f32 [rows, 2].  Four
// launches on `stream`.
extern "C" int fused_ln_mlp_ln_fwd_bf16_split(const void* s, const void* g1, const void* bl1,
                                              const void* w1t, const void* b1, const void* w2t,
                                              const void* b2, const void* g2, const void* bl2,
                                              void* out, void* x_buf, void* h_buf, void* z_buf,
                                              void* stats, long long rows, int c, int h,
                                              void* stream) {
#if !TAIL_FUSED
  using namespace split;
  if (c != C || h != H || rows < 0) return int(cudaErrorInvalidValue);
  if (rows == 0) return int(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  tail_split_ln1<<<row_tiles(rows), RTHREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(s), F(g1), F(bl1), static_cast<__nv_bfloat16*>(x_buf),
      static_cast<float2*>(stats), rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  Epi e{F(b1), nullptr, nullptr, nullptr, nullptr, nullptr, static_cast<__nv_bfloat16*>(h_buf), nullptr,
        nullptr, rows};
  if ((err = launch_gemm<EPI_H>(x_buf, w1t, e, st)) != cudaSuccess) return int(err);
  e = Epi{F(b2), static_cast<const __nv_bfloat16*>(s), static_cast<const float2*>(stats), F(g1), F(bl1),
          nullptr, nullptr, static_cast<float*>(z_buf), nullptr, rows};
  if ((err = launch_gemm<EPI_Z>(h_buf, w2t, e, st)) != cudaSuccess) return int(err);
  tail_split_ln2<<<row_tiles(rows), RTHREADS, 0, st>>>(static_cast<const float*>(z_buf), F(g2),
                                                       F(bl2), static_cast<__nv_bfloat16*>(out), rows);
  return int(cudaGetLastError());
#else
  (void)s, (void)g1, (void)bl1, (void)w1t, (void)b1, (void)w2t, (void)b2, (void)g2, (void)bl2;
  (void)out, (void)x_buf, (void)h_buf, (void)z_buf, (void)stats, (void)rows, (void)c, (void)h;
  (void)stream;
  return int(cudaErrorInvalidValue);  // this width takes the single-pass kernel
#endif
}

extern "C" int fused_ln_mlp_ln_fwd_f32(const void* s, const void* g1, const void* bl1,
                                       const void* w1t, const void* b1, const void* w2t,
                                       const void* b2, const void* g2, const void* bl2,
                                       void* out, long long rows, int c, int h, int grid,
                                       long long smem_bytes, void* stream) {
  using namespace f32;
  if (c != C || h != H || grid <= 0 || rows < 0 || smem_bytes != (long long)SMEM)
    return int(cudaErrorInvalidValue);
  if (rows == 0) return int(cudaSuccess);
  cudaError_t err = cudaFuncSetAttribute(tail_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(SMEM));
  if (err != cudaSuccess) return int(err);
  tail_fwd_f32<<<unsigned(grid), THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(g1), static_cast<const float*>(bl1),
      static_cast<const float*>(w1t), static_cast<const float*>(b1),
      static_cast<const float*>(w2t), static_cast<const float*>(b2),
      static_cast<const float*>(g2), static_cast<const float*>(bl2), static_cast<float*>(out),
      rows);
  return int(cudaGetLastError());
}

// Dynamic shared memory a block takes (bf16 on the split path: its largest
// GEMM block), whether it stages the weights, and whether this width takes
// the split path.
#if TAIL_FUSED
constexpr long long kBf16Smem = k1::SMEM;
constexpr int kBf16Stage = k1::kStage;
#else
constexpr long long kBf16Smem = split::SMEM;
constexpr int kBf16Stage = 0;
#endif
extern "C" long long fused_ln_mlp_ln_fwd_smem_bytes(int bf16) {
  return bf16 ? kBf16Smem : (long long)f32::SMEM;
}

extern "C" int fused_ln_mlp_ln_fwd_stages_weights(int bf16) { return bf16 ? kBf16Stage : 0; }

extern "C" int fused_ln_mlp_ln_split(void) { return int(!TAIL_FUSED); }
