// The split path of the bf16 edge-tail kernels K1 (fused_mlp.cu) and K2
// (fused_mlp_bwd.cu): the widths the single-pass Hopper kernels do not take.
// Those need C a multiple of 8 (TMA row strides of 16 bytes) and C padded to
// 64 at most 256 (the C-wide accumulator of a 64-row tile in one
// warpgroup's registers, and s, x and dout tiles beside the weights in one
// SM's shared memory).  Every other C runs here: the same function with the
// same rounding points, in steps that pass their rows through device memory
// (L2 for the most part):
//
//   ln1      (CUDA cores) s -> round(x) [rows][CP] and (mu1, rstd1) [rows]
//   gemm h   (wgmma)      h = round(relu(x W1 + b1)) [rows][HP]
//   gemm z   (wgmma)      z = x1 + (h W2 + b2) [rows][CP] in f32, x1 the f32
//                         LN1 output rebuilt from s and (mu1, rstd1)
//   K1: ln2  (CUDA cores) out = round(LN2(z))
//   K2: ln2' (CUDA cores) dr = LN2'(dout) over z in place, round(dr) to the
//                         dm operand; dg2, dbl2, db2 partials
//       gemm dh (wgmma)   dh = (round(dr) W2^T) * (h > 0), round(dh) to the
//                         dh operand; db1 partials
//       gemm dx (wgmma)   dx = dr + round(dh) W1^T, over dr in place
//       ln1' (CUDA cores) ds = round(LN1'(dx)); dg1, dbl1 partials
//   then K2's wgrad and reduce launches, as in the single-pass design.
//
// The ReLU mask of dh is read from the stored h: h > 0 differs from
// h_pre > 0 only for 0 < h_pre < 2^-134, which rounds to a bf16 zero.
//
// gemm: one warpgroup a block owns a 64-row x BN tile (BN the largest of 256,
// 192, 128, 64 that divides the padded N); thread 0 feeds a ring of GSTAGES
// 64-deep K stages by TMA (A K-major; B K-major for x W1 and h W2, MN-major
// through wgmma's transpose bit for dm W2^T and dh W1^T, from the same padded
// W1^T and W2^T as the single-pass kernels); each stage is one batch of four
// m64nBNk16 wgmma.  Shared memory 4 x (8,192 + 128 BN) B + barriers + 1,024
// B of alignment slack (164,896 B at BN 256).  Row kernels: a block of eight
// warps a 64-row tile, a warp a row at a time, its lanes over the columns;
// the vector partials summed over a tile's rows in a fixed order (one
// partial a 64-row tile), so the same inputs give the same bits.

#pragma once

#include "tail_hopper.cuh"

namespace {
namespace split {
using namespace hop;
using bf16 = __nv_bfloat16;

constexpr int RB = 64;      // rows a tile
constexpr int RTHREADS = 256;
constexpr int RROWS = RB / (RTHREADS / 32);  // rows a warp, of a tile
constexpr int KC = CP / 32;                  // columns a lane
constexpr int GSTAGES = 4;
constexpr int bn_of(int n) {
  return n % 256 == 0 ? 256 : n % 192 == 0 ? 192 : n % 128 == 0 ? 128 : 64;
}
constexpr size_t gemm_smem(int bn) {
  return size_t(GSTAGES) * (size_t(RB) * 128 + size_t(bn) * 128) + GSTAGES * 8 + ALIGN_SLACK;
}
// the larger of the two tile widths (N = HP, N = CP): what a launch may take
constexpr size_t SMEM = gemm_smem(bn_of(HP)) > gemm_smem(bn_of(CP)) ? gemm_smem(bn_of(HP))
                                                                     : gemm_smem(bn_of(CP));
static_assert(SMEM <= SMEM_MAX, "shared memory over the limit");

// ---------------------------------------------------------------------------
// Row kernels
// ---------------------------------------------------------------------------
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}
__device__ __forceinline__ bool col_in(int k, int lane) { return lane + 32 * k < C; }

// LayerNorm statistics of a row held as v[k] at columns lane + 32 k (zero
// past C): the two-pass f32 mean and variance of the Pallas _ln_fwd.
__device__ __forceinline__ void warp_stats(const float (&v)[KC], int lane, float& mu,
                                           float& rstd) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < KC; ++k) s += v[k];
  mu = warp_sum(s) * (1.0f / C);
  float q = 0.0f;
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const float d = col_in(k, lane) ? v[k] - mu : 0.0f;
    q += d * d;
  }
  rstd = rsqrtf(warp_sum(q) * (1.0f / C) + EPS);
}

// Sum a[k] (the lane's columns lane + 32 k, summed over the warp's rows)
// over the block's warps in a fixed order into vp[col] for col < C, 256
// columns at a time through `red` [8][256].
__device__ __forceinline__ void block_col_sum(const float (&a)[KC], float* red, float* vp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k0 = 0; k0 < KC; k0 += 8) {
#pragma unroll
    for (int k = k0; k < k0 + 8 && k < KC; ++k) red[warp * 256 + 32 * (k - k0) + lane] = a[k];
    __syncthreads();
    const int col = 32 * k0 + threadIdx.x;
    if (col < C) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < RTHREADS / 32; ++w) sum += red[w * 256 + threadIdx.x];
      vp[col] = sum;
    }
    __syncthreads();
  }
}

// s [rows][C] -> round(x) [rows][CP] (zero past C) and (mu1, rstd1).
__global__ void __launch_bounds__(RTHREADS)
tail_split_ln1(const bf16* __restrict__ s, const float* __restrict__ g1,
               const float* __restrict__ bl1, bf16* __restrict__ x_out,
               float2* __restrict__ stats, long long rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = 0; i < RROWS; ++i) {
    const long long row = blockIdx.x * (long long)RB + warp * RROWS + i;
    if (row >= rows) break;
    float v[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k)
      v[k] = col_in(k, lane) ? __bfloat162float(s[row * C + lane + 32 * k]) : 0.0f;
    float mu, rstd;
    warp_stats(v, lane, mu, rstd);
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int c = lane + 32 * k;
      const float x = col_in(k, lane) ? ln_apply(v[k], mu, rstd, g1[c], bl1[c]) : 0.0f;
      x_out[row * CP + c] = __float2bfloat16_rn(x);
    }
    if (lane == 0) stats[row] = make_float2(mu, rstd);
  }
}

// K1: z [rows][CP] -> out = round(LN2(z)) [rows][C].
__global__ void __launch_bounds__(RTHREADS)
tail_split_ln2(const float* __restrict__ z, const float* __restrict__ g2,
               const float* __restrict__ bl2, bf16* __restrict__ out, long long rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = 0; i < RROWS; ++i) {
    const long long row = blockIdx.x * (long long)RB + warp * RROWS + i;
    if (row >= rows) break;
    float v[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) v[k] = col_in(k, lane) ? z[row * CP + lane + 32 * k] : 0.0f;
    float mu, rstd;
    warp_stats(v, lane, mu, rstd);
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int c = lane + 32 * k;
      if (col_in(k, lane))
        out[row * C + c] = __float2bfloat16_rn(ln_apply(v[k], mu, rstd, g2[c], bl2[c]));
    }
  }
}

// K2: z -> dr = LN2'(dout) in place, round(dr) to dm [rows][CP]; the tile's
// dg2, dbl2, db2 into vec_partial row blockIdx.x.
__global__ void __launch_bounds__(RTHREADS)
tail_split_ln2_bwd(float* __restrict__ z, const bf16* __restrict__ dout,
                   const float* __restrict__ g2, bf16* __restrict__ dm_out,
                   float* __restrict__ vec_partial, long long rows) {
  __shared__ float red_all[8 * 256];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float a_dg2[KC], a_dbl2[KC], a_db2[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) a_dg2[k] = a_dbl2[k] = a_db2[k] = 0.0f;
  for (int i = 0; i < RROWS; ++i) {
    const long long row = blockIdx.x * (long long)RB + warp * RROWS + i;
    if (row >= rows) break;
    float v[KC], go[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const bool ok = col_in(k, lane);
      v[k] = ok ? z[row * CP + lane + 32 * k] : 0.0f;
      go[k] = ok ? __bfloat162float(dout[row * C + lane + 32 * k]) : 0.0f;
    }
    float mu, rstd;
    warp_stats(v, lane, mu, rstd);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const bool ok = col_in(k, lane);
      v[k] = ok ? __fmul_rn(__fsub_rn(v[k], mu), rstd) : 0.0f;  // rhat
      const float dxh = go[k] * (ok ? g2[lane + 32 * k] : 0.0f);
      s1 += dxh;
      s2 += dxh * v[k];
    }
    const float m1 = warp_sum(s1) * (1.0f / C), m2 = warp_sum(s2) * (1.0f / C);
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int c = lane + 32 * k;
      const bool ok = col_in(k, lane);
      const float dxh = go[k] * (ok ? g2[c] : 0.0f);
      const float dr = ok ? (dxh - m1 - v[k] * m2) * rstd : 0.0f;
      z[row * CP + c] = dr;
      dm_out[row * CP + c] = __float2bfloat16_rn(dr);
      a_dg2[k] += go[k] * v[k];
      a_dbl2[k] += go[k];
      a_db2[k] += dr;
    }
  }
  float* vp = vec_partial + size_t(blockIdx.x) * NVEC;
  block_col_sum(a_dg2, red_all, vp + OFF_DG2);
  block_col_sum(a_dbl2, red_all, vp + OFF_DBL2);
  block_col_sum(a_db2, red_all, vp + OFF_DB2);
}

// K2: dx [rows][CP] -> ds = round(LN1'(dx)) [rows][C]; the tile's dg1,
// dbl1 into vec_partial row blockIdx.x.
__global__ void __launch_bounds__(RTHREADS)
tail_split_ln1_bwd(const float* __restrict__ dx, const bf16* __restrict__ s,
                   const float2* __restrict__ stats, const float* __restrict__ g1,
                   bf16* __restrict__ ds, float* __restrict__ vec_partial, long long rows) {
  __shared__ float red_all[8 * 256];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float a_dg1[KC], a_dbl1[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) a_dg1[k] = a_dbl1[k] = 0.0f;
  for (int i = 0; i < RROWS; ++i) {
    const long long row = blockIdx.x * (long long)RB + warp * RROWS + i;
    if (row >= rows) break;
    const float2 st = stats[row];
    float xh[KC], d[KC];
    float t1 = 0.0f, t2 = 0.0f;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int c = lane + 32 * k;
      const bool ok = col_in(k, lane);
      xh[k] = ok ? __fmul_rn(__fsub_rn(__bfloat162float(s[row * C + c]), st.x), st.y) : 0.0f;
      d[k] = ok ? dx[row * CP + c] : 0.0f;
      const float dxh = d[k] * (ok ? g1[c] : 0.0f);
      t1 += dxh;
      t2 += dxh * xh[k];
    }
    const float m1 = warp_sum(t1) * (1.0f / C), m2 = warp_sum(t2) * (1.0f / C);
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int c = lane + 32 * k;
      if (col_in(k, lane)) {
        const float dxh = d[k] * g1[c];
        ds[row * C + c] = __float2bfloat16_rn((dxh - m1 - xh[k] * m2) * st.y);
      }
      a_dg1[k] += d[k] * xh[k];
      a_dbl1[k] += d[k];
    }
  }
  float* vp = vec_partial + size_t(blockIdx.x) * NVEC;
  block_col_sum(a_dg1, red_all, vp + OFF_DG1);
  block_col_sum(a_dbl1, red_all, vp + OFF_DBL1);
}

// ---------------------------------------------------------------------------
// gemm: a 64-row x BN tile of A [rows][K] times B, and its epilogue
// ---------------------------------------------------------------------------
enum { EPI_H, EPI_Z, EPI_DH, EPI_DX };

template <int EPI>
struct Shape {
  static constexpr bool kNh = EPI == EPI_H || EPI == EPI_DH;  // N = HP, K = CP
  static constexpr int N = kNh ? HP : CP;
  static constexpr int K = kNh ? CP : HP;
  static constexpr int BN = bn_of(N);
  static constexpr int TB = EPI == EPI_DH || EPI == EPI_DX;  // B MN-major
  static constexpr size_t STAGE = size_t(RB) * 128 + size_t(BN) * 128;
};

struct Epi {
  const float* bias;    // EPI_H: b1 [HP]; EPI_Z: b2 [C]
  const bf16* s;        // EPI_Z: s [rows][C]
  const float2* stats;  // EPI_Z: (mu1, rstd1)
  const float* g1;
  const float* bl1;
  const bf16* h;        // EPI_DH: h [rows][HP], the ReLU mask
  bf16* out_b;          // EPI_H: h; EPI_DH: dh [rows][HP]
  float* out_f;         // EPI_Z: z; EPI_DX: dr -> dx in place [rows][CP]
  float* vec_partial;   // EPI_DH: db1, one row a 64-row tile
  long long rows;
};

template <int EPI>
__device__ __forceinline__ void gemm_load(uint8_t* stage, uint64_t* bar, const CUtensorMap* am,
                                          const CUtensorMap* bm, int k, int row0, int n0) {
  using S = Shape<EPI>;
  mbar_expect_tx(bar, uint32_t(S::STAGE));
  tma_load(stage, am, bar, 64 * k, row0);
  if constexpr (S::TB) {
#pragma unroll
    for (int i = 0; i < S::BN / 64; ++i)
      tma_load(stage + size_t(1 + i) * (RB * 128), bm, bar, n0 + 64 * i, 64 * k);
  } else {
    tma_load(stage + RB * 128, bm, bar, 64 * k, n0);
  }
}

template <int EPI>
__global__ void __launch_bounds__(128, 1)
tail_split_gemm(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
                const Epi e) {
  using S = Shape<EPI>;
  constexpr int BN = S::BN, NK = S::K / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + GSTAGES * S::STAGE);
  const int row0 = int(blockIdx.x) * RB;
  const int n0 = int(blockIdx.y) * BN;
  const Lane ln(threadIdx.x);
  if (threadIdx.x == 0) {
    for (int i = 0; i < GSTAGES; ++i) mbar_init(full + i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < GSTAGES && k < NK; ++k)
      gemm_load<EPI>(smem + size_t(k) * S::STAGE, full + k, &a_map, &b_map, k, row0, n0);

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int k = 0; k < NK; ++k) {
    const int st = k % GSTAGES;
    mbar_wait(full + st, uint32_t(k / GSTAGES) & 1);
    const uint8_t* a = smem + size_t(st) * S::STAGE;
    const uint8_t* b = a + RB * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = S::TB ? desc(b + kk * 2048, RB * 128, 1024) : desc(b + kk * 32, 16, 1024);
      Mma<BN>::template ss<0, S::TB>(acc, desc(a + kk * 32, 16, 1024), db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // stage k - 1's products are done
    __syncthreads();
    if (threadIdx.x == 0 && k >= 1 && k - 1 + GSTAGES < NK)
      gemm_load<EPI>(smem + size_t((k - 1) % GSTAGES) * S::STAGE, full + (k - 1) % GSTAGES,
                     &a_map, &b_map, k - 1 + GSTAGES, row0, n0);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  float u[EPI == EPI_DH ? BN / 8 : 1][2];  // db1: the thread's two rows' sum
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long row = row0 + ln.row(half);
    const bool live_row = row < e.rows;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + ln.col(j);
      float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if constexpr (EPI == EPI_H) {
        v0 = fmaxf(v0 + e.bias[col], 0.0f);
        v1 = fmaxf(v1 + e.bias[col + 1], 0.0f);
        if (live_row) *reinterpret_cast<uint32_t*>(e.out_b + row * HP + col) = pack_bf16(v0, v1);
      } else if constexpr (EPI == EPI_Z) {
        if (live_row) {
          const float2 st = e.stats[row];
          float z[2] = {v0, v1};
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int c = col + x;
            z[x] = c < C ? ln_apply(__bfloat162float(e.s[row * C + c]), st.x, st.y, e.g1[c],
                                    e.bl1[c]) +
                               (z[x] + e.bias[c])
                         : 0.0f;
          }
          *reinterpret_cast<float2*>(e.out_f + row * CP + col) = make_float2(z[0], z[1]);
        }
      } else if constexpr (EPI == EPI_DH) {
        if (live_row) {
          const float2 hv =
              unpack_bf16(*reinterpret_cast<const uint32_t*>(e.h + row * HP + col));
          v0 = hv.x > 0.0f ? v0 : 0.0f;
          v1 = hv.y > 0.0f ? v1 : 0.0f;
          *reinterpret_cast<uint32_t*>(e.out_b + row * HP + col) = pack_bf16(v0, v1);
        } else {
          v0 = v1 = 0.0f;
        }
        u[j][0] = half ? u[j][0] + v0 : v0;
        u[j][1] = half ? u[j][1] + v1 : v1;
      } else {
        if (live_row) {
          float2* p = reinterpret_cast<float2*>(e.out_f + row * CP + col);
          const float2 dr = *p;
          *p = make_float2(dr.x + v0, dr.y + v1);
        }
      }
    }
  }
  if constexpr (EPI == EPI_DH) {  // db1 over the tile's rows, in a fixed order
    float* red = reinterpret_cast<float*>(smem);  // [4 warps][BN]
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int x = 0; x < 2; ++x) {  // the warp's 16 rows: the lanes of one q
        float v = u[j][x];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if ((threadIdx.x & 31) < 4) red[ln.warp * BN + ln.col(j, x)] = v;
      }
    __syncthreads();
    for (int c = threadIdx.x; c < BN; c += 128) {
      const float sum = red[c] + red[BN + c] + red[2 * BN + c] + red[3 * BN + c];
      if (n0 + c < H) e.vec_partial[size_t(blockIdx.x) * NVEC + OFF_DB1 + n0 + c] = sum;
    }
  }
}

// Host: launch gemm EPI over `rows` rows with A the [rows][K] operand and B
// the padded weight (W1^T [HP][CP] or W2^T [CP][HP]).
template <int EPI>
inline cudaError_t launch_gemm(const void* a, const void* w, const Epi& e, cudaStream_t st) {
  using S = Shape<EPI>;
  CUtensorMap a_map, b_map;
  const bool w_is_w1 = EPI == EPI_H || EPI == EPI_DX;  // W1^T [HP][CP], else W2^T [CP][HP]
  const long long w_rows = w_is_w1 ? HP : CP;
  const int w_cols = w_is_w1 ? CP : HP;
  if (!make_map(&a_map, a, e.rows, S::K, RB) ||
      !make_map(&b_map, w, w_rows, w_cols, S::TB ? 64 : S::BN))
    return cudaErrorInvalidValue;
  const size_t smem = size_t(GSTAGES) * S::STAGE + GSTAGES * 8 + ALIGN_SLACK;
  cudaError_t err = cudaFuncSetAttribute(tail_split_gemm<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(unsigned((e.rows + RB - 1) / RB), unsigned(S::N / S::BN));
  tail_split_gemm<EPI><<<grid, 128, smem, st>>>(a_map, b_map, e);
  return cudaGetLastError();
}

inline unsigned row_tiles(long long rows) { return unsigned((rows + RB - 1) / RB); }

}  // namespace split
}  // namespace
