// Edge-modulated attention, the v2 op without projections, forward (K3).
//
// Replaces the TPU kernel druggen_tpu/ops/fused_attention.py::_fwd_kernel
// (called by _fwd_pallas).  For each graph b and query atom i, over the keys
// j < N and the D channels (heads x dk):
//
//     t[j]         = ((q[b,i] * k[b,j]) * inv_sqrt_dk) * (e[b,i,j] + 1) * e[b,i,j]
//     edge_pre[b,i,j] = round_T(t[j])
//     node[b,i]    = round_T(sum_j s[j] v[b,j]),  s = softmax over j of t, per channel
//
// all in f32 from the stream-type (T) inputs, in the Pallas kernel's order
// of operations, with one reassociation: node = (sum_j ex_j v_j) / sum with
// ex_j = expf(t_j - max) (one expf an element, one IEEE division a channel)
// in place of sum_j (ex_j / sum) v_j; the sums over keys run in the key
// groups' order (attn_v2.cuh), not j's.
//
// What bounds it on an H100 SXM: at the training shape (512 graphs of 45
// atoms, D = 128, bf16) it must read e (0.265 GB) and write edge_pre (0.265
// GB) besides the small q, k, v and node: 0.55 GB, 0.166 ms at 3.35 TB/s;
// its ~25 instructions an element take ~0.11 ms at the card's instruction
// rate.  So the bytes bound it, and the design reads e once and writes
// edge_pre once.
//
// Design (the plan, layout and producer are attn_v2.cuh's): a work item is
// one graph and 128 channels (64 above N 64); its k and v slices come into
// shared memory once by TMA, its query rows' e slices (with q_i) stream
// through a ring of slots kept full by a producer warp.  A consumer warp
// takes a row in one pass over its threads' keys: t from staged e, k and
// q_i, kept in registers, and the maximum; the exponentials, their sum and
// sum ex v from staged v; edge_pre written over e (after every load of the
// row, which the compiler may then schedule together); it releases the slot,
// and the producer stores edge_pre by TMA.  node leaves from the first key
// group's lanes after the release (the proxy fence before it waits for
// earlier global stores).  At the training shape: 16 consumer warps a
// block, two blocks a SM (56 registers a thread), 7 ring slots, 115,456 B a
// block; device memory sees e once and edge_pre once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libfused_attention_v2.so fused_attention_v2.cu
// Plain C interface for ctypes; no PyTorch headers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attn_v2.cuh"

namespace {
using namespace v2;

constexpr int PER = 1;   // tensors a slot: e

// One query row in the thread's channel pair: t from e, k and q_i (kept in
// registers), the maximum, ex = expf(t - max), sum ex and sum ex v over the
// keys; then edge_pre over e.  Every load comes before the first store (the
// pointers do not alias), so the compiler may schedule them together.
template <typename T, int KPT>
__device__ __forceinline__ void fwd_row(uint8_t* __restrict__ es, const uint8_t* __restrict__ ks,
                                        const uint8_t* __restrict__ vs, float2 qv, uint32_t off0,
                                        int g, int n, float inv, float& a0, float& a1, float& s0,
                                        float& s1) {
  using E = Elem<T>;
  float t[KPT][2];
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int m = 0; m < KPT; ++m) {
    if (key_ok<KPT>(m, g, n)) {
      const uint32_t o = off0 + 1024u * m;
      const float2 ev = E::ld(es, o), kv = E::ld(ks, o);
      t[m][0] = (((qv.x * kv.x) * inv) * (ev.x + 1.0f)) * ev.x;
      t[m][1] = (((qv.y * kv.y) * inv) * (ev.y + 1.0f)) * ev.y;
      m0 = fmaxf(m0, t[m][0]);
      m1 = fmaxf(m1, t[m][1]);
    }
  }
  m0 = group_max(m0);
  m1 = group_max(m1);
  s0 = s1 = a0 = a1 = 0.0f;
#pragma unroll
  for (int m = 0; m < KPT; ++m) {
    if (key_ok<KPT>(m, g, n)) {
      const float x0 = expf(t[m][0] - m0), x1 = expf(t[m][1] - m1);
      const float2 vv = E::ld(vs, off0 + 1024u * m);
      s0 += x0;
      s1 += x1;
      a0 = fmaf(x0, vv.x, a0);
      a1 = fmaf(x1, vv.y, a1);
    }
  }
  s0 = group_sum(s0);
  s1 = group_sum(s1);
  a0 = group_sum(a0);
  a1 = group_sum(a1);
#pragma unroll
  for (int m = 0; m < KPT; ++m)
    if (key_ok<KPT>(m, g, n)) E::st(es, off0 + 1024u * m, t[m][0], t[m][1]);
}

template <typename T, int KPT>
__global__ void __launch_bounds__(threads_of(KPT), KPT <= REG_KPT ? 2 : 1)
attn_v2_fwd_tma(const __grid_constant__ CUtensorMap e_map,
                const __grid_constant__ CUtensorMap ep_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap q_map, T* __restrict__ node, const Geo geo) {
  using E = Elem<T>;
  constexpr int W = width_of(KPT), WARPS = W / 8;
  extern __shared__ uint8_t smem_raw[];
  const Ring rg(smem_raw, geo, PER, sizeof(T) == 2);
  const int n = geo.n, d = geo.d, stages = geo.stages;
  long long it0, it1;
  item_range(geo.items, gridDim.x, blockIdx.x, it0, it1);
  const int rows = int((it1 - it0) * n);
  if (threadIdx.x == 0) init_barriers(rg, WARPS);
  __syncthreads();

  if (threadIdx.x >= 32 * WARPS) {   // the producer warp
    if (threadIdx.x != 32 * WARPS || rows == 0) return;
    const uint32_t row_tx = uint32_t((n + 1) * W * sizeof(T));
    const uint32_t kv_tx = uint32_t(2 * n * W * sizeof(T));
    produce(
        rg, it0, rows, n, d, W,
        [&](int s, const Cursor& c) {
          mbar_expect_tx(rg.full + s, row_tx);
          rg.load_box<T>(rg.box_of(s, 0), &e_map, rg.full + s, c.x, c.row(n) * n);
          tma_load(rg.vec_of(s, 0), &q_map, rg.full + s, c.x, c.row(n));
        },
        [&](int s, const Cursor& c) { rg.store_box<T>(&ep_map, rg.box_of(s, 0), c.x, c.row(n) * n); },
        [&](const Cursor& c) {
          mbar_expect_tx(rg.kv_bar, kv_tx);
          rg.load_box<T>(rg.kv, &k_map, rg.kv_bar, c.x, c.b * n);
          rg.load_box<T>(rg.kv + rg.box, &v_map, rg.kv_bar, c.x, c.b * n);
        });
    return;
  }

  const Lane ln(threadIdx.x);
  const uint32_t off0 = E::offset(ln.warp, ln.p, ln.g, rg.panel);
  const float inv = geo.inv_sqrt_dk;
  const uint8_t* ks = rg.kv;
  const uint8_t* vs = rg.kv + rg.box;
  Cursor c(it0, d / W, W);
  int s = 0;
  uint32_t phase = 0, kv_phase = 0;
  for (int r = 0; r < rows; ++r) {
    if (c.i == 0) {
      mbar_wait(rg.kv_bar, kv_phase);
      kv_phase ^= 1u;
    }
    mbar_wait(rg.full + s, phase);
    uint8_t* es = rg.box_of(s, 0);
    const float2 qv = ld_vec<T>(rg.vec_of(s, 0), ln.cp);
    float a0, a1, s0, s1;
    fwd_row<T, KPT>(es, ks, vs, qv, off0, ln.g, n, inv, a0, a1, s0, s1);
    fence_proxy_async();   // edge_pre, written over e, is read by the TMA store
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(rg.empty + s);
    // node after the fence, which would wait for a global store
    if (ln.g == 0) E::st(node + size_t(c.row(n)) * d + c.x + 2 * ln.cp, a0 / s0, a1 / s1);
    c.next(n, d, W);
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
  }
}

template <typename T>
auto kernel_of(int kpt) {
  switch (kpt) {
    case 2: return attn_v2_fwd_tma<T, 2>;
    case 4: return attn_v2_fwd_tma<T, 4>;
    case 6: return attn_v2_fwd_tma<T, 6>;
    case 8: return attn_v2_fwd_tma<T, 8>;
    case 10: return attn_v2_fwd_tma<T, 10>;
    case 12: return attn_v2_fwd_tma<T, 12>;
    default: return attn_v2_fwd_tma<T, 14>;
  }
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* e, void* edge_pre, void* node,
        long long batch, int n, int d, float inv_sqrt_dk, int grid, int stages,
        long long smem_bytes, void* stream) {
  constexpr bool bf16 = sizeof(T) == 2;
  if (!launch_ok(PER, batch, n, d, bf16, grid, stages, smem_bytes))
    return int(cudaErrorInvalidValue);
  if (batch == 0) return int(cudaSuccess);
  const int kpt = kpt_of(n), w = width_of(kpt);
  // A runtime call first: it makes the device's context current in this thread (an
  // autograd worker may have made none), which cuTensorMapEncodeTiled needs.
  auto kernel = kernel_of<T>(kpt);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem_bytes));
  if (err != cudaSuccess) return int(err);
  CUtensorMap maps[5];
  if (!make_map(&maps[0], bf16, e, batch * n * n, d, n, true, w) ||
      !make_map(&maps[1], bf16, edge_pre, batch * n * n, d, n, true, w) ||
      !make_map(&maps[2], bf16, k, batch * n, d, n, true, w) ||
      !make_map(&maps[3], bf16, v, batch * n, d, n, true, w) ||
      !make_map(&maps[4], bf16, q, batch * n, d, 1, false, w))
    return int(cudaErrorInvalidValue);
  const Geo geo{batch * (d / w), n, d, stages, inv_sqrt_dk};
  kernel<<<unsigned(grid), threads_of(kpt), size_t(smem_bytes),
           static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1], maps[2], maps[3], maps[4],
                                                static_cast<T*>(node), geo);
  return int(cudaGetLastError());
}

}  // namespace

// q, k, v, node: [batch, n, d]; e, edge_pre: [batch, n, n, d]; all in the
// stream type, 16-byte aligned.  1 <= n <= 112, d a multiple of 128; grid and
// stages from ops/fused_attention.py::v2_launch_plan, smem_bytes its shared
// memory, which must equal edge_attention_v2_fwd_plan's.  One launch on
// `stream`; does not synchronise, allocates nothing.  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for arguments it does not
// take).
#define EDGE_ATTENTION_V2_FWD(NAME, TYPE)                                                        \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* e,                \
                      void* edge_pre, void* node, long long batch, int n, int d,                 \
                      float inv_sqrt_dk, int grid, int stages, long long smem_bytes,             \
                      void* stream) {                                                            \
    return run<TYPE>(q, k, v, e, edge_pre, node, batch, n, d, inv_sqrt_dk, grid, stages,        \
                     smem_bytes, stream);                                                        \
  }
EDGE_ATTENTION_V2_FWD(edge_attention_v2_fwd_bf16, __nv_bfloat16)
EDGE_ATTENTION_V2_FWD(edge_attention_v2_fwd_f32, float)

// [shared memory bytes, keys a thread, blocks a SM the runtime keeps
// resident] of K3 at (n, bf16 or f32, stages).
extern "C" void edge_attention_v2_fwd_plan(int n, int bf16, int stages, long long out[3]) {
  if (bf16)
    plan_of(kernel_of<__nv_bfloat16>(kpt_of(n)), PER, n, true, stages, out);
  else
    plan_of(kernel_of<float>(kpt_of(n)), PER, n, false, stages, out);
}

// The items [begin, end) that block `block` of `grid` takes (K3 and K4).
extern "C" void edge_attention_v2_item_range(long long items, int grid, int block,
                                             long long out[2]) {
  item_range(items, grid, block, out[0], out[1]);
}
