// Edge-modulated attention, the v2 op without projections, backward (K4).
//
// Replaces the TPU kernel druggen_tpu/ops/fused_attention.py::_bwd_kernel
// (called by _bwd_pallas).  Given the forward's inputs and the cotangents
// ge (of edge_pre) and gn (of node_agg), it recomputes, in f32 from the
// stream-type (T) inputs,
//
//     base = (q_i k_j) inv_sqrt_dk, mod = (e + 1) e, t = base mod,
//     s = softmax over j of t (per channel), ds_in = gn_i v_j,
//     dot_i = sum_j s ds_in, dt = ge + s (ds_in - dot_i), dbase = dt mod,
//
// and returns, rounded to T,
//
//     de = (dt base)(2 e + 1),  dq_i = (sum_j dbase k_j) inv_sqrt_dk,
//     dk_j = (sum_i dbase q_i) inv_sqrt_dk,  dv_j = sum_i s gn_i.
//
// Reassociations against the Pallas kernel: s = ex * (1 / sum) with ex =
// expf(t - max), one expf an element and one IEEE division a channel;
// dot_i = (sum_j ex ds_in) / sum; the sums over keys run in the key groups'
// order (attn_v2.cuh), those over queries in query order.
//
// What bounds it on an H100 SXM: at the training shape (512 graphs of 45
// atoms, D = 128, bf16) it must read e and ge and write de, three edge-sized
// tensors of 0.265 GB, besides the node-sized ones: 0.84 GB, 0.250 ms at
// 3.35 TB/s; its ~45 instructions an element take ~0.2 ms at the card's
// instruction rate.  So the bytes bound it, if barely, and the design reads
// e and ge once and writes de once.
//
// Design (the plan, layout and producer are attn_v2.cuh's), one launch: a
// work item is one graph and 128 channels (64 above N 64).  Its k and v
// slices come into shared memory once by TMA; its query rows' e and ge
// slices (with q_i and gn_i) stream through a ring of slots kept full by a
// producer warp.  For query row i a thread, over its keys: t from staged e,
// k and q_i (kept in registers) and the maximum; ex, their sum and sum ex
// gn_i v_j; then dt, de (written over e, stored from the slot by the
// producer's TMA store once the warps have released it), dq_i, and its own
// dk_j and dv_j totals, kept in registers for the whole item and added in
// query order.  dq_i leaves from the first key group's lanes; dk and dv at
// the end of the item, from the thread that owns them.  No statistics leave
// the block, no float atomics: the same inputs give the same bits.  One
// block a SM: 16 consumer warps at up to 120 registers a thread (64-channel
// items above N 64: 8 warps, up to 255).  At the training shape: 8 ring
// slots, 230,656 B a block.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libfused_attention_v2_bwd.so fused_attention_v2_bwd.cu
// Plain C interface for ctypes; no PyTorch headers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attn_v2.cuh"

namespace {
using namespace v2;

constexpr int PER = 2;   // tensors a slot: e, ge (and row vectors q_i, gn_i)

// One query row in the thread's channel pair: t and the maximum; ex, their
// sum and sum ex ds_in; then dt, de over e, dq_i (this thread's part) and
// the thread's dk_j, dv_j totals.  The pointers do not alias, so the
// compiler may move a key's loads above the previous key's store.
template <typename T, int KPT>
__device__ __forceinline__ void bwd_row(uint8_t* __restrict__ es, const uint8_t* __restrict__ gs,
                                        const uint8_t* __restrict__ ks,
                                        const uint8_t* __restrict__ vs, float2 qv, float2 gv,
                                        uint32_t off0, int g, int n, float inv,
                                        float (&dkt)[KPT][2], float (&dvt)[KPT][2], float& q0,
                                        float& q1) {
  using E = Elem<T>;
  float sx[KPT][2];
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int m = 0; m < KPT; ++m) {
    if (key_ok<KPT>(m, g, n)) {
      const uint32_t o = off0 + 1024u * m;
      const float2 ev = E::ld(es, o), kv = E::ld(ks, o);
      sx[m][0] = ((qv.x * kv.x) * inv) * ((ev.x + 1.0f) * ev.x);
      sx[m][1] = ((qv.y * kv.y) * inv) * ((ev.y + 1.0f) * ev.y);
      m0 = fmaxf(m0, sx[m][0]);
      m1 = fmaxf(m1, sx[m][1]);
    }
  }
  m0 = group_max(m0);
  m1 = group_max(m1);
  float s0 = 0.0f, s1 = 0.0f, u0 = 0.0f, u1 = 0.0f;
#pragma unroll
  for (int m = 0; m < KPT; ++m) {
    if (key_ok<KPT>(m, g, n)) {
      sx[m][0] = expf(sx[m][0] - m0);
      sx[m][1] = expf(sx[m][1] - m1);
      const float2 vv = E::ld(vs, off0 + 1024u * m);
      s0 += sx[m][0];
      s1 += sx[m][1];
      u0 = fmaf(sx[m][0], gv.x * vv.x, u0);
      u1 = fmaf(sx[m][1], gv.y * vv.y, u1);
    }
  }
  s0 = group_sum(s0);
  s1 = group_sum(s1);
  u0 = group_sum(u0);
  u1 = group_sum(u1);
  const float r0 = 1.0f / s0, r1 = 1.0f / s1, dot0 = u0 / s0, dot1 = u1 / s1;
  q0 = q1 = 0.0f;
#pragma unroll
  for (int m = 0; m < KPT; ++m) {
    if (key_ok<KPT>(m, g, n)) {
      const uint32_t o = off0 + 1024u * m;
      const float2 ev = E::ld(es, o), gev = E::ld(gs, o), kv = E::ld(ks, o), vv = E::ld(vs, o);
      const float p0 = sx[m][0] * r0, p1 = sx[m][1] * r1;
      const float b0 = (qv.x * kv.x) * inv, b1 = (qv.y * kv.y) * inv;
      const float dt0 = gev.x + p0 * (gv.x * vv.x - dot0);
      const float dt1 = gev.y + p1 * (gv.y * vv.y - dot1);
      E::st(es, o, (dt0 * b0) * (2.0f * ev.x + 1.0f), (dt1 * b1) * (2.0f * ev.y + 1.0f));
      const float db0 = dt0 * ((ev.x + 1.0f) * ev.x), db1 = dt1 * ((ev.y + 1.0f) * ev.y);
      q0 = fmaf(db0, kv.x, q0);
      q1 = fmaf(db1, kv.y, q1);
      dkt[m][0] = fmaf(db0, qv.x, dkt[m][0]);
      dkt[m][1] = fmaf(db1, qv.y, dkt[m][1]);
      dvt[m][0] = fmaf(p0, gv.x, dvt[m][0]);
      dvt[m][1] = fmaf(p1, gv.y, dvt[m][1]);
    }
  }
}

template <typename T, int KPT>
__global__ void __launch_bounds__(threads_of(KPT), 1)
attn_v2_bwd_tma(const __grid_constant__ CUtensorMap e_map,
                const __grid_constant__ CUtensorMap ge_map,
                const __grid_constant__ CUtensorMap de_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap gn_map, T* __restrict__ dq,
                T* __restrict__ dk, T* __restrict__ dv, const Geo geo) {
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
    const uint32_t row_tx = uint32_t(2 * (n + 1) * W * sizeof(T));
    const uint32_t kv_tx = uint32_t(2 * n * W * sizeof(T));
    produce(
        rg, it0, rows, n, d, W,
        [&](int s, const Cursor& c) {
          uint64_t* bar = rg.full + s;
          mbar_expect_tx(bar, row_tx);
          rg.load_box<T>(rg.box_of(s, 0), &e_map, bar, c.x, c.row(n) * n);
          rg.load_box<T>(rg.box_of(s, 1), &ge_map, bar, c.x, c.row(n) * n);
          tma_load(rg.vec_of(s, 0), &q_map, bar, c.x, c.row(n));
          tma_load(rg.vec_of(s, 1), &gn_map, bar, c.x, c.row(n));
        },
        [&](int s, const Cursor& c) { rg.store_box<T>(&de_map, rg.box_of(s, 0), c.x, c.row(n) * n); },
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
  float dkt[KPT][2], dvt[KPT][2];   // this thread's dk_j, dv_j totals over i
  for (int r = 0; r < rows; ++r) {
    if (c.i == 0) {
      mbar_wait(rg.kv_bar, kv_phase);
      kv_phase ^= 1u;
#pragma unroll
      for (int m = 0; m < KPT; ++m) dkt[m][0] = dkt[m][1] = dvt[m][0] = dvt[m][1] = 0.0f;
    }
    mbar_wait(rg.full + s, phase);
    uint8_t* es = rg.box_of(s, 0);
    const uint8_t* gs = rg.box_of(s, 1);
    const float2 qv = ld_vec<T>(rg.vec_of(s, 0), ln.cp);
    const float2 gv = ld_vec<T>(rg.vec_of(s, 1), ln.cp);
    float q0, q1;
    bwd_row<T, KPT>(es, gs, ks, vs, qv, gv, off0, ln.g, n, inv, dkt, dvt, q0, q1);
    fence_proxy_async();   // de, written over e, is read by the TMA store
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(rg.empty + s);
    // dq after the fence, which would wait for a global store
    q0 = group_sum(q0);
    q1 = group_sum(q1);
    if (ln.g == 0) E::st(dq + size_t(c.row(n)) * d + c.x + 2 * ln.cp, q0 * inv, q1 * inv);
    if (c.i == n - 1) {   // the item's dk and dv, from the threads that own them
#pragma unroll
      for (int m = 0; m < KPT; ++m) {
        const int j = ln.g + GROUPS * m;
        if (j < n) {
          const size_t at = size_t(c.b * n + j) * d + c.x + 2 * ln.cp;
          E::st(dk + at, dkt[m][0] * inv, dkt[m][1] * inv);
          E::st(dv + at, dvt[m][0], dvt[m][1]);
        }
      }
    }
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
    case 2: return attn_v2_bwd_tma<T, 2>;
    case 4: return attn_v2_bwd_tma<T, 4>;
    case 6: return attn_v2_bwd_tma<T, 6>;
    case 8: return attn_v2_bwd_tma<T, 8>;
    case 10: return attn_v2_bwd_tma<T, 10>;
    case 12: return attn_v2_bwd_tma<T, 12>;
    default: return attn_v2_bwd_tma<T, 14>;
  }
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* e, const void* ge,
        const void* gn, void* dq, void* dk, void* dv, void* de, long long batch, int n, int d,
        float inv_sqrt_dk, int grid, int stages, long long smem_bytes, void* stream) {
  constexpr bool bf16 = sizeof(T) == 2;
  if (!launch_ok(PER, batch, n, d, bf16, grid, stages, smem_bytes))
    return int(cudaErrorInvalidValue);
  if (batch == 0) return int(cudaSuccess);
  const int kpt = kpt_of(n), w = width_of(kpt);
  const long long edges = batch * n * n, nodes = batch * n;
  // A runtime call first: it makes the device's context current in this thread (an
  // autograd worker may have made none), which cuTensorMapEncodeTiled needs.
  auto kernel = kernel_of<T>(kpt);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem_bytes));
  if (err != cudaSuccess) return int(err);
  CUtensorMap maps[7];
  if (!make_map(&maps[0], bf16, e, edges, d, n, true, w) ||
      !make_map(&maps[1], bf16, ge, edges, d, n, true, w) ||
      !make_map(&maps[2], bf16, de, edges, d, n, true, w) ||
      !make_map(&maps[3], bf16, k, nodes, d, n, true, w) ||
      !make_map(&maps[4], bf16, v, nodes, d, n, true, w) ||
      !make_map(&maps[5], bf16, q, nodes, d, 1, false, w) ||
      !make_map(&maps[6], bf16, gn, nodes, d, 1, false, w))
    return int(cudaErrorInvalidValue);
  const Geo geo{batch * (d / w), n, d, stages, inv_sqrt_dk};
  kernel<<<unsigned(grid), threads_of(kpt), size_t(smem_bytes),
           static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1], maps[2], maps[3], maps[4],
                                                maps[5], maps[6], static_cast<T*>(dq),
                                                static_cast<T*>(dk), static_cast<T*>(dv), geo);
  return int(cudaGetLastError());
}

}  // namespace

// q, k, v, gn, dq, dk, dv: [batch, n, d]; e, ge, de: [batch, n, n, d]; all
// in the stream type, 16-byte aligned.  1 <= n <= 112, d a multiple of 128;
// grid and stages from ops/fused_attention.py::v2_launch_plan, smem_bytes
// its shared memory, which must equal edge_attention_v2_bwd_plan's.  One
// launch on `stream`; does not synchronise, allocates nothing.  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for arguments it does not
// take).
#define EDGE_ATTENTION_V2_BWD(NAME, TYPE)                                                       \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* e,               \
                      const void* ge, const void* gn, void* dq, void* dk, void* dv, void* de,   \
                      long long batch, int n, int d, float inv_sqrt_dk, int grid, int stages,   \
                      long long smem_bytes, void* stream) {                                     \
    return run<TYPE>(q, k, v, e, ge, gn, dq, dk, dv, de, batch, n, d, inv_sqrt_dk, grid,        \
                     stages, smem_bytes, stream);                                               \
  }
EDGE_ATTENTION_V2_BWD(edge_attention_v2_bwd_bf16, __nv_bfloat16)
EDGE_ATTENTION_V2_BWD(edge_attention_v2_bwd_f32, float)

// [shared memory bytes, keys a thread, blocks a SM the runtime keeps
// resident] of K4 at (n, bf16 or f32, stages).
extern "C" void edge_attention_v2_bwd_plan(int n, int bf16, int stages, long long out[3]) {
  if (bf16)
    plan_of(kernel_of<__nv_bfloat16>(kpt_of(n)), PER, n, true, stages, out);
  else
    plan_of(kernel_of<float>(kpt_of(n)), PER, n, false, stages, out);
}
