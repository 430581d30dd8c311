// The plan and the building blocks shared by the v2 edge-attention kernels K3
// (fused_attention_v2.cu) and K4 (fused_attention_v2_bwd.cu): the work item,
// the shared-memory layout and its size, the TMA maps, the thread's place in
// a block, the reductions over keys and the producer.  ops/fused_attention.py
// ::v2_launch_plan mirrors the plan (the CPU tests check it; the libraries
// refuse a launch whose shared memory disagrees, and export theirs and the
// blocks a SM the runtime keeps resident for the card test).  The PTX
// wrappers are tail_hopper.cuh's.
//
// Work item: one graph b and a slice of `width` channels.  Every operation
// of the v2 op is per channel, so the item's block owns every sum over keys
// (the softmax's statistics, node, dot, dq) and over queries (dk, dv) of its
// slice outright: no scratch in device memory, no atomics.  width is 128 up
// to N 64 (8 keys a thread), so that a bf16 edge row of D 128 (256 bytes)
// is read whole (half rows, whose other half came ~40 rows later, streamed
// markedly slower on an H100); above N 64 the per-thread arrays need more
// than 128 registers and width is 64.  B x D / width items; persistent blocks each
// take a contiguous run of them (item_range) and stream the run's query
// rows (b, i) through a ring of `stages` slots.
//
// Warps: a consumer warp per 8 channels (16 or 8) and one producer warp.  The
// producer's one thread loads the first `stages` rows and the item's k and
// v, then, row by row, waits until every consumer warp has released the
// row's slot (`empty`), stores the row's edge-sized output from the slot by
// TMA, loads the next item's k and v after an item's last row, and refills
// the slot of the row before once its store has read it.  The consumers wait
// only on `full` (and the item's k and v), never on each other: with a
// block barrier a row, every warp waited for the slowest one's latency
// chain (three reductions, the exponentials) and for thread 0's TMA work.
//
// Shared memory (base aligned to 1,024 bytes by hand):
//   ring   stages x PER boxes   a slot: the row's e (K4: e, ge) slice
//   kv     2 boxes              the item's k and v slices, loaded once an item
//   vec    stages x PER x 512 B the row's q_i (K4: q_i, gn_i)
//   bars   2 stages + 1 mbarriers (full, empty, k and v)
// A box is [N][width] channels of one tensor as panels of N rows of 128
// bytes (64 bf16 or 32 f32 channels: the 128-byte swizzle spans 128 bytes a
// row), one TMA box each, each aligned to 1,024 bytes and written with the
// 128-byte swizzle (the 16-byte chunk index XOR the row index mod 8).  The
// outputs edge_pre (K3) and de (K4) are written over the e they were
// computed from, element by element by the thread that read it.
//
// Threads: a lane holds a channel pair p (lane % 4) of its warp's 8 channels
// and the keys j = g + 8 m (m < KPT) of its key group g, so a reduction over
// keys is a register sum and three __shfl_xor (lane bits 2-4).  g = 2 ((lane
// / 4) % 4) + lane / 16: in bf16 a warp reads eight rows of 16 bytes, one
// per 16-byte chunk of a 128-byte row after the swizzle; in f32 each
// half-warp reads four rows of 32 bytes whose chunks are again all
// different: no bank conflicts.  Since j mod 8 = g, a thread's swizzle is
// the same for all its keys, and key slot m sits 1,024 m bytes after slot 0.

#pragma once

#include "tail_hopper.cuh"

namespace {
namespace v2 {

using hop::fence_barrier_init;
using hop::fence_proxy_async;
using hop::mbar_expect_tx;
using hop::mbar_init;
using hop::mbar_wait;
using hop::tma_load;
using hop::tma_store;
using hop::tma_store_commit;

constexpr int GROUPS = 8;        // key groups of a warp
constexpr int MAX_KPT = 14;      // keys a thread: N at most 112
constexpr int REG_KPT = 8;       // up to this many keys a thread: 128-channel items
constexpr int MAX_STAGES = 8;
constexpr int VEC = 512;         // bytes a staged row vector (128 f32 channels)
constexpr size_t SMEM_MAX = 232448;   // dynamic shared memory a block may use
constexpr size_t ALIGN = 1024;        // slack to align the base by hand
constexpr size_t BARS = 256;

__host__ __device__ constexpr size_t align1k(size_t n) { return (n + 1023) / 1024 * 1024; }

// Keys a thread, rounded up to the kernels' instantiations (2, 4, ..., 14).
__host__ __device__ constexpr int kpt_of(int n) { return (n + 15) / 16 * 2; }
// Channels a work item: 128 (whole 256-byte bf16 rows) up to 8 keys a thread,
// 64 above (the per-thread arrays then need more than 128 registers, so a
// block is 8 warps); a warp owns 8 channels.
__host__ __device__ constexpr int width_of(int kpt) { return kpt <= REG_KPT ? 128 : 64; }
// Consumer warps (8 channels each) and one producer warp.
__host__ __device__ constexpr int threads_of(int kpt) { return 4 * width_of(kpt) + 32; }
__host__ __device__ constexpr size_t panel_bytes(int n) { return align1k(size_t(n) * 128); }
// One staged [N][width] slice: panels of 128-byte rows (64 bf16 or 32 f32
// channels), each aligned to 1,024 bytes.
__host__ __device__ constexpr size_t box_bytes(int n, bool bf16) {
  return size_t(width_of(kpt_of(n)) * (bf16 ? 2 : 4) / 128) * panel_bytes(n);
}
// Dynamic shared memory of a block: `per` tensors a slot (K3 1, K4 2).
__host__ __device__ constexpr size_t smem_bytes(int per, int n, bool bf16, int stages) {
  return ALIGN + size_t(stages * per + 2) * box_bytes(n, bf16) + size_t(stages) * per * VEC +
         BARS;
}
// The contiguous run of items [begin, end) of block `block` of `grid`.
__host__ __device__ inline void item_range(long long items, int grid, int block,
                                           long long& begin, long long& end) {
  begin = items * block / grid;
  end = items * (block + 1) / grid;
}

// A launch's arguments besides the maps and the node-sized outputs.
struct Geo {
  long long items;   // batch x d / width
  int n, d, stages;
  float inv_sqrt_dk;
};

// A query row (b, i) of the item (b, channels x ..): advanced row by row
// through a block's run of items (no divisions in the loop).
struct Cursor {
  int b, x, i;
  __device__ Cursor(long long item, int slices, int width)
      : b(int(item / slices)), x(int(item % slices) * width), i(0) {}
  __device__ void next(int n, int d, int width) {
    if (++i == n) {
      i = 0;
      x += width;
      if (x == d) {
        x = 0;
        ++b;
      }
    }
  }
  __device__ int row(int n) const { return b * n + i; }   // of q, k, v, node
};

// The stream type's channel pairs in a slot (swizzled panels) and in a
// node-sized tensor (plain).
template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kBoxCols = 64;
  // byte offset of the thread's pair at key slot 0 (row g): warp w owns
  // channels 8 w .. 8 w + 7, 16 bytes of panel w / 8
  __device__ static uint32_t offset(int warp, int p, int g, uint32_t panel) {
    return uint32_t(warp >> 3) * panel + uint32_t(g) * 128u +
           ((uint32_t(warp ^ g) & 7u) << 4) + 4u * uint32_t(p);
  }
  __device__ static float2 ld(const uint8_t* s, uint32_t off) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s + off));
  }
  __device__ static void st(uint8_t* s, uint32_t off, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(s + off) = __floats2bfloat162_rn(a, b);
  }
  __device__ static void st(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};
template <>
struct Elem<float> {
  static constexpr int kBoxCols = 32;
  // warp w: 32 bytes of panel w / 4
  __device__ static uint32_t offset(int warp, int p, int g, uint32_t panel) {
    const uint32_t chunk = 2u * uint32_t(warp & 3) + uint32_t(p >> 1);
    return uint32_t(warp >> 2) * panel + uint32_t(g) * 128u +
           (((chunk ^ uint32_t(g)) & 7u) << 4) + 8u * uint32_t(p & 1);
  }
  __device__ static float2 ld(const uint8_t* s, uint32_t off) {
    return *reinterpret_cast<const float2*>(s + off);
  }
  __device__ static void st(uint8_t* s, uint32_t off, float a, float b) {
    *reinterpret_cast<float2*>(s + off) = make_float2(a, b);
  }
  __device__ static void st(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};
// Channel pair cp of a row vector staged in shared memory.
template <typename T>
__device__ __forceinline__ float2 ld_vec(const uint8_t* s, int cp) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s + 4 * cp));
  } else {
    return *reinterpret_cast<const float2*>(s + 8 * cp);
  }
}

// Whether key slot m (key g + 8 m) of a thread exists.  KPT = 2 ceil(N / 16)
// puts N above 8 (KPT - 2), so only the last two slots need the test.
template <int KPT>
__device__ __forceinline__ bool key_ok(int m, int g, int n) {
  return m < KPT - 2 || g + GROUPS * m < n;
}

// The thread's place: warp, channel pair within the item, key group.
struct Lane {
  int warp, p, g, cp;
  __device__ explicit Lane(int tid)
      : warp(tid >> 5), p(tid & 3), g(2 * ((tid >> 2) & 3) + ((tid >> 4) & 1)),
        cp(4 * (tid >> 5) + (tid & 3)) {}
};

// Reductions over the eight key groups of a warp (lane bits 2, 3, 4), in a
// fixed order: every lane gets the same total, the same bits on every run.
__device__ __forceinline__ float group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
}
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(hop::smem_u32(bar)) : "memory");
}

// The TMA store group before the newest has read its shared memory.
__device__ __forceinline__ void tma_store_wait_read_all_but_newest() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}
// Every TMA store has finished.
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The ring of one block: slot addresses, and TMA boxes of [N][width].
struct Ring {
  uint8_t* ring;     // stages x per boxes
  uint8_t* kv;       // k box, v box
  uint8_t* vec;      // stages x per row vectors
  uint64_t* full;    // a slot's row has arrived (TMA)
  uint64_t* empty;   // every consumer warp is done with the slot
  uint64_t* kv_bar;
  uint32_t panel, box;
  int per, stages, panels;

  __device__ Ring(uint8_t* raw, const Geo& geo, int per_, bool bf16)
      : per(per_), stages(geo.stages) {
    // aligned by an offset, so that the compiler still sees shared memory
    uint8_t* base = raw + ((ALIGN - (hop::smem_u32(raw) & (ALIGN - 1))) & (ALIGN - 1));
    panel = uint32_t(panel_bytes(geo.n));
    box = uint32_t(box_bytes(geo.n, bf16));
    panels = int(box / panel);
    ring = base;
    kv = ring + size_t(stages) * per * box;
    vec = kv + 2 * size_t(box);
    full = reinterpret_cast<uint64_t*>(vec + size_t(stages) * per * VEC);
    empty = full + stages;
    kv_bar = empty + stages;
  }
  __device__ uint8_t* box_of(int slot, int t) const { return ring + size_t(slot * per + t) * box; }
  __device__ uint8_t* vec_of(int slot, int t) const { return vec + size_t(slot * per + t) * VEC; }

  // The box of a [rows, d] tensor at (row y, channel x) into dst.
  template <typename T>
  __device__ void load_box(uint8_t* dst, const CUtensorMap* map, uint64_t* bar, int x,
                           int y) const {
    for (int pn = 0; pn < panels; ++pn)
      tma_load(dst + pn * panel, map, bar, x + pn * Elem<T>::kBoxCols, y);
  }
  template <typename T>
  __device__ void store_box(const CUtensorMap* map, const uint8_t* src, int x, int y) const {
    for (int pn = 0; pn < panels; ++pn)
      tma_store(map, src + pn * panel, x + pn * Elem<T>::kBoxCols, y);
  }
};

// The block's barriers, set up by thread 0 before the block's first barrier.
__device__ __forceinline__ void init_barriers(const Ring& rg, int consumer_warps) {
  for (int s = 0; s < rg.stages; ++s) {
    mbar_init(rg.full + s, 1);
    mbar_init(rg.empty + s, consumer_warps);
  }
  mbar_init(rg.kv_bar, 1);
  fence_barrier_init();
}

// The producer (one thread of the last warp) keeps the ring full, in row
// order: the first `stages` rows and the first item's k and v, then for each
// row, once every consumer warp has released its slot, the TMA store of the
// slot (the row's edge-sized output, written over its input), the next
// item's k and v after an item's last row, and the load of row r - 1 +
// stages into the slot of row r - 1 once that row's store has read it.
// load_row(slot, cursor), store_row(slot, cursor), load_kv(cursor of the
// item's first row).
template <class LoadRow, class StoreRow, class LoadKv>
__device__ __forceinline__ void produce(const Ring& rg, long long it0, int rows, int n, int d,
                                        int width, LoadRow load_row, StoreRow store_row,
                                        LoadKv load_kv) {
  const int slices = d / width, stages = rg.stages;
  Cursor lc(it0, slices, width), sc(it0, slices, width);
  load_kv(lc);
  int loaded = 0;
  for (; loaded < rows && loaded < stages; ++loaded) {
    load_row(loaded, lc);
    lc.next(n, d, width);
  }
  int s = 0, prev = 0;
  uint32_t phase = 0;
  for (int r = 0; r < rows; ++r) {
    mbar_wait(rg.empty + s, phase);
    store_row(s, sc);
    tma_store_commit();
    const bool last = sc.i == n - 1;
    sc.next(n, d, width);
    if (last && r + 1 < rows) load_kv(sc);   // the consumers are past the item's k, v
    if (r >= 1 && loaded < rows) {
      tma_store_wait_read_all_but_newest();   // the slot of row r - 1 is free
      load_row(prev, lc);
      lc.next(n, d, width);
      ++loaded;
    }
    prev = s;
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
  }
  tma_store_wait_all();
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------
// A [rows][cols] row-major matrix of the stream type in boxes of
// [box_rows][128 bytes] with the 128-byte swizzle (64 bf16 or 32 f32
// channels) or, for the row vectors, one plain box of `width` channels.
// Returns false if cuTensorMapEncodeTiled refuses it.
inline bool make_map(CUtensorMap* map, bool bf16, const void* base, long long rows, int cols,
                     int box_rows, bool swizzle, int width) {
  hop::EncodeTiled fn = hop::encode_tiled();
  if (fn == nullptr || rows <= 0) return false;
  const int item = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * item};
  const cuuint32_t box[2] = {cuuint32_t(swizzle ? 128 / item : width), cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1u, 1u};
  return fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
            const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What a launch takes: 1 <= n <= 8 MAX_KPT, d a multiple of 128 (the JAX
// rule's), fewer than 2^31 edge rows, 2 <= stages <= MAX_STAGES, a grid,
// and the shared memory the library computes for them.
inline bool launch_ok(int per, long long batch, int n, int d, bool bf16, int grid, int stages,
                      long long smem) {
  return batch >= 0 && n >= 1 && n <= GROUPS * MAX_KPT && d > 0 && d % 128 == 0 &&
         batch * n * n < (1ll << 31) && grid > 0 && stages >= 2 && stages <= MAX_STAGES &&
         smem == (long long)smem_bytes(per, n, bf16, stages) && size_t(smem) <= SMEM_MAX;
}

// Sets the kernel's shared memory, then reports [smem bytes, keys a thread,
// blocks a SM that the runtime would keep resident].
template <typename K>
void plan_of(K kernel, int per, int n, bool bf16, int stages, long long out[3]) {
  const size_t smem = smem_bytes(per, n, bf16, stages);
  int blocks = 0;
  if (smem > SMEM_MAX ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads_of(kpt_of(n)),
                                                    smem) !=
          cudaSuccess)
    blocks = 0;
  out[0] = (long long)smem;
  out[1] = kpt_of(n);
  out[2] = blocks;
}

}  // namespace v2
}  // namespace
