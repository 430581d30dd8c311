// Hopper building blocks of the bf16 edge-tail kernels K1 (fused_mlp.cu) and
// K2 (fused_mlp_bwd.cu): the tile plan, inline PTX for wgmma, TMA and
// mbarriers, the shared-memory layouts the products read, the LayerNorm
// helpers that work in wgmma's accumulator layout, and the forward tile
// routine (ftile::tail_fwd_tiles) that K1 and K9's edge tail
// (fused_generator_hopper.cu) run, each with its own rounding policy.
//
// The tile plan (mirrored by ops/fused_mlp.py::launch_plan, which the CPU
// tests check; the kernels refuse a launch whose shared memory disagrees):
//   - C and H come from the build (-DKERNEL_C / -DKERNEL_H) and are padded
//     to CP and HP, multiples of 64 (one 128-byte swizzle row of bf16).
//   - A consumer warpgroup (128 threads) owns a 64-row tile; the hidden runs
//     in NJ chunks of HJ = 64 columns.
//   - Mode A (CP <= 128): two warpgroups a block; each thread keeps its
//     rows of s as packed bf16 pairs in registers, so the s tile's buffer is
//     free as soon as it is read.  Mode B (CP > 128): the C-wide accumulator
//     alone takes CP / 2 registers a thread, so one warpgroup a block keeps
//     s, the rounded LN1 output and K2's vector sums in shared memory.
//   - Both weights are staged once a block where they fit (kStage);
//     otherwise each warpgroup streams them chunk by chunk through its own
//     TMA ring of RING stages from L2.
//
// Shared-memory layouts.  Every wgmma operand is a set of "panels": rows of
// 128 bytes (64 bf16), 8 rows forming a 1,024-byte atom swizzled the way
// TMA's SWIZZLE_128B writes it (the 16-byte chunk index XOR the row index
// mod 8).  A 64-row tile of a C-wide matrix is KP = CP / 64 panels of
// [64 rows][128 B].  Staged weights:
//   W1^T [HP][CP] as KP panels of [HP rows][128 B]   (row h, column c)
//   W2^T [CP][HP] as NJ panels of [CP rows][128 B]   (row c, column h)
// One staged copy serves both directions: wgmma reads W1^T K-major as the B
// operand of x @ W1 and, with its transpose bit set, MN-major as the B
// operand of dh @ W1^T; likewise W2^T for h @ W2 and dm @ W2^T.  A streamed
// chunk j holds the same rows: W1^T rows [64j, 64j + 64) as KP panels of
// [64][128 B], then W2^T columns [64j, 64j + 64) as one panel of [CP][128 B].
//
// Accumulator layout (wgmma m64nN, f32): thread t of a warpgroup (warp
// w = t / 32, lane l) holds rows r0 = 16 w + l / 4 and r1 = r0 + 8, columns
// 8 j + 2 (l % 4) + e (e = 0, 1) for j < N / 8, at d[4 j + 2 half + e].  The
// bf16 A operand from registers uses the same (row, column) sets, so an
// accumulator becomes the next product's A operand in registers (the
// FlashAttention-3 treatment of P), and a tile read into this layout has
// its LayerNorm rows spread over the four lanes of a quad.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#ifndef KERNEL_C
#define KERNEL_C 128
#endif
#ifndef KERNEL_H
#define KERNEL_H 384
#endif
#define TAIL_FUSED (KERNEL_C % 8 == 0 && (KERNEL_C + 63) / 64 * 64 <= 256)

namespace {
namespace hop {

constexpr int C = KERNEL_C;
constexpr int H = KERNEL_H;
constexpr int CP = (C + 63) / 64 * 64;
constexpr int HP = (H + 63) / 64 * 64;
constexpr int BM = 64;                  // rows a warpgroup tile
constexpr int HJ = 64;                  // hidden columns a chunk
constexpr int NJ = HP / HJ;             // hidden chunks
constexpr int KP = CP / 64;             // panels across C
constexpr int JC = CP / 8;              // 8-column groups of a C-wide accumulator
constexpr bool kFullC = C == CP;
constexpr bool kModeA = CP <= 128;
constexpr int NWG = kModeA ? 2 : 1;     // consumer warpgroups a block
constexpr int THREADS = NWG * 128;
constexpr float EPS = 1e-5f;
constexpr size_t SMEM_MAX = 232448;     // dynamic shared memory a block may use
constexpr size_t ALIGN_SLACK = 1024;    // the base is aligned to 1,024 bytes by hand
constexpr size_t TILE_BYTES = size_t(BM) * CP * 2;   // a 64-row tile, C wide
constexpr size_t W_BYTES = size_t(CP) * HP * 2;      // one padded weight
constexpr size_t CHUNK_BYTES = 2 * size_t(HJ) * CP * 2;  // W1^T and W2^T rows of a chunk
// K2's vector partial: dg1[C] dbl1[C] db1[H] db2[C] dg2[C] dbl2[C]
constexpr int OFF_DG1 = 0, OFF_DBL1 = C, OFF_DB1 = 2 * C, OFF_DB2 = 2 * C + H,
              OFF_DG2 = 3 * C + H, OFF_DBL2 = 4 * C + H, NVEC = 5 * C + H;

// The single-pass kernels take C a multiple of 8 (TMA row strides of 16
// bytes) with CP at most 256 (the C-wide accumulator of a warpgroup); every
// other C takes the split path (tail_split.cuh).  The sources compile the
// one their width takes (TAIL_FUSED).
constexpr bool kFused = TAIL_FUSED;

// Ring stages a warpgroup gets for streamed weights, given the bytes the
// rest of the block takes.
constexpr int ring_stages(size_t fixed) {
  const size_t room = SMEM_MAX - ALIGN_SLACK - 256 - fixed;
  const size_t n = room / (size_t(NWG) * CHUNK_BYTES);
  return n > 4 ? 4 : int(n);
}

__host__ __device__ constexpr size_t align1k(size_t n) { return (n + 1023) / 1024 * 1024; }

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// TMA: a 2-D box from global memory into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                         int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}
// TMA: a 2-D box from shared memory to global memory (rows past the end of
// the tensor are not written).
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int x, int y) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(x), "r"(y)
               : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// Generic-proxy writes to shared memory made visible to TMA and wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// Barrier of one warpgroup (ids 1.. ; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous products that write it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operands:
// sbo = 1,024 (the next 8 rows), lbo unused (16).  MN-major operands: lbo =
// the stride between 64-element panels along M or N, sbo = 1,024 (the next
// 8 rows along K).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t((lbo & 0x3FFFF) >> 4) << 16) |
         (uint64_t((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// Byte offset of element (r, c), c < 64, in a panel of 128-byte rows.
__device__ __forceinline__ uint32_t sw_off(int r, int c) {
  return uint32_t(r) * 128u + ((uint32_t((c >> 3) ^ r) & 7u) << 4) + uint32_t(c & 7) * 2u;
}

// wgmma m64nNk16, bf16 in, f32 accumulate (scale-d 1: d += a b).  ss: A and
// B from shared memory (TA / TB: MN-major when 1); rs: A from registers (the
// accumulator layout's rows and columns, packed bf16 pairs).
template <int N>
struct Mma;

template <>
struct Mma<64> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
};

template <>
struct Mma<128> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
};

template <>
struct Mma<192> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[96], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, %99, %100;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
};

template <>
struct Mma<256> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
};

// ---------------------------------------------------------------------------
// Rows in the accumulator layout
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// The thread's place in a warpgroup tile.
struct Lane {
  int t;     // thread in the warpgroup
  int warp;  // warp in the warpgroup
  int r0;    // first of its two rows (the other is r0 + 8)
  int q;     // lane % 4: its columns are 8 j + 2 q + e
  __device__ __forceinline__ explicit Lane(int tid_in_wg)
      : t(tid_in_wg), warp(tid_in_wg >> 5), r0((tid_in_wg >> 5) * 16 + ((tid_in_wg & 31) >> 2)),
        q(tid_in_wg & 3) {}
  __device__ __forceinline__ int row(int half) const { return r0 + 8 * half; }
  __device__ __forceinline__ int col(int j, int e = 0) const { return 8 * j + 2 * q + e; }
};

__device__ __forceinline__ bool c_ok(int col) { return kFullC || col < C; }

// Byte offset of the bf16 pair at (r, 8 j + 2 q) in a C-wide tile of KP panels.
__device__ __forceinline__ uint32_t tile_off(int r, int j, int q) {
  return uint32_t(j >> 3) * uint32_t(BM * 128) + sw_off(r, ((j & 7) << 3) + 2 * q);
}

// Sum over the four lanes of a quad (one row's columns).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// LayerNorm statistics of the thread's two rows from their C-wide values
// v[4 j + 2 half + e] (zero past C), in f32 with the two-pass variance of
// the Pallas kernels' _ln_fwd: mu and rstd of each row.
template <int N>
__device__ __forceinline__ void row_stats(const float (&v)[N], const Lane& ln, float (&mu)[2],
                                          float (&rstd)[2]) {
  static_assert(N == 4 * JC, "a C-wide row");
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < JC; ++j) s += v[4 * j + 2 * half] + v[4 * j + 2 * half + 1];
    mu[half] = quad_sum(s) * (1.0f / C);
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < JC; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = c_ok(ln.col(j, e)) ? v[4 * j + 2 * half + e] - mu[half] : 0.0f;
        q += d * d;
      }
    rstd[half] = rsqrtf(quad_sum(q) * (1.0f / C) + EPS);
  }
}

// Sum over the 16 rows of a warp of a quantity u[j][e] (columns 8 j + 2 q + e,
// already summed over the thread's two rows), scattered so that each lane
// keeps J / 8 column pairs: lane l keeps j = (l >> 4) J/2 + ((l >> 3) & 1) J/4
// + ((l >> 2) & 1) J/8 + i for i < J / 8.  Fixed order: the same bits on
// every run.
template <int J>
__device__ __forceinline__ void warp_col_scatter(float (&u)[J][2]) {
  static_assert(J % 8 == 0, "eight row groups");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int lvl = 0; lvl < 3; ++lvl) {
    const int mask = 16 >> lvl;
    const int half = J >> (lvl + 1);
    const bool hi = (lane & mask) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float send = hi ? u[i][e] : u[i + half][e];
        const float keep = hi ? u[i + half][e] : u[i][e];
        u[i][e] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
      }
  }
}
// warp_col_scatter<J> of u[j][e] = f(j, e), computed as the first level
// needs it: only J / 2 pairs are held at a time.  The same sums in the same
// lanes, in u[i] for i < J / 8.
template <int J, typename F>
__device__ __forceinline__ void warp_col_scatter_of(F&& f, float (&u)[J / 2][2]) {
  static_assert(J % 8 == 0, "eight row groups");
  const int lane = threadIdx.x & 31;
  {
    const bool hi = (lane & 16) != 0;
#pragma unroll
    for (int i = 0; i < J / 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float lo_v = f(i, e), hi_v = f(i + J / 2, e);
        const float send = hi ? lo_v : hi_v;
        const float keep = hi ? hi_v : lo_v;
        u[i][e] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
      }
  }
#pragma unroll
  for (int lvl = 1; lvl < 3; ++lvl) {
    const int mask = 16 >> lvl;
    const int half = J >> (lvl + 1);
    const bool hi = (lane & mask) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float send = hi ? u[i][e] : u[i + half][e];
        const float keep = hi ? u[i + half][e] : u[i][e];
        u[i][e] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
      }
  }
}
// The j of pair i that warp_col_scatter<J> leaves in this lane.
template <int J>
__device__ __forceinline__ int scattered_j(int i) {
  const int lane = threadIdx.x & 31;
  return ((lane >> 4) & 1) * (J / 2) + ((lane >> 3) & 1) * (J / 4) + ((lane >> 2) & 1) * (J / 8) + i;
}

// One row's bf16 pairs v[jj] (columns 8 jj + 2 q, jj < NG) transposed over
// the quad of lanes that holds the row, so that lane q holds whole 16-byte
// groups: out[g] = columns 8 (4 g + q) .. 8 (4 g + q) + 7, ready for one
// 16-byte store each.  Four shuffles per four groups.
template <int NG>
__device__ __forceinline__ void quad_transpose(const uint32_t (&v)[NG], uint4 (&out)[NG / 4]) {
  static_assert(NG % 4 == 0, "groups of four");
  const int lane = threadIdx.x & 31;
  const bool b1 = (lane & 2) != 0, b0 = (lane & 1) != 0;
#pragma unroll
  for (int g = 0; g < NG / 4; ++g) {
    uint32_t r1[2][2];  // [bit 1 of the source lane][m0]: pairs m = 2 b1 + m0
#pragma unroll
    for (int m0 = 0; m0 < 2; ++m0) {
      const uint32_t lo = v[4 * g + m0], hi = v[4 * g + 2 + m0];
      const uint32_t recv = __shfl_xor_sync(0xffffffffu, b1 ? lo : hi, 2);
      r1[0][m0] = b1 ? recv : lo;
      r1[1][m0] = b1 ? hi : recv;
    }
    uint32_t f[4];
#pragma unroll
    for (int pb1 = 0; pb1 < 2; ++pb1) {
      const uint32_t keep = b0 ? r1[pb1][1] : r1[pb1][0];
      const uint32_t recv = __shfl_xor_sync(0xffffffffu, b0 ? r1[pb1][0] : r1[pb1][1], 1);
      f[2 * pb1] = b0 ? recv : keep;
      f[2 * pb1 + 1] = b0 ? keep : recv;
    }
    out[g] = make_uint4(f[0], f[1], f[2], f[3]);
  }
}

// Stores a 64-column chunk of bf16 pairs held as k-step A registers a[kk][*]
// (to_a_regs' layout) to rows r0 and r0 + 8 of `dst` (row stride `ld`
// elements, the chunk's first column at `dst`), 16 bytes a store; rows at or
// past `rows_left` are not written.  Every lane of the warp calls it.
__device__ __forceinline__ void store_chunk(const uint32_t (&a)[4][4], __nv_bfloat16* dst,
                                            long long ld, const Lane& ln, long long rows_left) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t v[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) v[jj] = a[jj >> 1][(jj & 1) * 2 + half];
    uint4 out[2];
    quad_transpose(v, out);
    const int r = ln.row(half);
    if (r < rows_left) {
#pragma unroll
      for (int g = 0; g < 2; ++g)
        *reinterpret_cast<uint4*>(dst + r * ld + 8 * (4 * g + ln.q)) = out[g];
    }
  }
}

// ---------------------------------------------------------------------------
// Host: TMA descriptors
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime (no link against libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [rows][cols] bf16 row-major matrix read or written in boxes of
// [box_rows][64] with the 128-byte swizzle (rows past the end read as zeros
// and are not written).  Returns false if the driver refuses it.
inline bool make_map(CUtensorMap* map, const void* base, long long rows, int cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || rows <= 0) return false;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * 2};
  const cuuint32_t box[2] = {64u, cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1u, 1u};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// Weights
// ---------------------------------------------------------------------------
// Both padded weights into their staged panels (every thread of the block;
// 16-byte copies).
__device__ __forceinline__ void stage_weights(uint8_t* w1s, uint8_t* w2s,
                                              const __nv_bfloat16* __restrict__ w1t,
                                              const __nv_bfloat16* __restrict__ w2t) {
  for (int i = threadIdx.x; i < HP * (CP / 8); i += blockDim.x) {  // W1^T [HP][CP]
    const int r = i / (CP / 8), c = (i % (CP / 8)) * 8;
    *reinterpret_cast<uint4*>(w1s + size_t(c >> 6) * (HP * 128) + sw_off(r, c & 63)) =
        *reinterpret_cast<const uint4*>(w1t + size_t(r) * CP + c);
  }
  for (int i = threadIdx.x; i < CP * (HP / 8); i += blockDim.x) {  // W2^T [CP][HP]
    const int r = i / (HP / 8), c = (i % (HP / 8)) * 8;
    *reinterpret_cast<uint4*>(w2s + size_t(c >> 6) * (CP * 128) + sw_off(r, c & 63)) =
        *reinterpret_cast<const uint4*>(w2t + size_t(r) * HP + c);
  }
}

// Where chunk j's weights are: W1^T rows [64 j, 64 j + 64) start at w1 + row0
// * 128 in each of KP panels w1_stride apart; W2^T columns [64 j, 64 j + 64)
// are the panel at w2 (CP rows).
struct Chunk {
  const uint8_t* w1;
  uint32_t w1_stride;
  uint32_t row0;
  const uint8_t* w2;
};
__device__ __forceinline__ Chunk staged_chunk(const uint8_t* w1s, const uint8_t* w2s, int j) {
  return {w1s, uint32_t(HP * 128), uint32_t(j * HJ), w2s + size_t(j) * (CP * 128)};
}
__device__ __forceinline__ Chunk ring_chunk(const uint8_t* stage) {
  return {stage, uint32_t(HJ * 128), 0u, stage + size_t(KP) * (HJ * 128)};
}
// Issue the TMA loads of chunk j into a ring stage.
__device__ __forceinline__ void load_chunk(uint8_t* stage, uint64_t* bar, const CUtensorMap* w1map,
                                           const CUtensorMap* w2map, int j) {
  mbar_expect_tx(bar, uint32_t(CHUNK_BYTES));
#pragma unroll
  for (int p = 0; p < KP; ++p) tma_load(stage + size_t(p) * (HJ * 128), w1map, bar, 64 * p, HJ * j);
  tma_load(stage + size_t(KP) * (HJ * 128), w2map, bar, HJ * j, 0);
}

// B operands of chunk j, k-step kk (16 along K).
// x @ W1[:, j]: K = C, K-major rows h.
__device__ __forceinline__ uint64_t b_w1(const Chunk& ch, int kk) {
  return desc(ch.w1 + size_t(kk >> 2) * ch.w1_stride + ch.row0 * 128 + (kk & 3) * 32, 16, 1024);
}
// h_j @ W2[j, :]: K = 64 (the chunk), K-major rows c.
__device__ __forceinline__ uint64_t b_w2(const Chunk& ch, int kk) {
  return desc(ch.w2 + kk * 32, 16, 1024);
}
// dm @ W2^T[:, j]: K = C, MN-major (the chunk's 64 h columns are one panel).
__device__ __forceinline__ uint64_t b_w2t(const Chunk& ch, int kk) {
  return desc(ch.w2 + kk * 2048, CP * 128, 1024);
}
// dh_j @ W1^T[j, :]: K = 64 (the chunk's rows h), MN-major over KP panels.
__device__ __forceinline__ uint64_t b_w1t(const Chunk& ch, int kk) {
  return desc(ch.w1 + ch.row0 * 128 + kk * 2048, ch.w1_stride, 1024);
}
// A operand from a C-wide tile of KP panels, K-major, k-step kk.
__device__ __forceinline__ uint64_t a_tile(const uint8_t* tile, int kk) {
  return desc(tile + size_t(kk >> 2) * (BM * 128) + (kk & 3) * 32, 16, 1024);
}

// Packs an accumulator of N columns (values already final; rounded to bf16
// here) as the N / 16 k-steps' A registers of the next product.
template <int NV>
__device__ __forceinline__ void to_a_regs(const float (&v)[NV], uint32_t (&a)[NV / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NV / 8; ++kk) {
    a[kk][0] = pack_bf16(v[8 * kk + 0], v[8 * kk + 1]);
    a[kk][1] = pack_bf16(v[8 * kk + 2], v[8 * kk + 3]);
    a[kk][2] = pack_bf16(v[8 * kk + 4], v[8 * kk + 5]);
    a[kk][3] = pack_bf16(v[8 * kk + 6], v[8 * kk + 7]);
  }
}

// The LayerNorm output of one element, with explicit roundings so that every
// recomputation gives the same bits: (s - mu) * rstd * g + b.
__device__ __forceinline__ float ln_apply(float s, float mu, float rstd, float g, float b) {
  return __fmaf_rn(__fmul_rn(__fsub_rn(s, mu), rstd), g, b);
}

// Issue the TMA loads of a 64-row, C-wide tile (KP boxes) into `buf`.
__device__ __forceinline__ void load_tile(uint8_t* buf, const CUtensorMap* map, uint64_t* bar,
                                          long long tile) {
  mbar_expect_tx(bar, uint32_t(TILE_BYTES));
#pragma unroll
  for (int p = 0; p < KP; ++p) tma_load(buf + size_t(p) * (BM * 128), map, bar, 64 * p, int(tile * BM));
}
// Store a 64-row, C-wide tile from `buf` (rows past the end are dropped).
__device__ __forceinline__ void store_tile(const CUtensorMap* map, const uint8_t* buf, long long tile) {
#pragma unroll
  for (int p = 0; p < KP; ++p) tma_store(map, buf + size_t(p) * (BM * 128), 64 * p, int(tile * BM));
  tma_store_commit();
}

// The 1,024-byte aligned start of dynamic shared memory.
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// ---------------------------------------------------------------------------
// The forward tile routine: K1's kernel body (fused_mlp.cu) and K9's edge
// tail (fused_generator_hopper.cu), one persistent block an SM over 64-row
// tiles of [rows, C]
// ---------------------------------------------------------------------------
#if TAIL_FUSED
namespace ftile {

struct Params {
  const float* g1;
  const float* bl1;
  const float* b1;  // padded to HP
  const float* b2;
  const float* g2;
  const float* bl2;
  const __nv_bfloat16* w1t;  // W1^T [HP][CP]
  const __nv_bfloat16* w2t;  // W2^T [CP][HP]
  __nv_bfloat16* out;
  long long rows;
};

// Shared memory, bytes from the aligned base: [staged weights] [per
// warpgroup: s tile (mode B: and the x operand)] [per warpgroup: weight
// ring] [mbarriers].
constexpr size_t STAGED = 2 * W_BYTES;
constexpr size_t BUFS = kModeA ? TILE_BYTES : 2 * TILE_BYTES;
constexpr bool kStage = STAGED + NWG * BUFS + 256 + ALIGN_SLACK <= SMEM_MAX;
constexpr int RING = kStage ? 0 : ring_stages(NWG * BUFS);
constexpr int RINGS = RING > 0 ? RING : 1;  // RING as a divisor (unused when staged)
constexpr size_t OFF_BUFS = kStage ? STAGED : 0;
constexpr size_t OFF_RING = OFF_BUFS + NWG * BUFS;
constexpr size_t OFF_BAR = OFF_RING + size_t(NWG) * RING * CHUNK_BYTES;
constexpr int NBAR = NWG * (1 + RING);
constexpr size_t SMEM = OFF_BAR + size_t(NBAR) * 8 + ALIGN_SLACK;
static_assert(kStage || RING >= 1, "no room for the weight ring");
static_assert(SMEM <= SMEM_MAX, "shared memory over the limit");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// K1's output: the tile's rows of out [rows, C] (bf16), 16 bytes a store.
struct RowStore {
  __nv_bfloat16* out;
  long long rows;
  __device__ __forceinline__ void operator()(const uint32_t (&o)[JC], long long row, int,
                                             const Lane& ln) const {
    uint4 og[JC / 4];
    quad_transpose(o, og);  // 16-byte stores
    if (row < rows) {
#pragma unroll
      for (int g = 0; g < JC / 4; ++g) {
        const int c = 8 * (4 * g + ln.q);
        if (c_ok(c)) *reinterpret_cast<uint4*>(out + row * C + c) = og[g];
      }
    }
  }
};

// Every 64-row tile of s [rows, C] through
//     x = LN1(s); h = relu(round(x) W1 + b1); m = round(h) W2 + b2
//     out = round(LN2(x + m))                                (kRound false: K1)
//     out = round(LN2(round(round(x) + round(m))))           (kRound true: K9)
// and out(o, row, half, ln) for each of the thread's two rows (o: its
// columns of row ln.row(half) as packed bf16 pairs; every thread of the
// warpgroup calls it, half 0 then half 1).  K9's
// other rounding points are K1's: fc1's A operand is round(x) in both, and
// relu(round(z)) = round(relu(z)) is how h is rounded.  The persistent
// block's warpgroups take tiles blockIdx.x * NWG + wg, then every
// gridDim.x * NWG-th.
template <bool kRound, typename Out>
__device__ __forceinline__ void tail_fwd_tiles(const CUtensorMap* s_map, const CUtensorMap* w1_map,
                                               const CUtensorMap* w2_map, const Params& p,
                                               const Out& out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const int wg = threadIdx.x >> 7;
  const Lane ln(threadIdx.x & 127);
  const bool leader = ln.t == 0;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* full_s = bars + wg;
  uint64_t* ring_full = bars + NWG + wg * RING;
  uint8_t* s_buf = smem + OFF_BUFS + wg * BUFS;
  uint8_t* x_buf = kModeA ? s_buf : s_buf + TILE_BYTES;
  uint8_t* ring = smem + OFF_RING + size_t(wg) * RING * CHUNK_BYTES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NBAR; ++i) mbar_init(bars + i, 1);
    fence_barrier_init();
  }
  if constexpr (kStage) {
    stage_weights(smem, smem + W_BYTES, p.w1t, p.w2t);
    fence_proxy_async();
  }
  __syncthreads();

  const long long n_tiles = (p.rows + BM - 1) / BM;
  const long long stride = (long long)gridDim.x * NWG;
  const long long first = (long long)blockIdx.x * NWG + wg;
  const long long my_tiles = first < n_tiles ? (n_tiles - 1 - first) / stride + 1 : 0;
  const long long chunks = my_tiles * NJ;  // ring loads this warpgroup consumes
  if (leader && my_tiles > 0) {
    load_tile(s_buf, s_map, full_s, first);
    if constexpr (!kStage)
      for (int n = 0; n < RING && n < chunks; ++n)
        load_chunk(ring + size_t(n) * CHUNK_BYTES, ring_full + n, w1_map, w2_map, n % NJ);
  }

  uint32_t it = 0;
  long long n = 0;  // ring position
  for (long long tile = first; tile < n_tiles; tile += stride, ++it) {
    mbar_wait(full_s, it & 1);
    // ---- 1. s, LN1 statistics, the x operand
    float mu[2], rstd[2];
    uint32_t sp[JC][2];       // mode A: s as packed bf16 pairs
    uint32_t xa[CP / 16][4];  // mode A: round(x), the A operand of fc1
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
      row_stats(v, ln, mu, rstd);
      if constexpr (kModeA) {  // the buffer is free: bring the next tile
        wg_sync(1 + wg);
        if (leader && tile + stride < n_tiles) load_tile(s_buf, s_map, full_s, tile + stride);
      }
#pragma unroll
      for (int j = 0; j < JC; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = ln.col(j, e);
          const float g = c_ok(c) ? __ldg(p.g1 + c) : 0.0f;
          const float b = c_ok(c) ? __ldg(p.bl1 + c) : 0.0f;
#pragma unroll
          for (int half = 0; half < 2; ++half)
            v[4 * j + 2 * half + e] = ln_apply(v[4 * j + 2 * half + e], mu[half], rstd[half], g, b);
        }
      if constexpr (kModeA) {
        to_a_regs(v, xa);
      } else {
#pragma unroll
        for (int j = 0; j < JC; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<uint32_t*>(x_buf + tile_off(ln.row(half), j, ln.q)) =
                pack_bf16(v[4 * j + 2 * half], v[4 * j + 2 * half + 1]);
        fence_proxy_async();
        wg_sync(1 + wg);
      }
    }

    // ---- 2. the hidden in chunks of 64
    float acc2[CP / 2];
#pragma unroll
    for (int i = 0; i < CP / 2; ++i) acc2[i] = 0.0f;
    for (int j = 0; j < NJ; ++j, ++n) {
      Chunk ch;
      if constexpr (kStage) {
        ch = staged_chunk(smem, smem + W_BYTES, j);
      } else {
        mbar_wait(ring_full + n % RINGS, uint32_t(n / RINGS) & 1);
        ch = ring_chunk(ring + size_t(n % RINGS) * CHUNK_BYTES);
      }
      float acc1[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc1[i] = 0.0f;
      fence_regs(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CP / 16; ++kk) {
        if constexpr (kModeA)
          Mma<64>::rs<0>(acc1, xa[kk], b_w1(ch, kk));
        else
          Mma<64>::ss<0, 0>(acc1, a_tile(x_buf, kk), b_w1(ch, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc1);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float b = __ldg(p.b1 + j * HJ + ln.col(jj, e));
          acc1[4 * jj + e] = fmaxf(acc1[4 * jj + e] + b, 0.0f);
          acc1[4 * jj + 2 + e] = fmaxf(acc1[4 * jj + 2 + e] + b, 0.0f);
        }
      uint32_t ha[4][4];
      to_a_regs(acc1, ha);
      fence_regs(acc2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Mma<CP>::rs<0>(acc2, ha[kk], b_w2(ch, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc2);
      if constexpr (!kStage) {  // the stage is free: bring chunk n + RING
        wg_sync(1 + wg);
        if (leader && n + RING < chunks)
          load_chunk(ring + size_t(n % RINGS) * CHUNK_BYTES, ring_full + n % RINGS, w1_map,
                     w2_map, int((n + RING) % NJ));
      }
    }

    // ---- 3. out = LN2(x + (m + b2)), x rebuilt in f32 from s
    {
      float v[4 * JC];
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
            float sv;
            if constexpr (kModeA) {
              const float2 f = unpack_bf16(sp[j][half]);
              sv = e ? f.y : f.x;
            } else {
              const float2 f = unpack_bf16(*reinterpret_cast<const uint32_t*>(
                  s_buf + tile_off(ln.row(half), j, ln.q)));
              sv = e ? f.y : f.x;
            }
            const float x = ln_apply(sv, mu[half], rstd[half], g, b);
            const float m = acc2[4 * j + 2 * half + e] + b2;
            const float z = kRound ? round_bf16(round_bf16(x) + round_bf16(m)) : x + m;
            v[4 * j + 2 * half + e] = ok ? z : 0.0f;
          }
        }
      float mu2[2], rstd2[2];
      row_stats(v, ln, mu2, rstd2);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t o[JC];
#pragma unroll
        for (int j = 0; j < JC; ++j) {
          const int c = ln.col(j);
          const bool ok = c_ok(c);
          o[j] = pack_bf16(
              ln_apply(v[4 * j + 2 * half], mu2[half], rstd2[half], ok ? __ldg(p.g2 + c) : 0.0f,
                       ok ? __ldg(p.bl2 + c) : 0.0f),
              ln_apply(v[4 * j + 2 * half + 1], mu2[half], rstd2[half],
                       ok ? __ldg(p.g2 + c + 1) : 0.0f, ok ? __ldg(p.bl2 + c + 1) : 0.0f));
        }
        out(o, tile * BM + ln.row(half), half, ln);
      }
    }
    if constexpr (!kModeA) {  // s and x are done with: bring the next tile
      wg_sync(1 + wg);
      if (leader && tile + stride < n_tiles) load_tile(s_buf, s_map, full_s, tile + stride);
    }
  }
}

}  // namespace ftile
#endif  // TAIL_FUSED

}  // namespace hop
}  // namespace
