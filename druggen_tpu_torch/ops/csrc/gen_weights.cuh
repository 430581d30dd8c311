// Where K9's kernels (fused_generator.cu, fused_generator_hopper.cu) find
// the Generator's packed parameters (ops/fused_generator.py _Packed): the
// matrices as W^T [pad16(out)][pad16(in)] in the stream type at wts +
// woff[id], the vectors as f32 holding stream-type values at vecs +
// voff[id], in the order of fused_generator.py's _MATS_* and _VECS_*
// tuples: the input MLPs, then each depth's, then the readouts.  mat and vec
// run on the device (woff, voff in device memory) and on the host (woff,
// voff in host memory: pointers for a launch's parameters).

#pragma once

namespace {
namespace genw {

constexpr int MAT_NF1 = 0, MAT_NF2 = 1, MAT_EF1 = 2, MAT_EF2 = 3, MAT_BLOCK = 4;
constexpr int MATS_PER_BLOCK = 10;
enum BlockMat { W_Q, W_K, W_V, W_E, W_OE, W_ON, W_M1, W_M2, W_P1, W_P2 };
constexpr int VEC_NF1 = 0, VEC_NF2 = 1, VEC_EF1 = 2, VEC_EF2 = 3, VEC_BLOCK = 4;
constexpr int VECS_PER_BLOCK = 20;
enum BlockVec { V_LN1S, V_LN1B, V_Q, V_K, V_V, V_E, V_OE, V_ON, V_LN3S, V_LN3B, V_LN4S, V_LN4B,
                V_M1, V_M2, V_LN5S, V_LN5B, V_P1, V_P2, V_LN6S, V_LN6B };

struct Weights {
  const void* wts;
  const float* vecs;
  const long long* woff;
  const long long* voff;
};

template <typename T>
__host__ __device__ __forceinline__ const T* mat(const Weights& w, int id) {
  return static_cast<const T*>(w.wts) + w.woff[id];
}
__host__ __device__ __forceinline__ const float* vec(const Weights& w, int id) {
  return w.vecs + w.voff[id];
}
// Depth d's block matrix m and vector v; the readouts after the last depth.
__host__ __device__ constexpr int block_mat(int d, int m) {
  return MAT_BLOCK + MATS_PER_BLOCK * d + m;
}
__host__ __device__ constexpr int block_vec(int d, int v) {
  return VEC_BLOCK + VECS_PER_BLOCK * d + v;
}
__host__ __device__ constexpr int readout_mat(int depth, int edge) {
  return block_mat(depth, edge);
}
__host__ __device__ constexpr int readout_vec(int depth, int edge) {
  return block_vec(depth, edge);
}

}  // namespace genw
}  // namespace
