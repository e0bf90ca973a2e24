// Shared pieces of the port's hand-written GEMM kernels (dense_gemm.cu,
// griffin_spmm.cu, sparse_a.cu): type conversion and 8-wide loads widened
// to fp32.
//
// Batch invariance: in every kernel the order in which an output element's
// K products are summed is a fixed function of K, the weights' layout and
// the kernel's constants — never of M, of how M is tiled or of the other
// rows.  So a row computes the same bits whether it is decoded alone or
// beside other rows, which the serving engine's token parity with its
// batch-1 oracle rests on.  griffin_spmm's bf16 route sums, for each
// output: within each 16-deep K slice, the tensor core's own fixed order
// for that row; slices into one fp32 accumulator per warp, warp w taking
// slices w, w + 4, ... of each 64-row chunk in ascending chunk order; the 4
// warps' accumulators as ((w0 + w1) + w2) + w3; then the cluster ranks'
// partials in rank order 0..S-1.  Which chunks a rank owns follows from
// cnt and the split plan, a function of the weight's shape alone.  A chunk
// skipped because its A is all zero adds only exact zeros, so skipping
// never changes a value.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace griffin {

// dtype codes of the C interface (the Python wrappers pass them)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// elements per vector load: 16 bytes of bf16, 32 bytes of fp32
constexpr int kVec = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// v[0..7] = p[0..7]; p must be 16-byte aligned.
__device__ __forceinline__ void load8(const float* __restrict__ p,
                                      float (&v)[kVec]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p,
                                      float (&v)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// v[e] = p[e * stride] for e < n, else 0 (the unaligned / ragged path).
template <typename T>
__device__ __forceinline__ void load8_strided(const T* __restrict__ p,
                                              int64_t stride, int n,
                                              float (&v)[kVec]) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) v[e] = e < n ? to_f32(p[e * stride]) : 0.f;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace griffin
