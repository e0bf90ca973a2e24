// Shared pieces of the port's hand-written GEMM kernels (dense_gemm.cu,
// griffin_spmm.cu, sparse_a.cu): type conversion, 8-wide loads widened to
// fp32, and the tensor-core tile's building blocks (XOR swizzle, cp.async,
// ldmatrix, mma.sync) that griffin_spmm.cu and sparse_a.cu share.
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
// never changes a value.  sparse_a's bf16 route sums the same way, except
// that rank r owns the absolute K blocks [r KB / S, (r + 1) KB / S) and
// walks those of them its M tile lists live, ascending: a block listed
// only because another row of the tile needs it adds exact zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace griffin {

// dtype codes of the C interface (the Python wrappers pass them): A, the
// weight and C all fp32 or all bf16, or A and C fp32 against a bf16 weight
// (products of the widened values on CUDA cores)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kFloat32BFloat16 = 2;

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

// ---------------------------------------------------------------------------
// tensor-core tile building blocks (griffin_spmm.cu, sparse_a.cu)
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;         // warps of a tensor-core block
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kPass = 32;          // M rows per pass (grid.y)
constexpr int kMaxSplits = 8;      // the portable cluster size
constexpr int kMaxSmem = 232448;   // a block's shared memory on sm_90

// Offset (elements) of 16-byte piece v of row r in a shared-memory row of
// n 16-byte pieces (n = 2, 4 or 8; log2 n = n_log): pieces are XOR-swizzled
// by row, so the 8 rows an ldmatrix phase reads hit 8 distinct bank groups
__device__ __forceinline__ int swizzle(int r, int v, int n, int n_log) {
  return (v ^ ((r >> (3 - n_log)) & (n - 1))) * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 4-byte async copy (metadata)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// 16-byte async copy; bytes < 16 zero-fills the rest (0: all zeros)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16x16, row) . b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace griffin
