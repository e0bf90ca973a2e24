// Dense GEMM C = A . B for Hopper (sm_90a), fp32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/dense_gemm/kernel.py
// (dense_matmul_kernel, body _matmul_kernel): a Pallas grid of
// (M/bm, N/bn, K/bk) steps accumulating into a VMEM scratch tile.
//
// What bounds it on the card: on the serving path it is the tied
// unembedding, A (4 or 1, 2048) against B = embed.T (2048, 128256).  It
// reads 525 MB of bf16 weights for 2 MFLOP per row, so it is bound by
// device-memory bytes (0.157 ms at 3.35 TB/s), never by arithmetic.
//
// Design: B is addressed through its two strides, so embed.T is read in
// place as the (N, K) row-major embedding — one contiguous K row per output
// column, no per-call copy of 525 MB.  Each warp owns 4 output columns and
// a 4-row M tile (grid.y walks the M tiles); its 32 lanes stride along K in
// 8-element vector loads (16 bytes of bf16), every lane keeping several
// independent loads in flight, and the lanes' partial sums meet in a fixed
// xor-shuffle butterfly.  The Pallas K grid axis becomes this loop; there is
// no shared memory and no barrier.  A is read straight from global memory
// (the same few rows for every warp, so they stay in L1).  Ragged K and M
// are masked; layouts that are not k-contiguous and 16-byte aligned take the
// same loop with scalar strided loads.  Inputs are widened to fp32 and
// multiplied with fmaf (no TF32, no tensor cores).  An output's summation
// order — lane-local in ascending k, then the butterfly — depends on K only,
// so rows are batch-invariant (gemm_tile.cuh).  wgmma/TMA are later work.

#include "gemm_tile.cuh"

namespace griffin {

constexpr int kWarps = 8;          // warps per block
constexpr int kColsPerWarp = 4;    // output columns per warp
constexpr int kRows = 4;           // M rows per tile (grid.y)

template <typename T, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
    dense_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                      T* __restrict__ C, int M, int N, int K, int64_t lda,
                      int64_t sbk, int64_t sbn, int64_t ldc) {
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kColsPerWarp;
  const int m0 = blockIdx.y * kRows;
  if (n0 >= N) return;  // whole warp: no shuffle partner is lost
  float acc[kRows][kColsPerWarp];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c) acc[i][c] = 0.f;

#pragma unroll 2
  for (int k0 = lane * kVec; k0 < K; k0 += 32 * kVec) {
    float a[kRows][kVec];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const T* pa = A + (int64_t)(m0 + i) * lda + k0;
      if (m0 + i >= M)
        load8_strided(pa, 1, 0, a[i]);
      else if (VEC)
        load8(pa, a[i]);
      else
        load8_strided(pa, 1, K - k0, a[i]);
    }
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c) {
      const T* pb = B + (int64_t)(n0 + c) * sbn + (int64_t)k0 * sbk;
      float b[kVec];
      if (n0 + c >= N)
        load8_strided(pb, sbk, 0, b);
      else if (VEC)
        load8(pb, b);
      else
        load8_strided(pb, sbk, K - k0, b);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[i][c] = fmaf(a[i][e], b[e], acc[i][c]);
    }
  }
  // fixed butterfly: every lane ends with the same total (a + b == b + a)
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], off);
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c)
      if (lane == i * kColsPerWarp + c && m0 + i < M && n0 + c < N)
        C[(int64_t)(m0 + i) * ldc + n0 + c] = from_f32<T>(acc[i][c]);
}

template <typename T>
static void launch(const void* A, const void* B, void* C, int M, int N, int K,
                   int64_t lda, int64_t sbk, int64_t sbn, int64_t ldc,
                   cudaStream_t s) {
  const int cols = kWarps * kColsPerWarp;
  dim3 grid((N + cols - 1) / cols, (M + kRows - 1) / kRows);
  // vector loads need k-contiguous, 16-byte aligned rows of A and B
  const bool vec = sbk == 1 && K % kVec == 0 && aligned16(A) &&
                   aligned16(B) && (lda * sizeof(T)) % 16 == 0 &&
                   (sbn * sizeof(T)) % 16 == 0;
  if (vec)
    dense_gemm_kernel<T, true><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const T*>(A), static_cast<const T*>(B),
        static_cast<T*>(C), M, N, K, lda, sbk, sbn, ldc);
  else
    dense_gemm_kernel<T, false><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const T*>(A), static_cast<const T*>(B),
        static_cast<T*>(C), M, N, K, lda, sbk, sbn, ldc);
}

}  // namespace griffin

// C (M, N) row-major with row stride ldc; A (M, K) with row stride lda and
// unit column stride; B (K, N) element (k, n) at B[k * sbk + n * sbn].
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int dense_gemm(int dtype, const void* A, const void* B, void* C,
                          int M, int N, int K, long long lda, long long sbk,
                          long long sbn, long long ldc, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == griffin::kFloat32)
    griffin::launch<float>(A, B, C, M, N, K, lda, sbk, sbn, ldc, s);
  else if (dtype == griffin::kBFloat16)
    griffin::launch<__nv_bfloat16>(A, B, C, M, N, K, lda, sbk, sbn, ldc, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
