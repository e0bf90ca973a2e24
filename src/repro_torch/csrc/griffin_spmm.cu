// Griffin block-sparse GEMM (Sparse.B, and Sparse.AB with dual) for Hopper
// (sm_90a): C = A . W_pruned from the block-compacted weights.
//
// Replaces the TPU kernel src/repro/kernels/griffin_spmm/kernel.py
// (griffin_spmm_kernel, body _spmm_kernel): a Pallas grid of
// (m_tiles, n_tiles, max_cnt) whose k axis walks the compacted position,
// with kidx/cnt as scalar-prefetch operands and pl.when predicating the
// steps kc >= cnt[j] (and, dual, the all-zero A tiles).
//
// Operands: b_comp (max_cnt * bk, Npad) row-major, N tile j's kc-th live
// K block in rows [kc * bk, (kc + 1) * bk); kidx (n_tiles, max_cnt) int32
// source K-block ids; cnt (n_tiles,) int32 live blocks per tile.
//
// What bounds it on the card: on the serving path A is 4 (decode) to 32
// (prefill) rows and each weight matrix (2048 or 8192 on a side, about half
// of its 128x128 blocks live at 0.8 sparsity with 32-wide pruning units) is
// read once per call, so it is bound by device-memory bytes: the live
// b_comp blocks.  At M <= 32 the arithmetic is at most 64 FLOP per weight
// byte, under the card's ~295 FLOP/byte balance point.  The matrices are
// small (1-18 MB), so what the design must supply is enough loads in
// flight to cover memory latency.
//
// Design: one block of 256 threads per (4-row M tile, 32-column slice of an
// N tile).  The block's threads are 4 column groups (8 columns each, one
// 16-byte bf16 vector load per weight row) by 64 K groups: the live rows
// q = kc * bk + r of the tile (kc < cnt[j], read from device memory by the
// block — there is no scalar prefetch on the card, and dead steps never
// run) are dealt round-robin to the K groups, so each thread streams its
// share of b_comp with several independent loads in flight and no barrier.
// kidx[j, kc] picks the A column (the paper's AMUX); A is read straight from
// global memory (a few rows shared by every block, so they stay in cache),
// and A columns at or past the real K are masked (kidx counts padded K
// blocks), so activations are never padded.  At the end the 64 K-group
// partial sums meet in shared memory and are added in K-group order.  With
// dual a thread skips a weight row whose 4 A values are exact zeros — the
// TPU kernel's all-zero-tile skip at finer grain; the skipped products are
// zeros, so the result is unchanged.  fp32 inputs use fmaf (no TF32); bf16
// inputs are widened to fp32.  Every output's summation order depends only
// on bk, cnt and the constants here, never on M (gemm_tile.cuh).  wgmma,
// TMA and pipelining are later work.

#include "gemm_tile.cuh"

namespace griffin {

constexpr int kColGroups = 4;                     // x 8 columns = 32
constexpr int kCols = kColGroups * kVec;
constexpr int kKGroups = 64;
constexpr int kThreads = kColGroups * kKGroups;   // 256
constexpr int kRows = 4;                          // M rows per tile (grid.y)

template <typename T, bool DUAL, bool VEC>
__global__ void __launch_bounds__(kThreads)
    griffin_spmm_kernel(const T* __restrict__ A, const T* __restrict__ Bc,
                        const int* __restrict__ kidx,
                        const int* __restrict__ cnt, T* __restrict__ C,
                        int M, int K, int Npad, int bk, int bn, int max_cnt,
                        int64_t lda) {
  __shared__ float part[kKGroups][kRows][kCols];  // 32 KB
  const int t = threadIdx.x;
  const int cg = t % kColGroups, g = t / kColGroups;
  const int nsub = (bn + kCols - 1) / kCols;
  const int j = blockIdx.x / nsub;                      // N tile
  const int s0 = (blockIdx.x % nsub) * kCols;           // slice in tile
  const int c0 = s0 + cg * kVec;                        // thread's columns
  const int ncols = min(kVec, bn - c0);
  const int m0 = blockIdx.y * kRows;
  float acc[kRows][kVec];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[i][e] = 0.f;

  if (ncols > 0) {
    const int rows = cnt[j] * bk;                 // live compacted rows
    const int* kid = kidx + (int64_t)j * max_cnt;
    const T* bcol = Bc + (int64_t)j * bn + c0;
#pragma unroll 4
    for (int q = g; q < rows; q += kKGroups) {
      const int kc = q / bk;
      const int64_t col = (int64_t)kid[kc] * bk + (q - kc * bk);
      float a[kRows];
      bool any = false;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        a[i] = (m0 + i < M && col < K)
                   ? to_f32(A[(int64_t)(m0 + i) * lda + col])
                   : 0.f;
        any |= a[i] != 0.f;
      }
      if (DUAL && !any) continue;
      float b[kVec];
      if (VEC)
        load8(bcol + (int64_t)q * Npad, b);
      else
        load8_strided(bcol + (int64_t)q * Npad, 1, ncols, b);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[i][e] = fmaf(a[i], b[e], acc[i][e]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int e = 0; e < kVec; ++e) part[g][i][cg * kVec + e] = acc[i][e];
  __syncthreads();
  // the K groups' partial sums meet in K-group order
  for (int o = t; o < kRows * kCols; o += kThreads) {
    const int i = o / kCols, c = o % kCols;
    float sum = 0.f;
    for (int gg = 0; gg < kKGroups; ++gg) sum += part[gg][i][c];
    if (m0 + i < M && s0 + c < bn)
      C[(int64_t)(m0 + i) * Npad + (int64_t)j * bn + s0 + c] =
          from_f32<T>(sum);
  }
}

template <typename T, bool DUAL>
static void launch(const void* A, const void* Bc, const int* kidx,
                   const int* cnt, void* C, int M, int K, int Npad,
                   int n_tiles, int bk, int bn, int max_cnt, int64_t lda,
                   cudaStream_t s) {
  const int nsub = (bn + kCols - 1) / kCols;
  dim3 grid(n_tiles * nsub, (M + kRows - 1) / kRows);
  // vector loads need 16-byte aligned 8-column groups of b_comp
  const bool vec = aligned16(Bc) && bn % kVec == 0 && Npad % kVec == 0;
  if (vec)
    griffin_spmm_kernel<T, DUAL, true><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(A), static_cast<const T*>(Bc), kidx, cnt,
        static_cast<T*>(C), M, K, Npad, bk, bn, max_cnt, lda);
  else
    griffin_spmm_kernel<T, DUAL, false><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(A), static_cast<const T*>(Bc), kidx, cnt,
        static_cast<T*>(C), M, K, Npad, bk, bn, max_cnt, lda);
}

template <typename T>
static void dispatch(int dual, const void* A, const void* Bc,
                     const int* kidx, const int* cnt, void* C, int M, int K,
                     int Npad, int n_tiles, int bk, int bn, int max_cnt,
                     int64_t lda, cudaStream_t s) {
  if (dual)
    launch<T, true>(A, Bc, kidx, cnt, C, M, K, Npad, n_tiles, bk, bn,
                    max_cnt, lda, s);
  else
    launch<T, false>(A, Bc, kidx, cnt, C, M, K, Npad, n_tiles, bk, bn,
                     max_cnt, lda, s);
}

}  // namespace griffin

// A (M, K) with row stride lda and unit column stride (K = the real,
// unpadded contraction length); C (M, Npad) row-major, every column written.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int griffin_spmm(int dtype, int dual, const void* A,
                            const void* Bc, const void* kidx,
                            const void* cnt, void* C, int M, int K, int Npad,
                            int n_tiles, int bk, int bn, int max_cnt,
                            long long lda, void* stream) {
  if (M <= 0 || K <= 0 || n_tiles <= 0 || bk <= 0 || bn <= 0 ||
      max_cnt <= 0 || Npad != n_tiles * bn)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ki = static_cast<const int*>(kidx);
  const int* ct = static_cast<const int*>(cnt);
  if (dtype == griffin::kFloat32)
    griffin::dispatch<float>(dual, A, Bc, ki, ct, C, M, K, Npad, n_tiles, bk,
                             bn, max_cnt, lda, s);
  else if (dtype == griffin::kBFloat16)
    griffin::dispatch<__nv_bfloat16>(dual, A, Bc, ki, ct, C, M, K, Npad,
                                     n_tiles, bk, bn, max_cnt, lda, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
