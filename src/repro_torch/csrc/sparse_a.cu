// Sparse.A GEMM for Hopper (sm_90a): C = A . B with dense B, visiting per
// M tile only the K blocks its activations keep live.  fp32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/sparse_a/kernel.py
// (sparse_a_gemm_kernel, body _sparse_a_kernel): a Pallas grid of
// (m_tiles, n_tiles, max_cnt) whose k axis walks the compacted position,
// with kidx/cnt as scalar-prefetch operands that pick both the A tile
// (i, kidx[i, kc]) and the B tile (kidx[i, kc], j), and pl.when
// predicating the steps kc >= cnt[i].
//
// Operands: A (M, K) with row stride lda and unit column stride; B (K, N)
// with element (k, n) at B[k * sbk + n * sbn] — row-major weights, or the
// tied unembedding's view embed.T, read in place; kidx (m_tiles, max_cnt)
// int32, per M tile of bm rows its visited K-block ids (blocks of bk), in
// ascending order; cnt (m_tiles,) int32.  Ids outside [0, K / bk) and
// counts past max_cnt are ignored rather than read out of bounds.
//
// What bounds it on the card: on the serving path A is 1 to 32 rows, so
// the GEMM is bound by device-memory bytes — the B rows of the visited K
// blocks, read once: 33.5 MB for w_gate/w_up/w_down (10 us at 3.35 TB/s)
// and 525 MB for the unembedding (0.157 ms).  At M <= 32 it does at most 32
// FLOP per weight byte, far under the card's ~295 FLOP/byte balance point.
// What the design must supply is enough loads in flight.
//
// Design.  The TPU's sequential max_cnt grid axis becomes a loop inside the
// block: the block reads cnt[i] and kidx[i, :] itself (there is no scalar
// prefetch on the card) and loops kc < cnt[i], so dead steps never run.
// Ragged M, N and K edges are masked, nothing is padded.  fp32 inputs use
// fmaf (no TF32); bf16 inputs are widened to fp32.  Two layouts of B:
//
//  * rows kernel (B row-major, and any other strides with scalar loads):
//    one block of 256 threads per (4-row group of an M tile, 32-column
//    slice): 4 column groups (8 columns, one 16-byte bf16 load per B row)
//    by 64 K groups; the K groups' partial sums meet in shared memory at
//    the end, added in K-group order.
//  * k-major kernel (B k-contiguous: embed.T, as in dense_gemm.cu): a
//    half-warp per 4 output columns, its 16 lanes each taking 8-element k
//    chunks in 16-byte loads; the lanes meet in a fixed xor butterfly.
//
// Batch invariance.  kidx depends on the data: the engine's 4-row tile
// visits the union of its rows' live blocks, a 1-row call only its own.
// The extra products are exact zeros, which leave a running fp32 sum
// unchanged — provided each partial sum takes its terms in an order fixed
// by their absolute k.  So work is split by absolute k, never by compacted
// position: row k of block kb goes to K group (k - kb * bk) % 64 (rows
// kernel) and chunk k / 8 to lane (k - kb * bk) / 8 % 16 (k-major kernel),
// each walks its terms in ascending k, and the groups meet in a fixed
// order.  (griffin_spmm.cu deals compacted rows round-robin; that is fine
// for its weight-fixed kidx but would break here.)  An output's bits thus
// depend on K, bk, the layout of B and the constants here, never on M or
// on the other rows.  wgmma, TMA and pipelining are later work.

#include "gemm_tile.cuh"

namespace griffin {

constexpr int kRows = 4;                          // rows per block

// rows kernel
constexpr int kColGroups = 4;                     // x 8 columns = 32
constexpr int kCols = kColGroups * kVec;
constexpr int kKGroups = 64;
constexpr int kThreads = kColGroups * kKGroups;   // 256

// k-major kernel
constexpr int kLanes = 16;                        // lanes per column set
constexpr int kHalfCols = 4;                      // columns per half-warp
constexpr int kWarps = 8;
constexpr int kBlockCols = kWarps * 2 * kHalfCols;  // 64

// The block's M tile, its first row and its row count (<= 0: no rows).
struct RowGroup {
  int tile, m0, rows;
  __device__ RowGroup(int M, int bm, int row_groups) {
    tile = blockIdx.y / row_groups;
    const int r0 = (blockIdx.y % row_groups) * kRows;
    m0 = tile * bm + r0;
    rows = min(kRows, min(bm - r0, M - m0));
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    sparse_a_rows_kernel(const T* __restrict__ A, const T* __restrict__ B,
                         const int* __restrict__ kidx,
                         const int* __restrict__ cnt, T* __restrict__ C,
                         int M, int N, int K, int bm, int bk, int max_cnt,
                         int row_groups, int64_t lda, int64_t sbk,
                         int64_t sbn, int64_t ldc) {
  __shared__ float part[kKGroups][kRows][kCols];  // 32 KB
  const RowGroup rg(M, bm, row_groups);
  if (rg.rows <= 0) return;                       // whole block
  const int t = threadIdx.x;
  const int cg = t % kColGroups, g = t / kColGroups;
  const int s0 = blockIdx.x * kCols;
  const int n0 = s0 + cg * kVec;
  const int ncols = min(kVec, N - n0);
  float acc[kRows][kVec];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[i][e] = 0.f;

  if (ncols > 0 && g < bk) {
    // K group g takes rows g, g + 64, ... of every visited block
    const int per = (bk - g + kKGroups - 1) / kKGroups;
    const int steps = min(cnt[rg.tile], max_cnt) * per;
    const int* kid = kidx + (int64_t)rg.tile * max_cnt;
#pragma unroll 4
    for (int q = 0; q < steps; ++q) {
      const int kc = q / per;
      const int64_t k =
          (int64_t)kid[kc] * bk + g + (int64_t)(q - kc * per) * kKGroups;
      if (k < 0 || k >= K) continue;
      float a[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        a[i] = i < rg.rows ? to_f32(A[(int64_t)(rg.m0 + i) * lda + k]) : 0.f;
      float b[kVec];
      const T* pb = B + k * sbk + (int64_t)n0 * sbn;
      if (VEC)
        load8(pb, b);
      else
        load8_strided(pb, sbn, ncols, b);
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
    if (i < rg.rows && s0 + c < N)
      C[(int64_t)(rg.m0 + i) * ldc + s0 + c] = from_f32<T>(sum);
  }
}

template <typename T, bool VEC_A>
__global__ void __launch_bounds__(kWarps * 32)
    sparse_a_kmajor_kernel(const T* __restrict__ A, const T* __restrict__ B,
                           const int* __restrict__ kidx,
                           const int* __restrict__ cnt, T* __restrict__ C,
                           int M, int N, int K, int bm, int bk, int max_cnt,
                           int row_groups, int64_t lda, int64_t sbn,
                           int64_t ldc) {
  const RowGroup rg(M, bm, row_groups);
  if (rg.rows <= 0) return;                       // whole block
  const int lane = threadIdx.x & 31;
  const int l = lane % kLanes;
  const int n0 =
      (blockIdx.x * kWarps * 2 + (threadIdx.x >> 5) * 2 + lane / kLanes) *
      kHalfCols;
  float acc[kRows][kHalfCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kHalfCols; ++c) acc[i][c] = 0.f;

  const int chunks = bk / kVec;                   // bk % 8 == 0 here
  if (l < chunks) {
    // lane l takes chunks l, l + 16, ... of every visited block
    const int per = (chunks - l + kLanes - 1) / kLanes;
    const int steps = min(cnt[rg.tile], max_cnt) * per;
    const int* kid = kidx + (int64_t)rg.tile * max_cnt;
#pragma unroll 2
    for (int q = 0; q < steps; ++q) {
      const int kc = q / per;
      const int64_t k0 = (int64_t)kid[kc] * bk +
                         (int64_t)(l + (q - kc * per) * kLanes) * kVec;
      if (k0 < 0 || k0 >= K) continue;            // K % 8 == 0: whole chunk
      float a[kRows][kVec];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const T* pa = A + (int64_t)(rg.m0 + i) * lda + k0;
        if (i >= rg.rows)
          load8_strided(pa, 1, 0, a[i]);
        else if (VEC_A)
          load8(pa, a[i]);
        else
          load8_strided(pa, 1, kVec, a[i]);
      }
#pragma unroll
      for (int c = 0; c < kHalfCols; ++c) {
        float b[kVec];
        if (n0 + c < N)
          load8(B + (int64_t)(n0 + c) * sbn + k0, b);
        else
          load8_strided(B, 1, 0, b);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            acc[i][c] = fmaf(a[i][e], b[e], acc[i][c]);
      }
    }
  }
  // fixed butterfly inside each half-warp; every lane of the warp takes
  // part, so the full mask is valid
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kHalfCols; ++c)
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], off);
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kHalfCols; ++c)
      if (l == i * kHalfCols + c && i < rg.rows && n0 + c < N)
        C[(int64_t)(rg.m0 + i) * ldc + n0 + c] = from_f32<T>(acc[i][c]);
}

template <typename T>
static int launch(const void* A, const void* B, const int* kidx,
                  const int* cnt, void* C, int M, int N, int K, int bm,
                  int bk, int m_tiles, int max_cnt, int64_t lda, int64_t sbk,
                  int64_t sbn, int64_t ldc, cudaStream_t s) {
  const int row_groups = (bm + kRows - 1) / kRows;
  if ((int64_t)m_tiles * row_groups > 65535) return (int)cudaErrorInvalidValue;
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  T* c = static_cast<T*>(C);
  const size_t esz = sizeof(T);
  // k-major: B k-contiguous with 16-byte aligned rows, whole 8-wide chunks
  const bool kmajor = sbk == 1 && bk % kVec == 0 && K % kVec == 0 &&
                      aligned16(B) && (sbn * esz) % 16 == 0;
  if (kmajor) {
    dim3 grid((N + kBlockCols - 1) / kBlockCols, m_tiles * row_groups);
    if (aligned16(A) && (lda * esz) % 16 == 0)
      sparse_a_kmajor_kernel<T, true><<<grid, kWarps * 32, 0, s>>>(
          a, b, kidx, cnt, c, M, N, K, bm, bk, max_cnt, row_groups, lda, sbn,
          ldc);
    else
      sparse_a_kmajor_kernel<T, false><<<grid, kWarps * 32, 0, s>>>(
          a, b, kidx, cnt, c, M, N, K, bm, bk, max_cnt, row_groups, lda, sbn,
          ldc);
    return (int)cudaGetLastError();
  }
  dim3 grid((N + kCols - 1) / kCols, m_tiles * row_groups);
  // vector loads need n-contiguous, 16-byte aligned 8-column groups of B
  if (sbn == 1 && N % kVec == 0 && aligned16(B) && (sbk * esz) % 16 == 0)
    sparse_a_rows_kernel<T, true><<<grid, kThreads, 0, s>>>(
        a, b, kidx, cnt, c, M, N, K, bm, bk, max_cnt, row_groups, lda, sbk,
        sbn, ldc);
  else
    sparse_a_rows_kernel<T, false><<<grid, kThreads, 0, s>>>(
        a, b, kidx, cnt, c, M, N, K, bm, bk, max_cnt, row_groups, lda, sbk,
        sbn, ldc);
  return (int)cudaGetLastError();
}

}  // namespace griffin

// C (M, N) with row stride ldc.  Returns the cudaError_t of the launch
// (0 = cudaSuccess).
extern "C" int sparse_a_gemm(int dtype, const void* A, const void* B,
                             const void* kidx, const void* cnt, void* C,
                             int M, int N, int K, int bm, int bk, int m_tiles,
                             int max_cnt, long long lda, long long sbk,
                             long long sbn, long long ldc, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bk <= 0 || max_cnt <= 0 ||
      (int64_t)m_tiles * bm < M)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ki = static_cast<const int*>(kidx);
  const int* ct = static_cast<const int*>(cnt);
  if (dtype == griffin::kFloat32)
    return griffin::launch<float>(A, B, ki, ct, C, M, N, K, bm, bk, m_tiles,
                                  max_cnt, lda, sbk, sbn, ldc, s);
  if (dtype == griffin::kBFloat16)
    return griffin::launch<__nv_bfloat16>(A, B, ki, ct, C, M, N, K, bm, bk,
                                          m_tiles, max_cnt, lda, sbk, sbn,
                                          ldc, s);
  return (int)cudaErrorInvalidValue;
}
