// Dense GEMM C = A . B for Hopper (sm_90a), fp32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/dense_gemm/kernel.py
// (dense_matmul_kernel, body _matmul_kernel): a Pallas grid of
// (M/bm, N/bn, K/bk) steps accumulating into a VMEM scratch tile.
//
// Operands: A (M, K) with row stride lda and unit column stride; B (K, N)
// with element (k, n) at B[k * sbk + n * sbn]; C (M, N) in A's dtype.  A
// and B are both fp32, both bf16, or A fp32 against a bf16 B (the mLSTM
// block feeds its fp32 product to w_down, as the reference does); inputs
// are widened to fp32 and multiplied with fmaf (no TF32, no tensor cores).
//
// Two routes, chosen by kernel.py from N alone (never from M or the data):
//
//  * wide route (N > 8).  On the serving path this is the tied
//    unembedding, A (4 or 1, 2048) against B = embed.T (2048, 128256): it
//    reads 525 MB of bf16 weights for 2 MFLOP per row, so it is bound by
//    device-memory bytes (0.157 ms at 3.35 TB/s), never by arithmetic.  B
//    is addressed through its two strides, so embed.T is read in place as
//    the (N, K) row-major embedding — one contiguous K row per output
//    column, no per-call copy of 525 MB.  Each warp owns 4 output columns
//    and a 4-row M tile (grid.y walks the M tiles); its 32 lanes stride
//    along K in 8-element vector loads (16 bytes of bf16), every lane
//    keeping several independent loads in flight, and the lanes' partial
//    sums meet in a fixed xor-shuffle butterfly.  Ragged K and M are
//    masked; layouts that are not k-contiguous and 16-byte aligned take the
//    same loop with scalar strided loads.
//
//  * skinny route (N <= 8: xlstm's (4096, 4) gate leaves).  The wide
//    route's grid would be one block of one live warp per 4-row M tile,
//    walking all of K alone through scalar strided loads of a row-major B.
//    Here the work is 64 KB (A and B, bf16, M 4): bound by one launch and
//    one round trip to device memory, not by bytes (0.02 us at 3.35 TB/s).
//    So the design puts every load of a call in flight at once:
//     - K is cut into 8-row chunks and the chunks into S slices of
//       consecutive chunks, slice r owning [r C / S, (r + 1) C / S) of the
//       C = ceil(K / 8) chunks; S (a power of two up to 8) comes from K
//       alone (kernel.py skinny_slices: the least that leaves a slice no
//       more chunks than a block has threads).  One block per (slice,
//       4-row M tile); its 128 threads take the slice's chunks t, t + 128,
//       ..., so at K 4096 (S 4) every thread loads one chunk and the whole
//       call is one wave of independent loads.
//     - B's chunk is loaded as 16-byte vectors: for a row-major B the 8
//       rows x N columns are 16 N contiguous bytes (bf16), 2 rows x 4
//       columns a vector at N 4; for a k-major B one vector per column.
//       A's rows of the chunk are one 16-byte vector (bf16) each.  The
//       ragged last chunk of K, and strides that are not 16-byte aligned,
//       take scalar loads.
//     - The S blocks of an M tile are a thread block cluster: each block
//       sums its threads (lane butterfly, then warps in order 0..3) into a
//       partial tile in shared memory, and the cluster's partial tiles
//       meet through distributed shared memory in slice order 0..S-1, each
//       output summed and stored by one block.  One launch, no workspace,
//       no atomics and no ticket to reset (why a cluster and not a last-
//       block ticket over an fp32 workspace: the partials never leave the
//       chip, and no state outlives a launch).
//
// Batch invariance (gemm_tile.cuh): an output's summation order is, on the
// wide route, lane-local in ascending k then the butterfly; on the skinny
// route, thread-local over its chunks in ascending k, then the butterfly,
// the warps in order and the slices in order.  Both depend on K (and the
// route, a function of N) only, never on M or the other rows.
// wgmma/TMA are later work.

#include <cooperative_groups.h>

#include "gemm_tile.cuh"

namespace griffin {

namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// wide route
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;          // warps per block
constexpr int kColsPerWarp = 4;    // output columns per warp
constexpr int kRows = 4;           // M rows per tile (grid.y), both routes

template <typename TA, typename TB, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
    dense_gemm_kernel(const TA* __restrict__ A, const TB* __restrict__ B,
                      TA* __restrict__ C, int M, int N, int K, int64_t lda,
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
      const TA* pa = A + (int64_t)(m0 + i) * lda + k0;
      if (m0 + i >= M)
        load8_strided(pa, 1, 0, a[i]);
      else if (VEC)
        load8(pa, a[i]);
      else
        load8_strided(pa, 1, K - k0, a[i]);
    }
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c) {
      const TB* pb = B + (int64_t)(n0 + c) * sbn + (int64_t)k0 * sbk;
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
        C[(int64_t)(m0 + i) * ldc + n0 + c] = from_f32<TA>(acc[i][c]);
}

template <typename TA, typename TB>
static cudaError_t launch_wide(const void* A, const void* B, void* C, int M,
                               int N, int K, int64_t lda, int64_t sbk,
                               int64_t sbn, int64_t ldc, cudaStream_t s) {
  const int cols = kWarps * kColsPerWarp;
  dim3 grid((N + cols - 1) / cols, (M + kRows - 1) / kRows);
  // vector loads need k-contiguous, 16-byte aligned rows of A and B
  const bool vec = sbk == 1 && K % kVec == 0 && aligned16(A) &&
                   aligned16(B) && (lda * sizeof(TA)) % 16 == 0 &&
                   (sbn * sizeof(TB)) % 16 == 0;
  if (vec)
    dense_gemm_kernel<TA, TB, true><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const TA*>(A), static_cast<const TB*>(B),
        static_cast<TA*>(C), M, N, K, lda, sbk, sbn, ldc);
  else
    dense_gemm_kernel<TA, TB, false><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const TA*>(A), static_cast<const TB*>(B),
        static_cast<TA*>(C), M, N, K, lda, sbk, sbn, ldc);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// skinny route
// ---------------------------------------------------------------------------

constexpr int kSkinnyThreads = 128;
constexpr int kSkinnyWarps = kSkinnyThreads / 32;
constexpr int kMaxN = 8;           // widest output of the route
constexpr int kMaxSlices = 8;      // the portable cluster size
constexpr int kChunk = kVec;       // K rows a thread takes per step

// how a chunk of B is loaded: 16-byte vectors of a row-major B (its 8
// rows x N columns contiguous), one 16-byte vector per column of a
// k-major B, or scalar loads of any other strides
constexpr int kLayoutRows = 0;
constexpr int kLayoutKMajor = 1;
constexpr int kLayoutStrided = 2;

struct SkinnyArgs {
  const void* A;
  const void* B;
  void* C;
  int M, N, K;
  int64_t lda, sbk, sbn, ldc;
  int slices;                      // S: the cluster's blocks along K
  int layout;                      // of B
  int vec_a;                       // A's rows 16-byte aligned
};

// w[e][n] = B[k0 + e, n] for e < kn, else 0
template <typename TB, int N>
__device__ __forceinline__ void load_b_chunk(const SkinnyArgs& p,
                                             const TB* __restrict__ B,
                                             int k0, int kn,
                                             float (&w)[kChunk][N]) {
  if (kn == kChunk && p.layout == kLayoutRows) {
    const TB* src = B + (int64_t)k0 * N;      // 8 N contiguous elements
#pragma unroll
    for (int v = 0; v < N; ++v) {
      float f[kVec];
      load8(src + v * kVec, f);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        w[(v * kVec + j) / N][(v * kVec + j) % N] = f[j];
    }
  } else if (kn == kChunk && p.layout == kLayoutKMajor) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float f[kVec];
      load8(B + (int64_t)n * p.sbn + k0, f);
#pragma unroll
      for (int e = 0; e < kChunk; ++e) w[e][n] = f[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
#pragma unroll
      for (int n = 0; n < N; ++n)
        w[e][n] = e < kn ? to_f32(B[(int64_t)(k0 + e) * p.sbk +
                                    (int64_t)n * p.sbn])
                         : 0.f;
  }
}

template <typename TA, typename TB, int N>
__global__ void __launch_bounds__(kSkinnyThreads)
    dense_skinny_kernel(SkinnyArgs p) {
  constexpr int E = kRows * N;     // outputs of a block, <= 32
  __shared__ float warp_part[kSkinnyWarps][E];
  __shared__ float part[E];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = p.slices;
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kRows;
  const int rows = min(kRows, p.M - m0);
  const int chunks = (p.K + kChunk - 1) / kChunk;
  const int lo = static_cast<int>(static_cast<int64_t>(rank) * chunks / S);
  const int hi =
      static_cast<int>(static_cast<int64_t>(rank + 1) * chunks / S);
  const TA* A = static_cast<const TA*>(p.A) + (int64_t)m0 * p.lda;
  const TB* B = static_cast<const TB*>(p.B);

  float acc[kRows][N];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n) acc[i][n] = 0.f;

  // thread t walks chunks lo + t, lo + t + 128, ... of its slice, each in
  // ascending k; the loads of two steps are independent of each other
#pragma unroll 2
  for (int c = lo + tid; c < hi; c += kSkinnyThreads) {
    const int k0 = c * kChunk;
    const int kn = min(kChunk, p.K - k0);
    float w[kChunk][N];
    load_b_chunk<TB, N>(p, B, k0, kn, w);
    float a[kRows][kChunk];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const TA* pa = A + (int64_t)i * p.lda + k0;
      if (i >= rows)
        load8_strided(pa, 1, 0, a[i]);
      else if (p.vec_a && kn == kChunk)
        load8(pa, a[i]);
      else
        load8_strided(pa, 1, kn, a[i]);
    }
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int n = 0; n < N; ++n)
          acc[i][n] = fmaf(a[i][e], w[e][n], acc[i][n]);
  }

  // lanes meet in a fixed butterfly, then the warps in order 0..3
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[i][n] += __shfl_xor_sync(0xffffffffu, acc[i][n], off);
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n)
      if (lane == i * N + n) warp_part[warp][i * N + n] = acc[i][n];
  __syncthreads();
  if (tid < E) {
    float sum = warp_part[0][tid];
#pragma unroll
    for (int w = 1; w < kSkinnyWarps; ++w) sum += warp_part[w][tid];
    part[tid] = sum;
  }

  // the cluster's partial tiles meet in slice order 0..S-1; block r sums
  // and stores its share [r E / S, (r + 1) E / S) of the outputs
  cluster.sync();
  TA* C = static_cast<TA*>(p.C);
  for (int e = rank * E / S + tid; e < (rank + 1) * E / S;
       e += kSkinnyThreads) {
    float v[kMaxSlices];           // all loads in flight, then the sum
#pragma unroll
    for (int q = 0; q < kMaxSlices; ++q)
      v[q] = q < S ? cluster.map_shared_rank(part, q)[e] : 0.f;
    float sum = v[0];
#pragma unroll
    for (int q = 1; q < kMaxSlices; ++q)
      if (q < S) sum += v[q];
    const int i = e / N;
    if (i < rows)
      C[(int64_t)(m0 + i) * p.ldc + (e - i * N)] = from_f32<TA>(sum);
  }
  // keep part alive until every block has read it (no fence needed)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename TA, typename TB, int N>
static cudaError_t launch_skinny_n(const SkinnyArgs& p, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.slices, (p.M + kRows - 1) / kRows);
  cfg.blockDim = dim3(kSkinnyThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dense_skinny_kernel<TA, TB, N>, p);
}

template <typename TA, typename TB>
static cudaError_t launch_skinny(const void* A, const void* B, void* C,
                                 int M, int N, int K, int64_t lda,
                                 int64_t sbk, int64_t sbn, int64_t ldc,
                                 int slices, cudaStream_t s) {
  int layout = kLayoutStrided;
  if (sbn == 1 && sbk == N && aligned16(B))
    layout = kLayoutRows;
  else if (sbk == 1 && aligned16(B) && (sbn * sizeof(TB)) % 16 == 0)
    layout = kLayoutKMajor;
  const int vec_a = aligned16(A) && (lda * sizeof(TA)) % 16 == 0;
  const SkinnyArgs p{A, B, C, M, N, K, lda, sbk, sbn, ldc, slices, layout,
                     vec_a};
  switch (N) {
    case 1: return launch_skinny_n<TA, TB, 1>(p, s);
    case 2: return launch_skinny_n<TA, TB, 2>(p, s);
    case 3: return launch_skinny_n<TA, TB, 3>(p, s);
    case 4: return launch_skinny_n<TA, TB, 4>(p, s);
    case 5: return launch_skinny_n<TA, TB, 5>(p, s);
    case 6: return launch_skinny_n<TA, TB, 6>(p, s);
    case 7: return launch_skinny_n<TA, TB, 7>(p, s);
    case 8: return launch_skinny_n<TA, TB, 8>(p, s);
  }
  return cudaErrorInvalidValue;
}

template <typename TA, typename TB>
static cudaError_t launch(const void* A, const void* B, void* C, int M,
                          int N, int K, int64_t lda, int64_t sbk, int64_t sbn,
                          int64_t ldc, int slices, cudaStream_t s) {
  if (slices > 0)
    return launch_skinny<TA, TB>(A, B, C, M, N, K, lda, sbk, sbn, ldc,
                                 slices, s);
  return launch_wide<TA, TB>(A, B, C, M, N, K, lda, sbk, sbn, ldc, s);
}

}  // namespace griffin

// C (M, N) row-major with row stride ldc; A (M, K) with row stride lda and
// unit column stride; B (K, N) element (k, n) at B[k * sbk + n * sbn].
// slices: 0 for the wide route, else the skinny route's split S of K
// (1..8, N <= 8).  Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int dense_gemm(int dtype, const void* A, const void* B, void* C,
                          int M, int N, int K, long long lda, long long sbk,
                          long long sbn, long long ldc, int slices,
                          void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || slices < 0 ||
      (M + griffin::kRows - 1) / griffin::kRows > 65535 ||
      (slices > 0 &&
       (slices > griffin::kMaxSlices || N > griffin::kMaxN)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == griffin::kFloat32)
    err = griffin::launch<float, float>(A, B, C, M, N, K, lda, sbk, sbn, ldc,
                                        slices, s);
  else if (dtype == griffin::kBFloat16)
    err = griffin::launch<__nv_bfloat16, __nv_bfloat16>(
        A, B, C, M, N, K, lda, sbk, sbn, ldc, slices, s);
  else if (dtype == griffin::kFloat32BFloat16)
    err = griffin::launch<float, __nv_bfloat16>(A, B, C, M, N, K, lda, sbk,
                                                sbn, ldc, slices, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
