// Sparse.A GEMM for Hopper (sm_90a): C = A . B with dense B, visiting per
// M tile only the K blocks its activations keep live, fp32 accumulation;
// and the activation metadata (kidx, cnt) that lists those blocks, built on
// the card in one launch.
//
// Replaces the TPU kernel src/repro/kernels/sparse_a/kernel.py
// (sparse_a_gemm_kernel, body _sparse_a_kernel): a Pallas grid of
// (m_tiles, n_tiles, max_cnt) whose k axis walks the compacted position,
// with kidx/cnt as scalar-prefetch operands that pick both the A tile
// (i, kidx[i, kc]) and the B tile (kidx[i, kc], j), and pl.when
// predicating the steps kc >= cnt[i].  The metadata kernel replaces the
// reference's traced jnp metadata (src/repro/kernels/sparse_a/ops.py,
// compact_activations under jit), which ran outside the Pallas kernel.
//
// Operands: A (M, K) with row stride lda and unit column stride; B (K, N)
// with element (k, n) at B[k * sbk + n * sbn] — row-major weights, or the
// tied unembedding's view embed.T, read in place; kidx (m_tiles, max_cnt)
// int32, per M tile of bm rows its visited K-block ids (blocks of bk);
// cnt (m_tiles,) int32.  A block listed in kidx[i, :cnt[i]] is visited
// once, however often it is listed; ids outside [0, ceil(K / bk)) and
// counts past max_cnt are ignored rather than read out of bounds.
//
// What bounds it on the card: on the serving path A is 1 to 32 rows, so
// the GEMM is bound by device-memory bytes — the B rows of the visited K
// blocks, read once: 8.4 MB for wq/wo, 33.5 MB for w_gate/w_up/w_down
// (10 us at 3.35 TB/s) and 525 MB for the unembedding (0.157 ms).  At
// M <= 32 it does at most 32 FLOP per weight byte, far under the card's
// ~295 FLOP/byte balance point.  What the design must supply is enough
// weight bytes in flight on every SM from the first microsecond.
//
// Routes (chosen by kernel.py's route() from the dtype, the strides, the
// alignment and split_plan — never from M or from the data):
//
//  * tensor-core rows route (bf16, B row-major: wq/wk/wv/wo/w_gate/w_up/
//    w_down) and tensor-core k-major route (bf16, B k-contiguous: embed.T).
//    One kernel, the layout a template flag.  mma.sync.m16n8k16 (bf16 in,
//    fp32 accumulate); A fragments by ldmatrix, B fragments by
//    ldmatrix.trans from row-major B and by plain ldmatrix from embed.T,
//    whose rows are already the fragment's k-contiguous layout.  One block
//    covers a pass of up to 32 rows of one M tile and a slice of CW (16,
//    32 or 64; 128 on the k-major route) output columns; grid.y walks the
//    passes, each with the kidx/cnt row of its M tile.  The block lists the
//    live K blocks of its range in shared memory (one round trip for cnt
//    and the kidx row), then streams them through a ring of cp.async.cg
//    stages, each one chunk of KC (<= 64) rows of K: the chunk's B (KC x
//    CW) and A (up to 32 x KC), XOR-swizzled rows so every ldmatrix phase
//    hits 8 distinct bank groups.  Dead blocks are never issued.  The
//    k-major route's copies ask the L2 for the whole 256-byte K block of
//    each embed row (.L2::256B), whose second chunk the next step reads.
//    Warp w takes the 16-deep slices w, w + 4, ... of each chunk.
//    Split by absolute K: a thread block cluster of S <= 8 ranks per
//    column slice; rank r owns the K blocks [r KB / S, (r + 1) KB / S),
//    KB = ceil(K / bk), and walks those its tile lists live, ascending.
//    The ranks' partial tiles meet through distributed shared memory in
//    rank order 0..S-1, each output summed and stored by one rank: no
//    atomics, no second launch.  S and CW come from split_plan(K, N, bk,
//    layout) (about two blocks per SM); at the unembedding's N the plan is
//    S = 1 with 128-column slices.  Tried on the card and dropped: deeper
//    or shallower rings, 32-row chunks, L2 prefetch of the whole walk or of
//    a window ahead, 128-column row-major slices, twice the blocks, and
//    ranks pushing their partials to the summing rank (one barrier) — none
//    was faster at the serving shapes.
//  * CUDA-core routes (fp32, which keeps fmaf with no TF32; fp32 A against
//    a bf16 B, widened per element, its output fp32; bf16 whose bk is not
//    a multiple of 16, whose K, strides or pointers are not 16-byte
//    aligned, or whose B is neither row-major nor k-contiguous):
//     - rows kernel (B n-contiguous, and any other strides with scalar
//       loads): one block of 256 threads per (4-row group of an M tile,
//       32-column slice): 4 column groups (8 columns, one 16-byte bf16 load
//       per B row) by 64 K groups; the K groups' partial sums meet in
//       shared memory at the end, added in K-group order.
//     - k-major kernel (B k-contiguous, 16-byte aligned rows): a half-warp
//       per 4 output columns, its 16 lanes each taking 8-element k chunks
//       in 16-byte loads; the lanes meet in a fixed xor butterfly.
//
// Batch invariance.  kidx depends on the data: the engine's 4-row tile
// visits the union of its rows' live blocks, a 1-row call only its own.
// The extra products are exact zeros, which leave a running fp32 sum
// unchanged — provided each partial sum takes its terms in an order fixed
// by their absolute k.  So work is split by absolute k, never by compacted
// position: the tensor-core route's ranks by K block and its warps by
// slice position in a chunk; the CUDA-core rows kernel's K groups by row
// (k - kb * bk) % 64, its k-major kernel's lanes by chunk (k - kb * bk) / 8
// % 16; each walks its terms in ascending k and the groups meet in a fixed
// order.  A rank with nothing live adds its zero partial.  (griffin_spmm
// splits compacted chunks; that is fine for its weight-fixed kidx but
// would break here.)  An output's bits thus depend on K, N, bk, the layout
// of B and the constants here, never on M or on the other rows.
//
// Metadata kernel (sparse_a_meta): reduces "any element != 0" (by bits:
// -0 is zero, NaN and denormals are live) over each bm x bk block of A into
// shared flags, masking the ragged M and K edge as the reference's zero
// padding does, then one warp writes cnt[i] and kidx[i, :] by ballot
// scans: the live ids ascending, then the dead ids ascending — the stable
// argsort of the dead mask, bit for bit.  It reads A once and writes
// 4 (kt + 1) bytes a tile: 16 KB at decode, where it is bound by its
// launch and one round trip, up to 2 MB for a 128-row prefill tile at K
// 8192, where one block on one SM (the first design) read at ~35 GB/s.
// So each M tile is a thread block cluster of S blocks, S a power of two
// up to 16 from the tile's bytes alone (kernel.py meta_slices: one block
// under 128 KB, else a share of at least one 16-byte unit a thread and at
// least one whole K block a rank);
// rank r ORs the whole K blocks [r kt / S, (r + 1) kt / S) into its own
// flags and writes them into rank 0's through distributed shared memory,
// one cluster barrier overlapping the loads and one after the writes.
// S = 1 (decode's 16-64 KB) is a plain launch with no cluster barrier:
// on the card a cluster costs ~1.1 us more than one block, more than
// spreading those loads saves.  One
// launch, no workspace, no atomics: nothing outlives the launch.  The
// flags are a pure function of A, so the split never changes a bit of
// kidx or cnt.

#include <cooperative_groups.h>

#include "gemm_tile.cuh"

namespace griffin {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// route codes of the C interface (kernel.py passes them)
constexpr int kRouteCore = 0;
constexpr int kRouteRows = 1;
constexpr int kRouteKMajor = 2;

// ---------------------------------------------------------------------------
// bf16 tensor-core route
// ---------------------------------------------------------------------------

struct TcArgs {
  const bf16* A;          // (M, K), row stride lda
  const bf16* B;          // (K, N): B[k * sbk + n] or B[n * sbn + k]
  const int* kidx;        // (m_tiles, max_cnt)
  const int* cnt;         // (m_tiles,)
  bf16* C;                // (M, N), row stride ldc
  int M, N, K, bm, bk, max_cnt;
  int passes;             // 32-row passes per M tile
  int splits, chunk;      // cluster split S and chunk rows KC
  int64_t lda, sbk, sbn, ldc;
};

// ring depth: 6 stages for passes of up to 16 rows, 4 for 32-row passes
// (whose A chunks are twice as large): five or three chunks of weight
// bytes in flight per block, and three blocks still fit on an SM
__host__ __device__ constexpr int a_ring_stages(int mt) {
  return mt == 1 ? 6 : 4;
}

// 16-byte async copy of the k-major route's weights: the L2 fetches the
// whole 256-byte K block of an embed row, whose second half the next step
// reads
__device__ __forceinline__ void cp_async16_l2_256(uint32_t dst,
                                                  const void* src,
                                                  int bytes) {
  asm volatile(
      "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(dst),
      "l"(src), "r"(bytes)
      : "memory");
}

// K blocks a rank owns at most: ranges are [r KB / S, (r + 1) KB / S)
__host__ __device__ inline int block_cap(int K, int bk, int splits) {
  const int kb = (K + bk - 1) / bk;
  return (kb + splits - 1) / splits;
}

// Shared memory of one block, in bytes and in this order: the ring
// (a_ring_stages(MT) stages of a KC x CW B chunk then a 16 MT x KC A
// chunk), reused at the end for the warps' partial tiles (4 x 16 MT rows of
// CW + 8 fp32) and then the block's partial tile (16 MT x CW fp32); then
// int lists: the rank's live flags and visited blocks (cap each) and their
// count.  At KC = CW = 64 a pass takes 61.5 KB (16 rows) or 49 KB (32), so
// three blocks fit on an SM.
struct ATcLayout {
  int stage, part, flag, vis, count, total;
  __host__ __device__ ATcLayout(int cw, int mt, int kc, int cap) {
    const int mp = 16 * mt;
    stage = kc * cw + mp * kc;                   // elements
    const int ring = a_ring_stages(mt) * stage * 2;
    part = kTcWarps * mp * (cw + 8) * 4;
    const int body = part + mp * cw * 4;
    flag = ring > body ? ring : body;
    vis = flag + cap * 4;
    count = vis + cap * 4;
    total = count + 4;
  }
};

template <int CW, int MT, bool KMAJOR>
__global__ void __launch_bounds__(kTcThreads)
    sparse_a_tc_kernel(TcArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int MP = 16 * MT;          // padded rows of a pass
  constexpr int NT = CW / 8;           // n8 MMA tiles
  constexpr int BV = CW / 8;           // 16-byte pieces per row-major B row
  constexpr int BV_LOG = CW == 16 ? 1 : CW == 32 ? 2 : 3;
  constexpr int ST = a_ring_stages(MT);
  const int KC = p.chunk, AV = KC / 8;  // AV: 2, 4 or 8 pieces of 16 bytes
  const int av_log = 31 - __clz(AV);
  const int S = p.splits, cpb = p.bk / KC;
  const int cap = block_cap(p.K, p.bk, S);
  const ATcLayout lay(CW, MT, KC, cap);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* part = reinterpret_cast<float*>(smem + lay.part);
  int* flag = reinterpret_cast<int*>(smem + lay.flag);
  int* vis = reinterpret_cast<int*>(smem + lay.vis);
  int* count = reinterpret_cast<int*>(smem + lay.count);

  // the pass: rows [m0, m0 + rows) of M tile `tile`; every rank of a
  // cluster has the same blockIdx.y, so a cluster leaves together
  const int tile = blockIdx.y / p.passes;
  const int64_t t0 = static_cast<int64_t>(tile) * p.bm;
  const int64_t m0 = t0 + static_cast<int64_t>(blockIdx.y - tile * p.passes) *
                              kPass;
  const int64_t end = t0 + p.bm < p.M ? t0 + p.bm : p.M;
  const int rows = static_cast<int>(end - m0 < kPass ? end - m0 : kPass);
  if (rows <= 0) return;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / S) * CW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int KB = (p.K + p.bk - 1) / p.bk;
  const int lo = rank * KB / S, hi = (rank + 1) * KB / S;

  for (int i = tid; i < hi - lo; i += kTcThreads) flag[i] = 0;
  {  // padding rows of every stage's A chunk (the copies never write them)
    const int per = (MP - rows) * AV;            // uint4 per stage
    for (int e = tid; e < ST * per; e += kTcThreads) {
      const int s = e / per;
      reinterpret_cast<uint4*>(ring + s * lay.stage + CW * KC +
                               rows * KC)[e - s * per] = make_uint4(0, 0, 0,
                                                                    0);
    }
  }
  __syncthreads();
  {  // the rank's live blocks: cnt and the kidx row in one round trip
    const int* kid = p.kidx + static_cast<int64_t>(tile) * p.max_cnt;
    const int live = max(0, min(__ldg(p.cnt + tile), p.max_cnt));
    for (int i = tid; i < p.max_cnt; i += kTcThreads) {
      const int id = __ldg(kid + i);
      if (i < live && id >= lo && id < hi) flag[id - lo] = 1;
    }
  }
  __syncthreads();
  if (warp == 0) {  // visit order: the live blocks of the range, ascending
    int base = 0;
    for (int j0 = 0; j0 < hi - lo; j0 += 32) {
      const int j = j0 + lane;
      const bool on = j < hi - lo && flag[j];
      const unsigned b = __ballot_sync(0xffffffffu, on);
      if (on) vis[base + __popc(b & ((1u << lane) - 1))] = lo + j;
      base += __popc(b);
    }
    if (lane == 0) *count = base;
  }
  __syncthreads();
  const int steps = *count * cpb;

  // walk step i streams chunk i % cpb of visited block vis[i / cpb] into
  // ring stage i % ST: its B rows and its A columns; what lies past K or N
  // is zero-filled
  auto issue = [&](int i) {
    const int q = i / cpb;
    const int64_t k0 =
        static_cast<int64_t>(vis[q]) * p.bk + (i - q * cpb) * KC;
    bf16* sb = ring + (i % ST) * lay.stage;
    bf16* sa = sb + CW * KC;
    if constexpr (KMAJOR) {   // CW rows of embed, KC contiguous k each
      for (int e = tid; e < CW * AV; e += kTcThreads) {
        const int r = e >> av_log, v = e & (AV - 1);
        const int64_t k = k0 + v * 8;
        const bool in = n0 + r < p.N && k < p.K;
        cp_async16_l2_256(
            smem_u32(sb + r * KC + swizzle(r, v, AV, av_log)),
            in ? p.B + static_cast<int64_t>(n0 + r) * p.sbn + k : p.B,
            in ? 16 : 0);
      }
    } else {                  // KC rows of B, CW contiguous n each
      for (int e = tid; e < KC * BV; e += kTcThreads) {
        const int r = e / BV, v = e - r * BV;
        const int64_t k = k0 + r;
        const bool in = k < p.K && n0 + v * 8 < p.N;
        cp_async16(smem_u32(sb + r * CW + swizzle(r, v, BV, BV_LOG)),
                   in ? p.B + k * p.sbk + n0 + v * 8 : p.B, in ? 16 : 0);
      }
    }
    for (int e = tid; e < rows * AV; e += kTcThreads) {
      const int m = e >> av_log, v = e & (AV - 1);
      const int64_t k = k0 + v * 8;
      const bool in = k < p.K;
      cp_async16(smem_u32(sa + m * KC + swizzle(m, v, AV, av_log)),
                 in ? p.A + (m0 + m) * p.lda + k : p.A, in ? 16 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < steps) issue(i);
    cp_async_commit();
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int i = 0; i < steps; ++i) {
    cp_async_wait<ST - 2>();          // step i landed
    __syncthreads();                  // ... and step i-1 consumed
    if (i + ST - 1 < steps) issue(i + ST - 1);
    cp_async_commit();
    const bf16* b = ring + (i % ST) * lay.stage;
    const bf16* a = b + CW * KC;
    for (int ks = warp; ks < KC / 16; ks += kTcWarps) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = mt * 16 + (lane & 15);
        ldmatrix_x4(smem_u32(a + r * KC +
                             swizzle(r, ks * 2 + (lane >> 4), AV, av_log)),
                    af[mt]);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        if constexpr (KMAJOR) {  // matrices (n 0-7|8-15) x (k 0-7|8-15)
          const int r = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(smem_u32(b + r * KC +
                               swizzle(r, ks * 2 + ((lane >> 3) & 1), AV,
                                       av_log)),
                      bf);
        } else {
          const int r = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4_trans(
              smem_u32(b + r * CW +
                       swizzle(r, np * 2 + (lane >> 4), BV, BV_LOG)),
              bf);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' partial tiles meet in warp order 0..3 (the ring is free);
  // rows of RS floats, so the 8-byte stores hit distinct banks
  constexpr int RS = CW + 8;
  float* red = reinterpret_cast<float*>(smem);
  {
    const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float* r = red + (warp * MP + mt * 16 + g) * RS + nt * 8 + t2;
        *reinterpret_cast<float2*>(r) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(r + 8 * RS) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
  }
  __syncthreads();
  const int E = rows * CW;
  if (S == 1) {
    for (int e = tid; e < E; e += kTcThreads) {
      const int i = e / CW, c = e - i * CW;
      const float* r = red + i * RS + c;
      const float sum =
          ((r[0] + r[MP * RS]) + r[2 * MP * RS]) + r[3 * MP * RS];
      if (n0 + c < p.N)
        p.C[(m0 + i) * p.ldc + n0 + c] = __float2bfloat16_rn(sum);
    }
    return;
  }
  for (int e = tid; e < E; e += kTcThreads) {
    const float* r = red + (e / CW) * RS + e % CW;
    part[e] = ((r[0] + r[MP * RS]) + r[2 * MP * RS]) + r[3 * MP * RS];
  }

  // the cluster's partial tiles meet in rank order 0..S-1; rank r sums and
  // stores its share [r E / S, (r + 1) E / S) of the outputs
  cluster.sync();
  for (int e = rank * E / S + tid; e < (rank + 1) * E / S;
       e += kTcThreads) {
    float v[kMaxSplits];              // all loads in flight, then the sum
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      v[q] = q < S ? cluster.map_shared_rank(part, q)[e] : 0.f;
    float sum = v[0];
#pragma unroll
    for (int q = 1; q < kMaxSplits; ++q)
      if (q < S) sum += v[q];
    const int i = e / CW, c = e - i * CW;
    if (n0 + c < p.N)
      p.C[(m0 + i) * p.ldc + n0 + c] = __float2bfloat16_rn(sum);
  }
  // keep part alive until every rank has read it (no fence needed)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Shared memory the route needs for this shape at its largest pass (what
// decides whether it fits, so never M)
static int a_tc_smem(const TcArgs& p, int cw) {
  return ATcLayout(cw, 2, p.chunk, block_cap(p.K, p.bk, p.splits)).total;
}

template <int CW, int MT, bool KMAJOR>
static cudaError_t launch_tc(const TcArgs& p, int m_tiles, cudaStream_t s) {
  const ATcLayout lay(CW, MT, p.chunk, block_cap(p.K, p.bk, p.splits));
  static int allowed = 48 << 10;      // dynamic shared memory opted into
  if (lay.total > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        sparse_a_tc_kernel<CW, MT, KMAJOR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    allowed = kMaxSmem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.N + CW - 1) / CW * p.splits, m_tiles * p.passes);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, sparse_a_tc_kernel<CW, MT, KMAJOR>, p);
}

template <int CW, bool KMAJOR>
static cudaError_t launch_tc_rows(const TcArgs& p, int m_tiles,
                                  cudaStream_t s) {
  // one m16 MMA tile per pass up to 16 rows, two above
  return (p.bm < p.M ? p.bm : p.M) > 16
             ? launch_tc<CW, 2, KMAJOR>(p, m_tiles, s)
             : launch_tc<CW, 1, KMAJOR>(p, m_tiles, s);
}

template <bool KMAJOR>
static cudaError_t dispatch_tc(const TcArgs& p, int m_tiles, int cw,
                               cudaStream_t s) {
  if (cw == 16) return launch_tc_rows<16, KMAJOR>(p, m_tiles, s);
  if (cw == 32) return launch_tc_rows<32, KMAJOR>(p, m_tiles, s);
  if constexpr (KMAJOR)
    if (cw == 128) return launch_tc_rows<128, true>(p, m_tiles, s);
  return launch_tc_rows<64, KMAJOR>(p, m_tiles, s);
}

// ---------------------------------------------------------------------------
// CUDA-core routes (fp32, fp32 A x bf16 B, and bf16 the tensor-core route
// does not take)
// ---------------------------------------------------------------------------

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

template <typename TA, typename TB, bool VEC>
__global__ void __launch_bounds__(kThreads)
    sparse_a_rows_kernel(const TA* __restrict__ A, const TB* __restrict__ B,
                         const int* __restrict__ kidx,
                         const int* __restrict__ cnt, TA* __restrict__ C,
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
      const TB* pb = B + k * sbk + (int64_t)n0 * sbn;
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
      C[(int64_t)(rg.m0 + i) * ldc + s0 + c] = from_f32<TA>(sum);
  }
}

template <typename TA, typename TB, bool VEC_A>
__global__ void __launch_bounds__(kWarps * 32)
    sparse_a_kmajor_kernel(const TA* __restrict__ A,
                           const TB* __restrict__ B,
                           const int* __restrict__ kidx,
                           const int* __restrict__ cnt, TA* __restrict__ C,
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
        const TA* pa = A + (int64_t)(rg.m0 + i) * lda + k0;
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
        C[(int64_t)(rg.m0 + i) * ldc + n0 + c] = from_f32<TA>(acc[i][c]);
}

// A and C of type TA, B of type TB
template <typename TA, typename TB = TA>
static int launch_core(const void* A, const void* B, const int* kidx,
                  const int* cnt, void* C, int M, int N, int K, int bm,
                  int bk, int m_tiles, int max_cnt, int64_t lda, int64_t sbk,
                  int64_t sbn, int64_t ldc, cudaStream_t s) {
  const int row_groups = (bm + kRows - 1) / kRows;
  if ((int64_t)m_tiles * row_groups > 65535) return (int)cudaErrorInvalidValue;
  const TA* a = static_cast<const TA*>(A);
  const TB* b = static_cast<const TB*>(B);
  TA* c = static_cast<TA*>(C);
  const size_t esz = sizeof(TB);
  // k-major: B k-contiguous with 16-byte aligned rows, whole 8-wide chunks
  const bool kmajor = sbk == 1 && bk % kVec == 0 && K % kVec == 0 &&
                      aligned16(B) && (sbn * esz) % 16 == 0;
  if (kmajor) {
    dim3 grid((N + kBlockCols - 1) / kBlockCols, m_tiles * row_groups);
    if (aligned16(A) && (lda * sizeof(TA)) % 16 == 0)
      sparse_a_kmajor_kernel<TA, TB, true><<<grid, kWarps * 32, 0, s>>>(
          a, b, kidx, cnt, c, M, N, K, bm, bk, max_cnt, row_groups, lda, sbn,
          ldc);
    else
      sparse_a_kmajor_kernel<TA, TB, false><<<grid, kWarps * 32, 0, s>>>(
          a, b, kidx, cnt, c, M, N, K, bm, bk, max_cnt, row_groups, lda, sbn,
          ldc);
    return (int)cudaGetLastError();
  }
  dim3 grid((N + kCols - 1) / kCols, m_tiles * row_groups);
  // vector loads need n-contiguous, 16-byte aligned 8-column groups of B
  if (sbn == 1 && N % kVec == 0 && aligned16(B) && (sbk * esz) % 16 == 0)
    sparse_a_rows_kernel<TA, TB, true><<<grid, kThreads, 0, s>>>(
        a, b, kidx, cnt, c, M, N, K, bm, bk, max_cnt, row_groups, lda, sbk,
        sbn, ldc);
  else
    sparse_a_rows_kernel<TA, TB, false><<<grid, kThreads, 0, s>>>(
        a, b, kidx, cnt, c, M, N, K, bm, bk, max_cnt, row_groups, lda, sbk,
        sbn, ldc);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// activation metadata
// ---------------------------------------------------------------------------

constexpr int kMetaThreads = 1024;
constexpr int kMaxMetaBlocks = 12288;    // K blocks: 48 KB of flags
constexpr int kMaxMetaSlices = 16;       // a non-portable cluster above 8

// the bits of x that make it nonzero: -0 is zero, NaN and denormals live
__device__ __forceinline__ uint32_t value_bits(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}
__device__ __forceinline__ uint32_t value_bits(bf16 x) {
  return __bfloat16_as_ushort(x) & 0x7fffu;
}
// the same for a 16-byte piece of elements
__device__ __forceinline__ uint32_t value_bits(uint4 u, float) {
  const uint32_t m = 0x7fffffffu;
  return (u.x & m) | (u.y & m) | (u.z & m) | (u.w & m);
}
__device__ __forceinline__ uint32_t value_bits(uint4 u, bf16) {
  const uint32_t m = 0x7fff7fffu;
  return (u.x | u.y | u.z | u.w) & m;
}

// One M tile per cluster of S blocks (grid.x = S m_tiles), or with
// CLUSTER false one block per M tile (S = 1: a plain launch, no cluster
// barrier).  Rank r owns the K blocks [r kt / S, (r + 1) kt / S)
// (kernel.py meta_ranges): whole blocks, so no flag is written by two
// ranks.  Each rank ORs its share of the tile's bm x K slab: thread t takes
// column unit t % U of the row group t / U (U units in the rank's columns;
// a unit is a 16-byte piece with VEC, else one element) and ORs its rows'
// bits in registers, every load of the loop independent of the others,
// into its own shared flags.  A peer then writes its flags into rank 0's
// through distributed shared memory (having waited on the cluster barrier
// it arrived at on entry, so rank 0 has started) and exits after
// cluster.sync(); rank 0 writes kidx[tile, :] = live ids ascending, dead
// ids ascending (ballot scans) and cnt[tile] = the live count.  VEC:
// 16-byte loads (K, lda and A aligned to 16 bytes) and bk a multiple of
// the piece.
template <typename T, bool VEC, bool CLUSTER>
__global__ void __launch_bounds__(kMetaThreads)
    sparse_a_meta_kernel(const T* __restrict__ A, int* __restrict__ kidx,
                         int* __restrict__ cnt, int M, int K, int bm, int bk,
                         int kt, int64_t lda) {
  extern __shared__ int live[];
  constexpr int E = VEC ? 16 / sizeof(T) : 1;    // elements per unit
  cg::cluster_group cluster = cg::this_cluster();
  int S = 1, rank = 0;
  if constexpr (CLUSTER) {
    S = static_cast<int>(cluster.num_blocks());
    rank = static_cast<int>(cluster.block_rank());
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
  const int tile = blockIdx.x / S, tid = threadIdx.x;
  const int64_t m0 = static_cast<int64_t>(tile) * bm;
  const int rows = static_cast<int>(M - m0 < bm ? M - m0 : bm);
  const int lo = static_cast<int>(static_cast<int64_t>(rank) * kt / S);
  const int hi = static_cast<int>(static_cast<int64_t>(rank + 1) * kt / S);
  const int k0 = lo * bk;                        // < K: lo < kt
  const int k1 = static_cast<int>(
      static_cast<int64_t>(hi) * bk < K ? static_cast<int64_t>(hi) * bk : K);
  const int U = (k1 - k0) / E;                   // the rank's units per row
  const int groups = U >= kMetaThreads ? 1 : kMetaThreads / U;
  for (int j = lo + tid; j < hi; j += kMetaThreads) live[j] = 0;
  __syncthreads();
  const T* slab = A + m0 * lda + k0;
  for (int e = tid; e < U * groups; e += kMetaThreads) {
    const int g = e / U, v = e - g * U;
    uint32_t bits = 0;
#pragma unroll 8
    for (int m = g; m < rows; m += groups) {
      const T* row = slab + m * lda;
      if (VEC)
        bits |= value_bits(__ldg(reinterpret_cast<const uint4*>(row) + v),
                           T());
      else
        bits |= value_bits(row[v]);
    }
    if (bits) live[(k0 + v * E) / bk] = 1;
  }
  __syncthreads();                 // the rank's flags are final
  if constexpr (CLUSTER) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (rank != 0) {               // into rank 0's flags, which has started
      int* dst = cluster.map_shared_rank(live, 0);
      for (int j = lo + tid; j < hi; j += kMetaThreads) dst[j] = live[j];
    }
    cluster.sync();                // the peers' flags have landed
    if (rank != 0) return;
  }
  if (tid < 32) {  // ballot scans: live ids, then dead ids, each ascending
    int* row = kidx + static_cast<int64_t>(tile) * kt;
    const unsigned below = (1u << tid) - 1;
    int n = 0;
    for (int j0 = 0; j0 < kt; j0 += 32) {
      const bool on = j0 + tid < kt && live[j0 + tid];
      const unsigned b = __ballot_sync(0xffffffffu, on);
      if (on) row[n + __popc(b & below)] = j0 + tid;
      n += __popc(b);
    }
    if (tid == 0) cnt[tile] = n;
    for (int j0 = 0; j0 < kt; j0 += 32) {
      const bool off = j0 + tid < kt && !live[j0 + tid];
      const unsigned b = __ballot_sync(0xffffffffu, off);
      if (off) row[n + __popc(b & below)] = j0 + tid;
      n += __popc(b);
    }
  }
}

template <typename T, bool VEC>
static cudaError_t launch_meta_body(const T* a, int* kidx, int* cnt, int M,
                                    int K, int bm, int bk, int m_tiles,
                                    int kt, int64_t lda, int slices,
                                    cudaStream_t s) {
  const size_t smem = static_cast<size_t>(kt) * sizeof(int);
  if (slices == 1) {
    sparse_a_meta_kernel<T, VEC, false><<<m_tiles, kMetaThreads, smem, s>>>(
        a, kidx, cnt, M, K, bm, bk, kt, lda);
    return cudaGetLastError();
  }
  auto kernel = sparse_a_meta_kernel<T, VEC, true>;
  if (slices > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(slices) * m_tiles);
  cfg.blockDim = dim3(kMetaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a, kidx, cnt, M, K, bm, bk, kt,
                            lda);
}

template <typename T>
static int launch_meta(const void* A, int* kidx, int* cnt, int M, int K,
                       int bm, int bk, int m_tiles, int kt, int64_t lda,
                       int slices, cudaStream_t s) {
  const T* a = static_cast<const T*>(A);
  constexpr int E = 16 / sizeof(T);
  const cudaError_t err =
      lda % E == 0 && K % E == 0 && bk % E == 0 && aligned16(A)
          ? launch_meta_body<T, true>(a, kidx, cnt, M, K, bm, bk, m_tiles,
                                      kt, lda, slices, s)
          : launch_meta_body<T, false>(a, kidx, cnt, M, K, bm, bk, m_tiles,
                                       kt, lda, slices, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace griffin

// C (M, N) with row stride ldc.  route: 0 = CUDA-core, 1 = tensor-core
// rows (B row-major), 2 = tensor-core k-major (B k-contiguous); splits /
// cols / chunk: the tensor-core route's plan (kernel.py's split_plan),
// ignored by the CUDA-core route.  Returns the cudaError_t of the launch
// (0 = cudaSuccess); a plan or operands the route cannot take return
// cudaErrorInvalidValue without launching.
extern "C" int sparse_a_gemm(int dtype, const void* A, const void* B,
                             const void* kidx, const void* cnt, void* C,
                             int M, int N, int K, int bm, int bk, int m_tiles,
                             int max_cnt, long long lda, long long sbk,
                             long long sbn, long long ldc, int route,
                             int splits, int cols, int chunk, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bk <= 0 || max_cnt <= 0 ||
      (int64_t)m_tiles * bm < M)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ki = static_cast<const int*>(kidx);
  const int* ct = static_cast<const int*>(cnt);
  if (route == griffin::kRouteRows || route == griffin::kRouteKMajor) {
    const bool kmajor = route == griffin::kRouteKMajor;
    const int passes = (bm + griffin::kPass - 1) / griffin::kPass;
    griffin::TcArgs p{static_cast<const __nv_bfloat16*>(A),
                      static_cast<const __nv_bfloat16*>(B), ki, ct,
                      static_cast<__nv_bfloat16*>(C), M, N, K, bm, bk,
                      max_cnt, passes, splits, chunk, lda, sbk, sbn, ldc};
    const bool ok =
        dtype == griffin::kBFloat16 && splits >= 1 &&
        splits <= griffin::kMaxSplits &&
        splits <= (K + bk - 1) / bk &&
        (cols == 16 || cols == 32 || cols == 64 || (kmajor && cols == 128)) &&
        chunk % 16 == 0 &&
        chunk <= 64 && bk % chunk == 0 && K % 8 == 0 && lda % 8 == 0 &&
        griffin::aligned16(A) && griffin::aligned16(B) &&
        (kmajor ? sbk == 1 && sbn % 8 == 0
                : sbn == 1 && sbk % 8 == 0 && N % 8 == 0) &&
        (int64_t)m_tiles * passes <= 65535 &&
        griffin::a_tc_smem(p, cols) <= griffin::kMaxSmem;
    if (!ok) return (int)cudaErrorInvalidValue;
    const cudaError_t err =
        kmajor ? griffin::dispatch_tc<true>(p, m_tiles, cols, s)
               : griffin::dispatch_tc<false>(p, m_tiles, cols, s);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  if (route != griffin::kRouteCore) return (int)cudaErrorInvalidValue;
  if (dtype == griffin::kFloat32)
    return griffin::launch_core<float>(A, B, ki, ct, C, M, N, K, bm, bk,
                                       m_tiles, max_cnt, lda, sbk, sbn, ldc,
                                       s);
  if (dtype == griffin::kBFloat16)
    return griffin::launch_core<__nv_bfloat16>(A, B, ki, ct, C, M, N, K, bm,
                                               bk, m_tiles, max_cnt, lda,
                                               sbk, sbn, ldc, s);
  if (dtype == griffin::kFloat32BFloat16)
    return griffin::launch_core<float, __nv_bfloat16>(
        A, B, ki, ct, C, M, N, K, bm, bk, m_tiles, max_cnt, lda, sbk, sbn,
        ldc, s);
  return (int)cudaErrorInvalidValue;
}

// kidx (m_tiles, kt) and cnt (m_tiles,) int32 of A (M, K), row stride lda:
// M tiles of bm rows, K blocks of bk columns, kt = ceil(K / bk); slices:
// the cluster's blocks per M tile (kernel.py meta_slices: a power of two,
// 1..16, at most kt).  Returns the cudaError_t of the launch (0 =
// cudaSuccess).
extern "C" int sparse_a_meta(int dtype, const void* A, void* kidx, void* cnt,
                             int M, int K, int bm, int bk, int m_tiles,
                             int kt, long long lda, int slices,
                             void* stream) {
  if (M <= 0 || K <= 0 || bm <= 0 || bk <= 0 || m_tiles <= 0 ||
      (int64_t)m_tiles * bm < M || (int64_t)kt * bk < K ||
      (int64_t)(kt - 1) * bk >= K || kt > griffin::kMaxMetaBlocks ||
      slices < 1 || slices > griffin::kMaxMetaSlices ||
      (slices & (slices - 1)) || slices > kt ||
      (int64_t)slices * m_tiles > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ki = static_cast<int*>(kidx);
  int* ct = static_cast<int*>(cnt);
  if (dtype == griffin::kFloat32)
    return griffin::launch_meta<float>(A, ki, ct, M, K, bm, bk, m_tiles, kt,
                                       lda, slices, s);
  if (dtype == griffin::kBFloat16)
    return griffin::launch_meta<__nv_bfloat16>(A, ki, ct, M, K, bm, bk,
                                               m_tiles, kt, lda, slices, s);
  return (int)cudaErrorInvalidValue;
}
