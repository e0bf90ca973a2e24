// Griffin block-sparse GEMM (Sparse.B, and Sparse.AB with dual) for Hopper
// (sm_90a): C = A . W_pruned from the block-compacted weights, written
// straight into the final, unpermuted, unpadded (M, n) output.
//
// Replaces the TPU kernel src/repro/kernels/griffin_spmm/kernel.py
// (griffin_spmm_kernel, body _spmm_kernel): a Pallas grid of
// (m_tiles, n_tiles, max_cnt) whose k axis walks the compacted position,
// with kidx/cnt as scalar-prefetch operands and pl.when predicating the
// steps kc >= cnt[j] (and, dual, the all-zero A tiles).
//
// Operands: b_comp (max_cnt * bk, Npad) row-major, N tile j's kc-th live
// K block in rows [kc * bk, (kc + 1) * bk); kidx (n_tiles, max_cnt) int32
// source K-block ids; cnt (n_tiles,) int32 live blocks per tile; perm
// (Npad,) int32 or null: b_comp's column p holds output column perm[p]
// (the balance shuffle), and columns at or past n are padding.
//
// What bounds it on the card: the bytes of the live b_comp blocks.  On the
// serving path A is 1 (decode) to 32 (prefill) rows and each weight matrix
// is read once per call: 1.2 MB (wk/wv) to 19 MB (w_down) of live blocks
// at 0.8 sparsity, 0.4-5.9 us at 3.35 TB/s.  At M <= 32 the arithmetic is
// at most 32 FLOP per weight byte, under the card's ~295 FLOP/byte balance
// point.  The small matrices are bound in practice by the chain of
// dependent steps of one call (metadata, first copies, cluster exchange,
// store), the large ones by how evenly and how early every SM has its
// weight bytes in flight.
//
// Design of the bf16 route (what each point does about the bound):
//  1. Tensor cores, B read once per call for M <= 32.  One block covers all
//     M rows of a 32-row pass (grid.y walks further passes, so any M is
//     right) and runs mma.sync.m16n8k16 (bf16 in, fp32 accumulate) on
//     fragments read with ldmatrix / ldmatrix.trans.  M pads to 16 or 32 in
//     shared memory only; at decode most MMA rows are padding, which costs
//     nothing against the bytes.
//  2. A staged in shared memory.  The block loads cnt[j] and copies its
//     tile's kidx row and its slice's perm entries into shared memory with
//     async copies, all in one round trip; its first weight copies start
//     as soon as the kidx row and cnt[j] arrive (point 5).  Then, in one
//     copy group, it stages the A columns of every compacted chunk it owns,
//     picked by kidx from shared memory: no load in the loop waits on
//     another global load.
//     With dual, the staged A gives one zero flag per (32-row M pass, K
//     chunk of up to 64 columns) at no cost per row.
//  3. Enough blocks for every shape: a deterministic split-K across a
//     thread block cluster.  An N tile's column slice (16, 32 or 64
//     columns) is a cluster of S <= 8 blocks (a power of two); rank r
//     walks the tile's compacted chunks whose 64-row group of absolute K
//     is r mod S, so a live 128-row block gives each of two ranks one
//     half and the ranks' shares stay close.  The S partial tiles meet
//     through distributed shared memory: each output is summed in rank
//     order 0..S-1 by exactly one rank, which stores it.  No atomics, no
//     second launch.
//  4. Every output's summation order is a function of (K, N) alone.  S
//     comes from the weight's (K, N) (split_plan in kernel.py: about two
//     blocks per SM at 64-column slices), a rank's share is fixed by
//     absolute K, and within a rank the 16-row MMA step at absolute row k
//     runs on warp (k / 16) mod 4, each warp walking its steps in
//     ascending K into one accumulator; warps meet in order 0..3, ranks in
//     order 0..S-1.  A zero block that one compaction skips and a coarser
//     one walks adds exact zeros, so the bits of C depend neither on M and
//     the other rows nor on the compaction granularity (block_k, block_n,
//     unit, balance) nor on dual: a tuned plan changes how K2 runs, never
//     what it computes.  The slice width and chunk depth follow the
//     compaction and only lay out the work.
//  5. B streamed through a ring of cp.async.cg 16-byte copies: 5 stages,
//     3 for 32-row passes (their staged A is twice as large).  The block's
//     4 warps run the MMAs on the stage that has landed, each warp on its
//     own 16-deep K slices of the chunk (point 4).  Dead steps (past
//     cnt[j]) are never issued.  With dual,
//     the first stages - 1 owned chunks are always walked (their copies
//     start before the flags are known) and a later chunk whose A is all
//     zero is dropped, B bytes and all.  A and B rows in shared memory are
//     XOR-swizzled, so every ldmatrix phase hits 8 distinct bank groups.
//  6. The balance shuffle folded into the store: column p of the slice goes
//     to output column perm[p] (units of 32 columns stay contiguous, so the
//     stores stay coalesced), padding columns are dropped, and the caller
//     gathers nothing.
//
// Other inputs (fp32, which keeps a CUDA-core fmaf route with no TF32; fp32
// A against a bf16 weight, the mLSTM block's w_down, whose output is fp32;
// bf16 whose bk or bn is not a multiple of 16, whose A or b_comp is not
// 16-byte aligned, or whose staged A would not fit in shared memory) take
// the CUDA-core route: one block of 256 threads per (4-row M tile, 32-column
// slice), 64 K groups, group g summing the live rows at absolute K = g mod
// 64 in ascending order (so its bits, too, do not follow the compaction),
// an ordered shared-memory reduction, and the same permuted store.  Which
// route runs depends on the dtype, the shape and the alignment of the
// operands, never on M.

#include <cooperative_groups.h>

#include "gemm_tile.cuh"

namespace griffin {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

struct SpmmArgs {
  const void* A;          // (M, K), row stride lda
  const void* Bc;         // (max_cnt * bk, Npad)
  const int* kidx;        // (n_tiles, max_cnt)
  const int* cnt;         // (n_tiles,)
  const int* perm;        // (Npad,) or null
  void* C;                // (M, n) row-major
  int M, K, n, Npad, bk, bn, max_cnt;
  int64_t lda;
  int splits, chunk;      // cluster split S and chunk rows (bf16 route)
};

constexpr int kSplitRows = 64;  // rank r owns the 64-row groups = r mod S

// the output column of b_comp column p, or -1 for padding
__device__ __forceinline__ int out_col(const SpmmArgs& p, int col) {
  const int dst = p.perm ? __ldg(p.perm + col) : col;
  return dst < p.n ? dst : -1;
}

// ---------------------------------------------------------------------------
// bf16 tensor-core route
// ---------------------------------------------------------------------------

// B ring depth: 5 stages for passes of up to 16 rows; 3 for 32-row passes,
// whose staged A is 2x larger
__host__ __device__ constexpr int ring_stages(int mt) {
  return mt == 1 ? 5 : 3;
}

// Shared memory of one block, in bytes and in this order: the B ring
// (ring_stages(MT) chunks of KC x CW bf16) and the staged A (cap chunks of
// 16 MT x KC bf16), reused at the end for the warps' partial tiles (4 x
// 16 MT rows of CW + 8 fp32) and then the block's partial tile (16 MT x CW
// fp32); then int lists: the slice's output columns (CW), the tile's kidx
// row (max_cnt), the rank's chunks (cap), and, for dual, the zero flags
// and the visited chunks (cap each); then the counts of the rank's and of
// the visited chunks.  At w_down's shape (8 ranks of 16 groups of 64 rows)
// a 32-row pass takes about 91 KB, so two blocks fit on an SM and its
// clusters of 8 find room in every GPC at once.
struct TcLayout {
  int a, part, cols, kid, mine, flag, vis, count, total;
  __host__ __device__ TcLayout(int cw, int mt, int kc, int max_cnt,
                               int cap) {
    const int mp = 16 * mt;
    a = ring_stages(mt) * kc * cw * 2;
    const int staged = a + cap * mp * kc * 2;
    part = kTcWarps * mp * (cw + 8) * 4;
    const int body = part + mp * cw * 4;
    cols = staged > body ? staged : body;
    kid = cols + cw * 4;
    mine = kid + max_cnt * 4;
    flag = mine + cap * 4;
    vis = flag + cap * 4;
    count = vis + cap * 4;
    total = count + 2 * 4;
  }
};

// most chunks a rank owns: the tile's chunks (KC rows, aligned to KC)
// that start below K in the rank's ceil(G / S) of the G 64-row groups of
// K, no more than the tile has
__host__ __device__ inline int chunk_cap(const SpmmArgs& p) {
  const int groups = (p.K + kSplitRows - 1) / kSplitRows;
  const int span =
      (groups + p.splits - 1) / p.splits * (kSplitRows / p.chunk);
  const int all = p.max_cnt * (p.bk / p.chunk);
  return span < all ? span : all;
}

template <int CW, int MT>
__global__ void __launch_bounds__(kTcThreads)
    spmm_tc_kernel(SpmmArgs p, int dual) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int MP = 16 * MT;          // padded rows of a pass
  constexpr int NT = CW / 8;           // n8 MMA tiles
  constexpr int BV = CW / 8;           // 16-byte pieces per B row
  constexpr int BV_LOG = CW == 16 ? 1 : CW == 32 ? 2 : 3;
  constexpr int ST = ring_stages(MT);
  const int KC = p.chunk, AV = KC / 8;  // AV: 2, 4 or 8 pieces of 16 bytes
  const int av_log = 31 - __clz(AV);
  const int S = p.splits, cpb = p.bk / KC;
  const int cap = chunk_cap(p);
  const TcLayout lay(CW, MT, KC, p.max_cnt, cap);
  bf16* sB = reinterpret_cast<bf16*>(smem);
  bf16* sA = reinterpret_cast<bf16*>(smem + lay.a);
  float* part = reinterpret_cast<float*>(smem + lay.part);
  int* cols = reinterpret_cast<int*>(smem + lay.cols);
  int* kid = reinterpret_cast<int*>(smem + lay.kid);
  int* mine = reinterpret_cast<int*>(smem + lay.mine);
  int* flag = reinterpret_cast<int*>(smem + lay.flag);
  int* vis = reinterpret_cast<int*>(smem + lay.vis);
  int* count = reinterpret_cast<int*>(smem + lay.count);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / S;
  const int nsub = p.bn / CW;
  const int j = tile / nsub, c0 = (tile - j * nsub) * CW;
  const int m0 = blockIdx.y * kPass, rows = min(kPass, p.M - m0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* A = static_cast<const bf16*>(p.A);
  const bf16* Bc = static_cast<const bf16*>(p.Bc);

  // prologue: the tile's kidx row and the slice's perm entries go to
  // shared memory by async copies, in flight together with the cnt load
  // (one round trip, no thread waiting on one load before issuing the next)
  for (int i = tid; i < p.max_cnt; i += kTcThreads)
    cp_async4(smem_u32(kid + i),
              p.kidx + static_cast<int64_t>(j) * p.max_cnt + i);
  if (p.perm && tid < CW)
    cp_async4(smem_u32(cols + tid), p.perm + j * p.bn + c0 + tid);
  cp_async_commit();
  const int cntj = max(0, min(__ldg(p.cnt + j), p.max_cnt));
  const int total = cntj * cpb;               // the tile's chunks
  cp_async_wait<0>();                         // kidx row and perm landed
  __syncthreads();
  // the rank's chunks in ascending K (point 4): chunk c starts at
  // absolute row kid[c / cpb] * bk + (c % cpb) * KC; one starting at or
  // past K meets a zero A and is left out
  if (warp == 0) {
    int n = 0;
    for (int i0 = 0; i0 < total; i0 += 32) {
      const int c = i0 + lane, kb = c / cpb;
      const int row = c < total ? kid[kb] * p.bk + (c - kb * cpb) * KC
                                : p.K;
      const bool ours =
          row < p.K && ((row / kSplitRows) & (S - 1)) == rank;
      const unsigned b = __ballot_sync(0xffffffffu, ours);
      if (ours) mine[n + __popc(b & ((1u << lane) - 1))] = c;
      n += __popc(b);
    }
    if (lane == 0) count[1] = n;
  }
  __syncthreads();
  const int own = count[1];                   // chunks this rank owns

  // B: walk step i streams owned chunk o into ring stage i % ST
  auto issue = [&](int i, int o) {
    const int c = mine[o];
    bf16* b = sB + (i % ST) * KC * CW;
    const bf16* src = Bc + static_cast<int64_t>(c) * KC * p.Npad +
                      static_cast<int64_t>(j) * p.bn + c0;
    for (int e = tid; e < KC * BV; e += kTcThreads) {
      const int r = e / BV, v = e - r * BV;
      cp_async16(smem_u32(b + r * CW + swizzle(r, v, BV, BV_LOG)),
                 src + static_cast<int64_t>(r) * p.Npad + v * 8, 16);
    }
  };
  // the first ST - 1 owned chunks need only cnt and the kidx row: their
  // copies start at once, and they are walked in both modes; with dual, a
  // later chunk whose staged A is all zero (either sign) is dropped from
  // the walk, B bytes and all.  Walking or dropping an all-zero chunk adds
  // the same exact zeros, so the result does not depend on which chunks
  // are walked.
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < own) issue(i, i);
    cp_async_commit();
  }
  if (dual)
    for (int i = tid; i < ST - 1; i += kTcThreads) vis[i] = i;
  for (int i = tid; i < own; i += kTcThreads) flag[i] = 0;
  {  // padding rows of the staged A (the copies never write them)
    const int per = (MP - rows) * AV;         // uint4 per chunk
    for (int e = tid; e < own * per; e += kTcThreads) {
      const int i = e / per;
      reinterpret_cast<uint4*>(sA + (i * MP + rows) * KC)[e - i * per] =
          make_uint4(0, 0, 0, 0);
    }
  }
  if (tid < CW) {  // output column of each slice column, -1 for padding
    const int dst = p.perm ? cols[tid] : j * p.bn + c0 + tid;
    cols[tid] = dst < p.n ? dst : -1;
  }
  __syncthreads();

  // A: every owned chunk's columns (picked by kidx) for this pass's rows,
  // staged once, as the newest copy group; columns at or past K (A may be
  // narrower than the padded K) are zero-filled
  for (int i = 0; i < own; ++i) {
    const int c = mine[i], kc = c / cpb;
    const int64_t base =
        static_cast<int64_t>(kid[kc]) * p.bk + (c - kc * cpb) * KC;
    for (int e = tid; e < rows * AV; e += kTcThreads) {
      const int m = e >> av_log, v = e & (AV - 1);
      const int64_t col = base + v * 8;
      const bool in = col < p.K;
      cp_async16(smem_u32(sA + (i * MP + m) * KC + swizzle(m, v, AV, av_log)),
                 in ? A + static_cast<int64_t>(m0 + m) * p.lda + col : A,
                 in ? 16 : 0);
    }
  }
  cp_async_commit();

  int steps = own;
  if (dual) {
    cp_async_wait<0>();                       // the staged A has landed
    __syncthreads();
    const int first = ST - 1, per = rows * AV;
    for (int e = tid; e < (own - first) * per; e += kTcThreads) {
      const int i = first + e / per, rem = e % per;
      const int m = rem >> av_log, v = rem & (AV - 1);
      const uint4 u =
          *reinterpret_cast<const uint4*>(sA + (i * MP + m) * KC + v * 8);
      if ((u.x | u.y | u.z | u.w) & 0x7fff7fffu) flag[i] = 1;
    }
    __syncthreads();
    if (warp == 0) {
      int base = first;
      for (int i0 = first; i0 < own; i0 += 32) {
        const int i = i0 + lane;
        const bool live = i < own && flag[i];
        const unsigned b = __ballot_sync(0xffffffffu, live);
        if (live) vis[base + __popc(b & ((1u << lane) - 1))] = i;
        base += __popc(b);
      }
      if (lane == 0) count[0] = min(base, own);
    }
    __syncthreads();
    steps = count[0];
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int i = 0; i < steps; ++i) {
    // step i landed (and, at step 0, the staged A, the newest group)
    if (i == 0)
      cp_async_wait<0>();
    else
      cp_async_wait<ST - 2>();
    __syncthreads();                  // ... and step i-1 consumed
    const int next = i + ST - 1;
    if (next < steps) issue(next, dual ? vis[next] : next);
    cp_async_commit();
    const int o = dual ? vis[i] : i;
    const bf16* b = sB + (i % ST) * KC * CW;
    const bf16* a = sA + o * MP * KC;
    // the 16-row step at absolute row k runs on warp (k / 16) mod 4: slice
    // ks = warp of a 64-row chunk (64-aligned), else by the chunk's row
    int ks0 = warp;
    if (KC < 64) {
      const int c = mine[o], kc = c / cpb;
      ks0 = (warp - kid[kc] * (p.bk / 16) - (c - kc * cpb) * (KC / 16)) &
            (kTcWarps - 1);
    }
    for (int ks = ks0; ks < KC / 16; ks += kTcWarps) {
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
        const int r = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(
            smem_u32(b + r * CW +
                     swizzle(r, np * 2 + (lane >> 4), BV, BV_LOG)),
            bf);
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

  // the warps' partial tiles meet in warp order 0..3 (ring and A are
  // free); rows of RS floats, so the 8-byte stores hit distinct banks
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
  bf16* C = static_cast<bf16*>(p.C);
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
    const int i = e / CW, dst = cols[e - i * CW];
    if (dst >= 0)
      C[static_cast<int64_t>(m0 + i) * p.n + dst] = __float2bfloat16_rn(sum);
  }
  // keep part alive until every rank has read it (no fence needed)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Shared memory the bf16 route needs for this shape at its largest pass:
// what decides whether the route fits, so never M.  kernel.py's tc_smem and
// route mirror this, chunk_cap, TcLayout and the choice in griffin_spmm
// below, so that Python knows each launch's route: change them together.
static int tc_smem(const SpmmArgs& p, int cw) {
  return TcLayout(cw, 2, p.chunk, p.max_cnt, chunk_cap(p)).total;
}

template <int CW, int MT>
static cudaError_t launch_tc(const SpmmArgs& p, int dual, int n_tiles,
                             cudaStream_t s) {
  const TcLayout lay(CW, MT, p.chunk, p.max_cnt, chunk_cap(p));
  static int allowed = 48 << 10;      // dynamic shared memory opted into
  if (lay.total > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        spmm_tc_kernel<CW, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return err;
    allowed = kMaxSmem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * (p.bn / CW) * p.splits,
                     (p.M + kPass - 1) / kPass);
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
  return cudaLaunchKernelEx(&cfg, spmm_tc_kernel<CW, MT>, p, dual);
}

template <int CW>
static cudaError_t launch_tc_rows(const SpmmArgs& p, int dual, int n_tiles,
                                  cudaStream_t s) {
  // one m16 MMA tile per pass up to 16 rows, two above
  return p.M > 16 ? launch_tc<CW, 2>(p, dual, n_tiles, s)
                  : launch_tc<CW, 1>(p, dual, n_tiles, s);
}

static cudaError_t dispatch_tc(const SpmmArgs& p, int dual, int n_tiles,
                               int cw, cudaStream_t s) {
  if (cw == 16) return launch_tc_rows<16>(p, dual, n_tiles, s);
  if (cw == 32) return launch_tc_rows<32>(p, dual, n_tiles, s);
  return launch_tc_rows<64>(p, dual, n_tiles, s);
}

// ---------------------------------------------------------------------------
// CUDA-core route (fp32, and bf16 the tensor-core route does not take)
// ---------------------------------------------------------------------------

constexpr int kColGroups = 4;                     // x 8 columns = 32
constexpr int kCols = kColGroups * kVec;
constexpr int kKGroups = 64;
constexpr int kThreads = kColGroups * kKGroups;   // 256
constexpr int kRows = 4;                          // M rows per tile (grid.y)

template <typename TA, typename TB, bool DUAL, bool VEC>
__global__ void __launch_bounds__(kThreads) spmm_core_kernel(SpmmArgs p) {
  __shared__ float part[kKGroups][kRows][kCols];  // 32 KB
  const TA* A = static_cast<const TA*>(p.A);
  const TB* Bc = static_cast<const TB*>(p.Bc);
  const int t = threadIdx.x;
  const int colg = t % kColGroups, g = t / kColGroups;
  const int nsub = (p.bn + kCols - 1) / kCols;
  const int j = blockIdx.x / nsub;                      // N tile
  const int s0 = (blockIdx.x % nsub) * kCols;           // slice in tile
  const int c0 = s0 + colg * kVec;                      // thread's columns
  const int ncols = min(kVec, p.bn - c0);
  const int m0 = blockIdx.y * kRows;
  float acc[kRows][kVec];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[i][e] = 0.f;

  if (ncols > 0) {
    const int cntj = min(max(p.cnt[j], 0), p.max_cnt);
    const int* kid = p.kidx + (int64_t)j * p.max_cnt;
    const TB* bcol = Bc + (int64_t)j * p.bn + c0;
    // group g walks the live rows at absolute K = g mod 64, ascending
    for (int kc = 0; kc < cntj; ++kc) {
      const int64_t base = (int64_t)kid[kc] * p.bk;
      const TB* brow = bcol + (int64_t)kc * p.bk * p.Npad;
      for (int r = (g - static_cast<int>(base)) & (kKGroups - 1); r < p.bk;
           r += kKGroups) {
        const int64_t col = base + r;
        float a[kRows];
        bool any = false;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          a[i] = (m0 + i < p.M && col < p.K)
                     ? to_f32(A[(int64_t)(m0 + i) * p.lda + col])
                     : 0.f;
          any |= a[i] != 0.f;
        }
        if (DUAL && !any) continue;
        float b[kVec];
        if (VEC)
          load8(brow + (int64_t)r * p.Npad, b);
        else
          load8_strided(brow + (int64_t)r * p.Npad, 1, ncols, b);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            acc[i][e] = fmaf(a[i], b[e], acc[i][e]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int e = 0; e < kVec; ++e) part[g][i][colg * kVec + e] = acc[i][e];
  __syncthreads();
  // the K groups' partial sums meet in K-group order
  TA* C = static_cast<TA*>(p.C);
  for (int o = t; o < kRows * kCols; o += kThreads) {
    const int i = o / kCols, c = o % kCols;
    if (m0 + i >= p.M || s0 + c >= p.bn) continue;
    const int dst = out_col(p, j * p.bn + s0 + c);
    if (dst < 0) continue;
    float sum = 0.f;
    for (int gg = 0; gg < kKGroups; ++gg) sum += part[gg][i][c];
    C[(int64_t)(m0 + i) * p.n + dst] = from_f32<TA>(sum);
  }
}

template <typename TA, typename TB, bool DUAL>
static cudaError_t launch_core(const SpmmArgs& p, int n_tiles,
                               cudaStream_t s) {
  const int nsub = (p.bn + kCols - 1) / kCols;
  dim3 grid(n_tiles * nsub, (p.M + kRows - 1) / kRows);
  // vector loads need 16-byte aligned 8-column groups of b_comp
  if (aligned16(p.Bc) && p.bn % kVec == 0 && p.Npad % kVec == 0)
    spmm_core_kernel<TA, TB, DUAL, true><<<grid, kThreads, 0, s>>>(p);
  else
    spmm_core_kernel<TA, TB, DUAL, false><<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

// A and C of type TA, the compacted weight of type TB
template <typename TA, typename TB = TA>
static cudaError_t dispatch_core(const SpmmArgs& p, int dual, int n_tiles,
                                 cudaStream_t s) {
  return dual ? launch_core<TA, TB, true>(p, n_tiles, s)
              : launch_core<TA, TB, false>(p, n_tiles, s);
}

}  // namespace griffin

// Launches per route since the library was loaded: [0] the tensor-core
// route, [1] the CUDA-core route (griffin_spmm_route_launches reads them).
static long long g_route_launches[2] = {0, 0};

// A (M, K) with row stride lda and unit column stride (K = the real,
// unpadded contraction length); C (M, n) row-major, every column written;
// perm (Npad,) or null.  splits / cols / chunk_rows: the bf16 route's plan
// (cluster split S <= 8, slice width 16, 32 or 64, chunk rows dividing bk,
// a multiple of 16 up to 64), or splits = 0 for the CUDA-core route.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int griffin_spmm(int dtype, int dual, const void* A,
                            const void* Bc, const void* kidx,
                            const void* cnt, const void* perm, void* C,
                            int M, int K, int n, int Npad, int n_tiles,
                            int bk, int bn, int max_cnt, long long lda,
                            int splits, int cols, int chunk_rows,
                            void* stream) {
  if (M <= 0 || K <= 0 || n <= 0 || n > Npad || n_tiles <= 0 || bk <= 0 ||
      bn <= 0 || max_cnt <= 0 || Npad != n_tiles * bn)
    return (int)cudaErrorInvalidValue;
  griffin::SpmmArgs p{A, Bc, static_cast<const int*>(kidx),
                      static_cast<const int*>(cnt),
                      static_cast<const int*>(perm), C, M, K, n, Npad, bk, bn,
                      max_cnt, lda, splits, chunk_rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  bool tc = false;
  if (dtype == griffin::kBFloat16 && splits > 0) {
    const bool plan_ok = splits <= griffin::kMaxSplits &&
                         (splits & (splits - 1)) == 0 &&
                         (cols == 16 || cols == 32 || cols == 64) &&
                         bn % cols == 0 && chunk_rows % 16 == 0 &&
                         chunk_rows <= 64 && bk % chunk_rows == 0;
    if (!plan_ok) return (int)cudaErrorInvalidValue;
    // the route kernel.py::route predicts (keep the two equal)
    tc = griffin::aligned16(A) && griffin::aligned16(Bc) && lda % 8 == 0 &&
         K % 8 == 0 && griffin::tc_smem(p, cols) <= griffin::kMaxSmem;
    err = tc ? griffin::dispatch_tc(p, dual, n_tiles, cols, s)
             : griffin::dispatch_core<__nv_bfloat16>(p, dual, n_tiles, s);
  } else if (dtype == griffin::kBFloat16) {
    err = griffin::dispatch_core<__nv_bfloat16>(p, dual, n_tiles, s);
  } else if (dtype == griffin::kFloat32) {
    err = griffin::dispatch_core<float>(p, dual, n_tiles, s);
  } else if (dtype == griffin::kFloat32BFloat16) {
    err = griffin::dispatch_core<float, __nv_bfloat16>(p, dual, n_tiles, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  ++g_route_launches[tc ? 0 : 1];
  return (int)cudaGetLastError();
}

// out[0], out[1]: the launches of the tensor-core and of the CUDA-core
// route so far (kernel.py::route_launches)
extern "C" void griffin_spmm_route_launches(long long* out) {
  out[0] = g_route_launches[0];
  out[1] = g_route_launches[1];
}
