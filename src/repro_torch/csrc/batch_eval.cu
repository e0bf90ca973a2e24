// The greedy sliding-window schedule of the paper's cycle model for Hopper
// (sm_90a): executed cycles per tile stream, one configuration per launch.
//
// Replaces src/repro/kernels/batch_eval/ops.py (_schedule_cycles): a per-tile
// lax.while_loop whose body unrolls, at trace time, the (1 + d1) window
// chunks times the (1 + d2)(1 + d3) borrow offsets, vmapped over the tiles
// and jitted (not a Pallas kernel).  The numpy engine
// (core/scheduler.py, _schedule_rows) defines the result; this kernel gives
// the same integers for one shared (d1, d2, d3) on cycles-only, full-length
// streams.  Lane shuffling is applied to the mask on the host beforehand,
// exactly as the reference does.
//
// Operands: mask (tiles, T, K0, G) bool, contiguous, one byte per element;
// out (tiles,) int64; scratch (tiles, T) 64-bit words, used only when the
// block's words do not fit in shared memory (null otherwise).
//
// Each chunk's K0 x G bits are packed in one 64-bit word, bit g * K0 + l
// for lane l of PE group g, so (K0 G <= 64):
//   * the lane borrow chunk[dl:] (one-sided, no wrap) is a right shift by
//     dl inside every K0-bit block, masked to lanes [0, K0 - dl);
//   * the PE-group borrow roll(src, -dg, axis=G) (a ring) is a rotation of
//     the whole K0 G-bit word by dg K0 bits;
//   * the occupancy of the cycle's K0 x G slots is one word, and a
//     placement step is put = src & ~occ; occ |= put; chunk &= ~taken, where
//     taken (put rolled back by +dg and shifted up by dl) is the sources
//     that put consumed.
// A schedule cycle walks the window [f, f + win) capped at T, oldest chunk
// first, inside a chunk the offsets in the reference's priority order
// (_offsets: PE distance dg, then lane distance dl).  Then the front
// advances: f = the first chunk >= f that still has bits, at most f + win
// (every chunk below f is empty).  The loop runs while a chunk has bits (a
// count of nonempty words); the trailing chunks cost ceil((T - f) / win).
//
// What bounds it on the card: the mask bytes are read once (the Figure 8
// sweep's largest stream, 256 x 84 x 16 x 1, is 344 KB: 0.1 us at 3.35
// TB/s, below a launch), but the work is one dependent chain per tile of
// cycles x window x offsets word operations.  The first design ran it one
// thread a tile, 64 tiles a block: a 256-tile stream on 4 of 132 SMs, and
// at SparTen's 128-deep window every cycle a chain through all 84 chunks,
// 0.84 ms on that stream (PERF.md).  Two routes now, chosen by the config
// alone (kernel.py route), never by the data:
//
//  * scan (d2 = d3 = 0: SparTen's (127, 0, 0), Sparse.AB*'s (2, 0, 0)).
//    With no borrow, a placement is put = c & ~occ over one offset, so a
//    cycle keeps in chunk t exactly c_t & (c_f | ... | c_{t-1}): an
//    exclusive prefix OR over the window's words, oldest first (the
//    occ == full early exit changes nothing: c & full = c).  A warp runs a
//    tile: lane l holds the P = ceil(len / 32) consecutive window words
//    [f + l P, f + (l + 1) P), ORs them, a 5-step __shfl_up_sync scan makes
//    the exclusive prefix across lanes, and each lane applies it to its
//    words in order.  The words that became empty are summed over the warp
//    (nz), and the front is the first nonempty word: a __ballot_sync over
//    the lanes that hold one and a shuffle from the lowest.  A cycle is
//    thus a few dependent steps, not a chain through the window.  Four
//    tiles a block.
//  * chain (every other config: lane borrows and the PE ring make a
//    placement depend on every earlier one inside a chunk; the Figure 8
//    windows are at most 9 chunks deep).  One thread runs a tile's chain
//    as the first design did, but a block is one warp that holds only
//    kernel.py's chain_tiles (a power of two up to 32 from the tile count,
//    so that a 256-tile stream spreads over 128 SMs and fewer tiles share
//    a warp's divergent loop).
// Either route first packs its tiles' chunks cooperatively (consecutive
// threads read consecutive chunks, so the mask is read once) into shared
// memory, or into the global scratch [tile][t] when T is too long for it.

#include <cstdint>
#include <cuda_runtime.h>

namespace griffin_batch_eval {

constexpr int kChainThreads = 32;    // a chain block: one warp
constexpr int kScanWarps = 4;        // scan tiles a block
constexpr int kScanThreads = kScanWarps * 32;
constexpr int kMaxDynSmem = 200 * 1024;

__device__ __forceinline__ uint64_t low_bits(int n) {
  return n >= 64 ? ~0ull : ((1ull << n) - 1ull);
}

// rotate right by s bits inside an n-bit word (0 <= s < n <= 64)
__device__ __forceinline__ uint64_t rotr(uint64_t x, int s, int n,
                                         uint64_t full) {
  return s == 0 ? x : (((x >> s) | (x << (n - s))) & full);
}

__device__ __forceinline__ uint64_t rotl(uint64_t x, int s, int n,
                                         uint64_t full) {
  return s == 0 ? x : (((x << s) | (x >> (n - s))) & full);
}

// One chunk's K0 x G bytes as a word, bit g * K0 + l for byte l * G + g.
__device__ __forceinline__ uint64_t pack_chunk(const uint8_t* src, int n,
                                               int K0, int G) {
  uint64_t w = 0;
  int l = 0, g = 0;
  for (int j = 0; j < n; ++j) {
    if (src[j]) w |= 1ull << (g * K0 + l);
    if (++g == G) g = 0, ++l;
  }
  return w;
}

// chain route: one thread a tile, `per_block` tiles a one-warp block
__global__ void __launch_bounds__(kChainThreads)
    batch_eval_chain_kernel(const uint8_t* __restrict__ mask,
                            int64_t* __restrict__ out, uint64_t* scratch,
                            int tiles, int T, int K0, int G, int d1, int d2,
                            int d3, int per_block) {
  extern __shared__ uint64_t smem[];
  __shared__ uint64_t lane_mask[64];   // per dl: lanes [0, K0 - dl) of every
                                       // K0-bit block
  const int n = K0 * G;
  const uint64_t full = low_bits(n);
  const int base = blockIdx.x * per_block;
  const int nb = min(per_block, tiles - base);
  const int stride = per_block + 1;
  const int dl_max = min(d2, K0 - 1);  // dl >= K0 moves no lane
  for (int dl = threadIdx.x; dl <= dl_max; dl += kChainThreads) {
    uint64_t lanes = low_bits(K0 - dl), rep = 0;
    for (int g = 0; g < G; ++g) rep |= lanes << (g * K0);
    lane_mask[dl] = rep;
  }

  // pack the block's nb x T chunks
  const bool shared = scratch == nullptr;
  const int nwords = nb * T;
  const uint8_t* block_mask = mask + (int64_t)base * T * n;
  for (int idx = threadIdx.x; idx < nwords; idx += kChainThreads) {
    const uint64_t w = pack_chunk(block_mask + (int64_t)idx * n, n, K0, G);
    const int tl = idx / T, t = idx - tl * T;
    if (shared)
      smem[t * stride + tl] = w;
    else
      scratch[(int64_t)base * T + idx] = w;
  }
  __syncthreads();
  if ((int)threadIdx.x >= nb) return;

  const int tile = base + threadIdx.x;
  uint64_t* words = shared ? smem + threadIdx.x : scratch + (int64_t)tile * T;
  const int ws = shared ? stride : 1;
  const int64_t win = (int64_t)d1 + 1;
  int nz = 0;
  for (int t = 0; t < T; ++t) nz += words[t * ws] != 0;

  int f = 0;
  int64_t cycles = 0;
  while (nz > 0) {
    uint64_t occ = 0;
    const int end = f + win < T ? (int)(f + win) : T;
    for (int t = f; t < end && occ != full; ++t) {
      uint64_t c = words[t * ws];
      if (c == 0) continue;
      const uint64_t c0 = c;
      for (int dg = 0; dg <= d3; ++dg) {
        const int s = (dg % G) * K0;   // the ring wraps modulo G
        for (int dl = 0; dl <= dl_max; ++dl) {
          const uint64_t src = (rotr(c, s, n, full) >> dl) & lane_mask[dl];
          const uint64_t put = src & ~occ;
          if (put) {
            occ |= put;
            c &= ~rotl(put << dl, s, n, full);
          }
        }
      }
      if (c != c0) {
        words[t * ws] = c;
        nz -= c == 0;
      }
    }
    ++cycles;
    int nf = f;                        // window front advance
    while (nf < end && words[nf * ws] == 0) ++nf;
    f = nf;
  }
  out[tile] = cycles + (T - f + win - 1) / win;   // trailing travel
}

// scan route (d2 = d3 = 0): one warp a tile, kScanWarps tiles a block
__global__ void __launch_bounds__(kScanThreads)
    batch_eval_scan_kernel(const uint8_t* __restrict__ mask,
                           int64_t* __restrict__ out, uint64_t* scratch,
                           int tiles, int T, int K0, int G, int d1) {
  extern __shared__ uint64_t smem[];
  constexpr unsigned kAll = 0xffffffffu;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kScanWarps + warp;
  if (tile >= tiles) return;           // a whole warp; no block barrier follows
  const int n = K0 * G;
  uint64_t* words = scratch != nullptr ? scratch + (int64_t)tile * T
                                       : smem + (int64_t)warp * T;
  const uint8_t* src = mask + (int64_t)tile * T * n;
  int nz = 0;
  for (int t = lane; t < T; t += 32) {
    const uint64_t w = pack_chunk(src + (int64_t)t * n, n, K0, G);
    words[t] = w;
    nz += w != 0;
  }
  nz = __reduce_add_sync(kAll, nz);
  __syncwarp();

  const int64_t win = (int64_t)d1 + 1;
  int f = 0;
  int64_t cycles = 0;
  while (nz > 0) {
    const int end = f + win < T ? (int)(f + win) : T;
    const int P = (end - f + 31) >> 5;           // window words a lane
    const int b = min(f + lane * P, end), e = min(b + P, end);
    uint64_t local = 0;
    for (int t = b; t < e; ++t) local |= words[t];
    uint64_t inc = local;                        // inclusive OR over lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint64_t y = __shfl_up_sync(kAll, inc, off);
      if (lane >= off) inc |= y;
    }
    uint64_t before = __shfl_up_sync(kAll, inc, 1);  // exclusive
    if (lane == 0) before = 0;
    int emptied = 0, first = end;
    for (int t = b; t < e; ++t) {
      const uint64_t c = words[t];
      const uint64_t kept = c & before;          // what this cycle leaves
      before |= c;
      if (kept != c) {
        words[t] = kept;
        emptied += kept == 0;
      }
      if (kept != 0 && first == end) first = t;
    }
    nz -= __reduce_add_sync(kAll, emptied);
    ++cycles;
    const unsigned held = __ballot_sync(kAll, first < end);
    f = held ? __shfl_sync(kAll, first, __ffs(held) - 1) : end;  // front
    __syncwarp();
  }
  if (lane == 0) out[tile] = cycles + (T - f + win - 1) / win;
}

}  // namespace griffin_batch_eval

// route codes of the C interface (kernel.py passes them)
enum { kRouteChain = 0, kRouteScan = 1 };

// Bytes of dynamic shared memory a launch of `route` with T chunks per
// tile and per_block tiles a chain block needs; 0 means the words go to
// the caller's global scratch instead.
extern "C" int batch_eval_smem_bytes(int T, int route, int per_block) {
  using namespace griffin_batch_eval;
  const long long bytes =
      route == kRouteScan ? (long long)T * kScanWarps * 8
                          : (long long)T * (per_block + 1) * 8;
  return bytes <= kMaxDynSmem ? (int)bytes : 0;
}

// route: kRouteChain (per_block tiles a block, 1..32) or kRouteScan (d2 =
// d3 = 0 only; per_block ignored).  Returns the cudaError_t of the launch
// (0 = cudaSuccess).
extern "C" int batch_eval(const void* mask, void* out, void* scratch,
                          int tiles, int T, int K0, int G, int d1, int d2,
                          int d3, int route, int per_block, void* stream) {
  using namespace griffin_batch_eval;
  if (tiles <= 0 || T <= 0 || K0 <= 0 || G <= 0 || K0 * G > 64 || d1 < 0 ||
      d2 < 0 || d3 < 0 ||
      (route == kRouteScan ? d2 != 0 || d3 != 0
                           : route != kRouteChain || per_block < 1 ||
                                 per_block > kChainThreads))
    return (int)cudaErrorInvalidValue;
  const int smem = batch_eval_smem_bytes(T, route, per_block);
  if (smem == 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const void* fn = route == kRouteScan
                       ? reinterpret_cast<const void*>(batch_eval_scan_kernel)
                       : reinterpret_cast<const void*>(
                             batch_eval_chain_kernel);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int64_t* o = static_cast<int64_t*>(out);
  uint64_t* sc = smem ? nullptr : static_cast<uint64_t*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteScan)
    batch_eval_scan_kernel<<<(tiles + kScanWarps - 1) / kScanWarps,
                             kScanThreads, smem, s>>>(m, o, sc, tiles, T, K0,
                                                      G, d1);
  else
    batch_eval_chain_kernel<<<(tiles + per_block - 1) / per_block,
                              kChainThreads, smem, s>>>(
        m, o, sc, tiles, T, K0, G, d1, d2, d3, per_block);
  return (int)cudaGetLastError();
}
