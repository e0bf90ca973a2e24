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
// Design: one thread per tile, whose schedule is a data-dependent loop over
// a private, mutable window of chunks (no tile's loop can be split between
// threads: each placement depends on every earlier one).  Each chunk's
// K0 x G bits are packed in one 64-bit word, bit g * K0 + l for lane l of
// PE group g, so (K0 G <= 64):
//   * the lane borrow chunk[dl:] (one-sided, no wrap) is a right shift by
//     dl inside every K0-bit block, masked to lanes [0, K0 - dl);
//   * the PE-group borrow roll(src, -dg, axis=G) (a ring) is a rotation of
//     the whole K0 G-bit word by dg K0 bits;
//   * the occupancy of the cycle's K0 x G slots is one word, and a
//     placement step is put = src & ~occ; occ |= put; chunk &= ~taken, where
//     taken (put rolled back by +dg and shifted up by dl) is the sources
//     that put consumed.
// The block first packs its tiles' chunks cooperatively (consecutive
// threads read consecutive chunks, so the mask is read once) into shared
// memory, laid out [t][kThreads + 1] so a warp's threads hit different
// banks, or into the global scratch [tile][t] when T is long.
// Then each thread runs its tile: per cycle, the window [f, f + win)
// capped at T, oldest chunk first; inside a chunk the offsets in the
// reference's priority order (_offsets: PE distance dg, then lane distance
// dl); a cycle whose slots are all taken stops early (nothing more could be
// placed).  Then the front advances: f = the first chunk >= f that still
// has bits, at most f + win (every chunk below f is empty, so the scan
// stops at the window's end).  The loop runs while a chunk has bits (a
// count of nonempty words); the trailing chunks cost ceil((T - f) / win).
//
// What bounds it on the card: the mask bytes are read once (the Figure 8
// sweep's largest stream, 256 x 84 x 16 x 1, is 344 KB: 0.1 us at 3.35
// TB/s), but the work is one dependent chain per tile of cycles x window x
// offsets word operations, so the kernel is bound by the longest tile's
// chain and by how few tiles a stream has (hundreds: a few blocks on 132
// SMs), never by bytes: 0.84 ms on that stream at SparTen's 128-deep
// window, on an H100 80GB HBM3 at 700 W (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace griffin_batch_eval {

constexpr int kThreads = 64;         // tiles per block
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

__global__ void __launch_bounds__(kThreads)
    batch_eval_kernel(const uint8_t* __restrict__ mask,
                      int64_t* __restrict__ out, uint64_t* scratch, int tiles,
                      int T, int K0, int G, int d1, int d2, int d3) {
  extern __shared__ uint64_t smem[];
  __shared__ uint64_t lane_mask[64];   // per dl: lanes [0, K0 - dl) of every
                                       // K0-bit block
  const int n = K0 * G;
  const uint64_t full = low_bits(n);
  const int base = blockIdx.x * kThreads;
  const int nb = min(kThreads, tiles - base);
  const int dl_max = min(d2, K0 - 1);  // dl >= K0 moves no lane
  for (int dl = threadIdx.x; dl <= dl_max; dl += kThreads) {
    uint64_t lanes = low_bits(K0 - dl), rep = 0;
    for (int g = 0; g < G; ++g) rep |= lanes << (g * K0);
    lane_mask[dl] = rep;
  }

  // pack the block's nb x T chunks
  const bool shared = scratch == nullptr;
  const int nwords = nb * T;
  const uint8_t* block_mask = mask + (int64_t)base * T * n;
  for (int idx = threadIdx.x; idx < nwords; idx += kThreads) {
    const uint64_t w = pack_chunk(block_mask + (int64_t)idx * n, n, K0, G);
    const int tl = idx / T, t = idx - tl * T;
    if (shared)
      smem[t * (kThreads + 1) + tl] = w;
    else
      scratch[(int64_t)base * T + idx] = w;
  }
  __syncthreads();
  if ((int)threadIdx.x >= nb) return;

  const int tile = base + threadIdx.x;
  uint64_t* words = shared ? smem + threadIdx.x : scratch + (int64_t)tile * T;
  const int stride = shared ? kThreads + 1 : 1;
  const int64_t win = (int64_t)d1 + 1;
  int nz = 0;
  for (int t = 0; t < T; ++t) nz += words[t * stride] != 0;

  int f = 0;
  int64_t cycles = 0;
  while (nz > 0) {
    uint64_t occ = 0;
    const int end = f + win < T ? (int)(f + win) : T;
    for (int t = f; t < end && occ != full; ++t) {
      uint64_t c = words[t * stride];
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
        words[t * stride] = c;
        nz -= c == 0;
      }
    }
    ++cycles;
    int nf = f;                        // window front advance
    while (nf < end && words[nf * stride] == 0) ++nf;
    f = nf;
  }
  out[tile] = cycles + (T - f + win - 1) / win;   // trailing travel
}

}  // namespace griffin_batch_eval

// Bytes of dynamic shared memory a launch with T chunks per tile needs; 0
// means the words go to the caller's global scratch instead.
extern "C" int batch_eval_smem_bytes(int T) {
  const long long bytes =
      (long long)T * (griffin_batch_eval::kThreads + 1) * 8;
  return bytes <= griffin_batch_eval::kMaxDynSmem ? (int)bytes : 0;
}

extern "C" int batch_eval(const void* mask, void* out, void* scratch,
                          int tiles, int T, int K0, int G, int d1, int d2,
                          int d3, void* stream) {
  using namespace griffin_batch_eval;
  if (tiles <= 0 || T <= 0 || K0 <= 0 || G <= 0 || K0 * G > 64 || d1 < 0 ||
      d2 < 0 || d3 < 0)
    return (int)cudaErrorInvalidValue;
  const int smem = batch_eval_smem_bytes(T);
  if (smem == 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        batch_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (tiles + kThreads - 1) / kThreads;
  batch_eval_kernel<<<blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<int64_t*>(out),
      smem ? nullptr : static_cast<uint64_t*>(scratch), tiles, T, K0, G, d1,
      d2, d3);
  return (int)cudaGetLastError();
}
