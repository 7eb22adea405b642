// 256-bin histogram of a flat uint8 buffer, exact 64-bit counts.
//
// Replaces vit_ocm_wmsegmentation_tpu/ops/threshold.py::histogram_u8_pallas
// (kernel body `kern`): the streamed gigapixel path runs it once per mosaic
// over the uint8 blend image before the Otsu threshold (1.07 G pixels at
// 32768^2). The TPU kernel carries its int32 counts across a sequential
// grid. Here the CTAs run in parallel, one an SM, and each adds each
// non-zero bin of its sums to the global (256,) 64-bit count with one
// atomic. Integer atomics commute, so the counts do not depend on the order
// the CTAs run in, and no count passes through a float: an f32 accumulator
// would stall at 2^24 per bin, which the gigapixel image passes.
//
// What bounds it on the H100: bytes, 1.07 GB read once at 32768^2 (0.32 ms
// at 3.35 TB/s), so every SM must keep ~40 KB in flight while it counts 15
// bytes a cycle. The kernel this replaced had one 16-byte load in flight per
// thread, behind 16 counts that branched on the data and each took a shared
// atomic on a per-warp sub-histogram (lanes of a warp on one bin or one bank
// serialize): 1.46 TB/s on spread bytes. Here the loading and the counting
// are apart:
//   * loads: one lane of a producer warp streams the buffer in 16 KB pieces
//     by cp.async.bulk (1-D TMA) into a ring of 4 stages behind "full" and
//     "empty" mbarriers, 48 KB in flight whatever the counting costs; piece
//     P goes to CTA P % G, so the card reads the buffer front to back. The
//     head of a view whose data pointer is not 16-byte aligned (x[1:]) and
//     the last n % 16 bytes are counted byte-wise by CTA 0;
//   * counting: 256 counting threads, each with private 16-bit counters in
//     shared memory laid out [bin % 128][thread], bins b and b + 128 in the
//     two halves of one word: a thread's words all lie in bank thread % 32,
//     so the 32 lanes of a warp always hit 32 banks, on spread and on skewed
//     bytes alike, and no lane waits on another. Each byte is one shared
//     atomic add (fire-and-forget, so a thread's adds do not wait on each
//     other) of 1 or 1 << 16, with no branch on its value; a warp whose 64
//     bytes a lane of a piece are all 0 (a run of bin 0, as in the dark parts
//     of the blend image) adds them with one atomic a lane. The counters
//     (128 KB) are summed into 64-bit totals before any can wrap: at the
//     end, and after every 1023 pieces (65472 bytes a thread).
// On an H100 this was faster than per-warp 32-bit sub-histograms under the
// same atomics (bank conflicts on spread bytes), than private counters
// updated by load, add and store (each waits on the last), than contiguous
// shares a CTA, and than 3, 5 or 6 stages or 8 or 32 KB pieces (PERF.md).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

namespace vitocm {

constexpr int kHistT = 256;                  // counting threads
constexpr int kHistThreads = kHistT + 32;    // and a producer warp
constexpr int kHistStages = 4;
constexpr int kHistPiece = 16384;            // bytes a stage: 4 x 16 a counting thread
constexpr int kHistVecs = kHistPiece / 16;   // 16-byte vectors a stage
constexpr int kHistFlush = 65535 / (kHistPiece / kHistT);  // pieces between flushes
static_assert(kHistT == 256, "counting thread t sums bin t");
constexpr size_t kHistSmem = 1024 + 128 * kHistT * 4 + kHistStages * kHistPiece +
                             8 * 2 * kHistStages;

__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the four bytes of w into this thread's counters (word (b % 128) * kHistT)
__device__ __forceinline__ void count_word(unsigned* mine, unsigned w) {
  const unsigned lo = w & 0x7f7f7f7fu, hi = (w >> 7) & 0x01010101u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned idx = __byte_perm(lo, 0, 0x4440 | k), h = __byte_perm(hi, 0, 0x4440 | k);
    atomicAdd(mine + idx * kHistT, 1u + h * 0xffffu);
  }
}

// m bytes of value b into this thread's counters
__device__ __forceinline__ void count_byte(unsigned* mine, unsigned b, unsigned m = 1u) {
  atomicAdd(mine + (b & 127u) * kHistT, m << ((b >> 7) * 16));
}

// bin t's count over every counting thread's counters, added to total
__device__ __forceinline__ void sum_bin(const unsigned* cnt, int t, unsigned long long& total) {
  const unsigned* row = cnt + (t & 127) * kHistT;
  const int shift = (t >> 7) * 16;
  unsigned s[4] = {0u, 0u, 0u, 0u};  // each at most kHistT * 65535 < 2^32
#pragma unroll 8
  for (int j = 0; j < kHistT; ++j) s[j & 3] += (row[(j + t) & (kHistT - 1)] >> shift) & 0xffffu;
  total += (unsigned long long)s[0] + s[1] + s[2] + s[3];
}

// x[0, head) byte-wise, then nv 16-byte vectors from x + head (pieces of
// kHistVecs, piece P in CTA P % G), then the tail x[head + 16 nv, n)
// byte-wise; head and the tail are below 16 bytes
__global__ void __launch_bounds__(kHistThreads, 1)
    histogram_u8_kernel(const uint8_t* __restrict__ x, size_t n, size_t head, size_t nv,
                        unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned* cnt = reinterpret_cast<unsigned*>(align1024(smem_raw));  // (128, kHistT)
  unsigned char* ring = reinterpret_cast<unsigned char*>(cnt + 128 * kHistT);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kHistStages * kHistPiece);
  uint64_t* empty = full + kHistStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t np = (nv + kHistVecs - 1) / kHistVecs;
  const long long pieces = (long long)((np - blockIdx.x + gridDim.x - 1) / gridDim.x);
  if (tid == 0) {
    for (int st = 0; st < kHistStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kHistT / 32);  // every counting warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kHistT / 32) {  // producer warp: one lane issues every copy
    if (lane == 0) {
      const uint8_t* src = x + head;
      for (long long k = 0; k < pieces; ++k) {
        const int st = (int)(k % kHistStages);
        const size_t P = blockIdx.x + (size_t)k * gridDim.x, left = nv - P * kHistVecs;
        const unsigned bytes = 16u * (unsigned)(left < kHistVecs ? left : kHistVecs);
        mbar_wait(&empty[st], (unsigned)((k / kHistStages) & 1) ^ 1u);
        mbar_expect_tx(&full[st], bytes);
        bulk_load(ring + st * kHistPiece, src + P * kHistPiece, bytes, &full[st]);
      }
    }
    return;
  }

  unsigned* mine = cnt + tid;  // zeroed by this thread alone, while the first pieces load
#pragma unroll 8
  for (int w = 0; w < 128; ++w) mine[w * kHistT] = 0u;
  if (blockIdx.x == 0) {
    const size_t tail = head + 16 * nv;
    if ((size_t)tid < head) count_byte(mine, x[tid]);
    if (tail + tid < n) count_byte(mine, x[tail + tid]);
  }
  unsigned long long total = 0;  // bin tid's count from the flushed counters
  for (long long k = 0; k < pieces; ++k) {
    const int st = (int)(k % kHistStages);
    const size_t left = nv - (blockIdx.x + (size_t)k * gridDim.x) * kHistVecs;
    const int nvec = left < kHistVecs ? (int)left : kHistVecs;
    mbar_wait(&full[st], (unsigned)((k / kHistStages) & 1));
    const uint4* v = reinterpret_cast<const uint4*>(ring + st * kHistPiece);
    uint4 q[kHistVecs / kHistT];
#pragma unroll
    for (int j = 0; j < kHistVecs / kHistT; ++j) {
      const int i = tid + j * kHistT;
      q[j] = i < nvec ? v[i] : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // the stage is in registers: refill it
    // a warp whose 64 bytes a lane are all 0 (a run of bin 0) counts them
    // with one add a lane
    unsigned any = 0u;
#pragma unroll
    for (int j = 0; j < kHistVecs / kHistT; ++j) any |= q[j].x | q[j].y | q[j].z | q[j].w;
    if (__all_sync(0xffffffffu, any == 0u)) {
      const int m = nvec <= tid ? 0 : min((nvec - tid + kHistT - 1) / kHistT, kHistVecs / kHistT);
      if (m) count_byte(mine, 0u, 16u * m);  // this thread's vectors of the piece
    } else {
#pragma unroll
      for (int j = 0; j < kHistVecs / kHistT; ++j) {
        if (tid + j * kHistT >= nvec) break;
        count_word(mine, q[j].x);
        count_word(mine, q[j].y);
        count_word(mine, q[j].z);
        count_word(mine, q[j].w);
      }
    }
    if ((k + 1) % kHistFlush == 0 && k + 1 < pieces) {  // before a 16-bit counter can wrap
      named_barrier(1, kHistT);
      sum_bin(cnt, tid, total);
      named_barrier(1, kHistT);
#pragma unroll 8
      for (int w = 0; w < 128; ++w) mine[w * kHistT] = 0u;
    }
  }
  named_barrier(1, kHistT);
  sum_bin(cnt, tid, total);
  if (total) atomicAdd(&counts[tid], total);
}

}  // namespace vitocm

// x: n bytes on the current device; counts: (256,) int64 on it, zeroed by
// the caller, to which the counts are added. Returns cudaGetLastError()
// after the launch (0 on success); n == 0 launches nothing.
extern "C" int vitocm_histogram_u8(const void* x, size_t n, void* counts, void* stream) {
  using namespace vitocm;
  if (n == 0) return 0;
  if (x == nullptr || counts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int rc = device_sms_for<&histogram_u8_kernel>(kHistSmem, &sms);
  if (rc != 0) return rc;
  const size_t mis = reinterpret_cast<uintptr_t>(x) & 15u;
  const size_t head = mis ? (16 - mis < n ? 16 - mis : n) : 0;
  const size_t nv = (n - head) / 16;
  const size_t want = (nv + kHistVecs - 1) / kHistVecs;  // pieces
  const size_t cap = static_cast<size_t>(sms);
  const unsigned grid = static_cast<unsigned>(want < 1 ? 1 : (want < cap ? want : cap));
  histogram_u8_kernel<<<grid, kHistThreads, kHistSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), n, head, nv, static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}
