// 256-bin histogram of a flat uint8 buffer, exact 64-bit counts.
//
// Replaces vit_ocm_wmsegmentation_tpu/ops/threshold.py::histogram_u8_pallas
// (kernel body `kern`): the streamed gigapixel path runs it once per mosaic
// over the uint8 blend image before the Otsu threshold (1.07 G pixels at
// 32768^2). The TPU kernel carries its int32 counts across a sequential
// grid. Here the blocks run in parallel: each CTA counts into one private
// 256-bin uint32 sub-histogram per warp in shared memory (8 warps, 8 KB),
// merges them, and adds each non-zero bin to the global (256,) 64-bit count
// with one atomic. Integer atomics commute, so the counts do not depend on
// the order the CTAs run in, and no count passes through a float: an f32
// accumulator would stall at 2^24 per bin, which the gigapixel image passes.
//
// What bounds it on the H100: bytes. Every input byte is read once, with
// 16-byte (uint4) loads in a grid-stride loop, a byte-wise head for a data
// pointer that is not 16-byte aligned (a view such as x[1:]) and a
// byte-wise tail. The counting is shared-memory atomics. Skewed data (the
// blend image is mostly bin 0 wherever the attention is low) sends many
// lanes of a warp to one shared address, which serialises them; each
// thread therefore counts runs of equal bytes in registers and adds a whole
// run with one atomic.
//
// Overflow: a warp's uint32 sub-histogram counts only the bytes its 32
// threads read. Once the buffer is large the grid is capped at 8 CTAs an
// SM, so a warp reads about n / (8 * 8 * SMs) bytes (n / 8448 on 132 SMs):
// below 2^32 for any buffer the card can hold.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace vitocm {

constexpr int kHistThreads = 256;
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kHistCtasPerSm = 8;  // 8 x 256 threads fill an SM's 2048

struct RunCounter {
  unsigned* hist;  // this warp's sub-histogram
  unsigned value = 0, run = 0;

  __device__ __forceinline__ void push(unsigned b) {
    if (b == value) {
      ++run;
    } else {
      if (run) atomicAdd(&hist[value], run);
      value = b;
      run = 1;
    }
  }
  __device__ __forceinline__ void push_word(unsigned w) {
#pragma unroll
    for (int k = 0; k < 4; ++k) push((w >> (8 * k)) & 0xffu);
  }
  __device__ __forceinline__ void flush() {
    if (run) atomicAdd(&hist[value], run);
    run = 0;
  }
};

// x[0, head) byte-wise, then nv 16-byte vectors from x + head, then the
// tail x[head + 16 nv, n) byte-wise; head and the tail are below 16 bytes
__global__ void __launch_bounds__(kHistThreads)
    histogram_u8_kernel(const uint8_t* __restrict__ x, size_t n, size_t head, size_t nv,
                        unsigned long long* __restrict__ counts) {
  __shared__ unsigned sub[kHistWarps][256];
  for (int i = threadIdx.x; i < kHistWarps * 256; i += kHistThreads) (&sub[0][0])[i] = 0u;
  __syncthreads();

  RunCounter rc{sub[threadIdx.x / 32]};
  const size_t tid = static_cast<size_t>(blockIdx.x) * kHistThreads + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * kHistThreads;
  if (tid < head) rc.push(x[tid]);
  const uint4* v = reinterpret_cast<const uint4*>(x + head);
  for (size_t i = tid; i < nv; i += stride) {
    const uint4 q = __ldg(v + i);
    rc.push_word(q.x);
    rc.push_word(q.y);
    rc.push_word(q.z);
    rc.push_word(q.w);
  }
  const size_t tail = head + nv * 16;
  if (tail + tid < n) rc.push(x[tail + tid]);
  rc.flush();
  __syncthreads();

  for (int b = threadIdx.x; b < 256; b += kHistThreads) {
    unsigned long long s = 0;
#pragma unroll
    for (int w = 0; w < kHistWarps; ++w) s += sub[w][b];
    if (s) atomicAdd(&counts[b], s);
  }
}

}  // namespace vitocm

// x: n bytes on the current device; counts: (256,) int64 on it, zeroed by
// the caller, to which the counts are added. Returns cudaGetLastError()
// after the launch (0 on success); n == 0 launches nothing.
extern "C" int vitocm_histogram_u8(const void* x, size_t n, void* counts, void* stream) {
  using namespace vitocm;
  if (n == 0) return 0;
  if (x == nullptr || counts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t mis = reinterpret_cast<uintptr_t>(x) & 15u;
  const size_t head = mis ? (16 - mis < n ? 16 - mis : n) : 0;
  const size_t nv = (n - head) / 16;
  const size_t want = (nv + kHistThreads - 1) / kHistThreads;
  const size_t cap = static_cast<size_t>(sms > 0 ? sms : 1) * kHistCtasPerSm;
  const unsigned grid = static_cast<unsigned>(want < 1 ? 1 : (want < cap ? want : cap));
  histogram_u8_kernel<<<grid, kHistThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), n, head, nv, static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}
