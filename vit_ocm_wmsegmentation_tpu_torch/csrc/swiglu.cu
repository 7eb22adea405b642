// The elementwise work of the DINOv2 block around its library products
// (models/vit.py, the "dinov2" block kind; cuBLAS runs qkv, proj, w12 and
// w3 with the bias in the epilogue), two kernels:
//
// * swiglu_gate_kernel: the SwiGLU gate (dinov2/layers/swiglu_ffn.py),
//   x12 (R, 2H) -> g (R, H), g = silu(a) * b with a = x12[:, :H] and
//   b = x12[:, H:], in f32 (silu(a) = a / (1 + exp(-a)), a true division)
//   and rounded once to the storage type;
// * layerscale_norm_kernel: a LayerScale residual and the LayerNorm after
//   it, x' = x + gamma * y (the product and the sum each rounded in f32, no
//   FMA, as torch computes them, then one rounding to the storage type) and
//   z = LN(x') scale + bias of the rounded x', the next norm's input: the
//   attention branch's residual emits LN2's input, the FFN's the next
//   block's LN1 input (or the final norm's), as the fused GELU MLP's "lnout"
//   route does for the DINO block.
//
// Arithmetic, the plain twins' of ops/swiglu.py in f32 up to the order of
// the LayerNorm's sums and expf's last bit.
//
// What bounds them: bytes. The gate reads 2 R H and writes R H values (1.57
// GB at 63749 x 4096 in bf16, 0.47 ms at 3.35 TB/s); the residual reads x and
// y and writes x' and z, 4 R D values (0.39 GB at 63749 x 1536). The gate runs
// one thread an 8-value chunk (16-byte loads of a and b, a 16-byte store), a
// grid-stride loop over the R H / 8 chunks; the residual one warp a row,
// held in registers as loaded (8 values a lane a chunk, chunks 32 apart, so
// that a warp reads 512 contiguous bytes a step) between its two sums.

#include <stdint.h>

#include "common.cuh"

namespace vitocm {

constexpr int kGateThreads = 256;
constexpr int kNormThreads = 256;  // 8 rows a block

__device__ __forceinline__ uint32_t word_of(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// 8 consecutive values of T as loaded (16 bytes of bf16, 32 of f32); v(e) is
// value e as a float
template <typename T>
struct Vec8 {
  uint4 w[sizeof(T) / 2];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < (int)sizeof(T) / 2; ++i) w[i] = reinterpret_cast<const uint4*>(p)[i];
  }
  __device__ __forceinline__ float v(int e) const {
    if constexpr (sizeof(T) == 4) return __uint_as_float(word_of(w[e >> 2], e & 3));
    const uint32_t u = word_of(w[0], e >> 1);
    return __uint_as_float(e & 1 ? u & 0xFFFF0000u : u << 16);
  }
};

// 8 floats stored as T (rounded to nearest even for bf16), 16 or 32 bytes
template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&f)[8]) {
  if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  } else {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// the value v takes once stored as T, back in float
template <typename T>
__device__ __forceinline__ float as_stored(float v) {
  if constexpr (sizeof(T) == 4) return v;
  return round_bf16(v);
}

template <typename T>
__global__ void __launch_bounds__(kGateThreads)
swiglu_gate_kernel(const T* __restrict__ x12, T* __restrict__ g, long long R, int H) {
  const int per_row = H / 8;
  const long long chunks = R * per_row;
  for (long long i = blockIdx.x * (long long)kGateThreads + threadIdx.x; i < chunks;
       i += (long long)gridDim.x * kGateThreads) {
    const long long row = i / per_row;
    const int col = (int)(i - row * per_row) * 8;
    const T* src = x12 + row * 2 * H + col;
    Vec8<T> a, b;
    a.load(src);
    b.load(src + H);
    float out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float av = a.v(e);
      const float s = __fdiv_rn(av, __fadd_rn(1.f, expf(-av)));
      out[e] = __fmul_rn(s, b.v(e));
    }
    store8(g + row * H + col, out);
  }
}

// CPL: chunks of 8 values a lane, at least D / 256
template <typename T, int CPL>
__global__ void __launch_bounds__(kNormThreads)
layerscale_norm_kernel(const T* __restrict__ x, const T* __restrict__ y,
                       const float* __restrict__ gamma, const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ out, T* __restrict__ z,
                       int R, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kNormThreads / 32) + (threadIdx.x >> 5);
  if (row >= R) return;
  const int chunks = D / 8;
  const long long base = (long long)row * D;
  float v[CPL][8];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int ch = lane + 32 * c;
    if (ch < chunks) {
      Vec8<T> xv, yv;
      xv.load(x + base + 8 * ch);
      yv.load(y + base + 8 * ch);
      const float4 g0 = reinterpret_cast<const float4*>(gamma + 8 * ch)[0];
      const float4 g1 = reinterpret_cast<const float4*>(gamma + 8 * ch)[1];
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[c][e] = as_stored<T>(__fadd_rn(xv.v(e), __fmul_rn(gv[e], yv.v(e))));
        sum += v[c][e];
      }
      store8(out + base + 8 * ch, v[c]);
    }
  }
  const float mu = warp_sum(sum) / D;
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < CPL; ++c)
    if (lane + 32 * c < chunks)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float t = v[c][e] - mu;
        q += t * t;
      }
  const float rstd = 1.f / sqrtf(warp_sum(q) / D + eps);
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int ch = lane + 32 * c;
    if (ch < chunks) {
      const float4 s0 = reinterpret_cast<const float4*>(scale + 8 * ch)[0];
      const float4 s1 = reinterpret_cast<const float4*>(scale + 8 * ch)[1];
      const float4 b0 = reinterpret_cast<const float4*>(bias + 8 * ch)[0];
      const float4 b1 = reinterpret_cast<const float4*>(bias + 8 * ch)[1];
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      float zo[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) zo[e] = (v[c][e] - mu) * rstd * sv[e] + bv[e];
      store8(z + base + 8 * ch, zo);
    }
  }
}

template <typename T>
static int launch_gate(const void* x12, void* g, long long R, int H, cudaStream_t s) {
  const long long chunks = R * (H / 8);
  const long long blocks = (chunks + kGateThreads - 1) / kGateThreads;
  // a grid-stride loop past 16 waves of 2048-thread SMs' worth of blocks
  const int grid = (int)(blocks < 132LL * 8 * 16 ? blocks : 132LL * 8 * 16);
  swiglu_gate_kernel<T><<<grid, kGateThreads, 0, s>>>(static_cast<const T*>(x12),
                                                      static_cast<T*>(g), R, H);
  return (int)cudaGetLastError();
}

template <typename T, int CPL>
static void launch_norm_cpl(const void* x, const void* y, const float* gamma, const float* scale,
                            const float* bias, void* out, void* z, int R, int D, float eps,
                            cudaStream_t s) {
  const dim3 grid((R + kNormThreads / 32 - 1) / (kNormThreads / 32));
  layerscale_norm_kernel<T, CPL><<<grid, kNormThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), gamma, scale, bias,
      static_cast<T*>(out), static_cast<T*>(z), R, D, eps);
}

template <typename T>
static int launch_norm(const void* x, const void* y, const float* gamma, const float* scale,
                       const float* bias, void* out, void* z, int R, int D, float eps,
                       cudaStream_t s) {
  const int need = (D / 8 + 31) / 32;  // chunks a lane
  if (need <= 1) launch_norm_cpl<T, 1>(x, y, gamma, scale, bias, out, z, R, D, eps, s);
  else if (need <= 2) launch_norm_cpl<T, 2>(x, y, gamma, scale, bias, out, z, R, D, eps, s);
  else if (need <= 3) launch_norm_cpl<T, 3>(x, y, gamma, scale, bias, out, z, R, D, eps, s);
  else if (need <= 4) launch_norm_cpl<T, 4>(x, y, gamma, scale, bias, out, z, R, D, eps, s);
  else if (need <= 6) launch_norm_cpl<T, 6>(x, y, gamma, scale, bias, out, z, R, D, eps, s);
  else launch_norm_cpl<T, 8>(x, y, gamma, scale, bias, out, z, R, D, eps, s);
  return (int)cudaGetLastError();
}

}  // namespace vitocm

// x12 (R, 2H) f32 (dtype 0) or bf16 (1), 16-byte aligned; g (R, H) out.
// H a multiple of 8. Returns cudaGetLastError() after the launch.
extern "C" int vitocm_swiglu_gate(int dtype, const void* x12, void* g, long long R, int H,
                                  void* stream) {
  using namespace vitocm;
  if (R < 1 || H < 8 || H % 8 != 0) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_gate<float>(x12, g, R, H, s);
  if (dtype == kBF16) return launch_gate<__nv_bfloat16>(x12, g, R, H, s);
  return (int)cudaErrorInvalidValue;
}

// x, y (R, D) of the storage dtype, 16-byte aligned; gamma, scale, bias (D,)
// f32; out = x + gamma * y and z = LN(out) scale + bias, (R, D) each. D a
// multiple of 8 and at most 2048.
extern "C" int vitocm_layerscale_norm(int dtype, const void* x, const void* y, const void* gamma,
                                      const void* scale, const void* bias, void* out, void* z,
                                      int R, int D, float eps, void* stream) {
  using namespace vitocm;
  if (R < 1 || D < 8 || D % 8 != 0 || D > 2048) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  if (dtype == kF32) return launch_norm<float>(x, y, g, sc, b, out, z, R, D, eps, s);
  if (dtype == kBF16) return launch_norm<__nv_bfloat16>(x, y, g, sc, b, out, z, R, D, eps, s);
  return (int)cudaErrorInvalidValue;
}
