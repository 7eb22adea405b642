// Fused pre-norm MLP block of a ViT layer, forward only:
//   out = x + W2 . gelu(W1 . LN(x; s1, b1n) + b1) + b2
//   z   = LN(out; s2, b2n)                      (LNOUT variant only)
//
// Replaces vit_ocm_wmsegmentation_tpu/ops/fused_mlp.py::_mlp_fwd_lnout_kernel
// (fused_mlp_block_lnout, LNOUT = true: blocks 0-9 of the mosaic path, z is
// the next block's normalized input) and ::_mlp_fwd_kernel (LNOUT = false):
// with no residual outputs for block 10 of the mosaic path, and on its
// save-h1 route (want="h1", the training forward) when h1 is not null: the
// pre-GELU h1 = W1 . LN(x) + b1 (R, H) is then stored in the storage type
// for the backward (fused_mlp_bwd.cu) to recompute GELU from. With gp not
// null as well (want="gp", the SAVE_GP route) the kernel stores g = gelu(h1)
// in h1's place and gp = gelu'(h1), both in the storage type, so that the
// backward computes no erf and no exp; g is the very value the forward
// multiplies by W2, so out is bit-equal to the save-h1 route's.
//
// Weight layouts are PyTorch's nn.Linear ones, as the port's ViT holds them:
// w1 = fc1.weight (H, D), w2 = fc2.weight (D, H), both contiguous in the
// storage type (f32 here, bf16 in fused_mlp_mma.cu). LayerNorm scales and
// all biases come in as f32.
//
// What bounds it on the H100: the (rows, H) hidden activation is what the
// fusion keeps out of HBM (at the mosaic shape 112945 x 1536, 347 MB in bf16
// per layer, written and read back by an unfused block). A CTA owns 32 rows:
// it normalizes them once into shared memory, then walks H in chunks of 32
// hidden units: h1 = xn . W1[c]^T + b1, exact-erf GELU, and
// y += g . W2[:, c]^T into a (32, D) f32 accumulator held
// in registers (48 floats a thread at D = 384). Shared memory at D = 384:
// xn, a W1 chunk and a W2 chunk of 32 x 385 floats each plus the g tile,
// 152 KB, which is above the 48 KB default and set through
// cudaFuncAttributeMaxDynamicSharedMemorySize; one CTA fits an SM. This
// kernel serves f32 storage only: the products run on the CUDA cores in f32,
// never through TF32, so it is bound by shared-memory loads and FMA issue;
// the weight chunks are re-read from L2 by every CTA. bf16 storage takes the
// tensor-core kernels of fused_mlp_wgmma.cu (inference) and fused_mlp_mma.cu
// (the training forward).
//
// Numerics, kept from the TPU kernel: LN statistics in f32 (biased
// variance); f32 products and accumulation (the TPU kernel's roundings of
// xn, g and out to the storage type are the identity in f32); z computed
// from the stored out. Deliberate difference: GELU uses erff, which is exact to
// ~1 ulp, where the TPU kernel carries Eigen's rational erf (_erf_f32); the
// two differ by about 1 ulp of f32.

#include <math.h>

#include "common.cuh"

namespace vitocm {

constexpr int kBR = 32;   // rows per CTA
constexpr int kHC = 32;   // hidden units per chunk
constexpr int kMT = 256;  // threads: 8 warps, warp w owns rows w + 8*i

template <int D>
constexpr size_t mlp_smem_bytes() {
  return sizeof(float) * (kBR * (D + 1) + 2 * kHC * (D + 1) + kBR * (kHC + 1));
}

template <int D, bool LNOUT, bool H1, bool GP>
__global__ void __launch_bounds__(kMT)
fused_mlp_kernel(const float* __restrict__ x, const float* __restrict__ s1,
                 const float* __restrict__ bn1, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, const float* __restrict__ s2,
                 const float* __restrict__ bn2, float* __restrict__ out,
                 float* __restrict__ z, float* __restrict__ h1, float* __restrict__ gp,
                 int R, int H, float eps) {
  constexpr int CPT = D / 32;
  constexpr int RPW = kBR / 8;  // rows per warp
  constexpr int PD = D + 1;
  constexpr int PG = kHC + 1;
  extern __shared__ float sm[];
  float* xn = sm;              // (BR, PD)
  float* w1s = xn + kBR * PD;  // (HC, PD): w1s[j][k] = W1[h0 + j][k]
  float* w2s = w1s + kHC * PD; // (HC, PD): w2s[j][c] = W2[c][h0 + j]
  float* gs = w2s + kHC * PD;  // (BR, PG)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * kBR;

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + 8 * i;
    const long long row = r0 + r;
    float v[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) v[c] = row < R ? x[row * D + lane + 32 * c] : 0.f;
    float mu, rstd;
    warp_ln_stats<D>(v, eps, mu, rstd);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = lane + 32 * c;
      xn[r * PD + col] = (v[c] - mu) * rstd * s1[col] + bn1[col];
    }
  }

  float acc[RPW][CPT];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int h0 = 0; h0 < H; h0 += kHC) {
    __syncthreads();  // xn written / the previous chunk consumed
    for (int i = tid; i < kHC * D; i += kMT) {
      const int j = i / D, k = i % D;
      w1s[j * PD + k] = w1[(long long)(h0 + j) * D + k];
    }
    for (int i = tid; i < kHC * D; i += kMT) {
      const int c = i / kHC, j = i % kHC;
      w2s[j * PD + c] = w2[(long long)c * H + h0 + j];
    }
    __syncthreads();

    {  // h1 for hidden unit h0 + lane, rows warp + 8*i
      float h[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) h[i] = 0.f;
#pragma unroll 4
      for (int k = 0; k < D; ++k) {
        const float wv = w1s[lane * PD + k];
#pragma unroll
        for (int i = 0; i < RPW; ++i) h[i] = fmaf(xn[(warp + 8 * i) * PD + k], wv, h[i]);
      }
      const float bj = b1[h0 + lane];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float t = h[i] + bj;
        float gv, gpv;
        gelu_pieces(t, gv, gpv);
        gs[(warp + 8 * i) * PG + lane] = gv;
        const long long row = r0 + warp + 8 * i;
        if (H1 && row < R) h1[row * H + h0 + lane] = GP ? gv : t;
        if (GP && row < R) gp[row * H + h0 + lane] = gpv;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kHC; ++j) {
      float wv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) wv[c] = w2s[j * PD + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float g = gs[(warp + 8 * i) * PG + j];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(g, wv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const long long row = r0 + warp + 8 * i;
    float o[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = lane + 32 * c;
      const float xv = row < R ? x[row * D + col] : 0.f;
      o[c] = xv + (acc[i][c] + b2[col]);
    }
    if (row < R) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) out[row * D + lane + 32 * c] = o[c];
    }
    if (LNOUT) {
      float mu, rstd;
      warp_ln_stats<D>(o, eps, mu, rstd);
      if (row < R) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int col = lane + 32 * c;
          z[row * D + col] = (o[c] - mu) * rstd * s2[col] + bn2[col];
        }
      }
    }
  }
}

template <int D, bool LNOUT>
static int launch_mlp(const void* x, const float* s1, const float* bn1, const void* w1,
                      const float* b1, const void* w2, const float* b2, const float* s2,
                      const float* bn2, void* out, void* z, void* h1, void* gp, int R, int H,
                      float eps, cudaStream_t stream) {
  const size_t smem = mlp_smem_bytes<D>();
  // the residual stores are template flags, so the inference instantiations carry none of them
  auto kern = h1 == nullptr   ? fused_mlp_kernel<D, LNOUT, false, false>
              : gp == nullptr ? fused_mlp_kernel<D, LNOUT, !LNOUT, false>
                              : fused_mlp_kernel<D, LNOUT, !LNOUT, !LNOUT>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int grid = (R + kBR - 1) / kBR;
  kern<<<grid, kMT, smem, stream>>>(static_cast<const float*>(x), s1, bn1,
                                    static_cast<const float*>(w1), b1,
                                    static_cast<const float*>(w2), b2, s2, bn2,
                                    static_cast<float*>(out), static_cast<float*>(z),
                                    static_cast<float*>(h1), static_cast<float*>(gp), R, H, eps);
  return (int)cudaGetLastError();
}

// bf16 storage takes the tensor-core kernels: fused_mlp_mma.cu for the
// training forward (h1 not null), fused_mlp_wgmma.cu for inference (its own
// entry point, vitocm_fused_mlp_wgmma)
template <int D>
int launch_mlp_mma(const void* x, const float* s1, const float* bn1, const void* w1,
                   const float* b1, const void* w2, const float* b2, void* out, void* h1,
                   void* gp, int R, int H, float eps, cudaStream_t stream);

template <int D, bool LNOUT>
static int launch_any(int dtype, const void* x, const float* s1, const float* bn1,
                      const void* w1, const float* b1, const void* w2, const float* b2,
                      const float* s2, const float* bn2, void* out, void* z, void* h1, void* gp,
                      int R, int H, float eps, cudaStream_t stream) {
  if (dtype == kF32)
    return launch_mlp<D, LNOUT>(x, s1, bn1, w1, b1, w2, b2, s2, bn2, out, z, h1, gp, R, H, eps,
                                stream);
  if constexpr (!LNOUT) {
    if (dtype == kBF16 && h1 != nullptr)
      return launch_mlp_mma<D>(x, s1, bn1, w1, b1, w2, b2, out, h1, gp, R, H, eps, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int D>
static int dispatch_lnout(int dtype, int lnout, const void* x, const float* s1,
                          const float* bn1, const void* w1, const float* b1, const void* w2,
                          const float* b2, const float* s2, const float* bn2, void* out,
                          void* z, void* h1, void* gp, int R, int H, float eps,
                          cudaStream_t stream) {
  if (lnout)
    return launch_any<D, true>(dtype, x, s1, bn1, w1, b1, w2, b2, s2, bn2, out, z, h1, gp, R, H,
                               eps, stream);
  return launch_any<D, false>(dtype, x, s1, bn1, w1, b1, w2, b2, s2, bn2, out, z, h1, gp, R, H,
                              eps, stream);
}

}  // namespace vitocm

// x, out, z (R, D); h1, gp (R, H); w1 (H, D); w2 (D, H) in the storage
// type; s1, bn1, s2, bn2, b2 (D) and b1 (H) in f32. lnout = 0 ignores s2, bn2
// and z; h1 may be null, and must be with lnout = 1; gp not null (it needs
// h1) takes the SAVE_GP route: g = gelu(h1) into h1, gelu'(h1) into gp.
// bf16 only with h1 (the training forward); bf16 inference takes
// vitocm_fused_mlp_wgmma. D in {192, 384}, H a multiple of 64. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int vitocm_fused_mlp(int dtype, int lnout, const void* x, const void* s1,
                                const void* bn1, const void* w1, const void* b1, const void* w2,
                                const void* b2, const void* s2, const void* bn2, void* out,
                                void* z, void* h1, void* gp, int R, int D, int H, float eps,
                                void* stream) {
  using namespace vitocm;
  if (R < 1 || H < 64 || H % 64 != 0 || (lnout && (z == nullptr || h1 != nullptr)) ||
      (gp != nullptr && h1 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (D == 384)
    return dispatch_lnout<384>(dtype, lnout, x, f(s1), f(bn1), w1, f(b1), w2, f(b2), f(s2),
                               f(bn2), out, z, h1, gp, R, H, eps, s);
  if (D == 192)
    return dispatch_lnout<192>(dtype, lnout, x, f(s1), f(bn1), w1, f(b1), w2, f(b2), f(s2),
                               f(bn2), out, z, h1, gp, R, H, eps, s);
  return (int)cudaErrorInvalidValue;
}
