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
// storage type (f32 here, bf16 in fused_mlp_wgmma.cu). LayerNorm scales and
// all biases come in as f32.
//
// What bounds it on the H100: the (rows, H) hidden activation is what the
// fusion keeps out of HBM (at the mosaic shape 112945 x 1536, 694 MB in f32
// per layer, written and read back by an unfused block). What is left is
// 4 R D H flops of exact f32 products on the CUDA cores (FFMA, never TF32):
// 266 GFLOP at the mosaic shape against 67 TFLOP/s. An SM issues 128 FFMA a
// cycle but moves 32 floats a cycle from shared memory to registers, so a
// micro-tile of TR x TK outputs, which loads TR + TK floats for TR * TK
// FFMA, keeps the pipes fed only from TR * TK / (TR + TK) = 4. The design
// (the f32 attention kernels' building blocks, ffma_tiles.cuh):
//   * a CTA of 256 threads owns 64 rows: it normalizes them once into
//     shared memory (xn, pitch D + 4) and walks H in chunks of 128 hidden
//     units, so the weights are read from L2 once per 64 rows;
//   * h1 for a chunk (64 x 128, depth D) is a register micro-tile of 4 rows
//     x 8 units a thread (tile_dot, 16 row groups of 16 lanes, operands read
//     as float4 along D); bias and exact-erf GELU follow in registers, g goes
//     to a shared (64 x 128) tile (and h1, g, gp to device memory on the
//     training routes); 4 x 8 loads 2.67 floats an FFMA where 8 x 8 would
//     load 4, but 8 x 8 over 256-unit chunks spilled beside the 96-float y
//     accumulator at 255 registers and ran slower on the H100;
//   * y (64 x D) stays in registers for the whole walk, 8 rows x D/32
//     columns a thread (8 x 12 at D = 384, one warp a row group), fed by
//     tile_dot from the g tile and W2's rows, both read along the hidden
//     units;
//   * the weights arrive in slices through a two-slot ring of 16-byte
//     cp.async copies, in their nn.Linear layouts: W1 rows (128 units x 64
//     of D) for the h1 product, W2 rows (D x 16 units) for the y product;
//     slice s + 1 is in flight while slice s is multiplied, one barrier a
//     slice.
// Shared memory at D = 384: xn 97 KB, the g tile 36 KB, two slots of 34 KB:
// 201 KB, one CTA an SM. A chunk past H (H a multiple of 64, not of 128)
// reads zero rows of W1 and walks only its valid W2 slices. bf16 storage
// takes the wgmma kernel of fused_mlp_wgmma.cu, inference and training.
//
// Numerics, kept from the TPU kernel: LN statistics in f32 (biased
// variance); f32 products and accumulation (the TPU kernel's roundings of
// xn, g and out to the storage type are the identity in f32); z computed
// from the stored out. Every sum runs over its inner index in order: h1 over
// k = 0 .. D-1 from 0, then the bias; y over the hidden units 0 .. H-1 from
// 0, then b2 and the residual; so the results do not depend on the tiling.
// Deliberate difference: GELU uses erff, which is exact to ~1 ulp, where the
// TPU kernel carries Eigen's rational erf (_erf_f32); the two differ by
// about 1 ulp of f32.

#include <math.h>

#include "common.cuh"
#include "ffma_tiles.cuh"

namespace vitocm {

constexpr int kBR = 64;        // rows a CTA
constexpr int kHC = 128;       // hidden units a chunk
constexpr int kKS = 64;        // depth (of D) of a W1 slice
constexpr int kJS = 16;        // hidden units of a W2 slice
constexpr int kMT = 256;       // threads: 8 warps
constexpr int kGP = kHC + 16;  // the g tile's pitch: a warp's two row groups store to distinct banks

// floats of a ring slot: a W1 slice (HC x KS) or a W2 slice (D x JS)
template <int D>
__host__ __device__ constexpr int mlp_slot() {
  return kHC * (kKS + 4) > D * (kJS + 4) ? kHC * (kKS + 4) : D * (kJS + 4);
}

template <int D>
constexpr size_t mlp_smem_bytes() {
  return sizeof(float) * (kBR * (D + 4) + kBR * kGP + 2 * mlp_slot<D>());
}

template <int D, bool LNOUT, bool H1, bool GP>
__global__ void __launch_bounds__(kMT, 1)
fused_mlp_kernel(const float* __restrict__ x, const float* __restrict__ s1,
                 const float* __restrict__ bn1, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, const float* __restrict__ s2,
                 const float* __restrict__ bn2, float* __restrict__ out,
                 float* __restrict__ z, float* __restrict__ h1, float* __restrict__ gp,
                 int R, int H, float eps) {
  constexpr int CPT = D / 32;   // y columns a lane: lane + 32c
  constexpr int RPW = kBR / 8;  // y rows a warp: warp + 8i
  constexpr int PX = D + 4, SLOT = mlp_slot<D>(), NK = D / kKS;
  static_assert(D % kKS == 0 && 64 % kJS == 0 && kBR == 64 && kHC == 128, "tile shape");
  extern __shared__ __align__(16) float sm[];
  float* xn = sm;                // (BR, PX)
  float* gs = xn + kBR * PX;     // (BR, GP): g of the chunk
  float* ring = gs + kBR * kGP;  // 2 slots

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = tid >> 4, kg = tid & 15;  // the h1 tile: rows rg + 16i, units kg + 16j
  const int r0 = blockIdx.x * kBR;
  const int chunks = (H + kHC - 1) / kHC;
  // slice p of chunk c: W1[h0 .. h0+HC, 64p ..] for p < NK, then W2[:, h0 + 16(p-NK) ..]
  auto issue = [&](int c, int p, float* dst) {
    const int h0 = c * kHC;
    if (p < NK)
      stage_rows<kHC, kKS, kKS + 4, kMT>(dst, w1 + (long long)h0 * D + p * kKS, 0, H - h0, D);
    else
      stage_rows<D, kJS, kJS + 4, kMT>(dst, w2 + h0 + (p - NK) * kJS, 0, D, H);
  };
  // wait for slice st (slice p of np of chunk ch), put the next one in flight
  auto next = [&](int ch, int p, int np, int st) {
    cp_async_wait<0>();
    __syncthreads();  // slice st has landed; slice st-1 and (in a y phase) the g tile are done
    float* dst = ring + ((st + 1) & 1) * SLOT;
    if (p + 1 < np)
      issue(ch, p + 1, dst);
    else if (ch + 1 < chunks)
      issue(ch + 1, 0, dst);
    cp_async_commit();
    return ring + (st & 1) * SLOT;
  };

  issue(0, 0, ring);
  cp_async_commit();

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
      xn[r * PX + col] = (v[c] - mu) * rstd * s1[col] + bn1[col];
    }
  }

  float acc[RPW][CPT];  // y of rows warp + 8i, columns lane + 32c
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  for (int ch = 0, st = 0; ch < chunks; ++ch) {
    const int h0 = ch * kHC, nh = min(kHC, H - h0), np = NK + nh / kJS;
    float s[4][8];  // h1 of rows rg + 16i, units kg + 16j of the chunk
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int p = 0; p < NK; ++p, ++st)
      tile_dot<4, 8, 16, 16, kKS, PX, kKS + 4>(s, xn + p * kKS, next(ch, p, np, st), rg, kg);
    // bias, GELU, the g tile; h1 (or g) and gp on the training routes
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int u = kg + 16 * j;
      const bool on = u < nh;
      const float bj = on ? b1[h0 + u] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 16 * i;
        const long long row = r0 + r;
        const float t = s[i][j] + bj;
        float gv, gpv;
        gelu_pieces(t, gv, gpv);
        gs[r * kGP + u] = gv;
        if (H1 && on && row < R) h1[row * H + h0 + u] = GP ? gv : t;
        if (GP && on && row < R) gp[row * H + h0 + u] = gpv;
      }
    }
    for (int p = NK; p < np; ++p, ++st)
      tile_dot<RPW, CPT, 8, 32, kJS, kGP, kJS + 4>(acc, gs + (p - NK) * kJS, next(ch, p, np, st),
                                                   warp, lane);
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

template <int D>
static int dispatch_lnout(int lnout, const void* x, const float* s1, const float* bn1,
                          const void* w1, const float* b1, const void* w2, const float* b2,
                          const float* s2, const float* bn2, void* out, void* z, void* h1,
                          void* gp, int R, int H, float eps, cudaStream_t stream) {
  if (lnout)
    return launch_mlp<D, true>(x, s1, bn1, w1, b1, w2, b2, s2, bn2, out, z, h1, gp, R, H, eps,
                               stream);
  return launch_mlp<D, false>(x, s1, bn1, w1, b1, w2, b2, s2, bn2, out, z, h1, gp, R, H, eps,
                              stream);
}

}  // namespace vitocm

// x, out, z (R, D); h1, gp (R, H); w1 (H, D); w2 (D, H) in f32; s1, bn1, s2,
// bn2, b2 (D) and b1 (H) in f32. lnout = 0 ignores s2, bn2 and z; h1 may be
// null, and must be with lnout = 1; gp not null (it needs h1) takes the
// SAVE_GP route: g = gelu(h1) into h1, gelu'(h1) into gp. float32 only
// (dtype 0); bf16 storage takes vitocm_fused_mlp_wgmma. D in {192, 384}, H a
// multiple of 64. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vitocm_fused_mlp(int dtype, int lnout, const void* x, const void* s1,
                                const void* bn1, const void* w1, const void* b1, const void* w2,
                                const void* b2, const void* s2, const void* bn2, void* out,
                                void* z, void* h1, void* gp, int R, int D, int H, float eps,
                                void* stream) {
  using namespace vitocm;
  if (dtype != kF32 || R < 1 || H < 64 || H % 64 != 0 ||
      (lnout && (z == nullptr || h1 != nullptr)) || (gp != nullptr && h1 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (D == 384)
    return dispatch_lnout<384>(lnout, x, f(s1), f(bn1), w1, f(b1), w2, f(b2), f(s2), f(bn2), out,
                               z, h1, gp, R, H, eps, s);
  if (D == 192)
    return dispatch_lnout<192>(lnout, x, f(s1), f(bn1), w1, f(b1), w2, f(b2), f(s2), f(bn2), out,
                               z, h1, gp, R, H, eps, s);
  return (int)cudaErrorInvalidValue;
}
