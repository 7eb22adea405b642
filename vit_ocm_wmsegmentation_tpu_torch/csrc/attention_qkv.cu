// Multi-head softmax attention forward, f32 storage, CUDA cores.
//
// Replaces two TPU kernels of vit_ocm_wmsegmentation_tpu/ops/
// flash_attention.py (layouts in attention.cuh):
//   * _attn_fwd_qkvflat_kernel (attention_qkv, inference): read straight
//     from the fused qkv projection, q section already scaled by 1/sqrt(d);
//   * _attn_fwd_kernel on its logsumexp route (_flash_fwd with want_lse,
//     training): folded (B*h, N, d) q, k, v, q already scaled and rounded by
//     the wrapper, plus the f32 logsumexp the backward recomputes P from.
// Head dims 64 (every DINO ViT) and 128 (the MIM ViT).
//
// What bounds it on the H100: the TPU kernels keep whole (Np, Np) f32 score
// matrices on chip (about 60 MB at the mosaic's Np = 2432), far past an SM's
// 227 KB of shared memory. Here one CTA owns (batch, head, 64 query rows)
// and loops over 64-key tiles with an online softmax (running max, running
// sum), so the score matrix never exists beyond a 64 x 64 tile and nothing
// but q, k, v, out and lse touches device memory. 256 threads, 4 x (d/16)
// register blocks; 66.8 KB of shared memory at d = 64, 116 KB at d = 128.
// The products run on the CUDA cores in f32, never through TF32, so the
// kernel is bound by shared-memory loads and FMA issue, not by HBM. bf16
// storage, both layouts, takes the wgmma kernel of attention_qkv_wgmma.cu.
//
// Numerics, kept from the TPU kernels: scores, P and accumulators in f32
// (the TPU kernels' rounding of P to the storage type is the identity in
// f32); the denominator is the sum of P, clamped at 1e-35 for the division;
// lse = max + log(sum). Deliberate difference: the TPU kernels shift exp by
// the whole row's max (or by the Cauchy-Schwarz bound |q|*max|k|); this
// kernel shifts by the running row max, as the online softmax must. It is
// the same softmax. The keys' ragged last tile is masked here: the port's
// token stream is not padded to a tile multiple.

#include <math.h>

#include "attention.cuh"
#include "common.cuh"

namespace vitocm {

constexpr int kBQ = 64;  // query rows per CTA
constexpr int kBK = 64;  // keys per tile
constexpr int kNT = 256; // threads
constexpr int kPS = kBK + 1;

template <int D>
constexpr size_t attn_smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * kPS + 2 * kBQ);
}

template <int D, bool FOLDED>
__global__ void __launch_bounds__(kNT)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
                 int N, int n, int nh) {
  constexpr int PQ = D + 1;  // padded pitch: conflict-free column reads
  constexpr int OJ = D / 16; // output columns per thread
  extern __shared__ float sm[];
  float* Qs = sm;                    // (BQ, PQ)
  float* Ks = Qs + kBQ * PQ;         // (BK, PQ)
  float* Vs = Ks + kBK * PQ;         // (BK, D)
  float* Ss = Vs + kBK * D;          // (BQ, PS) scores, then P
  float* alpha_s = Ss + kBQ * kPS;   // (BQ) per-row rescale of this tile
  float* l_s = alpha_s + kBQ;        // (BQ) final denominators

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ, hh = blockIdx.y, b = blockIdx.z;
  const AttnRows<float, D, FOLDED> L(q, k, v, out, N, nh, b, hh);

  for (int i = tid; i < kBQ * D; i += kNT) {
    const int r = i / D, c = i % D, row = q0 + r;
    Qs[r * PQ + c] = row < N ? L.q[row * L.rs + c] : 0.f;
  }

  // S register blocks: rows tr + 16*i, cols tc + 16*j; O: cols tc + 16*j, j < D/16
  const int tr = tid / 16, tc = tid % 16;
  // softmax ownership: 4 consecutive lanes share row sr, cols sl + 4*c
  const int sr = tid >> 2, sl = tid & 3;
  float o[4][OJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) o[i][j] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < kBK * D; i += kNT) {
      const int r = i / D, c = i % D, row = k0 + r;
      const bool ok = row < n;
      Ks[r * PQ + c] = ok ? L.k[row * L.rs + c] : 0.f;
      Vs[r * D + c] = ok ? L.v[row * L.rs + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr + 16 * i) * PQ + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tc + 16 * j) * PQ + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tc + 16 * j;
        Ss[(tr + 16 * i) * kPS + col] = (k0 + col < n) ? s[i][j] : -INFINITY;
      }
    __syncthreads();

    // online softmax of row sr over this tile (every tile holds a valid key)
    float* srow = Ss + sr * kPS;
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kBK / 4; ++c) mx = fmaxf(mx, srow[sl + 4 * c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kBK / 4; ++c) {
      const float p = expf(srow[sl + 4 * c] - m_new);
      srow[sl + 4 * c] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float alpha = expf(m_run - m_new);  // 0 on the first tile
    l_run = l_run * alpha + sum;
    m_run = m_new;
    if (sl == 0) alpha_s[sr] = alpha;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = alpha_s[tr + 16 * i];
#pragma unroll
      for (int j = 0; j < OJ; ++j) o[i][j] *= al;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[OJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(tr + 16 * i) * kPS + kk];
#pragma unroll
      for (int j = 0; j < OJ; ++j) vv[j] = Vs[kk * D + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < OJ; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
  }

  if (sl == 0) {
    l_s[sr] = fmaxf(l_run, 1e-35f);
    if (FOLDED && q0 + sr < N)  // only the training route keeps the logsumexp
      lse[((long long)b * nh + hh) * N + q0 + sr] = m_run + logf(l_run);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i, row = q0 + r;
    if (row >= N) continue;
    const float l = l_s[r];
    float* orow = L.out + row * L.os;
#pragma unroll
    for (int j = 0; j < OJ; ++j) orow[tc + 16 * j] = o[i][j] / l;
  }
}

template <int D, bool FOLDED>
static int launch_attention(const void* q, const void* k, const void* v, void* out, float* lse,
                            int B, int N, int n, int nh, cudaStream_t stream) {
  const size_t smem = attn_smem_bytes<D>();
  auto kern = attention_kernel<D, FOLDED>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((N + kBQ - 1) / kBQ, nh, B);
  kern<<<grid, kNT, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                    static_cast<const float*>(v), static_cast<float*>(out), lse,
                                    N, n, nh);
  return (int)cudaGetLastError();
}

// bf16 storage takes the wgmma kernel of attention_qkv_wgmma.cu: the folded
// (training) layout through here, the flat one through its own entry point,
// vitocm_attention_qkv_wgmma
template <int D, bool FOLDED>
int launch_attention_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                           int B, int N, int n, int nh, cudaStream_t stream);

template <bool FOLDED>
static int launch_any(int dtype, int d, const void* q, const void* k, const void* v, void* out,
                      float* lse, int B, int N, int n, int nh, cudaStream_t s) {
  if (n < 1 || n > N || B < 1 || nh < 1) return (int)cudaErrorInvalidValue;
  if (dtype == kF32 && d == 64)
    return launch_attention<64, FOLDED>(q, k, v, out, lse, B, N, n, nh, s);
  if (dtype == kF32 && d == 128)
    return launch_attention<128, FOLDED>(q, k, v, out, lse, B, N, n, nh, s);
  if constexpr (FOLDED) {
    if (dtype == kBF16 && d == 64)
      return launch_attention_wgmma<64, true>(q, k, v, out, lse, B, N, n, nh, s);
    if (dtype == kBF16 && d == 128)
      return launch_attention_wgmma<128, true>(q, k, v, out, lse, B, N, n, nh, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace vitocm

// Inference route, f32 (bf16: vitocm_attention_qkv_wgmma): qkv (B, N,
// 3*nh*d), out (B, N, nh*d); keys masked at rows >= n. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int vitocm_attention_qkv(int dtype, const void* qkv, void* out, int B, int N, int n,
                                    int nh, int head_dim, void* stream) {
  using namespace vitocm;
  return launch_any<false>(dtype, head_dim, qkv, nullptr, nullptr, out, nullptr, B, N, n, nh,
                           static_cast<cudaStream_t>(stream));
}

// Training route: q (already scaled), k, v, out (BH, N, d) contiguous; lse
// (BH, N) f32. Returns cudaGetLastError() after the launch.
extern "C" int vitocm_flash_fwd(int dtype, const void* q, const void* k, const void* v, void* out,
                                void* lse, int BH, int N, int head_dim, void* stream) {
  using namespace vitocm;
  return launch_any<true>(dtype, head_dim, q, k, v, out, static_cast<float*>(lse), BH, N, N, 1,
                          static_cast<cudaStream_t>(stream));
}
