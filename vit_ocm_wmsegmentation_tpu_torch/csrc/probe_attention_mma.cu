// The TPU attention probes as one templated tensor-core kernel (mma.sync:
// bf16 m16n8k16 with f32 accumulation, int8 m16n8k32 with int32
// accumulation), head dim 64. Replaces the Pallas bodies of
//   tools/probe_dot.py::attn (`kern` :72, pallas_call :88), int8 and bf16;
//   tools/bench_attention_variants.py::make_variant (`kern` :31, :74), the
//     modes full / bf16exp / noexp / dotsonly;
//   tools/bench_attn_opt.py (`kern_base` :107, `kern_nomax` :120,
//     `kern_split` :138, `kern_stagger` :161, `kern_normbound` :189,
//     `kern_bf16sm` :425 via pallas_call :87; `kern_combo` :210 via :241;
//     `kern_qkvflat` :269 via :314; `kern_qkvflat_pipe` :333 via :406).
// Each computes the TPU body's function; none is carried over block by block:
// the TPU bodies hold whole (rows, Np) score blocks in VMEM, this kernel walks
// 64-key tiles with the scores in registers.
//
// Per 64-key tile: s = (q k^T) * scale + bias[key] in f32 (keys >= Nk left
// out), then p = f(s - m) with the template's
//   SHIFT  m: the true row max (two passes over the keys: pass 1 finds m,
//          pass 2 rounds exp(s - m) against the final m, as the TPU rounds
//          before the second product; an online rescale would round other
//          values), none, or Cauchy-Schwarz |q_i| max_j |k_j| (one pass; max
//          |k| over all Nk keys from a small pre-kernel);
//   EXPF   exp, exp2, relu or the identity; exp2 as XLA lowers it,
//          exp(x * ln 2) with ln 2 and the product in the working type (bf16
//          for the bf16 softmax variants);
//   SM     f32, or the argument s - m and the result of f rounded to bf16
//          (bf16exp, pipe2b), or also s rounded to bf16 before the max
//          (bf16sm);
// P rounded to bf16, or to int8 as trunc(p * 127) (XLA truncates toward 0),
// multiplied by V (its first 64 columns), and the output divided by the
// template's DEN: the sum of the rounded P (the TPU's ones column of V), the
// sum of the unrounded p, that sum + 1 (noexp), or nothing; one bf16 cast.
//
// Layouts: folded q (BH, Rq, 64), kt (BH, 64, Nk) and v (BH, Nk, vstride);
// folded q, k (BH, Nk, 64), v (BH, Nk, 64) (combo: the ones column built on
// chip); qkvflat (B, Np, 3 h 64) with o written into all three sections
// (kern_qkvflat :299-301). A CTA owns 64 query rows of one (batch, head),
// four warps of 16 (mma.cuh's fragments). In bf16, kt's tile is
// staged as it lies and read with ldmatrix.trans; ldmatrix has no 8-bit
// transpose, so the int8 route transposes kt and v while staging, v's keys
// permuted within 32 so that the int32 accumulators of s re-pack into P's A
// fragments in registers; v's unused columns 64-127 are not read. Padded
// keys of V stage as zeros, so the identity mode's -1e30 scores of padded keys
// meet zero rows (as the TPU's zero-padded V) and not NaN.
//
// Bound on the H100: tensor-core issue for the two products (the probes'
// 400 useful GFLOP) plus the exp on the CUDA cores; the two-pass variants
// issue the q k^T product twice.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace vitocm {

enum ProbeLayout { kFoldedT = 0, kFoldedK = 1, kQkvFlat = 2 };
enum ProbeShift { kRowMax = 0, kNoShift = 1, kCauchy = 2 };
enum ProbeExp { kExpE = 0, kExp2 = 1, kRelu = 2, kIdent = 3 };
enum ProbeSm { kSmF32 = 0, kSmBf16Arg = 1, kSmBf16All = 2 };
enum ProbeDen { kDenOnes = 0, kDenSum = 1, kDenSumPlus1 = 2, kDenNone = 3 };

constexpr int kPD = 64;     // head dim
constexpr int kPQ = 64;     // query rows per CTA
constexpr int kPK = 64;     // keys per tile
constexpr int kPT = 128;    // threads
constexpr int kPB = kPD + 8;  // bf16 tile pitch, elements
constexpr int kP8 = 80;     // int8 tile pitch, bytes
constexpr float kLn2F32 = 0.693147182f;  // ln 2 in f32 and in bf16, XLA's exp2 constants
constexpr float kLn2Bf16 = 0.69140625f;

struct ProbeArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const float* kmax;
  void* out;
  int Rq, Nk, vstride, heads;
  float scale;
};

__device__ __forceinline__ uint32_t u32_at(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

// position of key k (< 64) in the int8 route's staged V^T: within each 32
// keys, k = 16h + 8jj + 2tt + ii goes to 16h + 4tt + 2jj + ii, the k order of
// the P fragment that the int32 score accumulators re-pack into
__device__ __forceinline__ int v_perm(int k) {
  const int r = k & 31;
  return (k & ~31) + (r & 16) + ((r >> 1) & 3) * 4 + ((r >> 3) & 1) * 2 + (r & 1);
}

// sqrt(max_j |k_j|^2) of one (batch, head) over all Nk keys, in f32
template <int LAYOUT>
__global__ void __launch_bounds__(kPT) probe_kmax_kernel(const __nv_bfloat16* __restrict__ k,
                                                         float* __restrict__ kmax, int Nk,
                                                         int heads) {
  __shared__ float red[kPT / 32];
  const __nv_bfloat16* kb;
  long long es, ks;  // element stride along d, along keys
  if constexpr (LAYOUT == kQkvFlat) {
    const int b = blockIdx.x / heads, h = blockIdx.x % heads;
    const long long C = 3LL * heads * kPD;
    kb = k + b * Nk * C + heads * kPD + h * kPD;
    es = 1;
    ks = C;
  } else if constexpr (LAYOUT == kFoldedT) {
    kb = k + (long long)blockIdx.x * kPD * Nk;
    es = Nk;
    ks = 1;
  } else {
    kb = k + (long long)blockIdx.x * Nk * kPD;
    es = 1;
    ks = kPD;
  }
  float mx = 0.f;
  for (int key = threadIdx.x; key < Nk; key += kPT) {
    float s = 0.f;
    for (int d = 0; d < kPD; ++d) {
      const float x = __bfloat162float(kb[key * ks + d * es]);
      s += x * x;
    }
    mx = fmaxf(mx, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = red[0];
    for (int w = 1; w < kPT / 32; ++w) m = fmaxf(m, red[w]);
    kmax[blockIdx.x] = sqrtf(m);
  }
}

template <typename T, int LAYOUT, int SHIFT, int EXPF, int SM, int DEN>
__global__ void __launch_bounds__(kPT, 4) probe_attention_kernel(const ProbeArgs a) {
  constexpr bool I8 = sizeof(T) == 1;
  using Acc = typename std::conditional<I8, int, float>::type;
  constexpr int KSTEPS = kPD * (int)sizeof(T) / 32;  // 32-byte k-steps of q k^T
  __shared__ __align__(16) unsigned char smem[2 * kPK * kPB * 2];
  unsigned char* Kraw = smem;
  unsigned char* Vraw = smem + kPK * kPB * 2;
  __nv_bfloat16* Kb = reinterpret_cast<__nv_bfloat16*>(Kraw);  // bf16: K (key, d) or kt (d, key)
  __nv_bfloat16* Vb = reinterpret_cast<__nv_bfloat16*>(Vraw);  // bf16: V (key, d)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Rq = a.Rq, Nk = a.Nk;

  const T *qb, *kb, *vb;
  long long qstride = kPD, kstride, vstride = a.vstride, ostride = kPD, osec = 0;
  __nv_bfloat16* ob;
  if constexpr (LAYOUT == kQkvFlat) {
    const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
    const long long C = 3LL * a.heads * kPD;
    const T* base = static_cast<const T*>(a.q) + b * Rq * C;
    qb = base + h * kPD;
    kb = base + a.heads * kPD + h * kPD;
    vb = base + 2 * a.heads * kPD + h * kPD;
    qstride = kstride = vstride = ostride = C;
    ob = static_cast<__nv_bfloat16*>(a.out) + b * Rq * C + h * kPD;
    osec = a.heads * kPD;
  } else {
    const long long bh = blockIdx.y;
    qb = static_cast<const T*>(a.q) + bh * Rq * kPD;
    kb = static_cast<const T*>(a.k) + bh * Nk * kPD;
    vb = static_cast<const T*>(a.v) + bh * Nk * a.vstride;
    kstride = LAYOUT == kFoldedT ? Nk : kPD;
    ob = static_cast<__nv_bfloat16*>(a.out) + bh * Rq * kPD;
  }

  // Q rows r0, r1 as A fragments, 32 bytes of d a step
  const int r0 = blockIdx.x * kPQ + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[KSTEPS][4];
  {
    const unsigned char* q0p = reinterpret_cast<const unsigned char*>(qb + (long long)min(r0, Rq - 1) * qstride);
    const unsigned char* q1p = reinterpret_cast<const unsigned char*>(qb + (long long)min(r1, Rq - 1) * qstride);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      qa[kk][0] = r0 < Rq ? u32_at(q0p + 32 * kk + 4 * t) : 0u;
      qa[kk][1] = r1 < Rq ? u32_at(q1p + 32 * kk + 4 * t) : 0u;
      qa[kk][2] = r0 < Rq ? u32_at(q0p + 32 * kk + 4 * t + 16) : 0u;
      qa[kk][3] = r1 < Rq ? u32_at(q1p + 32 * kk + 4 * t + 16) : 0u;
    }
  }

  float m0 = 0.f, m1 = 0.f;  // the shift of rows r0, r1
  if constexpr (SHIFT == kCauchy) {
    float n0 = 0.f, n1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t w = qa[kk][e];
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
        (e & 1 ? n1 : n0) += f.x * f.x + f.y * f.y;
      }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      n0 += __shfl_xor_sync(0xffffffffu, n0, o);
      n1 += __shfl_xor_sync(0xffffffffu, n1, o);
    }
    const float km = a.kmax[blockIdx.y];
    m0 = __fmul_rn(sqrtf(n0), km);
    m1 = __fmul_rn(sqrtf(n1), km);
  }

  // the key tile at k0 (and its V tile) into shared memory, zeros past Nk
  auto stage = [&](int k0, bool with_v) {
    if constexpr (I8) {
      for (int i = tid; i < kPD * 4; i += kPT) {  // kt (d, key) -> K (key, d)
        const int d = i >> 2, c = (i & 3) * 16;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (k0 + c < Nk) val = *reinterpret_cast<const uint4*>(kb + (long long)d * kstride + k0 + c);
        const unsigned char* bv = reinterpret_cast<const unsigned char*>(&val);
#pragma unroll
        for (int e = 0; e < 16; ++e) Kraw[(c + e) * kP8 + d] = bv[e];
      }
      if (with_v)
        for (int i = tid; i < kPK * 4; i += kPT) {  // v (key, d) -> V^T (d, permuted key)
          const int key = i >> 2, c = (i & 3) * 16, pk = v_perm(key);
          uint4 val = make_uint4(0, 0, 0, 0);
          if (k0 + key < Nk)
            val = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + key) * vstride + c);
          const unsigned char* bv = reinterpret_cast<const unsigned char*>(&val);
#pragma unroll
          for (int e = 0; e < 16; ++e) Vraw[(c + e) * kP8 + pk] = bv[e];
        }
    } else {
      for (int i = tid; i < kPK * kPD / 8; i += kPT) {
        const int r = i / (kPD / 8), c = (i % (kPD / 8)) * 8;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
        if constexpr (LAYOUT == kFoldedT) {  // r = d, c = key offset
          if (k0 + c < Nk) kv = *reinterpret_cast<const uint4*>(kb + (long long)r * kstride + k0 + c);
        } else {  // r = key, c = d offset
          if (k0 + r < Nk) kv = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * kstride + c);
        }
        *reinterpret_cast<uint4*>(Kb + r * kPB + c) = kv;
        if (with_v) {
          if (k0 + r < Nk) vv = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * vstride + c);
          *reinterpret_cast<uint4*>(Vb + r * kPB + c) = vv;
        }
      }
    }
  };

  // s of the staged tile: scaled, biased, rounded per SM; -inf past Nk
  auto scores = [&](float (&s)[8][4], int k0) {
    Acc acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0;
    if constexpr (I8) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const unsigned char* bp = Kraw + (8 * j + g) * kP8 + 32 * kk + 4 * t;
          mma_s8_16832(acc[j], qa[kk], u32_at(bp), u32_at(bp + 16));
        }
    } else if constexpr (LAYOUT == kFoldedT) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t bf[4];
          ld_b_frag2(bf, Kb, kPB, 16 * kk, 16 * jj, lane);
          mma_bf16_16816(acc[2 * jj], qa[kk], bf[0], bf[1]);
          mma_bf16_16816(acc[2 * jj + 1], qa[kk], bf[2], bf[3]);
        }
    } else {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat16* bp = Kb + (8 * j + g) * kPB + 16 * kk + 2 * t;
          mma_bf16_16816(acc[j], qa[kk], ld_pair(bp), ld_pair(bp + 8));
        }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        float v = -INFINITY;
        if (key < Nk) {
          float x;
          if constexpr (I8) x = __int2float_rn(acc[j][e]);
          else x = acc[j][e];
          v = __fadd_rn(__fmul_rn(x, a.scale), __ldg(a.bias + key));
          if constexpr (SM == kSmBf16All) v = round_bf16(v);
        }
        s[j][e] = v;
      }
  };

  if constexpr (SHIFT == kRowMax) {  // pass 1: the true row max
    m0 = m1 = -INFINITY;
    float s[8][4];
    for (int k0 = 0; k0 < Nk; k0 += kPK) {
      __syncthreads();
      stage(k0, false);
      __syncthreads();
      scores(s, k0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
        m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
  }

  Acc o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0;
  float l0 = 0.f, l1 = 0.f;
  for (int k0 = 0; k0 < Nk; k0 += kPK) {
    __syncthreads();
    stage(k0, true);
    __syncthreads();
    float s[8][4];
    scores(s, k0);
    // p in place of s: the value P holds (bf16-rounded, or the int8 integer)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = s[j][e];
        float f = 0.f, p = 0.f;
        if (sv != -INFINITY) {
          float x = sv;
          if constexpr (SHIFT != kNoShift) x = __fsub_rn(sv, e < 2 ? m0 : m1);
          if constexpr (SM != kSmF32) x = round_bf16(x);
          if constexpr (EXPF == kExpE) f = expf(x);
          else if constexpr (EXPF == kExp2)  // as XLA lowers exp2: exp(x ln 2) in the working type
            f = SM != kSmF32 ? expf(round_bf16(__fmul_rn(x, kLn2Bf16))) : expf(__fmul_rn(x, kLn2F32));
          else if constexpr (EXPF == kRelu) f = fmaxf(x, 0.f);
          else f = x;
          if constexpr (SM != kSmF32) f = round_bf16(f);
          if constexpr (I8) p = (float)(int)__fmul_rn(f, 127.f);
          else p = round_bf16(f);
        }
        if constexpr (DEN == kDenOnes) (e < 2 ? l0 : l1) += p;
        else if constexpr (DEN != kDenNone) (e < 2 ? l0 : l1) += f;
        s[j][e] = p;
      }
    if constexpr (I8) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {  // 32 keys a product
        const int j0 = 4 * kk;
        const uint32_t pa[4] = {
            pack_s8((int)s[j0][0], (int)s[j0][1], (int)s[j0 + 1][0], (int)s[j0 + 1][1]),
            pack_s8((int)s[j0][2], (int)s[j0][3], (int)s[j0 + 1][2], (int)s[j0 + 1][3]),
            pack_s8((int)s[j0 + 2][0], (int)s[j0 + 2][1], (int)s[j0 + 3][0], (int)s[j0 + 3][1]),
            pack_s8((int)s[j0 + 2][2], (int)s[j0 + 2][3], (int)s[j0 + 3][2], (int)s[j0 + 3][3])};
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const unsigned char* bp = Vraw + (8 * jn + g) * kP8 + 32 * kk + 4 * t;
          mma_s8_16832(o[jn], pa, u32_at(bp), u32_at(bp + 16));
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          uint32_t vf[4];
          ld_b_frag2(vf, Vb, kPB, 16 * kk, 8 * j, lane);
          mma_bf16_16816(o[j], pa, vf[0], vf[1]);
          mma_bf16_16816(o[j + 1], pa, vf[2], vf[3]);
        }
      }
    }
  }

  if constexpr (DEN != kDenNone) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if constexpr (DEN == kDenSumPlus1) {
      l0 = __fadd_rn(l0, 1.f);
      l1 = __fadd_rn(l1, 1.f);
    }
  }
  auto fin = [&](Acc v, float l) {
    float x;
    if constexpr (I8) x = __int2float_rn(v);
    else x = v;
    if constexpr (DEN != kDenNone) x = __fdiv_rn(x, l);
    return x;
  };
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    const uint32_t w0 = pack_bf16(fin(o[j][0], l0), fin(o[j][1], l0));
    const uint32_t w1 = pack_bf16(fin(o[j][2], l1), fin(o[j][3], l1));
#pragma unroll
    for (int sec = 0; sec < (LAYOUT == kQkvFlat ? 3 : 1); ++sec) {
      if (r0 < Rq) *reinterpret_cast<uint32_t*>(ob + r0 * ostride + sec * osec + c) = w0;
      if (r1 < Rq) *reinterpret_cast<uint32_t*>(ob + r1 * ostride + sec * osec + c) = w1;
    }
  }
}

template <typename T, int LAYOUT, int SHIFT, int EXPF, int SM, int DEN>
int launch_probe(const ProbeArgs& a, int groups, cudaStream_t stream) {
  if constexpr (SHIFT == kCauchy) {
    probe_kmax_kernel<LAYOUT><<<groups, kPT, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(LAYOUT == kQkvFlat ? a.q : a.k),
        const_cast<float*>(a.kmax), a.Nk, a.heads);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  const dim3 grid((a.Rq + kPQ - 1) / kPQ, groups);
  probe_attention_kernel<T, LAYOUT, SHIFT, EXPF, SM, DEN><<<grid, kPT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace vitocm

// One probe attention. dtype 1: bf16 operands, 2: int8 (folded kt layout,
// row-max shift, exp, no denominator only). groups = BH (folded) or B * heads
// (qkvflat). kmax: groups floats of scratch for the Cauchy-Schwarz shift, else
// unused. The output (bf16) has q's rows; qkvflat writes (B, Np, 3 h 64).
// Returns cudaGetLastError() after the launches, or 1 (cudaErrorInvalidValue)
// for a combination that has no instantiation.
extern "C" int vitocm_probe_attention(int dtype, int layout, int shift, int expf_, int sm, int den,
                                      const void* q, const void* k, const void* v,
                                      const void* bias, void* kmax, void* out, int groups, int Rq,
                                      int Nk, int vstride, int heads, float scale, void* stream) {
  using namespace vitocm;
  const ProbeArgs a{q, k, v, static_cast<const float*>(bias), static_cast<const float*>(kmax),
                    out, Rq, Nk, vstride, heads, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
#define VITOCM_PROBE(T, CODE, L, S, E, M, D)                                         \
  if (dtype == CODE && layout == L && shift == S && expf_ == E && sm == M && den == D) \
    return launch_probe<T, L, S, E, M, D>(a, groups, s);
  VITOCM_PROBE(int8_t, 2, kFoldedT, kRowMax, kExpE, kSmF32, kDenNone)       // probe_dot int8
  VITOCM_PROBE(BF, 1, kFoldedT, kRowMax, kExpE, kSmF32, kDenNone)           // probe_dot bf16
  VITOCM_PROBE(BF, 1, kFoldedT, kRowMax, kExpE, kSmF32, kDenSum)            // full
  VITOCM_PROBE(BF, 1, kFoldedT, kRowMax, kExpE, kSmBf16Arg, kDenSum)        // bf16exp
  VITOCM_PROBE(BF, 1, kFoldedT, kNoShift, kRelu, kSmF32, kDenSumPlus1)      // noexp
  VITOCM_PROBE(BF, 1, kFoldedT, kNoShift, kIdent, kSmF32, kDenNone)         // dotsonly
  VITOCM_PROBE(BF, 1, kFoldedT, kRowMax, kExpE, kSmF32, kDenOnes)           // v0
  VITOCM_PROBE(BF, 1, kFoldedT, kRowMax, kExp2, kSmF32, kDenOnes)           // exp2
  VITOCM_PROBE(BF, 1, kFoldedT, kNoShift, kExpE, kSmF32, kDenOnes)          // nomax
  VITOCM_PROBE(BF, 1, kFoldedT, kCauchy, kExpE, kSmF32, kDenOnes)           // normbound
  VITOCM_PROBE(BF, 1, kFoldedT, kRowMax, kExp2, kSmBf16All, kDenOnes)       // bf16sm
  VITOCM_PROBE(BF, 1, kFoldedK, kCauchy, kExpE, kSmF32, kDenOnes)           // combo
  VITOCM_PROBE(BF, 1, kQkvFlat, kCauchy, kExpE, kSmF32, kDenOnes)           // qkvflat
  VITOCM_PROBE(BF, 1, kQkvFlat, kCauchy, kExp2, kSmF32, kDenOnes)           // qkvflat_pipe2
  VITOCM_PROBE(BF, 1, kQkvFlat, kCauchy, kExp2, kSmBf16Arg, kDenOnes)       // qkvflat_pipe2b
#undef VITOCM_PROBE
  return (int)cudaErrorInvalidValue;
}
