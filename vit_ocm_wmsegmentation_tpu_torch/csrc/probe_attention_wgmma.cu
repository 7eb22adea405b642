// The TPU attention probes as one templated kernel on Hopper's warpgroup
// tensor cores: wgmma fed by TMA through an mbarrier ring (bf16 m64n64k16
// with f32 accumulation, int8 m64n64k32 with s32 accumulation), head dim 64.
// Replaces the Pallas bodies of
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
// What bounds it on the H100: at the probes' (49 x 6, 2305 of 2432 keys,
// 64), the two products are 0.40 ms of bf16 tensor-core time (0.20 int8),
// the two-pass instances run q k^T twice, and the exp is 1.6-1.7 G calls
// (about 0.47 ms on the SFU's 16 a clock an SM). The bytes are far below
// either. The mma.sync kernel this replaced copied K and V with all threads
// between __syncthreads (tensor cores idle) and re-read each head's K and V
// once per 64 query rows. Here, as in attention_qkv_wgmma.cu, a CTA owns 128
// query rows of one (batch, head): two consumer warpgroups of 64 rows and a
// producer, which loads the CTA's Q once by TMA and keeps 64-key tiles of K
// (and, in the pass that needs them, V) in flight through a ring of 3
// stages, each guarded by a "full" mbarrier and an "empty" one (all 8
// consumer warps done with it). TMA reads through 3-D maps, so rows and keys
// past the ends read as 0 and the ragged edges need no copy code; padded
// keys meet zero V rows, so the identity mode's -1e30 scores of padded keys
// give 0 and not NaN. A consumer warpgroup computes S = Q K^T with wgmma
// from shared memory, the scores in registers (a row's 64 in the 4 lanes of
// a quad), and O += P V with P packed from the S accumulators as the
// register A operand; the denominator of the rounded P (the TPU's ones
// column of V) is P . 1 on the tensor cores beside it. The row-max instances
// stream K alone in pass 1 (S and the row max only); the one-pass instances
// never rescale O. Two CTAs fit an SM (66 KB of shared memory bf16, 49 KB
// int8); the bf16 producer is a warpgroup that drops to 24 registers, so the
// consumers hold 104 and do not spill (a ninth warp a CTA would cap them at
// 96). On an H100 the time goes to each warpgroup's serial chain (S, wait,
// softmax, P . V, wait) and, in the exp instances, the SFU: dotsonly takes
// ~1.05 ms, the one-pass exp instances ~0.5 ms more. Neither L2 nor shared
// memory holds it back: a copy that stopped reloading K and V ran as fast,
// and so did Q as the register operand of pass 1. Pass 1 two tiles deep,
// one wait for P . V of a tile and S of the next, 3 or 4 consumer
// warpgroups a CTA (one CTA an SM), no producer (thread 0 refilling the
// ring; 128 registers), 4 stages and a TMA-store epilogue were each slower
// or no faster (PERF.md).
//
// Layouts: folded_t q (G, Rq, 64), kt (G, 64, Nk) and v (G, Nk, vstride):
// kt's tile lands as it lies (d rows, keys contiguous) and is read as an
// MN-major B; v through a map of its first 64 columns with row stride
// vstride. folded (combo): q, k (G, Nk, 64) K-major, v (G, Nk, 64). qkvflat:
// one map over (B, Np, 3 h 64), o written into all three sections
// (kern_qkvflat :299-301). int8 (dot only): 8-bit wgmma reads both operands
// K-major and TMA does not transpose, so the producer warp lands kt's and
// v's tiles as they lie in a staging pair and transposes them in shared
// memory, 16 x 16 bytes a lane (16-byte loads and stores, byte permutes in
// registers), K in lanes 0-15 and V in 16-31; v's keys permuted within each
// 16 so that the s32 accumulators of S re-pack into the k32 A fragments of
// P.V in registers (wgmma's per-warp accumulator and A-fragment layouts are
// mma.sync's m16n8k32 ones).

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace vitocm {

enum ProbeLayout { kFoldedT = 0, kFoldedK = 1, kQkvFlat = 2 };
enum ProbeShift { kRowMax = 0, kNoShift = 1, kCauchy = 2 };
enum ProbeExp { kExpE = 0, kExp2 = 1, kRelu = 2, kIdent = 3 };
enum ProbeSm { kSmF32 = 0, kSmBf16Arg = 1, kSmBf16All = 2 };
enum ProbeDen { kDenOnes = 0, kDenSum = 1, kDenSumPlus1 = 2, kDenNone = 3 };

constexpr int kPD = 64;  // head dim
constexpr int kPK = 64;  // keys per tile
constexpr int kKmaxThreads = 256;
constexpr float kLn2F32 = 0.693147182f;  // ln 2 in f32 and in bf16, XLA's exp2 constants
constexpr float kLn2Bf16 = 0.69140625f;

// The CTA of an instance (two an SM) and its shared memory: WG consumer
// warpgroups of 64 query rows and a producer, a ring of STAGES stages (a K
// and a V operand tile each); shared memory holds Q (WG tiles of 64 rows),
// the ring and, int8, a pair of kt / v tiles as they lie, bf16 a tile of
// ones; every tile on a 1024-byte boundary. The producer: int8 one warp (its
// transposes need registers); bf16 a warpgroup, which gives the consumers its
// registers: two CTAs of 12 warps launch at 80 registers a thread, the
// producer drops to 24 and the consumers rise to 104 (setmaxnreg trades only
// a CTA's own registers).
template <typename T>
struct ProbeCfg {
  static constexpr bool I8 = sizeof(T) == 1;
  static constexpr int WG = 2;
  static constexpr int STAGES = 3;
  static constexpr int ROWS = 64 * WG;  // query rows a CTA
  static constexpr int THREADS = 128 * WG + (I8 ? 32 : 128);
  static constexpr int CONSUMER_REGS = 104;
  static constexpr int TILE = 64 * kPD * (int)sizeof(T);  // 64 rows of Q, K or V: 8 KB, int8 4 KB
  static constexpr int Q_BYTES = WG * TILE;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int RAWS = I8 ? 2 : 0;  // staging pairs (kt tile, v tile), 4 KB each
  static constexpr int RAW = 2 * 64 * 64;
  static constexpr int ONES = I8 ? 0 : 1024;  // bf16 ones: B of the row sums P . 1
  static constexpr size_t SMEM =
      1024 + Q_BYTES + STAGES * STAGE + RAWS * RAW + ONES + 8 * (2 * STAGES + 1 + RAWS);
};

struct ProbeArgs {
  const float* bias;
  const float* kmax;
  __nv_bfloat16* out;
  int Rq, Nk, heads;
  float scale;
};

__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

// the key of position p (< 16) of the int8 route's V^T rows, within each 16
// keys: position 4tt + 2jj + ii holds key 8jj + 2tt + ii, the k order of the
// P fragment that the s32 score accumulators re-pack into
__device__ __forceinline__ constexpr int v_key_at(int p) {
  return 8 * ((p >> 1) & 1) + 2 * (p >> 2) + (p & 1);
}

// the rows r0..r3 of a 4 x 4 byte block -> its columns: byte i of c[j] is
// byte j of r_i
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                           uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140), t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// One lane's 16 x 16 bytes of a 64 x 64 int8 tile, transposed: src rows
// 16 R + (vkeys ? v_key_at(i) : i) (64-byte rows as TMA lands them with no
// swizzle), bytes 16 C .. 16 C + 15, -> dst rows 16 C + j, bytes 16 R + i,
// in the 64-byte swizzle of a K-major wgmma operand (desc_k64); in two
// halves of 8 source rows, each 8 bytes of 16 dst rows
__device__ __forceinline__ void transpose_block(const unsigned char* src, unsigned char* dst,
                                                int R, int C, bool vkeys) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t w[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = 16 * R + (vkeys ? v_key_at(8 * h + i) : 8 * h + i);
      const uint4 x = *reinterpret_cast<const uint4*>(src + row * 64 + 16 * C);
      w[i][0] = x.x;
      w[i][1] = x.y;
      w[i][2] = x.z;
      w[i][3] = x.w;
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {  // src bytes 16 C + 4 cc .. + 3 -> dst rows 16 C + 4 cc ..
      uint32_t lo[4], hi[4];          // dst row 16 C + 4 cc + k: words 2 h, 2 h + 1
      transpose4(w[0][cc], w[1][cc], w[2][cc], w[3][cc], lo);
      transpose4(w[4][cc], w[5][cc], w[6][cc], w[7][cc], hi);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = 16 * C + 4 * cc + k;
        *reinterpret_cast<uint2*>(dst + r * 64 + ((R ^ ((r >> 1) & 3)) << 4) + 8 * h) =
            make_uint2(lo[k], hi[k]);
      }
    }
  }
}

// sqrt(max_j |k_j|^2) of one (batch, head) over all Nk keys, in f32, from
// 16-byte loads: folded_t, a thread sums 8 neighbouring keys down kt's 64
// rows; else 8 lanes share a key's 128-byte row
template <int LAYOUT>
__global__ void __launch_bounds__(kKmaxThreads) probe_kmax_kernel(
    const __nv_bfloat16* __restrict__ k, float* __restrict__ kmax, int Nk, int heads) {
  __shared__ float red[kKmaxThreads / 32];
  auto sq8 = [](const uint4& w, float (&acc)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      acc[2 * e] += f.x * f.x;
      acc[2 * e + 1] += f.y * f.y;
    }
  };
  float mx = 0.f;
  if constexpr (LAYOUT == kFoldedT) {
    const __nv_bfloat16* kb = k + (long long)blockIdx.x * kPD * Nk;
    for (int c = 8 * threadIdx.x; c < Nk; c += 8 * kKmaxThreads) {  // keys c .. c + 7
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < kPD; ++d)
        sq8(*reinterpret_cast<const uint4*>(kb + (long long)d * Nk + c), acc);
#pragma unroll
      for (int e = 0; e < 8; ++e) mx = fmaxf(mx, acc[e]);
    }
  } else {
    const long long C = LAYOUT == kQkvFlat ? 3LL * heads * kPD : kPD;
    const __nv_bfloat16* kb =
        LAYOUT == kQkvFlat
            ? k + (long long)(blockIdx.x / heads) * Nk * C + (heads + blockIdx.x % heads) * kPD
            : k + (long long)blockIdx.x * Nk * kPD;
    const int part = threadIdx.x & 7;
    for (int k0 = 0; k0 < Nk; k0 += kKmaxThreads / 8) {  // uniform: every lane shuffles
      const int key = k0 + (threadIdx.x >> 3);
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (key < Nk) sq8(*reinterpret_cast<const uint4*>(kb + key * C + 8 * part), acc);
      float s = ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5]) + (acc[6] + acc[7]));
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      mx = fmaxf(mx, s);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = red[0];
    for (int w = 1; w < kKmaxThreads / 32; ++w) m = fmaxf(m, red[w]);
    kmax[blockIdx.x] = sqrtf(m);
  }
}

// S = Q K^T of one tile, issued (not waited for): 64 rows x 64 keys
template <typename T, int LAYOUT, typename Acc>
__device__ __forceinline__ void issue_probe_scores(Acc (&acc)[32], const unsigned char* qw,
                                                   const unsigned char* ks) {
  wgmma_fence();  // the first product ignores acc's old values (scale-d 0)
  if constexpr (sizeof(T) == 1) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)  // 32 bytes of d a product
      wgmma_ss_m64n64k32_s8(acc, desc_k64(qw + 32 * kk), desc_k64(ks + 32 * kk), kk);
  } else if constexpr (LAYOUT == kFoldedT) {  // kt's tile: d rows of 64 keys, MN-major
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_m64n64k16<1>(acc, desc_k128(qw + 32 * kk),
                            desc_mn128(ks + kk * 16 * 128, kPK * 128), kk);
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_m64n64k16<0>(acc, desc_k128(qw + 32 * kk), desc_k128(ks + 32 * kk), kk);
  }
  wgmma_commit();
}

// both values rounded to bf16, in one conversion
__device__ __forceinline__ void round_bf16x2(float& a, float& b) {
  const uint32_t w = pack_bf16(a, b);
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xffff0000u);
}

// the scores of one tile, keys k0 ..: s[4j + e] = acc * scale + bias[key]
// (each rounded on its own; rounded to bf16 for SM kSmBf16All), key = k0 +
// 8 j + 2 t4 + (e & 1); with EDGE, -inf past Nk
template <int SM, bool EDGE, typename Acc>
__device__ __forceinline__ void probe_scores(const Acc (&acc)[32], float (&s)[32],
                                             const float* bias, int k0, int Nk, int t4,
                                             float scale) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int key = k0 + 8 * j + 2 * t4;
    float2 b;
    if constexpr (EDGE) {
      b.x = key < Nk ? __ldg(bias + key) : -INFINITY;
      b.y = key + 1 < Nk ? __ldg(bias + key + 1) : -INFINITY;
    } else {
      b = __ldg(reinterpret_cast<const float2*>(bias + key));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g, g + 8
      const int i = 4 * j + 2 * h;
      float v0, v1;
      if constexpr (std::is_same<Acc, int>::value) {
        v0 = __int2float_rn(acc[i]);
        v1 = __int2float_rn(acc[i + 1]);
      } else {
        v0 = acc[i];
        v1 = acc[i + 1];
      }
      v0 = __fadd_rn(__fmul_rn(v0, scale), b.x);
      v1 = __fadd_rn(__fmul_rn(v1, scale), b.y);
      if constexpr (SM == kSmBf16All) round_bf16x2(v0, v1);
      if constexpr (EDGE) {
        if (b.x == -INFINITY) v0 = -INFINITY;
        if (b.y == -INFINITY) v1 = -INFINITY;
      }
      s[i] = v0;
      s[i + 1] = v1;
    }
  }
}

template <typename T, int LAYOUT, int SHIFT, int EXPF, int SM, int DEN>
__global__ void __launch_bounds__(ProbeCfg<T>::THREADS, 2)
probe_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map, const ProbeArgs a) {
  using C = ProbeCfg<T>;
  constexpr bool I8 = C::I8;
  constexpr bool TWO_PASS = SHIFT == kRowMax;
  // the denominator of the rounded P (the TPU's ones column of V) as P . 1
  // on the tensor cores, beside P . V
  constexpr bool TC_DEN = DEN == kDenOnes && !I8;
  using Acc = typename std::conditional<I8, int, float>::type;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* ring = qs + C::Q_BYTES;
  unsigned char* raw = ring + C::STAGES * C::STAGE;
  unsigned char* ones = raw + C::RAWS * C::RAW;
  uint64_t* full = reinterpret_cast<uint64_t*>(ones + C::ONES);
  uint64_t* empty = full + C::STAGES;
  uint64_t* qbar = empty + C::STAGES;
  uint64_t* rawbar = qbar + 1;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int Rq = a.Rq, Nk = a.Nk, q0 = blockIdx.x * C::ROWS, grp = blockIdx.y;
  const int tiles = (Nk + kPK - 1) / kPK;
  const int uses = TWO_PASS ? 2 * tiles : tiles;  // ring uses: pass 1's K tiles, then K and V
  // map coordinates: first column of this head's q, k, v and the outer index
  int qc = 0, kc = 0, vc = 0, z = grp;
  if constexpr (LAYOUT == kQkvFlat) {
    const int h = grp % a.heads;
    z = grp / a.heads;
    qc = h * kPD;
    kc = (a.heads + h) * kPD;
    vc = (2 * a.heads + h) * kPD;
  }
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], I8 ? 32 : 1);  // int8: every producer lane after its transposes
      mbar_init(&empty[s], 4 * C::WG);     // every consumer warp
    }
    mbar_init(qbar, 1);
    for (int r = 0; r < C::RAWS; ++r) mbar_init(&rawbar[r], 1);
    mbar_fence_init();
  }
  if (TC_DEN && tid < C::ONES / 4) {
    reinterpret_cast<uint32_t*>(ones)[tid] = 0x3F803F80u;  // bf16 1.0 twice
    fence_proxy_async();
  }
  __syncthreads();

  auto with_v = [&](int it) { return !TWO_PASS || it >= tiles; };
  auto tile_of = [&](int it) { return TWO_PASS && it >= tiles ? it - tiles : it; };

  if (warp >= 4 * C::WG) {  // producer
    if constexpr (!I8) setmaxnreg_dec<24>();
    if (warp > 4 * C::WG) return;
    if (lane == 0) {
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int r = 0; r < C::WG; ++r)
        tma_load_3d(qs + r * C::TILE, &q_map, qbar, qc, q0 + 64 * r, z);
    }
    if constexpr (!I8) {
      if (lane == 0)
        for (int it = 0; it < uses; ++it) {
          const int s = it % C::STAGES, t = tile_of(it);
          const bool v = with_v(it);
          mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], v ? C::STAGE : C::TILE);
          unsigned char* st = ring + s * C::STAGE;
          if constexpr (LAYOUT == kFoldedT) tma_load_3d(st, &k_map, &full[s], t * kPK, 0, z);
          else tma_load_3d(st, &k_map, &full[s], kc, t * kPK, z);
          if (v) tma_load_3d(st + C::TILE, &v_map, &full[s], vc, t * kPK, z);
        }
    } else {
      // kt's and v's tiles as they lie into staging pair it % 2, then
      // transposed into the stage by all 32 lanes
      auto stage_raw = [&](int it) {
        const int r = it & 1, t = tile_of(it);
        const bool v = with_v(it);
        unsigned char* rb = raw + r * C::RAW;
        mbar_expect_tx(&rawbar[r], v ? 2 * 4096 : 4096);
        tma_load_3d(rb, &k_map, &rawbar[r], t * kPK, 0, z);
        if (v) tma_load_3d(rb + 4096, &v_map, &rawbar[r], 0, t * kPK, z);
      };
      if (lane == 0)
        for (int it = 0; it < 2 && it < uses; ++it) stage_raw(it);
      const bool vlane = lane >= 16;
      const int blk = lane & 15;
      for (int it = 0; it < uses; ++it) {
        const int s = it % C::STAGES, r = it & 1;
        mbar_wait(&rawbar[r], (it >> 1) & 1);
        mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
        unsigned char* rb = raw + r * C::RAW;
        unsigned char* st = ring + s * C::STAGE;
        if (!vlane || with_v(it))
          transpose_block(rb + (vlane ? 4096 : 0), st + (vlane ? C::TILE : 0), blk & 3, blk >> 2,
                          vlane);
        fence_proxy_async();  // the generic stores, seen by wgmma's reads
        mbar_arrive(&full[s]);
        __syncwarp();
        if (lane == 0 && it + 2 < uses) stage_raw(it + 2);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg ..; warp wl of it owns rows
  // 16 wl + g and 16 wl + g + 8 of those. A warpgroup with no row below Rq
  // only releases the tiles.
  if constexpr (!I8) setmaxnreg_inc<C::CONSUMER_REGS>();
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const unsigned char* qw = qs + wg * C::TILE;
  auto stage = [&](int it) { return ring + (it % C::STAGES) * C::STAGE; };
  auto await = [&](int it) { mbar_wait(&full[it % C::STAGES], (it / C::STAGES) & 1); };
  auto release = [&](int it) {
    if (lane == 0) mbar_arrive(&empty[it % C::STAGES]);
  };
  mbar_wait(qbar, 0);
  if (q0 + 64 * wg >= Rq) {
    for (int it = 0; it < uses; ++it) {
      await(it);
      release(it);
    }
    return;
  }

  float m0 = 0.f, m1 = 0.f;  // the shift of rows g, g + 8
  if constexpr (SHIFT == kCauchy) {  // |q_i| from Q in shared memory (bf16, 128-byte swizzle)
    float n0 = 0.f, n1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * wl + g + 8 * (e & 1), chunk = 2 * kk + (e >> 1);
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(qw + r * 128 + ((chunk ^ (r & 7)) << 4) + 4 * t4);
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
        (e & 1 ? n1 : n0) += f.x * f.x + f.y * f.y;
      }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      n0 += __shfl_xor_sync(0xffffffffu, n0, o);
      n1 += __shfl_xor_sync(0xffffffffu, n1, o);
    }
    const float km = a.kmax[grp];
    m0 = __fmul_rn(sqrtf(n0), km);
    m1 = __fmul_rn(sqrtf(n1), km);
  }

  // S of ring use it into acc, issued; then, once complete, its scores in s
  // (keys k0 ..; EDGE: the last tile, which holds keys >= Nk)
  auto issue = [&](Acc (&acc)[32], int it) {
    await(it);
    issue_probe_scores<T, LAYOUT>(acc, qw, stage(it));
  };
  auto scores = [&](auto edge, const Acc (&acc)[32], int k0, float (&s)[32]) {
    probe_scores<SM, decltype(edge)::value>(acc, s, a.bias, k0, Nk, t4, a.scale);
  };

  int it = 0;
  if constexpr (TWO_PASS) {  // pass 1: the true row max, from K alone
    m0 = m1 = -INFINITY;
    for (int t = 0; t < tiles; ++t, ++it) {
      const int k0 = t * kPK;
      Acc acc[32];
      issue(acc, it);
      wgmma_wait<0>();
      fence_regs(acc);
      release(it);
      float s[32];
      if (k0 + kPK > Nk) scores(std::true_type{}, acc, k0, s);
      else scores(std::false_type{}, acc, k0, s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m0 = fmaxf(m0, fmaxf(s[4 * j], s[4 * j + 1]));
        m1 = fmaxf(m1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
  }

  Acc o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0;
  float l0 = 0.f, l1 = 0.f;                 // this lane's share of the row denominators (ALU)
  float ld[4] = {0.f, 0.f, 0.f, 0.f};       // TC_DEN: P . 1, each column a whole row's sum
  const uint64_t ones_desc = smem_desc(ones, 128, 256, 0);  // no swizzle; every byte pair 1.0
  // f = f(s - m) of a pair of keys of one row (rounded per SM), masked keys
  // (EDGE only) 0; the denominator's ALU share
  auto probs = [&](auto edge, float x0, float x1, float m, float& l, float& f0, float& f1) {
    constexpr bool EDGE = decltype(edge)::value;
    const bool ok0 = !EDGE || x0 != -INFINITY, ok1 = !EDGE || x1 != -INFINITY;
    if constexpr (SHIFT != kNoShift) {
      x0 = __fsub_rn(x0, m);
      x1 = __fsub_rn(x1, m);
    }
    if constexpr (SM != kSmF32) round_bf16x2(x0, x1);
    if constexpr (EXPF == kExpE) {
      f0 = expf(x0);
      f1 = expf(x1);
    } else if constexpr (EXPF == kExp2) {  // as XLA lowers exp2: exp(x ln 2) in the working type
      if constexpr (SM != kSmF32) {
        x0 = __fmul_rn(x0, kLn2Bf16);
        x1 = __fmul_rn(x1, kLn2Bf16);
        round_bf16x2(x0, x1);
      } else {
        x0 = __fmul_rn(x0, kLn2F32);
        x1 = __fmul_rn(x1, kLn2F32);
      }
      f0 = expf(x0);
      f1 = expf(x1);
    } else if constexpr (EXPF == kRelu) {
      f0 = fmaxf(x0, 0.f);
      f1 = fmaxf(x1, 0.f);
    } else {
      f0 = x0;
      f1 = x1;
    }
    if constexpr (SM != kSmF32) round_bf16x2(f0, f1);
    if constexpr (EDGE) {
      f0 = ok0 ? f0 : 0.f;
      f1 = ok1 ? f1 : 0.f;
    }
    if constexpr (DEN == kDenSum || DEN == kDenSumPlus1) l += f0 + f1;
  };
  for (int t = 0; t < tiles; ++t, ++it) {
    const int k0 = t * kPK;
    const bool edge = k0 + kPK > Nk;
    Acc acc[32];
    issue(acc, it);
    wgmma_wait<0>();
    fence_regs(acc);
    float s[32];
    if (edge) scores(std::true_type{}, acc, k0, s);
    else scores(std::false_type{}, acc, k0, s);
    // P: pk[2j + h] the bf16 pair of keys k0 + 8j + 2t4 .. of row g + 8h;
    // int8 pi[4j + e] the integer of s[4j + e]
    uint32_t pk[16];
    int pi[I8 ? 32 : 1];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int h = q & 1;
      float f0, f1;
      if (edge) probs(std::true_type{}, s[2 * q], s[2 * q + 1], h ? m1 : m0, h ? l1 : l0, f0, f1);
      else probs(std::false_type{}, s[2 * q], s[2 * q + 1], h ? m1 : m0, h ? l1 : l0, f0, f1);
      if constexpr (I8) {  // trunc(p * 127), as XLA converts toward 0
        pi[2 * q] = (int)__fmul_rn(f0, 127.f);
        pi[2 * q + 1] = (int)__fmul_rn(f1, 127.f);
      } else {
        pk[q] = pack_bf16(f0, f1);
        if constexpr (DEN == kDenOnes && !TC_DEN)
          (h ? l1 : l0) += __uint_as_float(pk[q] << 16) + __uint_as_float(pk[q] & 0xffff0000u);
      }
    }
    const unsigned char* vs = stage(it) + C::TILE;
    wgmma_fence();
    if constexpr (I8) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {  // keys 32 kk .. 32 kk + 31
        const int j = 16 * kk;        // pi index of key column block 4 kk
        const uint32_t pa[4] = {pack_s8(pi[j], pi[j + 1], pi[j + 4], pi[j + 5]),
                                pack_s8(pi[j + 2], pi[j + 3], pi[j + 6], pi[j + 7]),
                                pack_s8(pi[j + 8], pi[j + 9], pi[j + 12], pi[j + 13]),
                                pack_s8(pi[j + 10], pi[j + 11], pi[j + 14], pi[j + 15])};
        wgmma_rs_m64n64k32_s8(o, pa, desc_k64(vs + 32 * kk));
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // keys 16 kk .. 16 kk + 15
        const uint32_t pa[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2], pk[4 * kk + 3]};
        wgmma_rs_m64n64k16<1>(o, pa, desc_mn128(vs + kk * 16 * 128, kPK * 128));
        if constexpr (TC_DEN) wgmma_rs_m64n8k16(ld, pa, ones_desc);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if constexpr (TC_DEN) fence_regs(ld);
    release(it);
  }

  if constexpr (TC_DEN) {
    l0 = ld[0];
    l1 = ld[2];
  } else if constexpr (DEN != kDenNone) {
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
  long long ostride = kPD, osec = 0;
  __nv_bfloat16* ob = a.out + (long long)grp * Rq * kPD;
  if constexpr (LAYOUT == kQkvFlat) {
    ostride = 3LL * a.heads * kPD;
    osec = (long long)a.heads * kPD;
    ob = a.out + (long long)z * Rq * ostride + qc;
  }
  const int r0 = q0 + 64 * wg + 16 * wl + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t4;
    const uint32_t w0 = pack_bf16(fin(o[4 * j], l0), fin(o[4 * j + 1], l0));
    const uint32_t w1 = pack_bf16(fin(o[4 * j + 2], l1), fin(o[4 * j + 3], l1));
#pragma unroll
    for (int sec = 0; sec < (LAYOUT == kQkvFlat ? 3 : 1); ++sec) {
      if (r0 < Rq) *reinterpret_cast<uint32_t*>(ob + r0 * ostride + sec * osec + c) = w0;
      if (r1 < Rq) *reinterpret_cast<uint32_t*>(ob + r1 * ostride + sec * osec + c) = w1;
    }
  }
}

// a 3-D map over (dims[2], dims[1], dims[0]) elements with row stride
// `row` elements and 64 x 64 boxes
template <typename T>
bool probe_map(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
               uint64_t row, CUtensorMapSwizzle swizzle) {
  const uint64_t dims[3] = {d0, d1, d2};
  const uint64_t strides[2] = {row * sizeof(T), row * d1 * sizeof(T)};
  const uint32_t box[3] = {64, 64, 1};
  return make_tmap(map,
                   sizeof(T) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   base, 3, dims, strides, box, swizzle);
}

template <typename T, int LAYOUT, int SHIFT, int EXPF, int SM, int DEN>
int launch_probe(const void* q, const void* k, const void* v, const ProbeArgs& a, float* kmax,
                 int groups, int vstride, cudaStream_t stream) {
  using C = ProbeCfg<T>;
  constexpr bool I8 = sizeof(T) == 1;
  const uint64_t G = groups, Rq = a.Rq, Nk = a.Nk;
  const auto sw = I8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  // int8: kt's and v's tiles land as they lie, for the producer's transposes
  const auto kvsw = I8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap maps[3];
  bool ok;
  if constexpr (LAYOUT == kQkvFlat) {
    const uint64_t cols = 3ull * a.heads * kPD;
    ok = probe_map<T>(&maps[0], q, cols, Rq, G / a.heads, cols, sw);
    maps[1] = maps[2] = maps[0];
  } else {
    ok = probe_map<T>(&maps[0], q, kPD, Rq, G, kPD, sw) &&
         (LAYOUT == kFoldedT ? probe_map<T>(&maps[1], k, Nk, kPD, G, Nk, kvsw)
                             : probe_map<T>(&maps[1], k, kPD, Nk, G, kPD, kvsw)) &&
         probe_map<T>(&maps[2], v, kPD, Nk, G, vstride, kvsw);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  if constexpr (SHIFT == kCauchy) {
    probe_kmax_kernel<LAYOUT><<<groups, kKmaxThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(LAYOUT == kQkvFlat ? q : k), kmax, a.Nk, a.heads);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  auto kern = probe_attention_wgmma_kernel<T, LAYOUT, SHIFT, EXPF, SM, DEN>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  const dim3 grid((a.Rq + C::ROWS - 1) / C::ROWS, groups);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(maps[0], maps[1], maps[2], a);
  return (int)cudaGetLastError();
}

}  // namespace vitocm

// One probe attention. dtype 1: bf16 operands, 2: int8 (folded kt layout,
// row-max shift, exp, no denominator only). groups = G (folded) or B * heads
// (qkvflat). kmax: groups floats of scratch for the Cauchy-Schwarz shift, else
// unused. The output (bf16) has q's rows; qkvflat writes (B, Np, 3 h 64).
// Operands 16-byte aligned with rows of a multiple of 16 bytes (TMA).
// Returns cudaGetLastError() after the launches, or 1 (cudaErrorInvalidValue)
// for a combination that has no instantiation or operands TMA cannot map.
extern "C" int vitocm_probe_attention(int dtype, int layout, int shift, int expf_, int sm, int den,
                                      const void* q, const void* k, const void* v,
                                      const void* bias, void* kmax, void* out, int groups, int Rq,
                                      int Nk, int vstride, int heads, float scale, void* stream) {
  using namespace vitocm;
  if (groups < 1 || Rq < 1 || Nk < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  const ProbeArgs a{static_cast<const float*>(bias), static_cast<const float*>(kmax),
                    static_cast<__nv_bfloat16*>(out), Rq, Nk, heads, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  float* km = static_cast<float*>(kmax);
  using BF = __nv_bfloat16;
#define VITOCM_PROBE(T, CODE, L, S, E, M, D)                                         \
  if (dtype == CODE && layout == L && shift == S && expf_ == E && sm == M && den == D) \
    return launch_probe<T, L, S, E, M, D>(q, k, v, a, km, groups, vstride, s);
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
