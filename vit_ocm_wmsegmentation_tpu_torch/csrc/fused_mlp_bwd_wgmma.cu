// Backward of the fused LayerNorm -> MLP -> residual block, bf16 storage, on
// Hopper's warpgroup tensor cores: wgmma fed by TMA through mbarrier rings.
//
// Replaces vit_ocm_wmsegmentation_tpu/ops/fused_mlp.py::_mlp_bwd_kernel
// (the backward of fused_mlp_block on its save-h1 route and, with gpp, on the
// SAVE_GP route) for bf16. Contract and arithmetic of fused_mlp_bwd.cu, with
// the TPU kernel's rounding points (twin: ops/fused_mlp.py::_mlp_bwd_plain):
// xn, g and dh1 = round(dg * gelu'(h1)) rounded to bf16 before their
// products, dx rounded once, every parameter gradient in f32. With GP, h1
// holds the forward's bf16 g and gp its bf16 gelu'(h1), and no kernel
// computes an erf or an exp.
//
// What bounds it on the H100: at the MIM step's 36880 x 384, H 1536, five
// products of 2 R D H (dg, dxn, dW1, dW2: 174 GFLOP, 0.176 ms at 989
// TFLOP/s); the HBM traffic (x, do, h1 and the outputs, ~0.2 GB, plus the
// dh1 and g round trip below, 0.45 GB) is ~0.2 ms at 3.35 TB/s. The
// mma.sync kernels this replaced staged every tile with all threads between
// two __syncthreads (tensor cores idle), and their weight kernel recomputed
// dg and gelu(h1) for every (row split, 32-unit chunk), re-reading each
// split's x and do 48 times at H = 1536: here each operand tile is read by
// TMA, and dg once.
//
// Two kernels, then fused_mlp_bwd.cu's fixed-order reduce_splits, so that
// two calls give the same bits (no atomics):
//   * dx (mlp_bwd_dx_wgmma_kernel): a CTA owns 128 rows, two consumer
//     warpgroups of 64, and a producer warpgroup. Each warpgroup normalizes
//     its rows first (xn, bf16, for the weight kernel; mu and rstd kept in
//     shared memory). do (128 x D, 128-byte swizzle, 96 KB at D = 384) stays
//     resident; per chunk of 32 hidden units the producer brings W2's
//     columns (D x 32, 64-byte swizzle), W1's rows (32 x D, 128-byte
//     swizzle) and the (128 x 32) h1 or gp tile (64-byte swizzle) into one
//     stage of a ring. dg = do . W2c by wgmma (m64n32, W2c read MN-major);
//     dh1 = round(dg * gelu'(h1)) on the accumulators, packed as the register
//     A operand of dxn += dh1 . W1c (m64n192, W1c read MN-major), which runs
//     while each warp writes its g = round(gelu(h1)) (h1 route) and dh1 rows
//     to bf16 workspaces, staged (g in its rows of the stage's h1 tile, dh1
//     in 1 KB of its own) for 16-byte stores. dxn is 64 x D f32 in registers
//     (192 a thread at D = 384): setmaxnreg 240 for the consumers, 24 for the
//     producer, as in fused_mlp_wgmma.cu. After the last chunk the producer
//     brings x (128 x D) into the freed ring, and the LN backward runs on the
//     accumulators with x, do and s1 read from shared memory (from device
//     memory, the loads the compiler hoisted beside the 192 accumulators
//     spilled 2.4 KB a thread): a row's D columns sit in the 4 lanes of a
//     quad, so its sums take two shuffles; dx = do + rstd (dxh - mean(dxh) -
//     xh mean(dxh xh)). The tile's column partials [db2 = sum do | ds = sum
//     dxn xh | dbb = sum dxn] are summed over the warp's 16 rows by shuffles
//     as each column is done, then over the 4 warps in order, into ln_part,
//     one row of 3 D a 64-row tile.
//   * weights (mlp_bwd_w_wgmma_kernel): dW1 = dh1^T xn and dW2^T = g^T do,
//     two plain A^T B products over a row split (K = rows), a CTA a (128
//     hidden units x D) output tile of one of them and one split. TMA brings
//     64-row slices of A (128 units) and B (D columns) into a ring; both are
//     row-major in memory, so wgmma reads both MN-major (m64n192, A from
//     shared memory, 64 units a warpgroup). db1 = sum dh1 comes out of the
//     same slices by one more m64n8 product against a tile of ones. The
//     split count fills the SMs in whole waves (11 at the MIM step's shape).
// Shared memory at D = 384: do 96 KB, two stages of 56 KB: 220 KB; one CTA
// an SM for both kernels (the weight kernel: three stages of 64 KB).
// Workspaces: part = splits x (2 H D + H) f32 partials, then dh1 (R, H) and,
// on the h1 route, g (R, H), both bf16; ln_part ceil(R / 64) x 3 D f32.
// dh1 and g make a round trip through device memory (2 x 113 MB at the MIM
// step's shape) where the weight kernel could recompute dg (one more R D H
// product and, on the h1 route, an erf a value).

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace vitocm {

constexpr int kDxR = 128;       // dx: rows a CTA (sw128_offset's 128), 64 a warpgroup
constexpr int kBC = 32;         // dx: hidden units a chunk
constexpr int kBThreads = 384;  // two consumer warpgroups + the producer warpgroup
constexpr int kWM = 128;        // weights: hidden units an output tile, 64 a warpgroup
constexpr int kWK = 64;         // weights: rows a slice

template <int D>
struct BwdDx {
  static constexpr int CH = D / 64, HALVES = D / 192;
  static constexpr int STAGES = D == 384 ? 2 : 3;
  static constexpr int DO_BYTES = CH * kDxR * 128;   // chunk c: 128 rows at c * 16 KB; x alike
  static constexpr int W2_BYTES = D * kBC * 2;       // D rows of 64 bytes
  static constexpr int W1_BYTES = CH * kBC * 128;    // chunk c: 32 rows at c * kBC * 128
  static constexpr int HID_BYTES = kDxR * kBC * 2;   // h1 or gp, then g: 128 rows of 64 bytes
  static constexpr int STAGE_BYTES = W2_BYTES + W1_BYTES + HID_BYTES;
  static constexpr int DH1_BYTES = 8 * 1024;         // the warps' (16 x 32) dh1 staging tiles
  // after the last chunk x takes the ring, and its tail and the dh1 staging
  // the two warpgroups' (4, D) tables of ds and dbb
  static_assert(STAGES * STAGE_BYTES + DH1_BYTES >= DO_BYTES + 2 * 2 * 4 * D * 4, "ring");
  static constexpr size_t SMEM = 1024 + DO_BYTES + STAGES * STAGE_BYTES + DH1_BYTES + kDxR * 8 +
                                 D * 4 + 8 * (2 * STAGES + 2);
};

template <int D>
struct BwdW {
  static constexpr int CH = D / 64, HALVES = D / 192;
  static constexpr int STAGES = D == 384 ? 3 : 4;
  static constexpr int A_BYTES = kWM * kWK * 2;   // warpgroup w's 64 units at w * 8192
  static constexpr int B_BYTES = CH * kWK * 128;  // chunk c: 64 rows at c * 8192
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr size_t SMEM = 1024 + STAGES * STAGE_BYTES + 1024 + 8 * 2 * STAGES;
};

template <int D, bool GP>
__global__ void __launch_bounds__(kBThreads, 1)
mlp_bwd_dx_wgmma_kernel(const __grid_constant__ CUtensorMap do_map,
                        const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap w1_map,
                        const __grid_constant__ CUtensorMap w2_map,
                        const __grid_constant__ CUtensorMap hid_map,
                        const __nv_bfloat16* __restrict__ x, const float* __restrict__ s1,
                        const float* __restrict__ bn1, __nv_bfloat16* __restrict__ dx,
                        __nv_bfloat16* __restrict__ xn_out, __nv_bfloat16* __restrict__ dh1_out,
                        __nv_bfloat16* __restrict__ g_out, float* __restrict__ ln_part, int R,
                        int H, float eps) {
  using C = BwdDx<D>;
  constexpr int CPT = D / 32;  // LN prologue: columns a lane
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* dos = align1024(smem_raw);
  unsigned char* ring = dos + C::DO_BYTES;  // then x, for the LN backward
  unsigned char* dst = ring + C::STAGES * C::STAGE_BYTES;  // dh1 staging, 1 KB a warp
  float2* stats = reinterpret_cast<float2*>(dst + C::DH1_BYTES);  // (mu, rstd) a row
  float* s1s = reinterpret_cast<float*>(stats + kDxR);
  uint64_t* full = reinterpret_cast<uint64_t*>(s1s + D);
  uint64_t* empty = full + C::STAGES;
  uint64_t* dobar = empty + C::STAGES;
  uint64_t* xbar = dobar + 1;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunks = H / kBC;
  const int r0 = blockIdx.x * kDxR;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // every consumer warp
    }
    mbar_init(dobar, 1);
    mbar_init(xbar, 1);
    mbar_fence_init();
  }
  for (int i = tid; i < D; i += kBThreads) s1s[i] = s1[i];
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one lane issues every copy
    setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(dobar, C::DO_BYTES);
      for (int j = 0; j < C::CH; ++j) tma_load_2d(dos + j * kDxR * 128, &do_map, dobar, 64 * j, r0);
      for (int c = 0; c < chunks; ++c) {
        const int s = c % C::STAGES;
        unsigned char* st = ring + s * C::STAGE_BYTES;
        mbar_wait(&empty[s], ((c / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        for (int j = 0; j < C::HALVES; ++j)
          tma_load_2d(st + j * 192 * kBC * 2, &w2_map, &full[s], c * kBC, 192 * j);
        for (int j = 0; j < C::CH; ++j)
          tma_load_2d(st + C::W2_BYTES + j * kBC * 128, &w1_map, &full[s], 64 * j, c * kBC);
        tma_load_2d(st + C::W2_BYTES + C::W1_BYTES, &hid_map, &full[s], c * kBC, r0);
      }
      // x into the ring once every consumer warp has freed its last stages
      for (int c = chunks > C::STAGES ? chunks - C::STAGES : 0; c < chunks; ++c)
        mbar_wait(&empty[c % C::STAGES], (c / C::STAGES) & 1);
      mbar_expect_tx(xbar, C::DO_BYTES);
      for (int j = 0; j < C::CH; ++j) tma_load_2d(ring + j * kDxR * 128, &x_map, xbar, 64 * j, r0);
    }
    return;
  }
  setmaxnreg_inc<240>();

  // consumer warpgroup wg: rows rb ..; warp wl of it normalizes rows 16 wl ..
  // 16 wl + 15 and holds accumulator rows 16 wl + g (+ 8). A warpgroup with
  // no row below R only releases the chunks.
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int rb = r0 + 64 * wg;
  auto stage = [&](int c) { return ring + (c % C::STAGES) * C::STAGE_BYTES; };
  auto await = [&](int c) { mbar_wait(&full[c % C::STAGES], (c / C::STAGES) & 1); };
  auto release = [&](int c) {
    if (lane == 0) mbar_arrive(&empty[c % C::STAGES]);
  };
  if (rb >= R) {
    for (int c = 0; c < chunks; ++c) {
      await(c);
      release(c);
    }
    return;
  }

  // xn = round(LN(x) * s1 + bn1) for the weight kernel, one row at a time
  // across the warp; (mu, rstd) kept for the LN backward
  for (int i = 0; i < 16; ++i) {
    const int r = 16 * wl + i;
    const long long row = (long long)rb + r;
    float v[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      v[c] = row < R ? __bfloat162float(x[row * D + lane + 32 * c]) : 0.f;
    float mu, rstd;
    warp_ln_stats<D>(v, eps, mu, rstd);
    if (lane == 0) stats[64 * wg + r] = make_float2(mu, rstd);
    if (row < R) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = lane + 32 * c;
        xn_out[row * D + col] = __float2bfloat16_rn((v[c] - mu) * rstd * s1s[col] + bn1[col]);
      }
    }
  }
  __syncwarp();  // the warp's rows' (mu, rstd), read back by their accumulator lanes

  // dxn: [4i + e] at row g + 8 (e >> 1), column 192 hf + 8i + 2 t4 + (e & 1)
  float acc[C::HALVES][96];
#pragma unroll
  for (int hf = 0; hf < C::HALVES; ++hf)
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[hf][i] = 0.f;
  const uint64_t dg_a = desc_k128(dos + wg * 64 * 128);  // this warpgroup's do rows
  const long long wrow = (long long)rb + 16 * wl;         // this warp's first row
  unsigned char* wst = dst + warp * 1024;                 // this warp's dh1 staging
  mbar_wait(dobar, 0);
  for (int c = 0; c < chunks; ++c) {
    await(c);
    unsigned char* st = stage(c);
    // this warp's rows of the h1 (gp) tile
    unsigned char* hid = st + C::W2_BYTES + C::W1_BYTES + (64 * wg + 16 * wl) * 64;
    // dg = do . W2c: 64 rows x 32 units, K = D (descriptors: a base and its byte offsets / 16)
    float dg[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) dg[i] = 0.f;
    const uint64_t dg_b = desc_mn64(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n32k16<1>(dg, dg_a + (((kk >> 2) * kDxR * 128 + (kk & 3) * 32) >> 4),
                            dg_b + kk * (1024 >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dg);

    // dh1 = round(dg * gelu'(h1)), packed as the A operand of the two
    // k-steps of dxn += dh1 . W1c and staged in the warp's dh1 tile; g =
    // round(gelu(h1)) staged over the h1 values it was computed from (each
    // lane rewrites only what it read)
    uint32_t da[2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = 8 * i + 2 * t4;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int at = sw64_offset(g + 8 * e, col);
        const float2 hv = bf16x2_at(hid + at);
        float p0 = hv.x, p1 = hv.y;
        if (!GP) {
          float g0, g1;
          gelu_pieces_bf16(hv.x, g0, p0);
          gelu_pieces_bf16(hv.y, g1, p1);
          *reinterpret_cast<uint32_t*>(hid + at) = pack_bf16(g0, g1);
        }
        const uint32_t d = pack_bf16(dg[4 * i + 2 * e] * p0, dg[4 * i + 2 * e + 1] * p1);
        *reinterpret_cast<uint32_t*>(wst + at) = d;
        da[i >> 1][2 * (i & 1) + e] = d;
      }
    }
    const uint64_t w1b = desc_mn128(st + C::W2_BYTES, kBC * 128);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int hf = 0; hf < C::HALVES; ++hf)
        wgmma_rs_m64n192k16<1>(acc[hf], da[kk], w1b + ((3 * hf * kBC * 128 + kk * 16 * 128) >> 4));
    wgmma_commit();
    __syncwarp();  // the warp's staged g and dh1 rows out while the product runs
    if (!GP) warp_tile_store(hid, g_out, wrow, R, H, c * kBC, lane);
    warp_tile_store(wst, dh1_out, wrow, R, H, c * kBC, lane);
    wgmma_wait<0>();
    __syncwarp();  // the dh1 tile read before the next chunk rewrites it
#pragma unroll
    for (int hf = 0; hf < C::HALVES; ++hf) fence_regs(acc[hf]);
    fence_proxy_async();  // every lane's staged writes, before TMA refills the stage
    __syncwarp();
    release(c);
  }

  // LN backward on the accumulators, x and do read from shared memory (x
  // arrives in the ring, rows past R as zeros): this thread's rows ra, ra + 8
  const unsigned char* xs = ring;
  const int ra = 64 * wg + 16 * wl + g;  // CTA row
  const float2 mr[2] = {stats[ra], stats[ra + 8]};
  mbar_wait(xbar, 0);
  float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < C::HALVES; ++hf)
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      const int col = 192 * hf + 8 * i + 2 * t4;
      const float2 sc = *reinterpret_cast<const float2*>(s1s + col);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 xv = bf16x2_at(xs + sw128_offset(ra + 8 * e, col));
        const float xh0 = (xv.x - mr[e].x) * mr[e].y, xh1 = (xv.y - mr[e].x) * mr[e].y;
        const float d0 = acc[hf][4 * i + 2 * e] * sc.x, d1 = acc[hf][4 * i + 2 * e + 1] * sc.y;
        m1[e] += d0 + d1;
        m2[e] += d0 * xh0 + d1 * xh1;
      }
    }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    m1[e] = sum_over_quad(m1[e]) / D;
    m2[e] = sum_over_quad(m2[e]) / D;
  }
  // dx = do + rstd (dxh - m1 - xh m2), and the column sums of dxn xh (ds)
  // and dxn (dbb) over the warp's 16 rows (two a lane, then shuffles over
  // g), into (4, D) tables of the warpgroup in the ring's tail past x and the
  // dh1 staging, free now
  float* red_ds = reinterpret_cast<float*>(ring + C::DO_BYTES) + wg * 2 * 4 * D;
  float* red_dbb = red_ds + 4 * D;
#pragma unroll
  for (int hf = 0; hf < C::HALVES; ++hf)
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      const int col = 192 * hf + 8 * i + 2 * t4;
      const float2 sc = *reinterpret_cast<const float2*>(s1s + col);
      float sd0 = 0.f, sd1 = 0.f, sb0 = 0.f, sb1 = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 xv = bf16x2_at(xs + sw128_offset(ra + 8 * e, col));
        const float xh0 = (xv.x - mr[e].x) * mr[e].y, xh1 = (xv.y - mr[e].x) * mr[e].y;
        const float a0 = acc[hf][4 * i + 2 * e], a1 = acc[hf][4 * i + 2 * e + 1];
        const long long row = (long long)r0 + ra + 8 * e;
        if (row < R) {
          const float2 dv = bf16x2_at(dos + sw128_offset(ra + 8 * e, col));
          *reinterpret_cast<uint32_t*>(dx + row * D + col) =
              pack_bf16(dv.x + mr[e].y * (a0 * sc.x - m1[e] - xh0 * m2[e]),
                        dv.y + mr[e].y * (a1 * sc.y - m1[e] - xh1 * m2[e]));
        }
        sd0 += a0 * xh0;
        sd1 += a1 * xh1;
        sb0 += a0;
        sb1 += a1;
      }
      sd0 = sum_over_g(sd0);
      sd1 = sum_over_g(sd1);
      sb0 = sum_over_g(sb0);
      sb1 = sum_over_g(sb1);
      if (g == 0) {
        *reinterpret_cast<float2*>(red_ds + wl * D + col) = make_float2(sd0, sd1);
        *reinterpret_cast<float2*>(red_dbb + wl * D + col) = make_float2(sb0, sb1);
      }
    }
  // db2 = sum do, alike, into a table in the warpgroup's x rows (free once
  // every warp of it is here); then each column of the tile's partials
  // [db2 | ds | dbb] summed over the 4 warps in order into ln_part
  named_barrier(1 + wg, 128);
  float* red_db2 = reinterpret_cast<float*>(ring + wg * 64 * 128);
#pragma unroll
  for (int hf = 0; hf < C::HALVES; ++hf)
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      const int col = 192 * hf + 8 * i + 2 * t4;
      const float2 d0 = bf16x2_at(dos + sw128_offset(ra, col));  // rows past R are zeros
      const float2 d1 = bf16x2_at(dos + sw128_offset(ra + 8, col));
      const float v0 = sum_over_g(d0.x + d1.x), v1 = sum_over_g(d0.y + d1.y);
      if (g == 0) *reinterpret_cast<float2*>(red_db2 + wl * D + col) = make_float2(v0, v1);
    }
  named_barrier(1 + wg, 128);
  float* part = ln_part + (long long)(2 * blockIdx.x + wg) * 3 * D;
  const float* tables[3] = {red_db2, red_ds, red_dbb};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float* t = tables[q];
    for (int col = tid & 127; col < D; col += 128)
      part[q * D + col] = ((t[col] + t[D + col]) + t[2 * D + col]) + t[3 * D + col];
  }
}

// One output tile of one weight-gradient product over one row split:
// blockIdx.x < ceil(H / 128) names 128 rows (hidden units) of dW1 = dh1^T xn,
// the rest those of dW2^T = g^T do; blockIdx.y the split. The dW1 tiles also
// write db1 = sum dh1 of their units; all f32, into the split's partials
// [dW1 (H, D) | dW2 (D, H) | db1 (H)].
template <int D>
__global__ void __launch_bounds__(kBThreads, 1)
mlp_bwd_w_wgmma_kernel(const __grid_constant__ CUtensorMap dh1_map,
                       const __grid_constant__ CUtensorMap g_map,
                       const __grid_constant__ CUtensorMap xn_map,
                       const __grid_constant__ CUtensorMap do_map, float* __restrict__ part,
                       int R, int H, int rows_per_split) {
  using C = BwdW<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* ones = ring + C::STAGES * C::STAGE_BYTES;  // 8 rows x 128 bytes of bf16 1.0
  uint64_t* full = reinterpret_cast<uint64_t*>(ones + 1024);
  uint64_t* empty = full + C::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ub = (H + kWM - 1) / kWM;
  const bool second = (int)blockIdx.x >= ub;  // dW2^T = g^T do
  const int u0 = (second ? blockIdx.x - ub : blockIdx.x) * kWM;
  const int rs0 = blockIdx.y * rows_per_split;
  const int rs1 = min(R, rs0 + rows_per_split);
  const int nst = rs1 > rs0 ? (rs1 - rs0 + kWK - 1) / kWK : 0;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // every consumer warp
    }
    mbar_fence_init();
  }
  if (tid < 256) reinterpret_cast<uint32_t*>(ones)[tid] = 0x3F803F80u;
  fence_proxy_async();
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one lane issues every copy
    setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
      const CUtensorMap* amap = second ? &g_map : &dh1_map;
      const CUtensorMap* bmap = second ? &do_map : &xn_map;
      for (int s = 0; s < nst; ++s) {
        const int b = s % C::STAGES;
        unsigned char* st = ring + b * C::STAGE_BYTES;
        mbar_wait(&empty[b], ((s / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[b], C::STAGE_BYTES);
        const int k0 = rs0 + s * kWK;
        for (int w = 0; w < 2; ++w) tma_load_2d(st + w * 8192, amap, &full[b], u0 + 64 * w, k0);
        for (int c = 0; c < C::CH; ++c)
          tma_load_2d(st + C::A_BYTES + c * 8192, bmap, &full[b], 64 * c, k0);
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  // consumer warpgroup wg: hidden units u0 + 64 wg ..; warp wl of it holds
  // accumulator rows 16 wl + g (+ 8)
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  float acc[C::HALVES][96];
#pragma unroll
  for (int hf = 0; hf < C::HALVES; ++hf)
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[hf][i] = 0.f;
  float db[4] = {0.f, 0.f, 0.f, 0.f};  // sum over rows of A: every column the same
  const uint64_t ones_desc = desc_k128(ones);
  for (int s = 0; s < nst; ++s) {
    mbar_wait(&full[s % C::STAGES], (s / C::STAGES) & 1);
    const unsigned char* st = ring + (s % C::STAGES) * C::STAGE_BYTES;
    const uint64_t a = desc_mn128(st + wg * 8192, 8192), b = desc_mn128(st + C::A_BYTES, 8192);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWK / 16; ++kk) {  // descriptors: a base plus byte offsets / 16
      const uint64_t da = a + kk * (16 * 128 >> 4);
#pragma unroll
      for (int hf = 0; hf < C::HALVES; ++hf)
        wgmma_ss_m64n192k16<1, 1>(acc[hf], da, b + ((3 * hf * 8192 + kk * 16 * 128) >> 4));
      if (!second) wgmma_ss_m64n8k16<1, 0>(db, da, ones_desc);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the slice before this one is done: free its stage
    if (s > 0 && lane == 0) mbar_arrive(&empty[(s - 1) % C::STAGES]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int hf = 0; hf < C::HALVES; ++hf) fence_regs(acc[hf]);
  fence_regs(db);

  const long long W = 2LL * H * D + H;
  float* out = part + blockIdx.y * W;
  const int m[2] = {u0 + 64 * wg + 16 * wl + g, u0 + 64 * wg + 16 * wl + g + 8};
#pragma unroll
  for (int hf = 0; hf < C::HALVES; ++hf)
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      const int n = 192 * hf + 8 * i + 2 * t4;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (m[e] >= H) continue;
        const float v0 = acc[hf][4 * i + 2 * e], v1 = acc[hf][4 * i + 2 * e + 1];
        if (second) {  // dW2 (D, H): 8 lanes store 32 consecutive bytes of a row
          out[(long long)H * D + (long long)n * H + m[e]] = v0;
          out[(long long)H * D + (long long)(n + 1) * H + m[e]] = v1;
        } else {
          *reinterpret_cast<float2*>(out + (long long)m[e] * D + n) = make_float2(v0, v1);
        }
      }
    }
  if (!second && t4 == 0) {
    if (m[0] < H) out[2LL * H * D + m[0]] = db[0];
    if (m[1] < H) out[2LL * H * D + m[1]] = db[2];
  }
}

// x, dout, dx, xn (R, D), h1, gp (R, H), w1 (H, D), w2 (D, H) bf16; part
// holds max_splits x (2 H D + H) f32 partials, then dh1 (R, H) and, without
// GP, g (R, H) in bf16; ln_part ceil(R / 64) x 3 D f32. Sets *splits to the
// number of partials written.
template <int D, bool GP>
int launch_mlp_bwd_wgmma(const void* x, const void* dout, const void* h1, const void* gp,
                         const float* s1, const float* bn1, const void* w1, const void* w2,
                         void* dx, void* xn, float* ln_part, float* part, int R, int H,
                         int max_splits, float eps, int* splits, cudaStream_t stream) {
  using T = __nv_bfloat16;
  T* dh1 = reinterpret_cast<T*>(part + (long long)max_splits * (2LL * H * D + H));
  T* g = GP ? const_cast<T*>(static_cast<const T*>(h1)) : dh1 + (long long)R * H;
  const uint64_t dd[2] = {(uint64_t)D, (uint64_t)R}, sd[1] = {(uint64_t)D * 2};
  const uint64_t dh[2] = {(uint64_t)H, (uint64_t)R}, sh[1] = {(uint64_t)H * 2};
  const uint64_t d1[2] = {(uint64_t)D, (uint64_t)H}, d2[2] = {(uint64_t)H, (uint64_t)D};
  const uint32_t box_do[2] = {64, kDxR}, box_w1[2] = {64, kBC}, box_w2[2] = {kBC, 192};
  const uint32_t box_hid[2] = {kBC, kDxR}, box_64[2] = {64, kWK};
  CUtensorMap do_dx, x_dx, w1m, w2m, hid, dh1_w, g_w, xn_w, do_w;
  if (!make_tmap_bf16(&do_dx, dout, 2, dd, sd, box_do, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_tmap_bf16(&x_dx, x, 2, dd, sd, box_do, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_tmap_bf16(&w1m, w1, 2, d1, sd, box_w1, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_tmap_bf16(&w2m, w2, 2, d2, sh, box_w2, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_tmap_bf16(&hid, GP ? gp : h1, 2, dh, sh, box_hid, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_tmap_bf16(&dh1_w, dh1, 2, dh, sh, box_64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_tmap_bf16(&g_w, g, 2, dh, sh, box_64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_tmap_bf16(&xn_w, xn, 2, dd, sd, box_64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_tmap_bf16(&do_w, dout, 2, dd, sd, box_64, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;

  using CX = BwdDx<D>;
  auto kx = mlp_bwd_dx_wgmma_kernel<D, GP>;
  cudaFuncSetAttribute(kx, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CX::SMEM);
  kx<<<(R + kDxR - 1) / kDxR, kBThreads, CX::SMEM, stream>>>(
      do_dx, x_dx, w1m, w2m, hid, static_cast<const T*>(x), s1, bn1, static_cast<T*>(dx),
      static_cast<T*>(xn), dh1, GP ? nullptr : g, ln_part, R, H, eps);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;

  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = 2 * ((H + kWM - 1) / kWM);
  const int s = weight_splits(tiles, min(max_splits, (R + kWK - 1) / kWK), sms);
  const int rps = ((R + s - 1) / s + kWK - 1) / kWK * kWK;  // whole slices
  using CW = BwdW<D>;
  auto kw = mlp_bwd_w_wgmma_kernel<D>;
  cudaFuncSetAttribute(kw, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CW::SMEM);
  kw<<<dim3(tiles, s), kBThreads, CW::SMEM, stream>>>(dh1_w, g_w, xn_w, do_w, part, R, H, rps);
  *splits = s;
  return (int)cudaGetLastError();
}

#define VITOCM_MLP_BWD_WGMMA(D, GP)                                                           \
  template int launch_mlp_bwd_wgmma<D, GP>(const void*, const void*, const void*, const void*, \
                                           const float*, const float*, const void*,             \
                                           const void*, void*, void*, float*, float*, int, int, \
                                           int, float, int*, cudaStream_t);
VITOCM_MLP_BWD_WGMMA(384, false)
VITOCM_MLP_BWD_WGMMA(384, true)
VITOCM_MLP_BWD_WGMMA(192, false)
VITOCM_MLP_BWD_WGMMA(192, true)
#undef VITOCM_MLP_BWD_WGMMA

}  // namespace vitocm
