// Backward of the fused LayerNorm -> MLP -> residual block, f32 storage,
// CUDA cores; the split-reduction kernel and the C entry point for both
// storage types.
//
// Replaces vit_ocm_wmsegmentation_tpu/ops/fused_mlp.py::_mlp_bwd_kernel
// (_bwd_impl, the backward of fused_mlp_block on its save-h1 route). With
// xn = LN(x) s + b, g = gelu(h1), gp = gelu'(h1) from the forward's saved
// h1, and do the cotangent of out:
//   dg = do W2,  dh1 = round(dg * gp),  dxn = dh1 W1,
//   dx = do + LN-backward(dxn),  ds = sum dxn * xh,  dbb = sum dxn,
//   dW1 = dh1^T xn,  db1 = sum dh1,  dW2 = do^T round(g),  db2 = sum do.
// On the SAVE_GP route (gp not null; _mlp_bwd_kernel with gp_ref) h1 holds
// the forward's rounded g and gp its rounded gelu'(h1): the dx kernel reads
// gp where it computes gelu'(h1), the weight kernel reads that g, and no
// kernel computes an erf or an exp.
// Weights in nn.Linear's layouts: w1 (H, D), w2 (D, H); dW1 comes back as
// (H, D) and dW2 as (D, H), all parameter gradients in f32.
//
// What changes on Hopper: the TPU kernel carries the weight gradients
// across a sequential grid axis over row chunks. Here the work splits into
// deterministic kernels without atomics:
//   1. dx: a CTA owns a row tile and walks H in chunks: dg, dh1, and dxn in
//      registers, then the LN backward; it writes dx, its tile's partial ds
//      and dbb, xn = LN(x) (R, D), and the chunk's dh1 (and g on the save-h1
//      route) (R, H) for the weight kernel;
//   2. weights: two plain products over the rows, dW1 = dh1^T xn and
//      dW2 = do^T g, a CTA a (128 x 128) output tile and a row split; db1
//      and db2 are the column sums of dh1 and do on the first column tile;
//      each split writes one f32 partial;
//   3. reduce: partials summed over splits (and row tiles) in a fixed order.
// 8 R D H flops of exact f32 FFMA on the CUDA cores (no TF32), 87 GFLOP at
// the MIM step's 36880 x 384, H 1536. dh1 and g make a round trip through
// device memory (2 x 227 MB at that shape, ~0.3 ms of HBM) where an earlier
// design recomputed dg in the weight kernel (2 R D H more flops): with both
// gradient products in one CTA, a (split, hidden chunk) CTA would hold
// 2 x chunk x D accumulators, which leaves micro-tiles of 4 x 12 at most;
// apart, each product takes 8 x 8 tiles and its CTAs fill the card.
//
// The kernels share the f32 forward's building blocks (ffma_tiles.cuh):
//   * dx kernel (256 threads, 64 rows): do (64 x D) resident in shared
//     memory (pitch D + 4); per chunk of 128 hidden units dg (64 x 128,
//     depth D) in 4 x 8 register tiles (tile_pv: do rows as float4 along
//     D, W2's rows as float4 along the units), dh1 = dg * gelu'(h1) into a
//     shared tile, then dxn (64 x D) += dh1 W1c in 8 x 12 tiles (4 x 12 at
//     D = 192) held for the whole walk; W2 slices (64 of D x 128 units) and
//     W1 slices (16 units x D) stream through a two-slot cp.async ring,
//     199 KB of shared memory at D = 384;
//   * weight kernel (256 threads, two CTAs an SM): an (M x N) = (128 x 128)
//     tile of A^T B for (R, M) A and (R, N) B, 8 x 8 a thread (tile_tn:
//     one row of each operand a step, as float4s), the rows of its split
//     in slices of 32 through a three-slot cp.async ring, 96 KB.
// The workspace is part = splits x (2 H D + H + D) partials, then dh1
// (R, H) and, on the save-h1 route, g (R, H), all f32.
// bf16 storage takes the wgmma kernels of fused_mlp_bwd_wgmma.cu.
//
// Numerics: LN statistics recomputed from x in f32 (biased variance);
// every product in f32, each sum over its inner index in order; erff where
// the TPU kernel carries a rational erf (about 1 ulp apart).

#include <math.h>

#include "common.cuh"
#include "ffma_tiles.cuh"

namespace vitocm {

// dx kernel
constexpr int kWR = 64;        // rows a tile
constexpr int kWH = 128;       // hidden units a chunk
constexpr int kWK = 64;        // rows of W2 (depth of dg) a slice
constexpr int kWJ = 16;        // rows of W1 (hidden units) a slice
constexpr int kWT = 256;       // threads
constexpr int kWG = kWH + 16;  // the dh1 tile's pitch: a warp's two row groups store to distinct banks

// the dxn tile: RG row groups of KG lanes, rows rg + RG*i, float4 column
// groups 4*kg + 4*KG*g; TR x TC = 8 x 12 at D = 384, 4 x 12 at D = 192
template <int D>
struct DxTiles;
template <>
struct DxTiles<384> {
  static constexpr int RG = 8, KG = 32;
};
template <>
struct DxTiles<192> {
  static constexpr int RG = 16, KG = 16;
};

// floats of a ring slot: a W2 slice (WK x WH) or a W1 slice (WJ x D)
template <int D>
__host__ __device__ constexpr int dx_slot() {
  return kWK * (kWH + 4) > kWJ * (D + 4) ? kWK * (kWH + 4) : kWJ * (D + 4);
}

template <int D>
constexpr size_t mlp_bwd_dx_smem_bytes() {
  return sizeof(float) * (kWR * (D + 4) + kWR * kWG + 2 * dx_slot<D>());
}

// weight kernel
constexpr int kYM = 128, kYN = 128;  // output tile
constexpr int kYK = 32;              // rows a slice
constexpr int kYS = 3;               // ring slots
constexpr int kYT = 256;             // threads
constexpr size_t kYSmem = sizeof(float) * kYS * kYK * (kYM + kYN);

template <int D, bool GP>
__global__ void __launch_bounds__(kWT, 1)
mlp_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ dout,
                  const float* __restrict__ h1, const float* __restrict__ gpp,
                  const float* __restrict__ s1, const float* __restrict__ bn1,
                  const float* __restrict__ w1, const float* __restrict__ w2,
                  float* __restrict__ dx, float* __restrict__ xn_out,
                  float* __restrict__ dh1_out, float* __restrict__ g_out,
                  float* __restrict__ ln_part, int R, int H, float eps) {
  using T = DxTiles<D>;
  constexpr int RG = T::RG, KG = T::KG, TR = kWR / RG, TC = D / KG;
  constexpr int PX = D + 4, SLOT = dx_slot<D>(), NK = D / kWK;
  static_assert(RG * KG == kWT && TC % 4 == 0 && D % kWK == 0 && 64 % kWJ == 0 &&
                    kWR == 64 && kWH == 128 && RG * 2 * D <= 2 * SLOT,
                "tile shape");
  extern __shared__ __align__(16) float sm[];
  float* dos = sm;                 // (WR, PX)
  float* dh1s = dos + kWR * PX;    // (WR, WG): dh1 of the chunk
  float* ring = dh1s + kWR * kWG;  // 2 slots

  const int tid = threadIdx.x;
  const int rg = tid / KG, kg = tid % KG;  // the dxn tile
  const int qg = tid >> 4, qk = tid & 15;  // the dg tile: rows qg + 16i, units 4qk + 64g + f
  const int r0 = blockIdx.x * kWR;
  const int chunks = (H + kWH - 1) / kWH;
  // slice p of chunk c: W2[64p .., h0 .. h0+WH] for p < NK, then W1[h0 + 16(p-NK) .., :]
  auto issue = [&](int c, int p, float* dst) {
    const int h0 = c * kWH;
    if (p < NK)
      stage_rows<kWK, kWH, kWH + 4, kWT>(dst, w2 + h0, p * kWK, D, H, H - h0);
    else
      stage_rows<kWJ, D, PX, kWT>(dst, w1 + (long long)(h0 + (p - NK) * kWJ) * D, 0, kWJ, D);
  };
  // wait for slice st (slice p of np of chunk ch), put the next one in flight
  auto next = [&](int ch, int p, int np, int st) {
    cp_async_wait<0>();
    __syncthreads();  // slice st (and do) has landed; slice st-1 and the dh1 tile are done
    float* dst = ring + ((st + 1) & 1) * SLOT;
    if (p + 1 < np)
      issue(ch, p + 1, dst);
    else if (ch + 1 < chunks)
      issue(ch + 1, 0, dst);
    cp_async_commit();
    return ring + (st & 1) * SLOT;
  };

  stage_rows<kWR, D, PX, kWT>(dos, dout, r0, R, D);
  issue(0, 0, ring);
  cp_async_commit();

  float acc[TR][TC];  // dxn
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[i][c] = 0.f;
  for (int ch = 0, st = 0; ch < chunks; ++ch) {
    const int h0 = ch * kWH, nh = min(kWH, H - h0), np = NK + nh / kWJ;
    float dg[4][8];  // rows qg + 16i, units 4qk + 64g + f of the chunk
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dg[i][j] = 0.f;
    for (int p = 0; p < NK; ++p, ++st)
      tile_pv<4, 8, 16, 16, kWK, PX, kWH + 4>(dg, dos + p * kWK, next(ch, p, np, st), qg, qk);
    // dh1 = dg * gelu'(h1) into the tile and, with g, to the workspace
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int u = 4 * qk + 64 * g;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = qg + 16 * i;
        const long long row = r0 + r, at = row * H + h0 + u;
        const bool ok = u < nh && row < R;
        float hv[4] = {0.f, 0.f, 0.f, 0.f}, pv[4] = {0.f, 0.f, 0.f, 0.f}, gv[4], d[4];
        if (ok) ld4(hv, h1 + at);
        if (GP && ok) ld4(pv, gpp + at);
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          if (!GP) gelu_pieces(hv[f], gv[f], pv[f]);
          d[f] = dg[i][4 * g + f] * pv[f];
        }
        st4(dh1s + r * kWG + u, d[0], d[1], d[2], d[3]);
        if (ok) {
          st4(dh1_out + at, d[0], d[1], d[2], d[3]);
          if (!GP) st4(g_out + at, gv[0], gv[1], gv[2], gv[3]);
        }
      }
    }
    for (int p = NK; p < np; ++p, ++st)
      tile_pv<TR, TC, RG, KG, kWJ, kWG, PX>(acc, dh1s + (p - NK) * kWJ, next(ch, p, np, st), rg,
                                            kg);
  }
  __syncthreads();  // the ring is free: it takes the column partials

  // LN backward, a row group a row: dx = do + r (dxh - mean(dxh) - xh mean(dxh xh))
  float psd[TC], psb[TC];  // this thread's column sums of dxn * xh and dxn
#pragma unroll
  for (int c = 0; c < TC; ++c) psd[c] = psb[c] = 0.f;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = rg + RG * i;
    const long long row = r0 + r;
    float v[TC], sc[TC];
#pragma unroll
    for (int g = 0; g < TC / 4; ++g) {
      const int col = 4 * kg + 4 * KG * g;
      float a[4] = {0.f, 0.f, 0.f, 0.f}, b[4];
      if (row < R) ld4(a, x + row * D + col);
      ld4(b, s1 + col);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        v[4 * g + f] = a[f];
        sc[4 * g + f] = b[f];
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < TC; ++c) sum += v[c];
    const float mu = group_sum<KG>(sum) / D;
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const float t = v[c] - mu;
      q += t * t;
    }
    const float rstd = 1.f / sqrtf(group_sum<KG>(q) / D + eps);
    float s_a = 0.f, s_b = 0.f;
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      v[c] = (v[c] - mu) * rstd;  // xh
      const float dxh = acc[i][c] * sc[c];
      s_a += dxh;
      s_b += dxh * v[c];
      psd[c] += acc[i][c] * v[c];
      psb[c] += acc[i][c];
    }
    const float m1 = group_sum<KG>(s_a) / D, m2 = group_sum<KG>(s_b) / D;
    if (row < R) {
#pragma unroll
      for (int g = 0; g < TC / 4; ++g) {
        const int col = 4 * kg + 4 * KG * g;
        float o[4], xo[4], bb[4], dv[4];
        ld4(dv, dos + r * PX + col);
        ld4(bb, bn1 + col);
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int c = 4 * g + f;
          o[f] = dv[f] + rstd * (acc[i][c] * sc[c] - m1 - v[c] * m2);
          xo[f] = v[c] * sc[c] + bb[f];
        }
        st4(dx + row * D + col, o[0], o[1], o[2], o[3]);
        st4(xn_out + row * D + col, xo[0], xo[1], xo[2], xo[3]);
      }
    }
  }
  float* red = ring;  // (RG, 2D): [dxn * xh | dxn] summed over a row group's rows
#pragma unroll
  for (int g = 0; g < TC / 4; ++g) {
    const int col = 4 * kg + 4 * KG * g;
    st4(red + rg * 2 * D + col, psd[4 * g], psd[4 * g + 1], psd[4 * g + 2], psd[4 * g + 3]);
    st4(red + rg * 2 * D + D + col, psb[4 * g], psb[4 * g + 1], psb[4 * g + 2], psb[4 * g + 3]);
  }
  __syncthreads();
  for (int c = tid; c < 2 * D; c += kWT) {
    float sum = 0.f;
    for (int r = 0; r < RG; ++r) sum += red[r * 2 * D + c];
    ln_part[(long long)blockIdx.x * 2 * D + c] = sum;
  }
}

// The weight gradients of one row split: blockIdx.x names an output tile of
// dW1 (H x D) = dh1^T xn (the first ceil(H/128) ceil(D/128) tiles) or of
// dW2 (D x H) = do^T g, blockIdx.y the split; the first column tile of each
// also sums its A's columns: db1 from dh1, db2 from do. Each sum runs over
// the split's rows in order.
__global__ void __launch_bounds__(kYT, 2)
mlp_bwd_w_kernel(const float* __restrict__ xn, const float* __restrict__ dout,
                 const float* __restrict__ dh1, const float* __restrict__ g,
                 float* __restrict__ part, int R, int D, int H, int rows_per_split) {
  const int t1 = (H + kYM - 1) / kYM * ((D + kYN - 1) / kYN);
  const bool second = (int)blockIdx.x >= t1;
  const int M = second ? D : H, N = second ? H : D;
  const int tt = second ? blockIdx.x - t1 : blockIdx.x, tn = (N + kYN - 1) / kYN;
  const int m0 = tt / tn * kYM, n0 = tt % tn * kYN;
  const float* A = second ? dout : dh1;  // (R, M)
  const float* B = second ? g : xn;      // (R, N)
  const long long W = 2LL * H * D + H + D;
  float* out = part + blockIdx.y * W + (second ? (long long)H * D : 0);  // (M, N)
  float* db = part + blockIdx.y * W + 2LL * H * D + (second ? H : 0);    // (M)
  const long long rs0 = (long long)blockIdx.y * rows_per_split;
  const long long rs1 = min((long long)R, rs0 + rows_per_split);
  const int nst = rs1 > rs0 ? (int)((rs1 - rs0 + kYK - 1) / kYK) : 0;

  extern __shared__ __align__(16) float sm[];
  auto slot = [&](int s) { return sm + (s % kYS) * kYK * (kYM + kYN); };  // A (YK, YM), B (YK, YN)
  auto issue = [&](int s) {
    const int k0 = (int)rs0 + s * kYK;
    stage_rows<kYK, kYM, kYM, kYT>(slot(s), A + m0, k0, (int)rs1, M, M - m0);
    stage_rows<kYK, kYN, kYN, kYT>(slot(s) + kYK * kYM, B + n0, k0, (int)rs1, N, N - n0);
  };

  if (nst > 0) issue(0);
  cp_async_commit();
  if (nst > 1) issue(1);
  cp_async_commit();

  const int tid = threadIdx.x, rg = tid >> 4, kg = tid & 15;
  const bool sums = n0 == 0 && tid < kYM;  // this thread sums A's column m0 + tid
  float acc[8][8];  // rows 4rg + 64a + e, columns 4kg + 64g + f
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float dbs = 0.f;
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<1>();
    __syncthreads();  // slice s has landed; slice s-1 is done
    if (s + 2 < nst) issue(s + 2);
    cp_async_commit();
    const float* a = slot(s);
#pragma unroll 2  // two rows in flight: within 128 registers, two CTAs an SM
    for (int k = 0; k < kYK; ++k)
      tile_tn<8, 8, 16, 16, 1, kYM, kYN>(acc, a + k * kYM, a + kYK * kYM + k * kYN, rg, kg);
    if (sums)
      for (int k = 0; k < kYK; ++k) dbs += a[k * kYM + tid];
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + 4 * rg + 64 * (i / 4) + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int gq = 0; gq < 2; ++gq) {
      const int n = n0 + 4 * kg + 64 * gq;
      if (n < N)
        st4(out + (long long)m * N + n, acc[i][4 * gq], acc[i][4 * gq + 1], acc[i][4 * gq + 2],
            acc[i][4 * gq + 3]);
    }
  }
  if (sums && m0 + tid < M) db[m0 + tid] = dbs;
}

// out[i] = sum over s < S of part[s * W + i], in order of s
__global__ void reduce_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     int S, long long W) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < W;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += part[s * W + i];
    out[i] = acc;
  }
}

int reduce_splits(const float* part, float* out, int S, long long W, cudaStream_t stream) {
  const int blocks = (int)min((W + 255) / 256, 4096LL);
  reduce_splits_kernel<<<blocks, 256, 0, stream>>>(part, out, S, W);
  return (int)cudaGetLastError();
}

// out[i] = sum over s < S of part[s * W + i] for a tall part (S >> W): a
// block sums 32 columns, each of its 8 warps a fixed range of rows in order,
// then the 8 warp sums in order (the bf16 ln_part rows of this file and of
// ln_linear.cu)
__global__ void reduce_rows_kernel(const float* __restrict__ part, float* __restrict__ out, int S,
                                   int W) {
  __shared__ float sums[8][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, col = blockIdx.x * 32 + lane;
  const int per = (S + 7) / 8, s0 = warp * per, s1 = min(S, s0 + per);
  float acc = 0.f;
  if (col < W)
    for (int s = s0; s < s1; ++s) acc += part[(long long)s * W + col];
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < W) {
    float t = 0.f;
    for (int w = 0; w < 8; ++w) t += sums[w][lane];
    out[col] = t;
  }
}

int reduce_rows(const float* part, float* out, int S, int W, cudaStream_t stream) {
  reduce_rows_kernel<<<(W + 31) / 32, 256, 0, stream>>>(part, out, S, W);
  return (int)cudaGetLastError();
}

template <int D, bool GP>
static int launch_mlp_bwd(const void* x, const void* dout, const void* h1, const void* gp,
                          const float* s1, const float* bn1, const void* w1, const void* w2,
                          void* dx, void* xn, float* ln_part, float* part, int R, int H,
                          int splits, int rps, float eps, cudaStream_t stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const size_t s_dx = mlp_bwd_dx_smem_bytes<D>();
  cudaFuncSetAttribute(mlp_bwd_dx_kernel<D, GP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)s_dx);
  cudaFuncSetAttribute(mlp_bwd_w_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kYSmem);
  // the workspace after the partials: dh1 (R, H), then g (R, H) on the save-h1 route
  float* dh1 = part + (long long)splits * (2LL * H * D + H + D);
  float* g = GP ? nullptr : dh1 + (long long)R * H;
  mlp_bwd_dx_kernel<D, GP><<<(R + kWR - 1) / kWR, kWT, s_dx, stream>>>(
      f(x), f(dout), f(h1), f(gp), s1, bn1, f(w1), f(w2), static_cast<float*>(dx),
      static_cast<float*>(xn), dh1, g, ln_part, R, H, eps);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int tiles = 2 * ((H + kYM - 1) / kYM) * ((D + kYN - 1) / kYN);
  mlp_bwd_w_kernel<<<dim3(tiles, splits), kYT, kYSmem, stream>>>(
      f(xn), f(dout), dh1, GP ? f(h1) : g, part, R, D, H, rps);
  return (int)cudaGetLastError();
}

// bf16 storage takes the wgmma kernels of fused_mlp_bwd_wgmma.cu
template <int D, bool GP>
int launch_mlp_bwd_wgmma(const void* x, const void* dout, const void* h1, const void* gp,
                         const float* s1, const float* bn1, const void* w1, const void* w2,
                         void* dx, void* xn, float* ln_part, float* part, int R, int H,
                         int max_splits, float eps, int* splits, cudaStream_t stream);

constexpr int kBwdTile = 64;  // rows of a dx tile's ln_part row, both storage types

// the launches of one storage type and route; *used: the split partials written
template <int D, bool GP>
static int launch_any_mlp_bwd(int dtype, const void* x, const void* dout, const void* h1,
                              const void* gp, const float* s1, const float* bn1, const void* w1,
                              const void* w2, void* dx, void* xn, float* ln_part, float* part,
                              int R, int H, int splits, float eps, int* used, cudaStream_t s) {
  if (dtype == kBF16)
    return launch_mlp_bwd_wgmma<D, GP>(x, dout, h1, gp, s1, bn1, w1, w2, dx, xn, ln_part, part,
                                       R, H, splits, eps, used, s);
  if (dtype != kF32) return (int)cudaErrorInvalidValue;
  // rows per split: a whole number of tiles
  const int rps = ((R + splits - 1) / splits + kBwdTile - 1) / kBwdTile * kBwdTile;
  *used = splits;
  return launch_mlp_bwd<D, GP>(x, dout, h1, gp, s1, bn1, w1, w2, dx, xn, ln_part, part, R, H,
                               splits, rps, eps, s);
}

template <int D>
static int launch_mlp_bwd_route(int dtype, const void* x, const void* dout, const void* h1,
                                const void* gp, const float* s1, const float* bn1,
                                const void* w1, const void* w2, void* dx, void* xn,
                                float* ln_part, float* part, int R, int H, int splits, float eps,
                                int* used, cudaStream_t s) {
  if (gp != nullptr)
    return launch_any_mlp_bwd<D, true>(dtype, x, dout, h1, gp, s1, bn1, w1, w2, dx, xn, ln_part,
                                       part, R, H, splits, eps, used, s);
  return launch_any_mlp_bwd<D, false>(dtype, x, dout, h1, gp, s1, bn1, w1, w2, dx, xn, ln_part,
                                      part, R, H, splits, eps, used, s);
}

}  // namespace vitocm

// x, dout, dx (R, D), h1 (R, H), w1 (H, D), w2 (D, H) in the storage type;
// gp null (save-h1 route: h1 is the pre-GELU activation) or (R, H) in the
// storage type (SAVE_GP route: h1 holds g = gelu(h1), gp gelu'(h1));
// s1, bn1 (D) f32. Workspaces: xn (R, D) in the storage type (the dx
// kernel writes LN(x) there for the weight kernel); part, for f32 storage
// splits x (2HD + H + D) f32 partials, then R x H f32 more on the SAVE_GP
// route and 2 R H on the save-h1 route, for bf16 splits x (2HD + H) f32
// partials, then R x H bf16 more on the SAVE_GP route and 2 R H on the
// save-h1 route; ln_part (ceil(R / 64), 2D) f32 for f32 storage, (ceil(R /
// 64), 3D) for bf16 (which sums db2 there). grads (2HD + H + 3D) f32
// receives [dW1 (H, D) | dW2 (D, H) | db1 (H) | db2 (D) | ds (D) | dbb (D)].
// D in {192, 384}; H a multiple of 64 for f32, of 32 for bf16. Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int vitocm_fused_mlp_bwd(int dtype, const void* x, const void* dout, const void* h1,
                                    const void* gp, const void* s1, const void* bn1, const void* w1,
                                    const void* w2, void* dx, void* xn, void* part, void* ln_part,
                                    void* grads, int R, int D, int H, int splits, float eps,
                                    void* stream) {
  using namespace vitocm;
  const int hmul = dtype == kBF16 ? 32 : 64;
  if (R < 1 || H < hmul || H % hmul != 0 || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *fs1 = static_cast<const float*>(s1), *fbn1 = static_cast<const float*>(bn1);
  float *fpart = static_cast<float*>(part), *fln = static_cast<float*>(ln_part);
  int rc = (int)cudaErrorInvalidValue, used = 0;
  if (D == 384)
    rc = launch_mlp_bwd_route<384>(dtype, x, dout, h1, gp, fs1, fbn1, w1, w2, dx, xn, fln, fpart,
                                   R, H, splits, eps, &used, s);
  else if (D == 192)
    rc = launch_mlp_bwd_route<192>(dtype, x, dout, h1, gp, fs1, fbn1, w1, w2, dx, xn, fln, fpart,
                                   R, H, splits, eps, &used, s);
  if (rc != 0) return rc;
  // the split partials hold [dW1 | dW2 | db1] and, for f32, db2; ln_part the
  // rest of the tail: [ds | dbb], and for bf16 db2 before them
  const bool bf16 = dtype == kBF16;
  const long long W = 2LL * H * D + H + (bf16 ? 0 : D);
  float* g = static_cast<float*>(grads);
  rc = reduce_splits(fpart, g, used, W, s);
  if (rc != 0) return rc;
  const int tiles = (R + kBwdTile - 1) / kBwdTile;
  if (bf16) return reduce_rows(fln, g + W, tiles, 3 * D, s);
  return reduce_splits(fln, g + W, tiles, 2LL * D, s);
}
