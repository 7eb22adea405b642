// Fused LayerNorm -> linear (TRAIN.LN_QKV kernel), forward, bf16 storage, on
// Hopper's warpgroup tensor cores: wgmma fed by TMA through an mbarrier ring,
// y written by TMA stores. Entry: ln_linear.cu's vitocm_ln_linear.
//
// Replaces vit_ocm_wmsegmentation_tpu/ops/ln_linear.py::_ln_linear_fwd_kernel
// for bf16, with the TPU kernel's rounding points (twin: ops/ln_linear.py
// ::ln_linear_plain): the LN statistics in f32 from the bf16 x, xn =
// bf16((x - mu) rstd s + bn), y = bf16(xn W^T + b) with f32 accumulation and
// the bias added in f32. W in nn.Linear's (K, D) layout, which is K-major for
// wgmma's B operand as it lies. D in {192, 384}, K a multiple of 64.
//
// What bounds it on the H100: at the MIM step's x (36880, 384), W (1152,
// 384), 32.6 GFLOP (0.033 ms at 989 TFLOP/s) against 0.11 GB of HBM traffic
// (x 28 MB read, y 85 MB written: 0.034 ms at 3.35 TB/s), so the bytes, y
// above all, and the tensor cores bound it about equally; W (0.88 MB) is read
// from L2 by every CTA, 48 KB for every 6.3 MFLOP. The mma.sync kernel this
// replaced (64 rows a CTA) staged each 64-column chunk of W with all threads
// between two __syncthreads (nothing in flight during the products, the
// tensor cores idle during the copies), wrote y 4 bytes a lane (half of each
// 32-byte sector) and ran 2.19 waves of row tiles. Here:
//   * work: units of (128 rows, 192 output columns), row-major; a persistent
//     CTA an SM walks a contiguous range of them (13 or 14 of 1734 units at
//     the MIM shape on 132 SMs, where whole row tiles leave a third wave 19 %
//     full), so no wave runs short, and it normalizes a row tile once for
//     all of its column chunks. Each output is one sum over D, so where the
//     columns are cut changes no bit;
//   * LN: a producer thread brings the x tile (128 x D, 128-byte swizzle) by
//     TMA into the xn buffer; each consumer warp normalizes 16 of its rows in
//     place (a warp a row, lane + 32 c, eight rows at a time), so xn is
//     exactly the mma.sync kernel's. The next tile's x comes in 64-column
//     pieces, each as soon as the last products of this tile that read that
//     piece of xn are done ("xfree" mbarriers), under the remaining products;
//   * products: another producer thread streams W's chunk of 192 rows in
//     pieces of 64 of D (24 KB, 128-byte swizzle) through a ring of 4 stages
//     ("full" and "empty" mbarriers). Two consumer warpgroups of 64 rows run
//     y_c = xn W_c^T by wgmma m64n192k16 with both operands in shared memory,
//     D / 16 steps in order from 0 (the mma.sync kernel's order: the bits of
//     y are its bits), one piece's products in flight while the next is
//     issued. 96 accumulators a thread; setmaxnreg 240 for the consumers, 24
//     for the producer warpgroup;
//   * epilogue: bias added in f32 and rounded, each warp's 16 x 64 tile
//     staged in the 128-byte swizzle (double-buffered, 2 KB each) and written
//     by one TMA store, rows past R and columns past K clipped by the map,
//     while the other warpgroup's products run.
// Shared memory at D = 384: xn 96 KB, ring 96 KB, staging 32 KB; one CTA an SM.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace vitocm {

constexpr int kLfRows = 128;     // rows a unit, 64 a consumer warpgroup
constexpr int kLfN = 192;        // output columns (rows of W) a unit
constexpr int kLfThreads = 384;  // two consumer warpgroups + the producer warpgroup
constexpr int kLfStages = 4;     // W ring

template <int D>
struct LnFwd {
  static constexpr int CH = D / 64;                      // 64-column pieces of D
  static constexpr int XS_BYTES = CH * kLfRows * 128;    // piece p: 128 rows at p * 16 KB
  static constexpr int PIECE_BYTES = kLfN * 128;         // 192 rows of W, 64 of D
  static constexpr int STG_BYTES = 8 * 2 * 2048;         // each warp's two 16 x 64 tiles
  static constexpr size_t SMEM =
      1024 + XS_BYTES + kLfStages * PIECE_BYTES + STG_BYTES + 8 * (2 * kLfStages + 2 * CH);
};

// v summed over the warp, for 8 rows at once: each level of
// common.cuh::warp_sum's butterfly taken for all 8 (the same sums, in the
// same order, as warp_sum row by row)
__device__ __forceinline__ void warp_sum8(float (&v)[8]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
}

// f(v[lane % 8]) computed by each lane, then broadcast: out[k] = f(v[k]) from
// lane k. One IEEE division (or square root) a lane where the rows would
// take eight one after another.
template <class F>
__device__ __forceinline__ void per_row(const float (&v)[8], float (&out)[8], int lane, F f) {
  float mine = v[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) mine = (lane & 7) == k ? v[k] : mine;
  mine = f(mine);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = __shfl_sync(0xffffffffu, mine, k);
}

// rows r0 .. r0 + 15 (r0 a multiple of 8) of the (128 x D) tile at xs
// normalized in place: xn = bf16((x - mu) rstd s + bn), lane + 32 c of a row
// in lane, eight rows at a time, with the arithmetic of common.cuh::
// warp_ln_stats (mu = sum / D, rstd = 1 / sqrt(sum of squares / D + eps)),
// so xn is the mma.sync kernel's bit for bit. Row r0 + 8 h + k has r % 8 = k,
// so each element's swizzled offset (sw128_offset) is a per-lane base plus a
// constant.
template <int D>
__device__ __forceinline__ void ln_rows_in_place(unsigned char* xs, int r0, int lane,
                                                 const float (&sv)[D / 32],
                                                 const float (&bv)[D / 32], float eps) {
  constexpr int CPT = D / 32;
  const int lb = lane >> 3, le = (lane & 7) * 2;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    unsigned char* row0 = xs + (r0 + 8 * h) * 128 + le;
    auto at = [&](int k, int c) {  // sw128_offset(r0 + 8 h + k, lane + 32 c) - that of row0
      return reinterpret_cast<__nv_bfloat16*>(row0 + (c >> 1) * kLfRows * 128 + k * 128 +
                                              (((lb + 4 * (c & 1)) ^ k) << 4));
    };
    float v[8][CPT], t[8], mu[8], rstd[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      t[k] = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        v[k][c] = __bfloat162float(*at(k, c));
        t[k] += v[k][c];
      }
    }
    warp_sum8(t);
    per_row(t, mu, lane, [](float sum) { return sum / D; });
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      t[k] = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float d = v[k][c] - mu[k];
        t[k] += d * d;
      }
    }
    warp_sum8(t);
    per_row(t, rstd, lane, [eps](float q) { return 1.f / sqrtf(q / D + eps); });
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        *at(k, c) = __float2bfloat16_rn((v[k][c] - mu[k]) * rstd[k] * sv[c] + bv[c]);
  }
}

template <int D>
__global__ void __launch_bounds__(kLfThreads, 1)
ln_linear_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap w_map,
                           const __grid_constant__ CUtensorMap y_map, const float* __restrict__ s,
                           const float* __restrict__ bn, const float* __restrict__ b, int R,
                           int K, int nch, int units, float eps) {
  using C = LnFwd<D>;
  constexpr int CH = C::CH, S = kLfStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* xs = align1024(smem_raw);
  unsigned char* ring = xs + C::XS_BYTES;
  unsigned char* stg = ring + S * C::PIECE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + C::STG_BYTES);
  uint64_t* empty = full + S;
  uint64_t* xfull = empty + S;
  uint64_t* xfree = xfull + CH;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this CTA's units [u0, u1): (row tile u / nch, column chunk u % nch)
  const int u0 = (int)((long long)blockIdx.x * units / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);
  if (tid == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);  // every consumer warp
    }
    for (int p = 0; p < CH; ++p) {
      mbar_init(&xfull[p], 1);
      mbar_init(&xfree[p], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one lane streams W, another x
    setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
      int c = u0 % nch, it = 0;
      for (int u = u0; u < u1; ++u) {
#pragma unroll 1
        for (int p = 0; p < CH; ++p, ++it) {
          const int st = it % S;
          mbar_wait(&empty[st], ((it / S) & 1) ^ 1);
          mbar_expect_tx(&full[st], C::PIECE_BYTES);
          tma_load_2d(ring + st * C::PIECE_BYTES, &w_map, &full[st], 64 * p, c * kLfN);
        }
        if (++c == nch) c = 0;
      }
    } else if (warp == 9 && lane == 0) {
      int c = u0 % nch, tile = u0 / nch, i = 0;
      for (int u = u0; u < u1; ++u) {
        if (u == u0 || c == 0) {  // a row tile's first unit here: its x, piece by piece
#pragma unroll 1
          for (int p = 0; p < CH; ++p) {
            if (i > 0) mbar_wait(&xfree[p], (i - 1) & 1);
            mbar_expect_tx(&xfull[p], kLfRows * 128);
            tma_load_2d(xs + p * kLfRows * 128, &x_map, &xfull[p], 64 * p, tile * kLfRows);
          }
          ++i;
        }
        if (++c == nch) {
          c = 0;
          ++tile;
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  // consumer warpgroup wg: rows 64 wg .. of the tile; warp wl of it
  // normalizes rows 16 wl .. 16 wl + 15 and holds accumulator rows 16 wl + g
  // (+ 8): [4i + e] at column 8i + 2 t4 + (e & 1) of the unit's 192
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  constexpr int CPT = D / 32;
  float sv[CPT], bv[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    sv[c] = s[lane + 32 * c];
    bv[c] = bn[lane + 32 * c];
  }
  unsigned char* wst = stg + warp * 4096;
  const uint64_t a_desc = desc_k128(xs + wg * 64 * 128);
  int c = u0 % nch, tile = u0 / nch, it = 0, ti = 0, sc = 0;
  for (int u = u0; u < u1; ++u) {
    const bool fresh = u == u0 || c == 0, last = u + 1 == u1 || c == nch - 1;
    const int rb = tile * kLfRows + 64 * wg;
    // a piece's stage freed, and in a tile's last unit its piece of xn too
    auto release = [&](int at, int p) {
      if (lane == 0) {
        mbar_arrive(&empty[at % S]);
        if (last) mbar_arrive(&xfree[p]);
      }
    };
    if (rb >= R) {  // no row of this warpgroup below R: only release
#pragma unroll 1
      for (int p = 0; p < CH; ++p, ++it) {
        mbar_wait(&full[it % S], (it / S) & 1);
        release(it, p);
      }
    } else {
      if (fresh) {
#pragma unroll 1
        for (int p = 0; p < CH; ++p) mbar_wait(&xfull[p], ti & 1);
        ln_rows_in_place<D>(xs, 64 * wg + 16 * wl, lane, sv, bv, eps);
        fence_proxy_async();  // xn's writes, seen by wgmma
        named_barrier(1 + wg, 128);
      }
      float acc[96];
#pragma unroll
      for (int i = 0; i < 96; ++i) acc[i] = 0.f;
#pragma unroll
      for (int p = 0; p < CH; ++p, ++it) {
        mbar_wait(&full[it % S], (it / S) & 1);
        const uint64_t b_desc = desc_k128(ring + (it % S) * C::PIECE_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // descriptors: a base plus byte offsets / 16
          wgmma_ss_m64n192k16<0, 0>(acc, a_desc + ((p * kLfRows * 128 + kk * 32) >> 4),
                                    b_desc + ((kk * 32) >> 4));
        wgmma_commit();
        wgmma_wait<1>();  // the piece before this one is done: free it
        if (p > 0) release(it - 1, p - 1);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(it - 1, CH - 1);

      // y = round(acc + b), 64 columns at a time through this warp's tiles
      const int wrow = rb + 16 * wl, col0 = c * kLfN;
#pragma unroll
      for (int j = 0; j < kLfN / 64; ++j, ++sc) {
        unsigned char* buf = wst + (sc & 1) * 2048;
        if (lane == 0) bulk_wait_read<1>();  // the store of two tiles ago has read buf
        __syncwarp();
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int i = 8 * j + q, col = col0 + 8 * i + 2 * t4;
          const float b0 = col < K ? b[col] : 0.f, b1 = col < K ? b[col + 1] : 0.f;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            *reinterpret_cast<uint32_t*>(buf + (g + 8 * e) * 128 + ((q ^ g) << 4) + 4 * t4) =
                pack_bf16(acc[4 * i + 2 * e] + b0, acc[4 * i + 2 * e + 1] + b1);
        }
        fence_proxy_async();  // the tile's writes, seen by the TMA store
        __syncwarp();
        if (lane == 0 && wrow < R && col0 + 64 * j < K) {
          tma_store_2d(&y_map, buf, col0 + 64 * j, wrow);
          bulk_commit();
        }
      }
    }
    if (fresh) ++ti;
    if (++c == nch) {
      c = 0;
      ++tile;
    }
  }
  if (lane == 0) bulk_wait_read<0>();  // the tiles read before shared memory is freed
}

// x (R, D), w (K, D), y (R, K) bf16, 16-byte aligned; s, bn (D), b (K) f32
template <int D>
int launch_ln_fwd_wgmma(const void* x, const float* s, const float* bn, const void* w,
                        const float* b, void* y, int R, int K, float eps, cudaStream_t stream) {
  const int tiles = (R + kLfRows - 1) / kLfRows, nch = (K + kLfN - 1) / kLfN;
  if ((long long)tiles * nch > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const uint64_t dx[2] = {(uint64_t)D, (uint64_t)R}, dw[2] = {(uint64_t)D, (uint64_t)K};
  const uint64_t sd[1] = {(uint64_t)D * 2};
  const uint64_t dy[2] = {(uint64_t)K, (uint64_t)R}, sk[1] = {(uint64_t)K * 2};
  const uint32_t box_x[2] = {64, kLfRows}, box_w[2] = {64, kLfN}, box_y[2] = {64, 16};
  CUtensorMap x_m, w_m, y_m;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!make_tmap_bf16(&x_m, x, 2, dx, sd, box_x, sw) ||
      !make_tmap_bf16(&w_m, w, 2, dw, sd, box_w, sw) ||
      !make_tmap_bf16(&y_m, y, 2, dy, sk, box_y, sw))
    return (int)cudaErrorInvalidValue;
  using C = LnFwd<D>;
  int sms = 0;
  const int rc = device_sms_for<&ln_linear_fwd_wgmma_kernel<D>>(C::SMEM, &sms);
  if (rc != 0) return rc;
  const int units = tiles * nch, grid = units < sms ? units : sms;
  ln_linear_fwd_wgmma_kernel<D><<<grid, kLfThreads, C::SMEM, stream>>>(x_m, w_m, y_m, s, bn, b, R,
                                                                     K, nch, units, eps);
  return (int)cudaGetLastError();
}

template int launch_ln_fwd_wgmma<384>(const void*, const float*, const float*, const void*,
                                      const float*, void*, int, int, float, cudaStream_t);
template int launch_ln_fwd_wgmma<192>(const void*, const float*, const float*, const void*,
                                      const float*, void*, int, int, float, cudaStream_t);

}  // namespace vitocm
