// Shared contract of the attention forward kernels (attention_qkv.cu, f32
// on the CUDA cores; attention_qkv_wgmma.cu, bf16 on wgmma): where
// head hh of batch element b reads its q, k, v rows and writes its output
// rows, in one of two layouts, fixed at compile time:
//   * FOLDED = false: the fused qkv projection (B, N, 3*nh*D) of the
//     inference path; q, k, v are its three sections, rows 3*nh*D apart, and
//     out is (B, N, nh*D), heads side by side;
//   * FOLDED = true: the folded (B*h, N, D) q, k, v and out of the training
//     path (nh = 1), rows D apart.
// Keys at rows >= n are masked. The folded layout also writes the f32
// logsumexp of each query row to lse[(b*nh + hh)*N + row].
#pragma once

namespace vitocm {

template <typename T, int D, bool FOLDED>
struct AttnRows {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  long long rs;  // row stride of q, k, v (elements)
  long long os;  // row stride of out

  __device__ __forceinline__ AttnRows(const T* q_, const T* k_, const T* v_, T* out_, int N,
                                      int nh, int b, int hh) {
    const long long dm = (long long)nh * D;
    rs = FOLDED ? D : 3 * dm;
    os = FOLDED ? D : dm;
    q = q_ + b * N * rs + (FOLDED ? 0 : hh * D);
    k = FOLDED ? k_ + b * N * rs : q + dm;
    v = FOLDED ? v_ + b * N * rs : q + 2 * dm;
    out = out_ + b * N * os + (FOLDED ? 0 : hh * D);
  }
};

}  // namespace vitocm
