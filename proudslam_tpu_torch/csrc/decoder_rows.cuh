// Row-tile pieces of the bf16 decoder kernels K2 and K3 at the sizes other
// than (16, 128, 128), shared by the streamed plan (mlp_stream.cu), the
// wide plan (mlp_wide.cu) and the parked plan (mlp_park.cu): K2's staging
// of its next tile's inputs, and K3's bias-gradient column sums, which add
// each tile's terms into the block's f32 slab of small gradients
// (decoder_wgrad.cuh).
#pragma once

#include "decoder_stream.cuh"

namespace st {

// Thread (row, q) = (t / 4, t % 4) copies x[row, 16k + 4q : 16k + 4q + 4]
// (k < D / 16) of `tile` into the staging buffer, if the row exists.
__device__ __forceinline__ void stage_x(const float* __restrict__ x,
                                        long long N, long long tile,
                                        float* stage) {
  const int row = threadIdx.x >> 2, q = threadIdx.x & 3;
  const long long n = tile * tc::TR + row;
  if (n < N) {
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      tc::cp_async16(stage + row * D + 16 * k + 4 * q,
                     x + n * D + 16 * k + 4 * q);
  }
  tc::cp_async_commit();
}

__device__ __forceinline__ void put(float* p, float v, bool first) {
  *p = first ? v : *p + v;
}

// Column sums of acc (this warpgroup's columns from col0) over each warp's
// 16 rows, unrounded f32, into cs[warp of the warpgroup][column]
template <int NA>
__device__ __forceinline__ void col_sums(const float (&acc)[NA], float* cs,
                                         int col0) {
  const int l = threadIdx.x & 31, wq = (threadIdx.x % tc::WG) >> 5;
#pragma unroll
  for (int i = 0; i < NA / 4; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = acc[4 * i + e] + acc[4 * i + 2 + e];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (l < 4) cs[wq * W + col0 + 8 * i + 2 * l + e] = s;
    }
}

// dst[0:len] (+)= the four warps' column sums, added in a fixed order
__device__ __forceinline__ void fold(const float* cs, float* dst, int len,
                                     bool first) {
  const int c = threadIdx.x;
  if (c < len)
    put(dst + c, ((cs[c] + cs[W + c]) + cs[2 * W + c]) + cs[3 * W + c],
        first);
}

}  // namespace st
