// Row-tile pieces of the bf16 decoder kernels K2 and K3 at the sizes other
// than (16, 128, 128), shared by the streamed plan (mlp_stream.cu) and the
// wide plan (mlp_wide.cu): K2's staging of its next tile's inputs, and K3's
// bias-gradient column sums and weight-gradient products, which add each
// tile's terms into the block's f32 slab (decoder_slab.cuh).
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

// dst (M x N, row-major) += act^T cot over the tile's rows, act (TR, M) and
// cot (TR, N) tiles: pieces of 64 x 64 (64 x 32 at in_dim 64 up to width
// 256), alternating between the warpgroups. The slab's old values are loaded while the products run. (A
// piece of 64 x 128, as in mlp_kernel.cu, takes 128 registers a thread for
// its sums and old values: at width 256 the kernel then spills.)
template <int M, int N>
__device__ inline void wgrad(const bf16* act, const bf16* cot,
                             float* __restrict__ dst, bool first,
                             const Lane& ln) {
  // 64 x 32 in the streamed plan at in_dim 64 (decoder_stream.cuh)
  constexpr int NB = D > 32 && W <= 256 ? 32 : 64;
  constexpr int JOBS = (M / 64) * (N / NB);
  const int wg = threadIdx.x / tc::WG;
#pragma unroll 1
  for (int job = wg; job < JOBS; job += 2) {
    const int mb = job / (N / NB) * 64, nb = job % (N / NB) * NB;
    float acc[NB / 2];
    float2 old[NB / 4];
    const uint64_t da = tc::desc_mn(act + tc::tofs(0, mb, M), M);
    const uint64_t db = tc::desc_mn(cot + tc::tofs(0, nb, N), N);
    tc::fence_regs(acc);
    tc::wg_fence();
#pragma unroll
    for (int j = 0; j < tc::TR / 16; ++j)
      tc::mma_ss<NB, 1, 1>(acc, da + j * tc::kstep_mn(M),
                           db + j * tc::kstep_mn(N), j > 0);
    tc::wg_commit();
    // entries 2i, 2i + 1: row mb + r0 + 8 (i % 2), columns nb + 8 (i / 2)
    // + c2 + {0, 1}
    float2* o = reinterpret_cast<float2*>(dst + (mb + ln.r0) * N + nb + ln.c2);
#pragma unroll
    for (int i = 0; i < NB / 4; ++i)
      old[i] = first ? make_float2(0.f, 0.f) : o[(i & 1) * 4 * N + 4 * (i >> 1)];
    tc::wg_wait_all();
    tc::fence_regs(acc);
#pragma unroll
    for (int i = 0; i < NB / 4; ++i)
      o[(i & 1) * 4 * N + 4 * (i >> 1)] =
          make_float2(old[i].x + acc[2 * i], old[i].y + acc[2 * i + 1]);
  }
}

// The D-wide weight gradient dst (D, N) += x^T cot, computed transposed
// (cot[:, mb:mb+64]^T x: M = 64 of cot's columns, N = D) and stored
// transposed; the 64-column pieces alternate between the warpgroups.
template <int N>
__device__ inline void wgrad_x(const bf16* cot, const bf16* xs,
                               float* __restrict__ dst, bool first,
                               const Lane& ln) {
  const int wg = threadIdx.x / tc::WG;
  // the same: x's columns 32 at a time (and in the wide plan at in_dim
  // 128, where whole they would take 128 registers a thread)
  if constexpr ((D > 32 && W <= 256) || D > 64) {
#pragma unroll 1
    for (int mb = 64 * wg; mb < N; mb += 128)
#pragma unroll 1
      for (int k0 = 0; k0 < D; k0 += 32) {
        float acc[16], old[16];
        const uint64_t da = tc::desc_mn(cot + tc::tofs(0, mb, N), N);
        const uint64_t db = tc::desc_mn(xs + tc::tofs(0, k0, D), D);
        tc::fence_regs(acc);
        tc::wg_fence();
#pragma unroll
        for (int j = 0; j < tc::TR / 16; ++j)
          tc::mma_ss<32, 1, 1>(acc, da + j * tc::kstep_mn(N),
                               db + j * tc::kstep_mn(D), j > 0);
        tc::wg_commit();
        float* o = dst + (k0 + ln.c2) * N + mb + ln.r0;
#pragma unroll
        for (int i = 0; i < 16; ++i)
          old[i] = first ? 0.f
                         : o[(8 * (i >> 2) + (i & 1)) * N + 8 * ((i >> 1) & 1)];
        tc::wg_wait_all();
        tc::fence_regs(acc);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          o[(8 * (i >> 2) + (i & 1)) * N + 8 * ((i >> 1) & 1)] = old[i] + acc[i];
      }
    return;
  }
#pragma unroll 1
  for (int mb = 64 * wg; mb < N; mb += 128) {
    float acc[D / 2], old[D / 2];
    const uint64_t da = tc::desc_mn(cot + tc::tofs(0, mb, N), N);
    const uint64_t db = tc::desc_mn(xs, D);
    tc::fence_regs(acc);
    tc::wg_fence();
#pragma unroll
    for (int j = 0; j < tc::TR / 16; ++j)
      tc::mma_ss<D, 1, 1>(acc, da + j * tc::kstep_mn(N),
                          db + j * tc::kstep_mn(D), j > 0);
    tc::wg_commit();
    // entry 4i + e: column m = mb + r0 + 8 (e / 2) of cot, row k = 8i + c2
    // + e % 2 of x
    float* o = dst + ln.c2 * N + mb + ln.r0;
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      old[i] = first ? 0.f : o[(8 * (i >> 2) + (i & 1)) * N + 8 * ((i >> 1) & 1)];
    tc::wg_wait_all();
    tc::fence_regs(acc);
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      o[(8 * (i >> 2) + (i & 1)) * N + 8 * ((i >> 1) & 1)] = old[i] + acc[i];
  }
}

}  // namespace st
