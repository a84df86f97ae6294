// The decoder forward that K1 (render_kernel.cu) and K2 (mlp_kernel.cu)
// both run, one 64-row tile per warpgroup, on the tensor cores: the layers
// chain through registers (each m64n128 accumulator, plus bias and
// activation, is rounded to bf16 and becomes the A operand of the next
// layer's wgmma), so h1, h2, feat and hc never touch shared memory. Only
// the input x goes through shared memory: it is the A operand of the first
// product and of the color head's x part. The odd widths run on the FMA
// units: the sdf column (h2 . ws[:, W]) and the 3-wide color head, as
// per-thread partial dots summed over the four lanes that share a row.
//
// Both kernels round x to bf16 with `pack_bf16x2` (round to nearest even)
// into the tile layout of decoder_tc.cuh, so K2 run on K1's f32 features
// gives K1's outputs bit for bit. Also here: the 16-byte cp.async copies
// with which both kernels stage their next tile's input while this tile's
// products run.
#pragma once

#include "decoder_tc.cuh"

namespace tc {

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Thread (row, half) of a warpgroup writes its 8 inputs f[0..7], the row's
// columns [8 half, 8 half + 8), rounded to bf16, into the tile x.
__device__ __forceinline__ void put_x(bf16* xs, int row, int half,
                                      const float (&f)[8]) {
  uint4 v;
  v.x = pack_bf16x2(f[0], f[1]);
  v.y = pack_bf16x2(f[2], f[3]);
  v.z = pack_bf16x2(f[4], f[5]);
  v.w = pack_bf16x2(f[6], f[7]);
  *reinterpret_cast<uint4*>(xs + tofs(row, 8 * half, D)) = v;
}

// acc + bias (ReLU if asked), rounded to bf16: the A operand of the next
// layer (entries 8j..8j+7 of the accumulator are k-step j's fragment).
// Also returns the rounded values in `acc` for the FMA heads.
__device__ __forceinline__ void to_frags(float (&acc)[64], const float* bias,
                                         bool relu, uint32_t (&af)[8][4]) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * i + 2 * c);
    float v[4] = {acc[4 * i] + b.x, acc[4 * i + 1] + b.y,
                  acc[4 * i + 2] + b.x, acc[4 * i + 3] + b.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (relu) v[e] = fmaxf(v[e], 0.f);
      acc[4 * i + e] = rbf(v[e]);
    }
    af[i >> 1][2 * (i & 1)] = pack_bf16x2(v[0], v[1]);
    af[i >> 1][2 * (i & 1) + 1] = pack_bf16x2(v[2], v[3]);
  }
}

// sum over the four lanes that hold one row's columns
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// The decoder of one tile whose input x (bf16, tile layout) is in place;
// thread t of the warpgroup writes out[tile rows] = [sigmoid(hc wo + bo),
// sdf] for its rows below N.
__device__ inline void decode(const TcWeights& w, const bf16* xs,
                              float* __restrict__ out, long long N,
                              long long tile, int t) {
  const int l = t & 31, c = l & 3;
  const int r0 = 16 * (t >> 5) + (l >> 2);
  float acc[64];
  uint32_t af[8][4];
  const uint64_t dx = desc_k(xs, D);

  // h1 = relu(x w1 + b1)
  fence_regs(acc);
  wg_fence();
  mma_m64n128<0, 0>(acc, dx, desc_k(w.w1, D), 0);
  wg_commit();
  wg_wait_all();
  fence_regs(acc);
  to_frags(acc, w.b1, true, af);

  // h2 = relu(h1 w2 + b2); sdf = h2 . ws[:, W] + bs[W]
  wg_fence();
  const uint64_t dw2 = desc_k(w.w2, W);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    mma_m64n128_rs<0>(acc, af[j], dw2 + j * KSTEP_K, j > 0);
  wg_commit();
  wg_wait_all();
  fence_regs(acc);
  fence_regs(af);
  to_frags(acc, w.b2, true, af);
  float sdf0 = 0.f, sdf1 = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float2 ws = *reinterpret_cast<const float2*>(w.ws_sdf + 8 * i + 2 * c);
    sdf0 = fmaf(acc[4 * i], ws.x, fmaf(acc[4 * i + 1], ws.y, sdf0));
    sdf1 = fmaf(acc[4 * i + 2], ws.x, fmaf(acc[4 * i + 3], ws.y, sdf1));
  }
  sdf0 = quad_sum(sdf0) + w.bs[W];
  sdf1 = quad_sum(sdf1) + w.bs[W];

  // feat = h2 ws[:, :W] + bs[:W]
  wg_fence();
  const uint64_t dws = desc_k(w.ws, W);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    mma_m64n128_rs<0>(acc, af[j], dws + j * KSTEP_K, j > 0);
  wg_commit();
  wg_wait_all();
  fence_regs(acc);
  fence_regs(af);
  to_frags(acc, w.bs, false, af);

  // hc = relu(feat wc_f + x wc_x + bc); rgb = sigmoid(hc wo + bo)
  wg_fence();
  const uint64_t dwc = desc_k(w.wc_f, W);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    mma_m64n128_rs<0>(acc, af[j], dwc + j * KSTEP_K, j > 0);
  mma_m64n128<0, 0>(acc, dx, desc_k(w.wc_x, D), 1);
  wg_commit();
  wg_wait_all();
  fence_regs(acc);
  fence_regs(af);
  to_frags(acc, w.bc, true, af);
  float p0[3] = {0.f, 0.f, 0.f}, p1[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float4 wo = *reinterpret_cast<const float4*>(w.wo + 4 * (8 * i + 2 * c + e));
      p0[0] = fmaf(acc[4 * i + e], wo.x, p0[0]);
      p0[1] = fmaf(acc[4 * i + e], wo.y, p0[1]);
      p0[2] = fmaf(acc[4 * i + e], wo.z, p0[2]);
      p1[0] = fmaf(acc[4 * i + 2 + e], wo.x, p1[0]);
      p1[1] = fmaf(acc[4 * i + 2 + e], wo.y, p1[1]);
      p1[2] = fmaf(acc[4 * i + 2 + e], wo.z, p1[2]);
    }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p0[k] = 1.f / (1.f + expf(-(quad_sum(p0[k]) + w.bo[k])));
    p1[k] = 1.f / (1.f + expf(-(quad_sum(p1[k]) + w.bo[k])));
  }
  if (c == 0) {
    const long long n0 = tile * TR + r0, n1 = n0 + 8;
    if (n0 < N)
      *reinterpret_cast<float4*>(out + n0 * 4) =
          make_float4(p0[0], p0[1], p0[2], sdf0);
    if (n1 < N)
      *reinterpret_cast<float4*>(out + n1 * 4) =
          make_float4(p1[0], p1[1], p1[2], sdf1);
  }
}

}  // namespace tc
