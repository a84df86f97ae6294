// Fused per-sample feature blend + decoder forward (kernel K1 of the port).
//
// Replaces the TPU kernel `_kernel` of
// proudslam_tpu/ops/pallas/render_kernel.py (`fused_render_forward`): for
// every sample (r, s) pick its hit slot h = bins[r, s] (h == H: invalid,
// zero features), form p = (o + d*z)/voxel - corner with the corner
// unpacked from the slot's 10-bit packed voxel key, blend the slot's 8
// corner embeddings trilinearly into D = 16 features, then run the decoder
// (16 -> 128 -> 128 -> 128+1 -> 128 -> 3) with bf16 operands and f32
// accumulation. Outputs: out (R*S, 4) [r, g, b, sdf] and feats (R*S, D).
//
// What bounds it on an H100: arithmetic. Per sample the decoder does
// ~2 * 54k = 108k flops against ~64 B of feature reads and 80 B of writes,
// far above the card's balance point, so the kernel's job is to keep every
// activation on chip: the weights (~107 KB as bf16) and one 64-row tile of
// activations stay in shared memory, and nothing but the features and the
// four outputs ever reaches device memory. The TPU kernel looped over all H
// slots with masks (its vector unit wants dense work); here each sample
// reads only its own slot's 8 x 16 corner values. This first version runs
// the products on the FMA units (not the tensor cores), with an 8x4 block
// of sums per thread; wgmma/TMA are for later work.
//
// Grid: persistent, one block per SM (the ~180 KB of shared memory allows
// one), each block walking tiles of TR = 64 sample rows; the weights are
// loaded once per block.

#include "decoder_tile.cuh"

using namespace dec;

namespace {

__global__ void __launch_bounds__(THREADS, 1)
render_forward_kernel(const float* __restrict__ rb,
                      const int* __restrict__ keys,
                      const int* __restrict__ bins,
                      const float* __restrict__ z,
                      const float* __restrict__ rays_o,
                      const float* __restrict__ rays_d, Params prm,
                      float* __restrict__ out, float* __restrict__ feats,
                      int R, int H, int S, float voxel) {
  extern __shared__ __align__(16) char smem[];
  Arena arena{smem};
  Weights w;
  Acts t;
  carve_weights(arena, w);
  carve_acts(arena, t);
  load_weights(w, prm);

  const long long N = static_cast<long long>(R) * S;
  const long long ntiles = (N + TR - 1) / TR;
  const int K8 = 8 * D;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = tile * TR;
    // ---- features: thread (r, quarter) = (tid / 4, tid % 4) -> 4 dims
    {
      const int r = threadIdx.x >> 2, qd = threadIdx.x & 3;
      const long long n = row0 + r;
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (n < N) {
        const long long ray = n / S;
        const int h = bins[n];
        if (h >= 0 && h < H) {
          const float zz = z[n];
          const int key = keys[ray * H + h];
          const float cx = static_cast<float>(((key >> 20) & 1023) - 512);
          const float cy = static_cast<float>(((key >> 10) & 1023) - 512);
          const float cz = static_cast<float>((key & 1023) - 512);
          const float px = __fdiv_rn(__fadd_rn(rays_o[ray * 3 + 0],
                                               __fmul_rn(rays_d[ray * 3 + 0], zz)),
                                     voxel) - cx;
          const float py = __fdiv_rn(__fadd_rn(rays_o[ray * 3 + 1],
                                               __fmul_rn(rays_d[ray * 3 + 1], zz)),
                                     voxel) - cy;
          const float pz = __fdiv_rn(__fadd_rn(rays_o[ray * 3 + 2],
                                               __fmul_rn(rays_d[ray * 3 + 2], zz)),
                                     voxel) - cz;
          const float* src = rb + (ray * H + h) * K8 + qd * 4;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float wx = (j & 4) ? px : 1.f - px;
            const float wy = (j & 2) ? py : 1.f - py;
            const float wz = (j & 1) ? pz : 1.f - pz;
            const float wj = __fmul_rn(__fmul_rn(wx, wy), wz);
            const float4 e = *reinterpret_cast<const float4*>(src + j * D);
            f[0] = __fadd_rn(f[0], __fmul_rn(wj, e.x));
            f[1] = __fadd_rn(f[1], __fmul_rn(wj, e.y));
            f[2] = __fadd_rn(f[2], __fmul_rn(wj, e.z));
            f[3] = __fadd_rn(f[3], __fmul_rn(wj, e.w));
          }
        }
        *reinterpret_cast<float4*>(feats + n * D + qd * 4) =
            make_float4(f[0], f[1], f[2], f[3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        t.x[r * D + qd * 4 + i] = __float2bfloat16_rn(f[i]);
    }
    forward_tile(w, t);
    {
      const int r = threadIdx.x >> 2, c = threadIdx.x & 3;
      if (row0 + r < N) out[(row0 + r) * 4 + c] = t.out[r * 4 + c];
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_render_forward(const float* rb, const int* keys,
                                    const int* bins, const float* z,
                                    const float* rays_o, const float* rays_d,
                                    const void* const* params, float* out,
                                    float* feats, int R, int H, int S,
                                    float voxel, int grid,
                                    cudaStream_t stream) {
  const int smem = WEIGHT_SMEM + ACT_SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      render_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  render_forward_kernel<<<grid, THREADS, smem, stream>>>(
      rb, keys, bins, z, rays_o, rays_d, params_from(params), out, feats, R,
      H, S, voxel);
  return static_cast<int>(cudaGetLastError());
}
