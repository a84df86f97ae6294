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
// far above the card's balance point, so nothing but the features and the
// four outputs reaches device memory, and the products run on the tensor
// cores (`wgmma`, decoder_tc.cuh). Design:
//   - a block of two warpgroups; each warpgroup walks its own 64-sample
//     tiles (one tile is one wgmma M of 64 rows), with the weights (~109 KB
//     as bf16) shared in shared memory for the block's life;
//   - each tile runs the register-chained decoder of decoder_chain.cuh
//     (`tc::decode`, which K2 runs too): the layers chain through
//     registers, only the blended input x goes through shared memory, and
//     the sdf column and the 3-wide color head run on the FMA units;
//   - the gather of the next tile overlaps this tile's products: each
//     sample's own slot (8 x 16 f32, selected by bins, so TMA does not fit)
//     is copied with 16-byte cp.async into the warpgroup's buffer right
//     after this tile's blend, and read at the next tile's blend.
// The blend keeps the exact f32 arithmetic (__fmul_rn/__fadd_rn, the same
// order) of the plain version, so `feats` matches it to rounding.

#include "decoder_chain.cuh"

namespace {

using tc::bf16;
using dec::D;

// the resident plan; every other size builds the streamed sources
// (render_stream.cu, mlp_stream.cu)
static_assert(D == 16 && dec::W == 128 && dec::SD == 128,
              "this plan holds the (16, 128, 128) decoder's weights");

constexpr int THREADS = 2 * tc::WG;          // two warpgroups, own tiles each
constexpr int KS = 8 * D;                    // corner values of a hit slot
constexpr int GROW = KS * 4 + 16;            // gather-buffer row, bytes (padded)
constexpr int GBUF = tc::TR * GROW;
constexpr int XTILE = tc::TR * D;            // bf16 input tile (TR, D)
constexpr int SMEM = tc::TC_WEIGHT_SMEM
                     + 2 * (dec::pad16(GBUF) + dec::pad16(XTILE * 2));

struct Inputs {
  const float *rb, *z, *rays_o, *rays_d;
  const int *keys, *bins;
  float *out, *feats;
  long long N;
  int H, S;
  float voxel;
};

// What one thread needs to blend its (row, half) of a tile, loaded when
// its copies are issued.
struct Sample {
  bool slot;          // the sample has a hit slot
  float z, o[3], d[3];
  int key;
};

// Gather of a tile: thread (row = t % 64, half = t / 64) loads its sample's
// scalars and issues the cp.async copies of dims [8 half, 8 half + 8) of
// the slot's 8 corners into the warpgroup's buffer.
__device__ inline void issue(const Inputs& in, long long tile, int row,
                             int half, char* gbuf, Sample& s) {
  const long long n = tile * tc::TR + row;
  s.slot = false;
  if (n < in.N) {
    const int h = in.bins[n];
    if (h >= 0 && h < in.H) {
      const long long ray = n / in.S;
      s.slot = true;
      s.z = in.z[n];
      s.key = in.keys[ray * in.H + h];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s.o[k] = in.rays_o[ray * 3 + k];
        s.d[k] = in.rays_d[ray * 3 + k];
      }
      const float* src = in.rb + (ray * in.H + h) * KS + 8 * half;
      char* dst = gbuf + row * GROW + 32 * half;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        tc::cp_async16(dst + 64 * j, src + j * D);
        tc::cp_async16(dst + 64 * j + 16, src + j * D + 4);
      }
    }
  }
  tc::cp_async_commit();
}

// The trilinear blend of this thread's 8 features: written to feats (f32)
// and, rounded to bf16, to the tile's input x.
__device__ inline void blend(const Inputs& in, long long tile, int row,
                             int half, const char* gbuf, const Sample& s,
                             bf16* xs) {
  const long long n = tile * tc::TR + row;
  float f[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = 0.f;
  if (s.slot) {
    const float cx = static_cast<float>(((s.key >> 20) & 1023) - 512);
    const float cy = static_cast<float>(((s.key >> 10) & 1023) - 512);
    const float cz = static_cast<float>((s.key & 1023) - 512);
    const float px = __fdiv_rn(__fadd_rn(s.o[0], __fmul_rn(s.d[0], s.z)),
                               in.voxel) - cx;
    const float py = __fdiv_rn(__fadd_rn(s.o[1], __fmul_rn(s.d[1], s.z)),
                               in.voxel) - cy;
    const float pz = __fdiv_rn(__fadd_rn(s.o[2], __fmul_rn(s.d[2], s.z)),
                               in.voxel) - cz;
    const float* src = reinterpret_cast<const float*>(gbuf + row * GROW) + 8 * half;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float wx = (j & 4) ? px : 1.f - px;
      const float wy = (j & 2) ? py : 1.f - py;
      const float wz = (j & 1) ? pz : 1.f - pz;
      const float wj = __fmul_rn(__fmul_rn(wx, wy), wz);
      const float4 e0 = *reinterpret_cast<const float4*>(src + j * D);
      const float4 e1 = *reinterpret_cast<const float4*>(src + j * D + 4);
      f[0] = __fadd_rn(f[0], __fmul_rn(wj, e0.x));
      f[1] = __fadd_rn(f[1], __fmul_rn(wj, e0.y));
      f[2] = __fadd_rn(f[2], __fmul_rn(wj, e0.z));
      f[3] = __fadd_rn(f[3], __fmul_rn(wj, e0.w));
      f[4] = __fadd_rn(f[4], __fmul_rn(wj, e1.x));
      f[5] = __fadd_rn(f[5], __fmul_rn(wj, e1.y));
      f[6] = __fadd_rn(f[6], __fmul_rn(wj, e1.z));
      f[7] = __fadd_rn(f[7], __fmul_rn(wj, e1.w));
    }
  }
  if (n < in.N) {
    float4* o = reinterpret_cast<float4*>(in.feats + n * D + 8 * half);
    o[0] = make_float4(f[0], f[1], f[2], f[3]);
    o[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  tc::put_x(xs, row, half, f);
}

__global__ void __launch_bounds__(THREADS, 1)
render_forward_kernel(Inputs in, dec::Params prm) {
  extern __shared__ __align__(16) char smem[];
  dec::Arena arena{smem};
  tc::TcWeights w;
  tc::carve_weights(arena, w);
  char* gbuf = arena.take<char>(2 * dec::pad16(GBUF));
  bf16* xbuf = arena.take<bf16>(2 * XTILE);
  tc::load_weights(w, prm);

  const int wg = threadIdx.x / tc::WG, t = threadIdx.x % tc::WG;
  const int row = t % tc::TR, half = t / tc::TR;
  char* gb = gbuf + wg * dec::pad16(GBUF);
  bf16* xs = xbuf + wg * XTILE;
  const long long ntiles = (in.N + tc::TR - 1) / tc::TR;
  const long long stride = 2LL * gridDim.x;
  Sample s;
  long long tile = 2LL * blockIdx.x + wg;
  if (tile < ntiles) issue(in, tile, row, half, gb, s);
  for (; tile < ntiles; tile += stride) {
    tc::cp_async_wait_all();
    tc::wg_barrier(wg);               // this tile's copies are visible
    blend(in, tile, row, half, gb, s, xs);
    tc::fence_proxy_async();
    tc::wg_barrier(wg);               // x is in place; the buffer is free
    if (tile + stride < ntiles) issue(in, tile + stride, row, half, gb, s);
    tc::decode(w, xs, in.out, in.N, tile, t);
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
  cudaError_t err = cudaFuncSetAttribute(
      render_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  Inputs in{rb, z, rays_o, rays_d, keys, bins, out, feats,
            static_cast<long long>(R) * S, H, S, voxel};
  render_forward_kernel<<<grid, THREADS, SMEM, stream>>>(
      in, dec::params_from(params));
  return static_cast<int>(cudaGetLastError());
}
