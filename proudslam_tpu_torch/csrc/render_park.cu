// Fused per-sample feature blend + decoder forward (kernel K1) at the decoder
// widths 768 and 1024: the parked plan (decoder_park.cuh).
//
// Replaces the TPU kernel `_kernel` of
// proudslam_tpu/ops/pallas/render_kernel.py (`fused_render_forward`), which
// takes any decoder size; render_wide.cu is the same function at widths 384
// and 512. The function is render_wide.cu's: per sample (r, s) pick its hit
// slot h = bins[r, s] (h == H: invalid, zero features), form p = (o +
// d*z)/voxel - corner with the corner unpacked from the slot's packed voxel
// key, blend the slot's 8 corner embeddings trilinearly into D features
// (16 to 128) in the plain version's exact f32 order, then run the decoder
// with bf16 operands and f32 sums. Outputs: out (R*S, 4) [r, g, b, sdf] and
// feats (R*S, D).
//
// What bounds it on an H100: arithmetic, ~2 * 3.2M flops per sample at
// (16, 1024, 1024) against 64 B of feature reads and 80 B of writes.
// Design: render_wide.cu's blocks, gather and blend (the corners of the
// next tile in registers at in_dim 16 and 32, in passes through a buffer
// above), with decoder_park.cuh's `decode`: one (64, W) activation tile in
// shared memory, h2 and feat parked in global memory. At in_dim 128 and
// width 1024 no buffer of 32 dims a corner (66,560 bytes) fits beside the
// 182,288 bytes of the rest, so there the buffer is the tile, free between
// one tile's decoder and the next: a quarter of each corner, four passes a
// tile, the first one's gather exposed too; at width 768 a separate buffer
// of a quarter of each corner (216,080 bytes in all).

#include "decoder_park.cuh"
#include "render_gather.cuh"

namespace {

using dec::D;
using dec::W;
using st::bf16;

constexpr int OTHER = wd::RING_SMEM + dec::pad16(tc::TR * W * 2)
                      + dec::pad16(tc::TR * D * 2) + wd::PART_SMEM;
#if DEC_D <= 32
constexpr int SMEM = OTHER;
#else
// at in_dim 128 and width 1024 no buffer of 32 dims a corner fits beside
// the rest: the buffer is then the activation tile t
constexpr bool IN_TILES = OTHER + kg::buffer_bytes(D / 4) > 232448;
constexpr int G = IN_TILES ? kg::dims_within(tc::TR * W * 2)
                           : kg::gather_dims(OTHER);   // a corner's dims
constexpr int SMEM = OTHER + (IN_TILES ? 0 : kg::buffer_bytes(G));
static_assert(G % 16 == 0, "a pass holds whole 16-dim pieces");
#endif
static_assert(SMEM <= 232448, "one block's shared memory");

#if DEC_D <= 32

constexpr int KS = 8 * D;                    // corner values of a hit slot

struct Inputs {
  const float *rb, *z, *rays_o, *rays_d;
  const int *keys, *bins;
  float *out, *feats;
  long long N;
  int H, S;
  float voxel;
};

// a sample's scalars and this thread's dims of its 8 corners
struct Sample {
  bool slot;          // the sample has a hit slot
  float z, o[3], d[3];
  int key;
  float4 e[8][D / 16];
};

// Gather of a tile: thread (row, q) loads its sample's scalars and dims
// [16k + 4q, 16k + 4q + 4) (k < D / 16) of the slot's 8 corners; corner j's
// D floats start at float D j of the slot's row.
__device__ inline void gather(const Inputs& in, long long tile, int row, int q,
                              Sample& s) {
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
      const float* src = in.rb + (ray * in.H + h) * KS + 4 * q;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          s.e[j][k] = __ldg(reinterpret_cast<const float4*>(src + j * D + 16 * k));
    }
  }
}

// The trilinear blend of this thread's D / 4 features (render_stream.cu's
// arithmetic): to feats (f32) and, rounded to bf16, to the tile's input x.
__device__ inline void blend(const Inputs& in, long long tile, int row, int q,
                             const Sample& s, bf16* xs) {
  const long long n = tile * tc::TR + row;
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    const int c = 16 * k + 4 * q;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
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
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float wx = (j & 4) ? px : 1.f - px;
        const float wy = (j & 2) ? py : 1.f - py;
        const float wz = (j & 1) ? pz : 1.f - pz;
        const float wj = __fmul_rn(__fmul_rn(wx, wy), wz);
        const float4 e = s.e[j][k];
        f[0] = __fadd_rn(f[0], __fmul_rn(wj, e.x));
        f[1] = __fadd_rn(f[1], __fmul_rn(wj, e.y));
        f[2] = __fadd_rn(f[2], __fmul_rn(wj, e.z));
        f[3] = __fadd_rn(f[3], __fmul_rn(wj, e.w));
      }
    }
    if (n < in.N)
      *reinterpret_cast<float4*>(in.feats + n * D + c) =
          make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<uint2*>(xs + tc::tofs(row, c, D)) =
        make_uint2(tc::pack_bf16x2(f[0], f[1]), tc::pack_bf16x2(f[2], f[3]));
  }
}

__global__ void __launch_bounds__(wd::THREADS, 1)
render_forward_kernel(Inputs in, bf16* wpack) {
  extern __shared__ __align__(16) char smem[];
  dec::Arena arena{smem};
  wd::Ring ring = wd::ring_init(arena, wpack, wd::NFWD);
  bf16* t = arena.take<bf16>(tc::TR * W);
  bf16* xs = arena.take<bf16>(tc::TR * D);
  float* part = arena.take<float>(2 * tc::TR * 4);
  const wd::Vecs w = pk::vecs_at(wpack);
  bf16* park = wpack + pk::PARK_OFF
               + static_cast<long long>(blockIdx.x) * pk::NPARK * pk::TILE;
  __syncthreads();                          // the ring's mbarriers

  const int row = threadIdx.x % tc::TR, q = threadIdx.x / tc::TR;
  const long long ntiles = (in.N + tc::TR - 1) / tc::TR;
  long long tile = blockIdx.x;
  Sample s;
  if (tile < ntiles) {
    wd::ring_start(ring);
    gather(in, tile, row, q, s);
  }
  for (; tile < ntiles; tile += gridDim.x) {
    const bool more = tile + gridDim.x < ntiles;
    // x's last readers, the previous tile's products, are done at the
    // barrier that ends its decode
    blend(in, tile, row, q, s, xs);
    tc::fence_proxy_async();
    __syncthreads();                  // x is in place
    if (more) gather(in, tile + gridDim.x, row, q, s);
    pk::decode(w, xs, t, park, part, ring, more, in.out, in.N, tile);
  }
}

#else   // in_dim 64 and 128: the gather in passes

using kg::Inputs;

__global__ void __launch_bounds__(wd::THREADS, 1)
render_forward_kernel(Inputs in, bf16* wpack) {
  extern __shared__ __align__(16) char smem[];
  dec::Arena arena{smem};
  wd::Ring ring = wd::ring_init(arena, wpack, wd::NFWD);
  bf16* t = arena.take<bf16>(tc::TR * W);
  bf16* xs = arena.take<bf16>(tc::TR * D);
  float* part = arena.take<float>(2 * tc::TR * 4);
  char* gbuf = IN_TILES ? reinterpret_cast<char*>(t)
                        : arena.take<char>(kg::buffer_bytes(G));
  const wd::Vecs w = pk::vecs_at(wpack);
  bf16* park = wpack + pk::PARK_OFF
               + static_cast<long long>(blockIdx.x) * pk::NPARK * pk::TILE;
  __syncthreads();                          // the ring's mbarriers

  const int row = threadIdx.x % tc::TR, q = threadIdx.x / tc::TR;
  const long long ntiles = (in.N + tc::TR - 1) / tc::TR;
  long long tile = blockIdx.x;
  kg::Sample s;
  if (tile < ntiles) {
    wd::ring_start(ring);
    if constexpr (!IN_TILES) {
      kg::locate(in, tile, row, q, s);
      kg::issue<G>(s, row, q, 0, gbuf);
    }
  }
  for (; tile < ntiles; tile += gridDim.x) {
    const bool more = tile + gridDim.x < ntiles;
    if constexpr (IN_TILES) {
      // the tile's last readers, the previous tile's products, are done at
      // the barrier that ends its decode
      kg::locate(in, tile, row, q, s);
      kg::issue<G>(s, row, q, 0, gbuf);
    }
    // x's last readers, the previous tile's products, are done at the
    // barrier that ends its decode
    kg::blend_tile<G>(in, tile, row, q, gbuf, s, xs);
    if (!IN_TILES && more) {
      kg::locate(in, tile + gridDim.x, row, q, s);
      kg::issue<G>(s, row, q, 0, gbuf);
    }
    pk::decode(w, xs, t, park, part, ring, more, in.out, in.N, tile);
  }
}

#endif

}  // namespace

// Returns cudaGetLastError() after the launches (0 = launched). wpack: the
// scratch of mlp_kernel.packed_weights (the packed weights, the f32 vectors
// and the parks, decoder_park.cuh); `grid` <= the SMs.
extern "C" int fused_render_forward(const float* rb, const int* keys,
                                    const int* bins, const float* z,
                                    const float* rays_o, const float* rays_d,
                                    const void* const* params, void* wpack,
                                    float* out, float* feats, int R, int H,
                                    int S, float voxel, int grid,
                                    cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      render_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = pk::pack(dec::params_from(params), static_cast<bf16*>(wpack), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  Inputs in{rb, z, rays_o, rays_d, keys, bins, out, feats,
            static_cast<long long>(R) * S, H, S, voxel};
  render_forward_kernel<<<grid, wd::THREADS, SMEM, stream>>>(
      in, static_cast<bf16*>(wpack));
  return static_cast<int>(cudaGetLastError());
}
