// Fused per-sample feature blend + decoder forward (kernel K1) at every
// decoder size other than (16, 128, 128): the streamed plan.
//
// Replaces the TPU kernel `_kernel` of
// proudslam_tpu/ops/pallas/render_kernel.py (`fused_render_forward`), which
// takes any decoder size; render_kernel.cu is the same function at
// (16, 128, 128), where the weights fit in shared memory. Per sample (r, s):
// pick its hit slot h = bins[r, s] (h == H: invalid, zero features), form
// p = (o + d*z)/voxel - corner with the corner unpacked from the slot's
// 10-bit packed voxel key, blend the slot's 8 corner embeddings trilinearly
// into D = 16 or 32 features, then run the decoder (D -> W -> W -> SD+1 ->
// W -> 3) with bf16 operands and f32 sums. Outputs: out (R*S, 4) [r, g, b,
// sdf] and feats (R*S, D).
//
// What bounds it on an H100: arithmetic, ~2 * 140k flops per sample at
// (16, 256, 128) against 64 B of feature reads and 80 B of writes. Design
// (decoder_stream.cuh): persistent blocks of two warpgroups, one 64-sample
// tile at a time (tile = block, stride grid), both warpgroups splitting each
// product's output columns; the large weights stream from L2 through a
// two-slot ring of bulk copies, the next chunk in flight during this one's
// products; the gather of the next tile (each sample's own slot, 8 x D f32
// selected by bins, so 16-byte cp.async rather than a tensor copy) is issued
// right after this tile's blend and lands during its decoder. Thread
// (row = t % 64, quarter = t / 64) gathers and blends dims [16k + 4q,
// 16k + 4q + 4) (k < D / 16) of its sample in the plain version's exact f32
// order, as render_kernel.cu. At in_dim 32 the gather buffer doubles
// (66,560 bytes), which fits beside the ring's 32-row chunks of that
// in_dim (decoder_stream.cuh): 213,040 bytes at (32, 256, 256). At in_dim
// 64 a whole row's buffer (132,096 bytes) fits up to width 128; at width
// 192 the buffer holds half of each corner and the blend runs in two
// passes, at 256 a quarter in four (render_gather.cuh): 217,136 bytes at
// (64, 256, 256). In_dim 128 runs the wide plan (render_wide.cu).

#include "decoder_stream.cuh"
#include "render_gather.cuh"

namespace {

using st::bf16;
using dec::D;
using dec::W;

// the block's shared memory but the gather buffer
constexpr int OTHER = tc::TC_SMALL_SMEM + st::RING_SMEM
                      + 2 * dec::pad16(tc::TR * W * 2)
                      + dec::pad16(tc::TR * D * 2) + st::PART_SMEM;
#if DEC_D <= 32
constexpr int KS = 8 * D;                    // corner values of a hit slot
constexpr int GROW = KS * 4 + 16;            // gather-buffer row, bytes (padded)
constexpr int SMEM = OTHER + dec::pad16(tc::TR * GROW);
#else
constexpr int G = kg::gather_dims(OTHER);    // a corner's dims in the buffer
constexpr int SMEM = OTHER + kg::buffer_bytes(G);
#endif
static_assert(SMEM <= 232448, "one block's shared memory");
static_assert(D <= 64, "in_dim 128 runs the wide plan (render_wide.cu)");

#if DEC_D <= 32

struct Inputs {
  const float *rb, *z, *rays_o, *rays_d;
  const int *keys, *bins;
  float *out, *feats;
  long long N;
  int H, S;
  float voxel;
};

struct Sample {
  bool slot;          // the sample has a hit slot
  float z, o[3], d[3];
  int key;
};

// Gather of a tile: thread (row, q) loads its sample's scalars and issues
// the cp.async copies of dims [16k + 4q, 16k + 4q + 4) (k < D / 16) of the
// slot's 8 corners; corner j's D floats start at byte 4 D j of the row.
__device__ inline void issue(const Inputs& in, long long tile, int row, int q,
                             char* gbuf, Sample& s) {
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
      char* dst = gbuf + row * GROW + 16 * q;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          tc::cp_async16(dst + 4 * D * j + 64 * k, src + j * D + 16 * k);
    }
  }
  tc::cp_async_commit();
}

// The trilinear blend of this thread's D / 4 features: to feats (f32) and,
// rounded to bf16, to the tile's input x, 4 features at a time.
__device__ inline void blend(const Inputs& in, long long tile, int row, int q,
                             const char* gbuf, const Sample& s, bf16* xs) {
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
      const float* src = reinterpret_cast<const float*>(gbuf + row * GROW) + c;
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
    if (n < in.N)
      *reinterpret_cast<float4*>(in.feats + n * D + c) =
          make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<uint2*>(xs + tc::tofs(row, c, D)) =
        make_uint2(tc::pack_bf16x2(f[0], f[1]), tc::pack_bf16x2(f[2], f[3]));
  }
}

__global__ void __launch_bounds__(st::THREADS, 1)
render_forward_kernel(Inputs in, dec::Params prm, const bf16* wpack) {
  extern __shared__ __align__(16) char smem[];
  dec::Arena arena{smem};
  tc::TcWeights w;
  tc::carve_small(arena, w);
  st::Ring ring = st::ring_init(arena, wpack, st::NFWD);
  bf16* hA = arena.take<bf16>(tc::TR * W);
  bf16* hB = arena.take<bf16>(tc::TR * W);
  bf16* xs = arena.take<bf16>(tc::TR * D);
  char* gbuf = arena.take<char>(tc::TR * GROW);
  float* part = arena.take<float>(2 * tc::TR * 4);
  tc::load_weights(w, prm);                 // ends with a barrier

  const int row = threadIdx.x % tc::TR, q = threadIdx.x / tc::TR;
  const long long ntiles = (in.N + tc::TR - 1) / tc::TR;
  long long tile = blockIdx.x;
  Sample s;
  if (tile < ntiles) {
    st::ring_start(ring);
    issue(in, tile, row, q, gbuf, s);
  }
  for (; tile < ntiles; tile += gridDim.x) {
    const bool more = tile + gridDim.x < ntiles;
    tc::cp_async_wait_all();
    __syncthreads();                  // the tile's copies are visible
    blend(in, tile, row, q, gbuf, s, xs);
    tc::fence_proxy_async();
    __syncthreads();                  // x is in place; the buffer is free
    if (more) issue(in, tile + gridDim.x, row, q, gbuf, s);
    st::decode(w, xs, hA, hB, part, ring, more, in.out, in.N, tile);
  }
}

#else   // in_dim 64: the gather in passes

using kg::Inputs;

__global__ void __launch_bounds__(st::THREADS, 1)
render_forward_kernel(Inputs in, dec::Params prm, const bf16* wpack) {
  extern __shared__ __align__(16) char smem[];
  dec::Arena arena{smem};
  tc::TcWeights w;
  tc::carve_small(arena, w);
  st::Ring ring = st::ring_init(arena, wpack, st::NFWD);
  bf16* hA = arena.take<bf16>(tc::TR * W);
  bf16* hB = arena.take<bf16>(tc::TR * W);
  bf16* xs = arena.take<bf16>(tc::TR * D);
  char* gbuf = arena.take<char>(kg::buffer_bytes(G));
  float* part = arena.take<float>(2 * tc::TR * 4);
  tc::load_weights(w, prm);                 // ends with a barrier

  const int row = threadIdx.x % tc::TR, q = threadIdx.x / tc::TR;
  const long long ntiles = (in.N + tc::TR - 1) / tc::TR;
  long long tile = blockIdx.x;
  kg::Sample s;
  if (tile < ntiles) {
    st::ring_start(ring);
    kg::locate(in, tile, row, q, s);
    kg::issue<G>(s, row, q, 0, gbuf);
  }
  for (; tile < ntiles; tile += gridDim.x) {
    const bool more = tile + gridDim.x < ntiles;
    // x's last readers, the previous tile's products, are done at the
    // barrier that ends its decode
    kg::blend_tile<G>(in, tile, row, q, gbuf, s, xs);
    if (more) {
      kg::locate(in, tile + gridDim.x, row, q, s);
      kg::issue<G>(s, row, q, 0, gbuf);
    }
    st::decode(w, xs, hA, hB, part, ring, more, in.out, in.N, tile);
  }
}

#endif

}  // namespace

// Returns cudaGetLastError() after the launches (0 = launched). wpack:
// scratch of st::PACKED bf16 for the packed weights.
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
  const dec::Params prm = dec::params_from(params);
  err = st::pack_weights(prm, static_cast<bf16*>(wpack), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  Inputs in{rb, z, rays_o, rays_d, keys, bins, out, feats,
            static_cast<long long>(R) * S, H, S, voxel};
  render_forward_kernel<<<grid, st::THREADS, SMEM, stream>>>(
      in, prm, static_cast<const bf16*>(wpack));
  return static_cast<int>(cudaGetLastError());
}
