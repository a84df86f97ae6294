// K1's gather and blend in passes (render_stream.cu, render_wide.cu at
// in_dim 64 and 128).
//
// A sample's hit slot holds 8 corners of D floats: 2 KB at in_dim 64. The
// streamed plan's gather buffer of whole rows (TR x (8 D 4 + 16) bytes:
// 132,096 at in_dim 64) does not fit beside the ring, the resident w1 and
// wc_x and two activation tiles above width 128, and the wide plan's
// gather into registers (8 x D / 16 float4 a thread: 128 registers at
// in_dim 64) would spill. So the buffer
// holds G of each corner's D values (G = D where the whole row fits, else
// D / 2 or D / 4: `gather_dims`), and a tile's blend runs in D / G passes:
// the first pass's copies are issued before the previous tile's decoder
// and land during it, as in the whole-row gather; each later pass issues
// its copies after the pass before has been blended, and waits for them.
// (In the wide plan at in_dim 128 no buffer fits beside the tiles, so the
// buffer is the two activation tiles, free between decoders, and the first
// pass waits too: render_wide.cu.)
// Thread (row = t % 64, quarter = t / 64) copies and blends dims
// [G p + 16k + 4q, G p + 16k + 4q + 4) (k < G / 16) of its sample in pass
// p, reading only what it copied itself, so a pass needs no block barrier;
// each feature is the same sum, in the plain version's exact f32 order, as
// in render_stream.cu's whole-row blend.
#pragma once

#include "decoder_chain.cuh"

namespace kg {

using dec::bf16;
using dec::D;

constexpr int KS = 8 * D;                    // corner values of a hit slot

// Bytes of a gather buffer of G dims a corner for one 64-sample tile.
__host__ __device__ constexpr int buffer_bytes(int g) {
  return tc::TR * (8 * g * 4 + 16);
}

// The dims a corner a gather buffer of at most `bytes` bytes holds: D,
// D / 2 or D / 4, the most that fits.
__host__ __device__ constexpr int dims_within(int bytes) {
  return buffer_bytes(D) <= bytes       ? D
         : buffer_bytes(D / 2) <= bytes ? D / 2
                                        : D / 4;
}

// The same for a buffer beside `other` bytes of shared memory in a block.
__host__ __device__ constexpr int gather_dims(int other) {
  return dims_within(232448 - other);
}

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
  const float* src;   // its slot's corners, from this thread's first dim
};

// The sample of `row` in `tile`: its scalars and where its corners lie.
__device__ inline void locate(const Inputs& in, long long tile, int row,
                              int q, Sample& s) {
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
      s.src = in.rb + (ray * in.H + h) * KS + 4 * q;
    }
  }
}

// Pass p's cp.async copies: this thread's dims of the 8 corners; corner j's
// G buffered values start at byte 4 G j of the row.
template <int G>
__device__ inline void issue(const Sample& s, int row, int q, int p,
                             char* gbuf) {
  if (s.slot) {
    const float* src = s.src + G * p;
    char* dst = gbuf + row * (8 * G * 4 + 16) + 16 * q;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < G / 16; ++k)
        tc::cp_async16(dst + 4 * G * j + 64 * k, src + j * D + 16 * k);
  }
  tc::cp_async_commit();
}

// Pass p's trilinear blend of this thread's dims, once its copies have
// landed: to feats (f32) and, rounded to bf16, to the tile's input x.
template <int G>
__device__ inline void blend(const Inputs& in, long long tile, int row, int q,
                             int p, const char* gbuf, const Sample& s,
                             bf16* xs) {
  const long long n = tile * tc::TR + row;
#pragma unroll
  for (int k = 0; k < G / 16; ++k) {
    const int c = G * p + 16 * k + 4 * q;
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
      const float* src = reinterpret_cast<const float*>(
                             gbuf + row * (8 * G * 4 + 16)) + 16 * k + 4 * q;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float wx = (j & 4) ? px : 1.f - px;
        const float wy = (j & 2) ? py : 1.f - py;
        const float wz = (j & 1) ? pz : 1.f - pz;
        const float wj = __fmul_rn(__fmul_rn(wx, wy), wz);
        const float4 e = *reinterpret_cast<const float4*>(src + j * G);
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

// The blend of a tile whose first pass was issued: every pass in turn.
// Ends with the proxy fence and a barrier: x is in place, the buffer free.
template <int G>
__device__ inline void blend_tile(const Inputs& in, long long tile, int row,
                                  int q, char* gbuf, const Sample& s,
                                  bf16* xs) {
#pragma unroll 1
  for (int p = 0; p < D / G; ++p) {
    if (p > 0) issue<G>(s, row, q, p, gbuf);
    tc::cp_async_wait_all();
    blend<G>(in, tile, row, q, p, gbuf, s, xs);
  }
  tc::fence_proxy_async();
  __syncthreads();
}

}  // namespace kg
