// The parked plan of the bf16 decoder kernels K1 (render_park.cu), K2 and
// K3 (mlp_park.cu): the decoder sizes of width 768 and 1024 (sdf_dim a
// multiple of 128 up to the width), built with -DDEC_W > 512.
//
// Why another plan. The wide plan (decoder_wide.cuh) keeps two (TR, W) bf16
// activation tiles in shared memory: 256 KB at width 1024, beside its 32 KB
// ring and ~36 KB of f32 vectors, against the 232,448 bytes a block may use,
// and `wgmma` takes no tile of fewer than 64 rows. So here:
//   - one (TR, W) tile `t` stays in shared memory: the A operand of the
//     product that runs (`wgmma` reads only shared memory). Every other
//     activation is parked as a bf16 tile (the same tile layout) in a
//     per-block scratch in global memory, which L2 holds: a product's
//     epilogue writes its output there straight from the accumulators
//     (st::store_tile to a global address), and the whole block loads a
//     parked tile back over `t` with plain 16-byte loads (`unpark`) when it
//     becomes the next product's A operand. ReLU masks are read from the
//     parked tiles where they lie;
//   - a weight gradient act^T cot (mlp_park.cu) takes cot from `t` and act
//     from its park in blocks of 64 columns through an 8 KB buffer
//     (`load_cols`), one block's 64 rows of the gradient at a time
//     (st::wgrad with M = 64);
//   - the f32 vectors (ws's sdf column and wo, both bf16-rounded, and the
//     biases) lie in global memory too, written once per launch beside the
//     packed weights (`pack`), and are read through L1 in the epilogues;
//   - the weights stream through the wide plan's ring in its chunks and in
//     its order (wd::chunk_at), and the products are its passes (wd::x_pass,
//     fwd_pass, bwd_block, dx_passes, dx_passes2): the same sums, term for
//     term, as at width 512.
// Shared memory at (128, 1024, 1024): K2 182,288 bytes, K1 182,288 plus its
// gather buffer, which at in_dim 128 is `t` (render_park.cu), K3 207,888.
// What the parks cost: per 64-row tile K2 and K1 write and load back h2 and
// feat (4 x 128 KB at width 1024); K3 writes seven parked tiles and reads
// eleven (six loaded back, three in column blocks, two as masks), ~2.3 MB
// at width 1024; against the 6 MB of bf16 weights a tile streams (K3:
// 12 MB).
// The rounding points are the other plans': every product operand bf16
// (round to nearest even), f32 sums; K1 and K2 run one `decode`, so K2 on
// K1's features gives K1's outputs bit for bit. A wait on a ring slot that
// does not complete within 2 s traps (wd::acquire).
#pragma once

#include "decoder_rows.cuh"
#include "decoder_wide.cuh"

namespace pk {

using dec::bf16;
using dec::D;
using dec::SD;
using dec::SO;
using dec::W;
using st::Lane;
using tc::TR;
using tc::WG;
using wd::NP;

static_assert(W > 512 && W <= 1024, "the parked plan: width 768 or 1024");

// The scratch after the packed bf16 weights (wd::PACKED): the f32 vectors,
// VEC_FLOATS floats from bf16 element VEC_OFF, [ws[:, SD] (W) | wo (W, 4) |
// b1 | b2 | bc (W each) | bs (SO, padded to SO4) | bo (4)], then NPARK
// parked (TR, W) tiles a block from bf16 element PARK_OFF
// (mlp_kernel.packed_weights sizes it).
constexpr int SO4 = (SO + 3) / 4 * 4;
constexpr int VEC_FLOATS = 8 * W + SO4 + 4;
constexpr long long VEC_OFF = (wd::PACKED + 7) / 8 * 8;
constexpr long long PARK_OFF = VEC_OFF + 2 * VEC_FLOATS;
constexpr int TILE = TR * W;               // bf16 elements of a parked tile
constexpr int NPARK = 4;                   // K3's parks a block (K1, K2: 1)

// f32 FusedParams -> the vectors (as wd::load_vecs puts them in shared
// memory: ws's sdf column and wo rounded to bf16, wo's rows padded to 4)
__global__ void pack_vecs_kernel(dec::Params p, float* __restrict__ v) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < VEC_FLOATS;
       i += gridDim.x * blockDim.x) {
    float x = 0.f;
    if (i < W) {
      x = tc::rbf(p.ws[i * SO + SD]);
    } else if (i < 5 * W) {
      const int j = i - W;
      if ((j & 3) < 3) x = tc::rbf(p.wo[(j >> 2) * 3 + (j & 3)]);
    } else if (i < 6 * W) {
      x = p.b1[i - 5 * W];
    } else if (i < 7 * W) {
      x = p.b2[i - 6 * W];
    } else if (i < 8 * W) {
      x = p.bc[i - 7 * W];
    } else if (i < 8 * W + SO4) {
      if (i - 8 * W < SO) x = p.bs[i - 8 * W];
    } else if (i - 8 * W - SO4 < 3) {
      x = p.bo[i - 8 * W - SO4];
    }
    v[i] = x;
  }
}

// the packed weights (wd::pack_weights) and the vectors, before a launch
inline cudaError_t pack(const dec::Params& p, bf16* wpack,
                        cudaStream_t stream) {
  cudaError_t err = wd::pack_weights(p, wpack, stream);
  if (err != cudaSuccess) return err;
  pack_vecs_kernel<<<(VEC_FLOATS + 255) / 256, 256, 0, stream>>>(
      p, reinterpret_cast<float*>(wpack + VEC_OFF));
  return cudaGetLastError();
}

// the vectors' places in the scratch
__device__ inline wd::Vecs vecs_at(const bf16* wpack) {
  const float* v = reinterpret_cast<const float*>(wpack + VEC_OFF);
  wd::Vecs w;
  w.ws_sdf = const_cast<float*>(v);
  w.wo = w.ws_sdf + W;
  w.b1 = w.wo + 4 * W;
  w.b2 = w.b1 + W;
  w.bc = w.b2 + W;
  w.bs = w.bc + W;
  w.bo = w.bs + SO4;
  return w;
}

// A parked tile (n bf16 elements) -> t, by the whole block, once every
// product that reads t has finished and the park's writes are done (the
// barrier first); then the proxy fence and a barrier, so the next products
// may read it.
__device__ inline void unpark(bf16* t, const bf16* src, int n) {
  __syncthreads();
  for (int i = threadIdx.x; i < n / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(t)[i] = reinterpret_cast<const uint4*>(src)[i];
  tc::fence_proxy_async();
  __syncthreads();
}

// Columns [mb, mb + 64) of a parked (TR, ld) tile -> the (TR, 64) tile c, by
// the whole block after c's last readers (the barrier first): row group g
// (rows 8g .. 8g + 7) holds those columns as 8 core matrices in a row,
// 1 KB, in both layouts. Ends with the proxy fence and a barrier.
__device__ inline void load_cols(bf16* c, const bf16* src, int ld, int mb) {
  __syncthreads();
  for (int i = threadIdx.x; i < TR * 8; i += blockDim.x) {
    const int g = i >> 6, j = i & 63;
    reinterpret_cast<uint4*>(c + 512 * g)[j] = reinterpret_cast<const uint4*>(
        src + (g * (ld / 8) + mb / 8) * 64)[j];
  }
  tc::fence_proxy_async();
  __syncthreads();
}

// ---- the forward of K1 and K2 ----

// wd::decode with h2 and feat parked: the decoder of one tile whose input
// xs (bf16, tile layout) is in place and visible to the block; t is the
// (TR, W) tile and park the block's parked tile; the ring's next chunk is
// the tile's first. Writes out[tile rows < N] = [sigmoid(hc wo + bo), sdf].
__device__ inline void decode(const wd::Vecs& w, const bf16* xs, bf16* t,
                              bf16* park, float* part, wd::Ring& r, bool more,
                              float* __restrict__ out, long long N,
                              long long tile) {
  const int wg = threadIdx.x / WG;
  const Lane ln = st::lane();
  const int cw = NP / 2 * wg;            // this warpgroup's columns of a pass
  const bool lead = (threadIdx.x & 3) == 0;
  float acc[NP / 4];

  // h1 = relu(x w1 + b1) -> t
#pragma unroll 1
  for (int p = 0; p < wd::PW; ++p) {
    wd::x_pass(acc, xs, r, more);
    st::store_tile(t, W, acc, w.b1, true, NP * p + cw, ln);
  }
  tc::fence_proxy_async();

  // h2 = relu(h1 w2 + b2) -> park; this thread's part of h2 . ws[:, SD]
  float s0 = 0.f, s1 = 0.f;
#pragma unroll 1
  for (int p = 0; p < wd::PW; ++p) {
    wd::fwd_pass<W>(acc, t, r, more, false);
    st::store_tile(park, W, acc, w.b2, true, NP * p + cw, ln);
#pragma unroll
    for (int i = 0; i < NP / 16; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(
          w.ws_sdf + NP * p + cw + 8 * i + ln.c2);
      s0 = fmaf(acc[4 * i], v.x, fmaf(acc[4 * i + 1], v.y, s0));
      s1 = fmaf(acc[4 * i + 2], v.x, fmaf(acc[4 * i + 3], v.y, s1));
    }
  }
  s0 = tc::quad_sum(s0);
  s1 = tc::quad_sum(s1);
  if (lead) {
    part[(wg * TR + ln.r0) * 4 + 3] = s0;
    part[(wg * TR + ln.r0 + 8) * 4 + 3] = s1;
  }
  unpark(t, park, TR * W);                   // h2 over h1

  // feat = h2 ws[:, :SD] + bs[:SD] -> park (h2's copy there was read by
  // the unpark)
#pragma unroll 1
  for (int p = 0; p < wd::PS; ++p) {
    wd::fwd_pass<W>(acc, t, r, more, false);
    st::store_tile(park, SD, acc, w.bs, false, NP * p + cw, ln);
  }
  unpark(t, park, TR * SD);                  // feat over h2

  // hc = relu(x wc_x + feat wc_f + bc); this thread's part of hc wo
  float p0[3] = {0.f, 0.f, 0.f}, p1[3] = {0.f, 0.f, 0.f};
#pragma unroll 1
  for (int p = 0; p < wd::PW; ++p) {
    wd::x_pass(acc, xs, r, more);
    wd::fwd_pass<SD>(acc, t, r, more, true);
#pragma unroll
    for (int i = 0; i < NP / 16; ++i) {
      const int col = NP * p + cw + 8 * i + ln.c2;
      const float2 b = *reinterpret_cast<const float2*>(w.bc + col);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 wo = *reinterpret_cast<const float4*>(w.wo + 4 * (col + e));
        const float h0 = tc::rbf(fmaxf(acc[4 * i + e] + (e ? b.y : b.x), 0.f));
        const float h1 = tc::rbf(fmaxf(acc[4 * i + 2 + e] + (e ? b.y : b.x), 0.f));
        p0[0] = fmaf(h0, wo.x, p0[0]);
        p0[1] = fmaf(h0, wo.y, p0[1]);
        p0[2] = fmaf(h0, wo.z, p0[2]);
        p1[0] = fmaf(h1, wo.x, p1[0]);
        p1[1] = fmaf(h1, wo.y, p1[1]);
        p1[2] = fmaf(h1, wo.z, p1[2]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p0[k] = tc::quad_sum(p0[k]);
    p1[k] = tc::quad_sum(p1[k]);
  }
  if (lead) {
    float* q0 = part + (wg * TR + ln.r0) * 4;
    float* q1 = part + (wg * TR + ln.r0 + 8) * 4;
    q0[0] = p0[0]; q0[1] = p0[1]; q0[2] = p0[2];
    q1[0] = p1[0]; q1[1] = p1[1]; q1[2] = p1[2];
  }
  __syncthreads();
  // row t: the two warpgroups' parts, in order
  if (threadIdx.x < TR) {
    const int row = threadIdx.x;
    const long long n = tile * TR + row;
    const float4 a = *reinterpret_cast<const float4*>(part + row * 4);
    const float4 b = *reinterpret_cast<const float4*>(part + (TR + row) * 4);
    if (n < N)
      *reinterpret_cast<float4*>(out + n * 4) = make_float4(
          1.f / (1.f + expf(-((a.x + b.x) + w.bo[0]))),
          1.f / (1.f + expf(-((a.y + b.y) + w.bo[1]))),
          1.f / (1.f + expf(-((a.z + b.z) + w.bo[2]))),
          (a.w + b.w) + w.bs[SD]);
  }
}

}  // namespace pk
