// Fused decoder forward (kernel K2) and backward (kernel K3) at the decoder
// widths above 256 and at in_dim 128: the wide plan (decoder_wide.cuh).
//
// K2 replaces the TPU kernel `_fwd_kernel` and K3 `_bwd_kernel` of
// proudslam_tpu/ops/pallas/mlp_kernel.py (`_run_fwd`, `_run_bwd`,
// bf16=True), which take any decoder size; mlp_stream.cu is the same pair up
// to width 256 and in_dim 64. The functions and rounding points are mlp_stream.cu's: K2
// maps x (N, D) f32 to out (N, 4) [sigmoid(rgb), sdf]; K3 recomputes the
// forward per tile and returns dx (N, D) and, unless dx-only, the 11
// parameter gradients summed over all rows, every product operand
// (cotangents included) rounded to bf16, bias gradients f32 sums of the
// unrounded cotangents, ReLU masks from the forward activations.
//
// What bounds them on an H100: arithmetic (~2 * 800k flops per row forward
// at (16, 512, 512), 3x that for the full backward), then, for the full
// backward, the slab of partial weight gradients each block reads and
// rewrites per 64-row tile (3.2 MB at (16, 512, 512)). Design:
//   - K2 is mlp_stream.cu's K2 with decoder_wide.cuh's `decode`, K1's, so
//     K2 on K1's features gives K1's outputs bit for bit;
//   - K3 keeps mlp_stream.cu's reduction (each of P blocks walks a
//     contiguous run of tiles and adds each tile's weight gradients into its
//     own f32 slab; reduce_partials_kernel sums the slabs in a fixed order:
//     bitwise repeatable) and its products, in passes, with two (TR, W)
//     bf16 activation tiles A and B instead of four. Per tile: h1 -> A and
//     h2 -> B, each also parked in the block's scratch in global memory;
//     feat -> A, hc -> B; dzo, dwo; dhc over hc in B; dwc_f, dwc_x and dx's
//     part dhc wc_x^T; dso over feat in A (dhc is then dead); h2 back from
//     its park over B, dws; dh2 over h2 in B; h1 back over A, dw2; dh1 over
//     h1 in A; dx += dh1 w1^T, dw1. The ReLU masks are the parked tiles'
//     own values, so every product and mask is mlp_stream.cu's. 195,632
//     bytes of shared memory at (32, 512, 512).
// At in_dim 128 K2's staging buffer for the next tile's inputs (32 KB)
// would take its block to 233,520 bytes at (128, 512, 512), so there each
// tile's inputs are read straight from global memory at its start, as K3
// reads them; w1 and wc_x come in chunks of 64 rows (decoder_wide.cuh),
// dx's columns two blocks of 64 (dx_passes2), and the x-side weight
// gradients in pieces of 32 of x's columns (decoder_rows.cuh). K3 there
// takes 207,920 bytes.
// A ragged last tile is masked: its missing rows carry zero inputs and zero
// cotangents (they add nothing to any gradient) and write no output.

#include "decoder_rows.cuh"
#include "decoder_slab.cuh"
#include "decoder_wide.cuh"

using namespace dec;
using st::Lane;
using st::col_sums;
using st::put;
using st::stage_x;
using st::wgrad;
using st::wgrad_x;
using wd::CR;
using wd::NP;

namespace {

// ---- K2 ----

// no staging buffer at in_dim 128 (the note above)
constexpr bool STAGE = D <= 64;
constexpr int K2_SMEM = wd::VEC_SMEM + wd::RING_SMEM
                        + 2 * pad16(tc::TR * W * 2) + pad16(tc::TR * D * 2)
                        + (STAGE ? pad16(tc::TR * D * 4) : 0) + wd::PART_SMEM;
static_assert(K2_SMEM <= 232448, "one block's shared memory");

__global__ void __launch_bounds__(wd::THREADS, 1)
decoder_forward_kernel(const float* __restrict__ x, Params prm,
                       const bf16* wpack, float* __restrict__ out,
                       long long N) {
  extern __shared__ __align__(16) char smem[];
  Arena arena{smem};
  const wd::Vecs w = wd::carve_vecs(arena);
  wd::Ring ring = wd::ring_init(arena, wpack, wd::NFWD);
  bf16* hA = arena.take<bf16>(tc::TR * W);
  bf16* hB = arena.take<bf16>(tc::TR * W);
  bf16* xs = arena.take<bf16>(tc::TR * D);
  float* stage = STAGE ? arena.take<float>(tc::TR * D) : nullptr;
  float* part = arena.take<float>(2 * tc::TR * 4);
  wd::load_vecs(w, prm);                    // ends with a barrier

  const int row = threadIdx.x >> 2, q = threadIdx.x & 3;
  const long long ntiles = (N + tc::TR - 1) / tc::TR;
  long long tile = blockIdx.x;
  if (tile < ntiles) {
    wd::ring_start(ring);
    if constexpr (STAGE) stage_x(x, N, tile, stage);
  }
  for (; tile < ntiles; tile += gridDim.x) {
    const bool more = tile + gridDim.x < ntiles;
    if constexpr (STAGE) {
      tc::cp_async_wait_all();
      // every thread's copy has landed; the barrier also keeps x's tile
      // until the previous tile's products have finished
      __syncthreads();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const int c = 16 * k + 4 * q;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (tile * tc::TR + row < N)
          v = *reinterpret_cast<const float4*>(stage + row * D + c);
        *reinterpret_cast<uint2*>(xs + tc::tofs(row, c, D)) =
            make_uint2(tc::pack_bf16x2(v.x, v.y), tc::pack_bf16x2(v.z, v.w));
      }
    } else {
      // x's last readers, the previous tile's products, are done at the
      // barrier that ends its decode: thread (row, q) reads x[row, 16k +
      // 4q : 16k + 4q + 4] (k < D / 16) from global memory
      const long long n = tile * tc::TR + row;
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const int c = 16 * k + 4 * q;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n < N) v = __ldg(reinterpret_cast<const float4*>(x + n * D + c));
        *reinterpret_cast<uint2*>(xs + tc::tofs(row, c, D)) =
            make_uint2(tc::pack_bf16x2(v.x, v.y), tc::pack_bf16x2(v.z, v.w));
      }
    }
    tc::fence_proxy_async();
    __syncthreads();                  // x is in place; the stage is free
    if (STAGE && more) stage_x(x, N, tile + gridDim.x, stage);
    wd::decode(w, xs, hA, hB, part, ring, more, out, N, tile);
  }
}

// ---- K3 ----

constexpr int K3_SMEM = wd::VEC_SMEM + wd::RING_SMEM + pad16(tc::TR * D * 2)
                        + 2 * pad16(tc::TR * W * 2) + pad16(tc::TR * 4 * 4)
                        + pad16(4 * W * 4);
static_assert(K3_SMEM <= 232448, "one block's shared memory");

// dst[0:len] (+)= the four warps' column sums, added in st::fold's order
// (len may exceed the block's threads here)
__device__ inline void fold_all(const float* cs, float* dst, int len,
                                bool first) {
  for (int c = threadIdx.x; c < len; c += blockDim.x)
    put(dst + c, ((cs[c] + cs[W + c]) + cs[2 * W + c]) + cs[3 * W + c],
        first);
}

// this thread's entries of a (TR, W) tile from col0 (as st::store_tile
// wrote them; acc holds the rounded values) -> the parked copy in global
// memory, in the same layout
__device__ __forceinline__ void park(bf16* dst, const float (&acc)[NP / 4],
                                     int col0, const Lane& ln) {
#pragma unroll
  for (int i = 0; i < NP / 16; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(
          dst + tc::tofs(ln.r0 + 8 * h, col0 + 8 * i + ln.c2, W)) =
          tc::pack_bf16x2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
}

// a parked (TR, W) tile -> shared memory, by the whole block; then the
// proxy fence and a barrier, so the next products may read it
__device__ inline void unpark(bf16* dst, const bf16* src) {
  for (int i = threadIdx.x; i < tc::TR * W / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  tc::fence_proxy_async();
  __syncthreads();
}

__global__ void __launch_bounds__(wd::THREADS, 1)
decoder_backward_kernel(const float* __restrict__ x,
                        const float* __restrict__ g, Params prm, bf16* wpack,
                        float* __restrict__ dx, float* __restrict__ partial,
                        long long N, int tiles_per_block, int want_wgrad) {
  extern __shared__ __align__(16) char smem[];
  Arena arena{smem};
  const wd::Vecs w = wd::carve_vecs(arena);
  wd::Ring ring = wd::ring_init(arena, wpack, wd::NFWD + wd::NBWD);
  bf16* xs = arena.take<bf16>(tc::TR * D);
  bf16* ta = arena.take<bf16>(tc::TR * W);    // h1, feat, dso, h1, dh1
  bf16* tb = arena.take<bf16>(tc::TR * W);    // h2, hc, dhc, h2, dh2
  float* rowv = arena.take<float>(tc::TR * 4);   // [dzo (3) | g_sdf]
  float* cs = arena.take<float>(4 * W);
  wd::load_vecs(w, prm);                    // ends with a barrier

  const int tid = threadIdx.x, wg = tid / tc::WG;
  const Lane ln = st::lane();
  const int cw = NP / 2 * wg;              // this warpgroup's columns of a pass
  float* slab = partial + static_cast<long long>(blockIdx.x) * NPARAM;
  bf16* park1 = wpack + wd::PACKED + static_cast<long long>(blockIdx.x) * wd::PARK;
  bf16* park2 = park1 + tc::TR * W;
  const long long ntiles = (N + tc::TR - 1) / tc::TR;
  const long long tile0 = static_cast<long long>(blockIdx.x) * tiles_per_block;
  const long long tile1 = min(ntiles, tile0 + tiles_per_block);
  float acc[NP / 4];                  // a pass's columns of an activation
  float ac[CR / 4];                   // a row block's columns of a cotangent
  float dd[D / 4];                    // dx's columns of this warpgroup
  float dd2[wd::XC][wd::XR / 4];      // the same at in_dim 128 (dx_passes2)
  if (tile0 < tile1) wd::ring_start(ring);

  for (long long tile = tile0; tile < tile1; ++tile) {
    const bool first = tile == tile0, more = tile + 1 < tile1;
    const long long row0 = tile * tc::TR;
    const int nvalid = static_cast<int>(min(static_cast<long long>(tc::TR), N - row0));

    // inputs: thread (r, q) = (tid / 4, tid % 4) takes x[r, 16k + 4q :
    // 16k + 4q + 4] (k < D / 16, bf16) and keeps g[r, q]; missing rows are
    // zeros
    const int r = tid >> 2, q = tid & 3;
    float gv = 0.f;
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      const int c = 16 * k + 4 * q;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nvalid) {
        v = *reinterpret_cast<const float4*>(x + (row0 + r) * D + c);
        if (k == 0) gv = g[(row0 + r) * 4 + q];
      }
      *reinterpret_cast<uint2*>(xs + tc::tofs(r, c, D)) =
          make_uint2(tc::pack_bf16x2(v.x, v.y), tc::pack_bf16x2(v.z, v.w));
    }
    tc::fence_proxy_async();
    __syncthreads();

    // forward recompute: h1 -> A and parked, h2 -> B and parked, feat -> A,
    // hc -> B
#pragma unroll 1
    for (int p = 0; p < wd::PW; ++p) {
      wd::x_pass(acc, xs, ring, more);
      st::store_tile(ta, W, acc, w.b1, true, NP * p + cw, ln);
      park(park1, acc, NP * p + cw, ln);
    }
    tc::fence_proxy_async();
#pragma unroll 1
    for (int p = 0; p < wd::PW; ++p) {
      wd::fwd_pass<W>(acc, ta, ring, more, false);
      st::store_tile(tb, W, acc, w.b2, true, NP * p + cw, ln);
      park(park2, acc, NP * p + cw, ln);
    }
    tc::fence_proxy_async();
#pragma unroll 1
    for (int p = 0; p < wd::PS; ++p) {
      wd::fwd_pass<W>(acc, tb, ring, more, false);
      st::store_tile(ta, SD, acc, w.bs, false, NP * p + cw, ln);
    }
    tc::fence_proxy_async();
#pragma unroll 1
    for (int p = 0; p < wd::PW; ++p) {
      wd::x_pass(acc, xs, ring, more);
      wd::fwd_pass<SD>(acc, ta, ring, more, true);
      st::store_tile(tb, W, acc, w.bc, true, NP * p + cw, ln);
    }
    __syncthreads();

    // color head and dzo = g_rgb * rgb * (1 - rgb): thread (r, q) sums
    // hc[r, q W/4 : (q + 1) W/4] . wo, the four quarters are summed across
    // lanes; rowv[r] = [dzo (3) | g_sdf] in f32
    {
      float p[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < W / 32; ++m) {
        const int k0 = q * (W / 4) + 8 * m;
        const uint4 v = *reinterpret_cast<const uint4*>(tb + tc::tofs(r, k0, W));
        const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 h = tc::unpack_bf16x2(u[k]);
          const float* wo = w.wo + 4 * (k0 + 2 * k);
#pragma unroll
          for (int c = 0; c < 3; ++c)
            p[c] = fmaf(h.y, wo[4 + c], fmaf(h.x, wo[c], p[c]));
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        p[c] += __shfl_xor_sync(0xffffffffu, p[c], 1);
        p[c] += __shfl_xor_sync(0xffffffffu, p[c], 2);
      }
      if (q < 3) {
        const float s = q == 0 ? p[0] : (q == 1 ? p[1] : p[2]);
        const float rgb = 1.f / (1.f + expf(-(s + w.bo[q])));
        rowv[r * 4 + q] = gv * rgb * (1.f - rgb);
      } else {
        rowv[r * 4 + 3] = gv;
      }
    }
    __syncthreads();
    if (want_wgrad) {
      // dwo[k][c] = sum_r hc[r][k] dzo[r][c]; dbo[c] = sum_r dzo[r][c]
      for (int e = tid; e < W * 3; e += wd::THREADS) {
        const int k = e / 3, c = e - 3 * k;
        float s = 0.f;
        for (int rr = 0; rr < tc::TR; ++rr)
          s = fmaf(__bfloat162float(tb[tc::tofs(rr, k, W)]),
                   tc::rbf(rowv[rr * 4 + c]), s);
        put(slab + OFF_WO + e, s, first);
      }
      if (tid < 3) {
        float s = 0.f;
        for (int rr = 0; rr < tc::TR; ++rr) s += rowv[rr * 4 + tid];
        put(slab + OFF_BO + tid, s, first);
      }
      __syncthreads();                // hc's readers are done
    }

    // dhc = (dzo wo^T) * (hc > 0) over hc, pass by pass on the FMA units;
    // each thread reads the masks of and writes only its own entries
    {
      float dz[2][3];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          dz[h][c] = tc::rbf(rowv[(ln.r0 + 8 * h) * 4 + c]);
#pragma unroll 1
      for (int p = 0; p < wd::PW; ++p) {
        const int col0 = NP * p + cw;
#pragma unroll
        for (int i = 0; i < NP / 16; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float* wo = w.wo + 4 * (col0 + 8 * i + ln.c2 + (e & 1));
            const float* d = dz[e >> 1];
            acc[4 * i + e] = fmaf(d[2], wo[2], fmaf(d[1], wo[1], d[0] * wo[0]));
          }
        st::relu_mask(acc, tb, W, col0, ln);
        if (want_wgrad) col_sums(acc, cs, col0);            // dbc
        st::store_tile(tb, W, acc, nullptr, false, col0, ln);
      }
    }
    tc::fence_proxy_async();
    __syncthreads();                  // dhc is in place; cs holds dbc
    if (want_wgrad) {
      fold_all(cs, slab + OFF_BC, W, first);
      wgrad<SD, W>(ta, tb, slab + S_WCF, first, ln);      // feat^T dhc
      wgrad_x<W>(tb, xs, slab + OFF_WCX, first, ln);      // x^T dhc
      if (tid == 0) {
        float s = 0.f;
        for (int rr = 0; rr < tc::TR; ++rr) s += rowv[rr * 4 + 3];
        put(slab + S_BS + SD, s, first);
      }
    }
    // dx = dhc wc_x^T (+ dh1 w1^T below): warpgroup wg takes columns
    // [D / 2 wg, D / 2 (wg + 1)) (at in_dim 128 [64 c + 32 wg, 64 c + 32
    // (wg + 1)) for c < 2); the first chunk's barrier also frees cs
    if constexpr (wd::XC > 1)
      wd::dx_passes2(dd2, tb, ring, more, false);
    else
      wd::dx_passes(dd, tb, ring, more, false);

    // dso[:, :SD] = dfeat = dhc wc_f^T, over feat (its readers are done at
    // the first chunk's barrier)
#pragma unroll 1
    for (int c = 0; c < wd::KS; ++c) {
      wd::bwd_block<W>(ac, tb, ring, more);
      const int col0 = CR * c + CR / 2 * wg;
      if (want_wgrad) col_sums(ac, cs, col0);            // dbs[:SD]
      st::store_tile(ta, SD, ac, nullptr, false, col0, ln);
    }
    tc::fence_proxy_async();
    __syncthreads();                  // dso is in place; dhc is dead
    if (want_wgrad) fold_all(cs, slab + S_BS, SD, first);

    // h2 back over dhc
    unpark(tb, park2);
    if (want_wgrad) {
      wgrad<W, SD>(tb, ta, slab + OFF_WS, first, ln);     // h2^T dso[:, :SD]
      for (int k = tid; k < W; k += wd::THREADS) {        // h2^T g_sdf
        float s = 0.f;
        for (int rr = 0; rr < tc::TR; ++rr)
          s = fmaf(__bfloat162float(tb[tc::tofs(rr, k, W)]),
                   tc::rbf(rowv[rr * 4 + 3]), s);
        put(slab + S_WS_SDF + k, s, first);
      }
    }

    // dh2 = (dso ws^T) * (h2 > 0), over h2: the SD feature columns on the
    // tensor cores, the sdf column's rank-1 term g_sdf ws[:, SD]^T on the
    // FMA units (h2's other readers are done at the first chunk's barrier)
    const float gs[2] = {tc::rbf(rowv[ln.r0 * 4 + 3]),
                         tc::rbf(rowv[(ln.r0 + 8) * 4 + 3])};
#pragma unroll 1
    for (int c = 0; c < wd::KW; ++c) {
      wd::bwd_block<SD>(ac, ta, ring, more);
      const int col0 = CR * c + CR / 2 * wg;
#pragma unroll
      for (int i = 0; i < CR / 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ac[4 * i + e] = fmaf(gs[e >> 1],
                               w.ws_sdf[col0 + 8 * i + ln.c2 + (e & 1)],
                               ac[4 * i + e]);
      st::relu_mask(ac, tb, W, col0, ln);
      if (want_wgrad) col_sums(ac, cs, col0);            // db2
      st::store_tile(tb, W, ac, nullptr, false, col0, ln);
    }
    tc::fence_proxy_async();
    __syncthreads();                  // dh2 is in place; dso is dead
    if (want_wgrad) fold_all(cs, slab + OFF_B2, W, first);

    // h1 back over dso
    unpark(ta, park1);
    if (want_wgrad) wgrad<W, W>(ta, tb, slab + OFF_W2, first, ln);   // h1^T dh2

    // dh1 = (dh2 w2^T) * (h1 > 0), over h1
#pragma unroll 1
    for (int c = 0; c < wd::KW; ++c) {
      wd::bwd_block<W>(ac, tb, ring, more);
      const int col0 = CR * c + CR / 2 * wg;
      st::relu_mask(ac, ta, W, col0, ln);
      if (want_wgrad) col_sums(ac, cs, col0);            // db1
      st::store_tile(ta, W, ac, nullptr, false, col0, ln);
    }
    tc::fence_proxy_async();
    __syncthreads();                  // dh1 is in place
    if (want_wgrad) fold_all(cs, slab + OFF_B1, W, first);

    // dx += dh1 w1^T
    if constexpr (wd::XC > 1) {
      wd::dx_passes2(dd2, ta, ring, more, true);
#pragma unroll
      for (int c = 0; c < wd::XC; ++c)
#pragma unroll
        for (int i = 0; i < wd::XR / 16; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rr = ln.r0 + 8 * h;
            if (rr < nvalid)
              *reinterpret_cast<float2*>(
                  dx + (row0 + rr) * D + wd::XR * c + wd::XR / 2 * wg
                  + 8 * i + ln.c2) =
                  make_float2(dd2[c][4 * i + 2 * h],
                              dd2[c][4 * i + 2 * h + 1]);
          }
    } else {
      wd::dx_passes(dd, ta, ring, more, true);
      const int n0 = D / 2 * wg;
#pragma unroll
      for (int i = 0; i < D / 16; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = ln.r0 + 8 * h;
          if (rr < nvalid)
            *reinterpret_cast<float2*>(dx + (row0 + rr) * D + n0 + 8 * i
                                       + ln.c2) =
                make_float2(dd[4 * i + 2 * h], dd[4 * i + 2 * h + 1]);
        }
    }
    if (want_wgrad) wgrad_x<W>(ta, xs, slab + OFF_W1, first, ln);   // x^T dh1
    __syncthreads();
  }
}

}  // namespace

// K2: out (N, 4) from x (N, D); `blocks` persistent blocks of two
// warpgroups (<= tiles). wpack: scratch of wd::PACKED bf16.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int decoder_forward(const float* x, const void* const* params,
                               void* wpack, float* out, long long N,
                               int blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decoder_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K2_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params prm = params_from(params);
  err = wd::pack_weights(prm, static_cast<bf16*>(wpack), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  decoder_forward_kernel<<<blocks, wd::THREADS, K2_SMEM, stream>>>(
      x, prm, static_cast<const bf16*>(wpack), out, N);
  return static_cast<int>(cudaGetLastError());
}

// K3: dx (N, D); dparams (NPARAM,) in FusedParams order when want_wgrad;
// partial: (P, NPARAM) scratch; wpack: scratch of wd::PACKED bf16 and, after
// them, wd::PARK bf16 per block (h1 and h2 parked). P blocks each take
// tiles_per_block tiles.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int decoder_backward(const float* x, const float* g,
                                const void* const* params, void* wpack,
                                float* dx, float* dparams, float* partial,
                                long long N, int P, int tiles_per_block,
                                int want_wgrad, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decoder_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K3_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params prm = params_from(params);
  err = wd::pack_weights(prm, static_cast<bf16*>(wpack), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  decoder_backward_kernel<<<P, wd::THREADS, K3_SMEM, stream>>>(
      x, g, prm, static_cast<bf16*>(wpack), dx, partial, N, tiles_per_block,
      want_wgrad);
  err = cudaGetLastError();
  if (err != cudaSuccess || !want_wgrad) return static_cast<int>(err);
  reduce_partials_kernel<<<(NPARAM + 255) / 256, 256, 0, stream>>>(
      partial, dparams, P);
  return static_cast<int>(cudaGetLastError());
}
