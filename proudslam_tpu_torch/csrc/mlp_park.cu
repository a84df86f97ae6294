// Fused decoder forward (kernel K2) and backward (kernel K3) at the decoder
// widths 768 and 1024: the parked plan (decoder_park.cuh).
//
// K2 replaces the TPU kernel `_fwd_kernel` and K3 `_bwd_kernel` of
// proudslam_tpu/ops/pallas/mlp_kernel.py (`_run_fwd`, `_run_bwd`,
// bf16=True), which take any decoder size; mlp_wide.cu is the same pair at
// widths 384 and 512. The functions and rounding points are mlp_wide.cu's:
// K2 maps x (N, D) f32 to out (N, 4) [sigmoid(rgb), sdf]; K3 recomputes the
// forward per tile and returns dx (N, D) and, unless dx-only, the 11
// parameter gradients summed over all rows, every product operand
// (cotangents included) rounded to bf16, bias gradients f32 sums of the
// unrounded cotangents, ReLU masks from the forward activations.
//
// What bounds them on an H100: arithmetic (~2 * 3.2M flops per row forward
// at (16, 1024, 1024), 2x that for K3's pass 1). Design:
//   - K2 is mlp_wide.cu's K2 with decoder_park.cuh's `decode`, K1's, so K2
//     on K1's features gives K1's outputs bit for bit;
//   - K3 is pass 1 of decoder_wgrad.cuh's two passes, as in mlp_wide.cu
//     (each of P blocks walks a contiguous run of tiles, adds each tile's
//     small gradients into its own f32 slab and stores its bf16 operands of
//     the large ones in the scratch), with its products and their order,
//     one (TR, W) tile t in shared memory and the other activations parked
//     in global memory. dx-only, four parks a block: P1 h1; P2 h2, then
//     dh1; P3 feat, then dh2; P4 hc, then dso. With the weight gradients
//     every operand is parked at its place in the scratch, which pass 2
//     reads, and only hc in P4. Per tile: h1 -> t and P1; h2 -> P2, back
//     over t (ws's sdf column of the gradient, h2^T g_sdf, from t); feat ->
//     P3, back over t; hc -> P4 with its color logits; dzo; hc back over t;
//     dwo; dhc over hc in t; dx's part dhc wc_x^T; dso -> P4; dso back over
//     t; dh2 (masks from P2) -> P3, back over t; dh1 (masks from P1) -> P2,
//     back over t; dx += dh1 w1^T. Every product and mask is mlp_wide.cu's;
//     the color logits are summed as in `decode` (K2's order).
// A ragged last tile is masked: its missing rows carry zero inputs and zero
// cotangents (they add nothing to any gradient) and write no output.

#include "decoder_park.cuh"
#include "decoder_wgrad.cuh"

using namespace dec;
using st::Lane;
using st::col_sums;
using st::put;
using st::stage_x;
using wd::CR;
using wd::NP;

namespace {

// ---- K2 ----

// the staging buffer for the next tile's inputs up to in_dim 64 (at 128
// each tile's inputs are read straight from global memory, as in
// mlp_wide.cu)
constexpr bool STAGE = D <= 64;
constexpr int K2_SMEM = wd::RING_SMEM + pad16(tc::TR * W * 2)
                        + pad16(tc::TR * D * 2)
                        + (STAGE ? pad16(tc::TR * D * 4) : 0) + wd::PART_SMEM;
static_assert(K2_SMEM <= 232448, "one block's shared memory");

__global__ void __launch_bounds__(wd::THREADS, 1)
decoder_forward_kernel(const float* __restrict__ x, bf16* wpack,
                       float* __restrict__ out, long long N) {
  extern __shared__ __align__(16) char smem[];
  Arena arena{smem};
  wd::Ring ring = wd::ring_init(arena, wpack, wd::NFWD);
  bf16* t = arena.take<bf16>(tc::TR * W);
  bf16* xs = arena.take<bf16>(tc::TR * D);
  float* stage = STAGE ? arena.take<float>(tc::TR * D) : nullptr;
  float* part = arena.take<float>(2 * tc::TR * 4);
  const wd::Vecs w = pk::vecs_at(wpack);
  bf16* park = wpack + pk::PARK_OFF
               + static_cast<long long>(blockIdx.x) * pk::NPARK * pk::TILE;
  __syncthreads();                          // the ring's mbarriers

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
      // barrier that ends its decode
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
    pk::decode(w, xs, t, park, part, ring, more, out, N, tile);
  }
}

// ---- K3 ----

constexpr int K3_SMEM = wd::RING_SMEM + pad16(tc::TR * D * 2)
                        + pad16(tc::TR * W * 2) + pad16(tc::TR * 4 * 4)
                        + pad16(4 * W * 4) + wd::PART_SMEM;
static_assert(K3_SMEM <= 232448, "one block's shared memory");
// the block's slab of small gradients
using SG = wg::SmallAt<W, SD>;

// dst[0:len] (+)= the four warps' column sums, added in st::fold's order
// (len may exceed the block's threads here)
__device__ inline void fold_all(const float* cs, float* dst, int len,
                                bool first) {
  for (int c = threadIdx.x; c < len; c += blockDim.x)
    put(dst + c, ((cs[c] + cs[W + c]) + cs[2 * W + c]) + cs[3 * W + c],
        first);
}

// this thread's entries of a (TR, W) tile from col0 (as st::store_tile
// wrote them; acc holds the rounded values) -> a parked copy, in the same
// layout
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

__global__ void __launch_bounds__(wd::THREADS, 1)
decoder_backward_kernel(const float* __restrict__ x,
                        const float* __restrict__ g, bf16* wpack,
                        float* __restrict__ dx, float* __restrict__ partial,
                        bf16* __restrict__ scratch, long long N,
                        int tiles_per_block, int want_wgrad) {
  extern __shared__ __align__(16) char smem[];
  Arena arena{smem};
  wd::Ring ring = wd::ring_init(arena, wpack, wd::NFWD + wd::NBWD);
  bf16* xs = arena.take<bf16>(tc::TR * D);
  bf16* t = arena.take<bf16>(tc::TR * W);
  float* rowv = arena.take<float>(tc::TR * 4);   // [dzo (3) | g_sdf]
  float* cs = arena.take<float>(4 * W);
  float* part = arena.take<float>(2 * tc::TR * 4);
  const wd::Vecs w = pk::vecs_at(wpack);
  __syncthreads();                          // the ring's mbarriers

  const int tid = threadIdx.x, wg = tid / tc::WG;
  const Lane ln = st::lane();
  const int cw = NP / 2 * wg;              // this warpgroup's columns of a pass
  const bool lead = (tid & 3) == 0;
  float* slab = partial + static_cast<long long>(blockIdx.x) * SG::n;
  bf16* p1 = wpack + pk::PARK_OFF
             + static_cast<long long>(blockIdx.x) * pk::NPARK * pk::TILE;
  bf16* p2 = p1 + pk::TILE;
  bf16* p3 = p2 + pk::TILE;
  bf16* p4 = p3 + pk::TILE;
  const long long ntiles = (N + tc::TR - 1) / tc::TR;
  const long long tile0 = static_cast<long long>(blockIdx.x) * tiles_per_block;
  const long long tile1 = min(ntiles, tile0 + tiles_per_block);
  // tile `tile` of operand `op` in the scratch
  auto at = [&](int op, long long tile) {
    return scratch + wg::offset(op, tile, D, W, SD);
  };
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
    if (q == 3) rowv[r * 4 + 3] = gv;         // g_sdf
    tc::fence_proxy_async();
    __syncthreads();
    // where each activation is parked: dx-only in the block's four parks,
    // else the operands at their places in the scratch (hc in P4)
    bf16* const ph1 = want_wgrad ? at(wg::H1, tile) : p1;
    bf16* const ph2 = want_wgrad ? at(wg::H2, tile) : p2;
    bf16* const pfeat = want_wgrad ? at(wg::FEAT, tile) : p3;
    bf16* const pdso = want_wgrad ? at(wg::DFEAT, tile) : p4;
    bf16* const pdh2 = want_wgrad ? at(wg::DH2, tile) : p3;
    bf16* const pdh1 = want_wgrad ? at(wg::DH1, tile) : p2;
    if (want_wgrad && tid == 0) wg::store(at(wg::X, tile), xs, 2 * tc::TR * D);

    // forward recompute: h1 -> t and P1, h2 -> P2, feat -> P3, hc -> P4
#pragma unroll 1
    for (int p = 0; p < wd::PW; ++p) {
      wd::x_pass(acc, xs, ring, more);
      st::store_tile(t, W, acc, w.b1, true, NP * p + cw, ln);
      park(ph1, acc, NP * p + cw, ln);
    }
    tc::fence_proxy_async();
#pragma unroll 1
    for (int p = 0; p < wd::PW; ++p) {
      wd::fwd_pass<W>(acc, t, ring, more, false);
      st::store_tile(ph2, W, acc, w.b2, true, NP * p + cw, ln);
    }
    pk::unpark(t, ph2, tc::TR * W);
    if (want_wgrad) {
      for (int k = tid; k < W; k += wd::THREADS) {        // h2^T g_sdf
        float s = 0.f;
        for (int rr = 0; rr < tc::TR; ++rr)
          s = fmaf(__bfloat162float(t[tc::tofs(rr, k, W)]),
                   tc::rbf(rowv[rr * 4 + 3]), s);
        put(slab + SG::ws_sdf + k, s, first);
      }
    }
#pragma unroll 1
    for (int p = 0; p < wd::PS; ++p) {
      wd::fwd_pass<W>(acc, t, ring, more, false);
      st::store_tile(pfeat, SD, acc, w.bs, false, NP * p + cw, ln);
    }
    pk::unpark(t, pfeat, tc::TR * SD);
    // hc and this thread's part of its color logits hc wo (decode's sums)
    {
      float p0[3] = {0.f, 0.f, 0.f}, p1s[3] = {0.f, 0.f, 0.f};
#pragma unroll 1
      for (int p = 0; p < wd::PW; ++p) {
        wd::x_pass(acc, xs, ring, more);
        wd::fwd_pass<SD>(acc, t, ring, more, true);
        st::store_tile(p4, W, acc, w.bc, true, NP * p + cw, ln);
#pragma unroll
        for (int i = 0; i < NP / 16; ++i) {
          const int col = NP * p + cw + 8 * i + ln.c2;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 wo =
                *reinterpret_cast<const float4*>(w.wo + 4 * (col + e));
            const float h0 = acc[4 * i + e], h1 = acc[4 * i + 2 + e];
            p0[0] = fmaf(h0, wo.x, p0[0]);
            p0[1] = fmaf(h0, wo.y, p0[1]);
            p0[2] = fmaf(h0, wo.z, p0[2]);
            p1s[0] = fmaf(h1, wo.x, p1s[0]);
            p1s[1] = fmaf(h1, wo.y, p1s[1]);
            p1s[2] = fmaf(h1, wo.z, p1s[2]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        p0[k] = tc::quad_sum(p0[k]);
        p1s[k] = tc::quad_sum(p1s[k]);
      }
      if (lead) {
        float* q0 = part + (wg * tc::TR + ln.r0) * 4;
        float* q1 = part + (wg * tc::TR + ln.r0 + 8) * 4;
        q0[0] = p0[0]; q0[1] = p0[1]; q0[2] = p0[2];
        q1[0] = p1s[0]; q1[1] = p1s[1]; q1[2] = p1s[2];
      }
    }
    __syncthreads();

    // dzo = g_rgb * rgb * (1 - rgb): rowv[r] = [dzo (3) | g_sdf] in f32,
    // the logit summed as decode sums it
    if (q < 3) {
      const float s = part[r * 4 + q] + part[(tc::TR + r) * 4 + q];
      const float rgb = 1.f / (1.f + expf(-(s + w.bo[q])));
      rowv[r * 4 + q] = gv * rgb * (1.f - rgb);
    }
    pk::unpark(t, p4, tc::TR * W);           // hc over feat; rowv is in place
    if (want_wgrad) {
      // dwo[k][c] = sum_r hc[r][k] dzo[r][c]; dbo[c] = sum_r dzo[r][c]
      for (int e = tid; e < W * 3; e += wd::THREADS) {
        const int k = e / 3, c = e - 3 * k;
        float s = 0.f;
        for (int rr = 0; rr < tc::TR; ++rr)
          s = fmaf(__bfloat162float(t[tc::tofs(rr, k, W)]),
                   tc::rbf(rowv[rr * 4 + c]), s);
        put(slab + SG::wo + e, s, first);
      }
      if (tid < 3) {
        float s = 0.f;
        for (int rr = 0; rr < tc::TR; ++rr) s += rowv[rr * 4 + tid];
        put(slab + SG::bo + tid, s, first);
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
        st::relu_mask(acc, t, W, col0, ln);
        if (want_wgrad) col_sums(acc, cs, col0);            // dbc
        st::store_tile(t, W, acc, nullptr, false, col0, ln);
      }
    }
    tc::fence_proxy_async();
    __syncthreads();                  // dhc is in place; cs holds dbc
    if (want_wgrad) {
      fold_all(cs, slab + SG::bc, W, first);
      if (tid == 0) wg::store(at(wg::DHC, tile), t, 2 * tc::TR * W);
      if (tid == 0) {
        float s = 0.f;
        for (int rr = 0; rr < tc::TR; ++rr) s += rowv[rr * 4 + 3];
        put(slab + SG::bs + SD, s, first);
      }
    }
    // dx = dhc wc_x^T (+ dh1 w1^T below): warpgroup wg takes columns
    // [D / 2 wg, D / 2 (wg + 1)) (at in_dim 128 [64 c + 32 wg, 64 c + 32
    // (wg + 1)) for c < 2); the first chunk's barrier also frees cs
    if constexpr (wd::XC > 1)
      wd::dx_passes2(dd2, t, ring, more, false);
    else
      wd::dx_passes(dd, t, ring, more, false);

    // dso[:, :SD] = dfeat = dhc wc_f^T -> P4 (hc's park, read back above);
    // dhc's store has read t before dso comes back over it
    if (want_wgrad && tid == 0) wg::stored_read();
#pragma unroll 1
    for (int c = 0; c < wd::KS; ++c) {
      wd::bwd_block<W>(ac, t, ring, more);
      const int col0 = CR * c + CR / 2 * wg;
      if (want_wgrad) col_sums(ac, cs, col0);            // dbs[:SD]
      st::store_tile(pdso, SD, ac, nullptr, false, col0, ln);
    }
    __syncthreads();                  // dso is parked; cs holds dbs
    if (want_wgrad) fold_all(cs, slab + SG::bs, SD, first);

    // dso back over dhc
    pk::unpark(t, pdso, tc::TR * SD);

    // dh2 = (dso ws^T) * (h2 > 0) -> P3 (feat's park): the SD feature
    // columns on the tensor cores, the sdf column's rank-1 term g_sdf
    // ws[:, SD]^T on the FMA units, the masks from h2's park
    const float gs[2] = {tc::rbf(rowv[ln.r0 * 4 + 3]),
                         tc::rbf(rowv[(ln.r0 + 8) * 4 + 3])};
#pragma unroll 1
    for (int c = 0; c < wd::KW; ++c) {
      wd::bwd_block<SD>(ac, t, ring, more);
      const int col0 = CR * c + CR / 2 * wg;
#pragma unroll
      for (int i = 0; i < CR / 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ac[4 * i + e] = fmaf(gs[e >> 1],
                               w.ws_sdf[col0 + 8 * i + ln.c2 + (e & 1)],
                               ac[4 * i + e]);
      st::relu_mask(ac, ph2, W, col0, ln);
      if (want_wgrad) col_sums(ac, cs, col0);            // db2
      st::store_tile(pdh2, W, ac, nullptr, false, col0, ln);
    }
    __syncthreads();                  // dh2 is parked
    if (want_wgrad) fold_all(cs, slab + SG::b2, W, first);

    // dh2 back over dso
    pk::unpark(t, pdh2, tc::TR * W);

    // dh1 = (dh2 w2^T) * (h1 > 0) -> P2 (h2's park), the masks from h1's
#pragma unroll 1
    for (int c = 0; c < wd::KW; ++c) {
      wd::bwd_block<W>(ac, t, ring, more);
      const int col0 = CR * c + CR / 2 * wg;
      st::relu_mask(ac, ph1, W, col0, ln);
      if (want_wgrad) col_sums(ac, cs, col0);            // db1
      st::store_tile(pdh1, W, ac, nullptr, false, col0, ln);
    }
    __syncthreads();                  // dh1 is parked
    if (want_wgrad) fold_all(cs, slab + SG::b1, W, first);

    // dh1 back over dh2; dx += dh1 w1^T
    pk::unpark(t, pdh1, tc::TR * W);
    if constexpr (wd::XC > 1) {
      wd::dx_passes2(dd2, t, ring, more, true);
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
      wd::dx_passes(dd, t, ring, more, true);
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
    if (want_wgrad && tid == 0) wg::stored_read();      // x's store
    __syncthreads();
  }
  if (want_wgrad && tid == 0) wg::stored();
}

}  // namespace

// K2: out (N, 4) from x (N, D); `blocks` persistent blocks of two
// warpgroups (<= tiles, <= the SMs). wpack: the scratch of
// mlp_kernel.packed_weights (the packed weights, the f32 vectors and the
// parks, decoder_park.cuh). Returns cudaGetLastError() after the launches
// (0 = launched).
extern "C" int decoder_forward(const float* x, const void* const* params,
                               void* wpack, float* out, long long N,
                               int blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decoder_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K2_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = pk::pack(params_from(params), static_cast<bf16*>(wpack), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  decoder_forward_kernel<<<blocks, wd::THREADS, K2_SMEM, stream>>>(
      x, static_cast<bf16*>(wpack), out, N);
  return static_cast<int>(cudaGetLastError());
}

// K3's pass 1: dx (N, D); when want_wgrad the small gradients' slabs
// (P, wg::small(W, SD).n) and the operands of the large ones in `scratch`
// (decoder_wgrad.cuh's layout); wpack: as K2's. P
// blocks (<= the SMs) each take tiles_per_block tiles.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int decoder_backward(const float* x, const float* g,
                                const void* const* params, void* wpack,
                                float* dx, float* slab, void* scratch,
                                long long N, int P, int tiles_per_block,
                                int want_wgrad, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decoder_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K3_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = pk::pack(params_from(params), static_cast<bf16*>(wpack), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  decoder_backward_kernel<<<P, wd::THREADS, K3_SMEM, stream>>>(
      x, g, static_cast<bf16*>(wpack), dx, slab, static_cast<bf16*>(scratch),
      N, tiles_per_block, want_wgrad);
  return static_cast<int>(cudaGetLastError());
}
