// Fused decoder forward (kernel K2) and backward (kernel K3) at every decoder
// size other than (16, 128, 128): the streamed plan (decoder_stream.cuh).
//
// K2 replaces the TPU kernel `_fwd_kernel` and K3 `_bwd_kernel` of
// proudslam_tpu/ops/pallas/mlp_kernel.py (`_run_fwd`, `_run_bwd`,
// bf16=True), which take any decoder size; mlp_kernel.cu is the same pair at
// (16, 128, 128), where the weights fit in shared memory. The functions and
// rounding points are mlp_kernel.cu's: K2 maps x (N, D) f32 to out (N, 4)
// [sigmoid(rgb), sdf]; K3 recomputes the forward per tile and returns dx
// (N, D) and, unless dx-only, the 11 parameter gradients summed over all
// rows, every product operand (cotangents included) rounded to bf16, bias
// gradients f32 sums of the unrounded cotangents, ReLU masks from the
// forward activations.
//
// What bounds them on an H100: arithmetic (at (16, 256, 128) ~2 * 140k
// flops per row forward, 3x that for the full backward, against 80 bytes of
// input and output), then the large weights' traffic from L2 (one read per
// 64-row tile forward, two backward). Design:
//   - K2 is K1's block without the blend: persistent blocks of two
//     warpgroups on one tile at a time (tile = block, stride grid), x staged
//     for the next tile with cp.async during this one's decoder, and the
//     decoder is decoder_stream.cuh's `decode`, K1's, so K2 on K1's features
//     gives K1's outputs bit for bit;
//   - K3: each of P blocks (<= the SM count) walks a contiguous run of tiles
//     and adds each tile's weight gradients into its own f32 slab, and
//     reduce_partials_kernel (decoder_slab.cuh) sums the slabs in a fixed
//     order: no float atomics, bitwise repeatable. Per tile it recomputes
//     h1, h2, feat and hc into shared-memory tiles (hc in the tile that then
//     holds dhc), then the backward chain, each streamed product giving 64
//     finished columns per chunk, written in place over the forward tile
//     whose ReLU mask it takes once that tile's weight gradient is done
//     (dso over feat, dh2 over h2, dh1 over h1). The weight gradients
//     (act^T cot, K = the tile's 64 rows) are split into 64 x 64 pieces
//     over the two warpgroups; the bias gradients' per-warp column
//     sums are folded into the slab in a fixed order after each product, so
//     one 4 x W buffer serves all four. Four bf16 tiles of width W or SD
//     beside the ring fit a block up to (16, 256, 256) (229,424 bytes) and,
//     with the ring's 32-row chunks of in_dim 32, up to (32, 256, 256)
//     (215,088 bytes).
// At in_dim 32 a row's inputs are two chunks of 16 floats (each thread
// loads and rounds one 4-float piece of each), the x-side products take
// two k16 steps, and dx's and the x-side weight gradients' products are 16
// columns wider; every other product is the in_dim-16 one. At in_dim 64
// w1 and wc_x stream through the ring (decoder_stream.cuh; resident, they
// would take K3's block to 251,952 bytes at (64, 256, 256), 186,416
// streamed): the x-side forward products take their two chunks each, dx
// takes w1's and wc_x's chunks in turn, each pair giving 32 finished
// columns, and the weight gradients run in pieces of 64 x 32
// (decoder_rows.cuh), which keeps K3 within 255 registers at width 256.
// In_dim 128 runs the wide plan (mlp_wide.cu).
// A ragged last tile is masked: its missing rows carry zero inputs and zero
// cotangents (they add nothing to any gradient) and write no output.

#include "decoder_rows.cuh"
#include "decoder_slab.cuh"

using namespace dec;
using st::HALF;
using st::Lane;
using st::col_sums;
using st::fold;
using st::put;
using st::stage_x;
using st::wgrad;
using st::wgrad_x;

namespace {

// ---- K2 ----

constexpr int K2_SMEM = tc::TC_SMALL_SMEM + st::RING_SMEM
                        + 2 * pad16(tc::TR * W * 2) + pad16(tc::TR * D * 2)
                        + pad16(tc::TR * D * 4) + st::PART_SMEM;
static_assert(K2_SMEM <= 232448, "one block's shared memory");
static_assert(D <= 64, "in_dim 128 runs the wide plan (mlp_wide.cu)");

__global__ void __launch_bounds__(st::THREADS, 1)
decoder_forward_kernel(const float* __restrict__ x, Params prm,
                       const bf16* wpack, float* __restrict__ out,
                       long long N) {
  extern __shared__ __align__(16) char smem[];
  Arena arena{smem};
  tc::TcWeights w;
  tc::carve_small(arena, w);
  st::Ring ring = st::ring_init(arena, wpack, st::NFWD);
  bf16* hA = arena.take<bf16>(tc::TR * W);
  bf16* hB = arena.take<bf16>(tc::TR * W);
  bf16* xs = arena.take<bf16>(tc::TR * D);
  float* stage = arena.take<float>(tc::TR * D);
  float* part = arena.take<float>(2 * tc::TR * 4);
  tc::load_weights(w, prm);                 // ends with a barrier

  const int row = threadIdx.x >> 2, q = threadIdx.x & 3;
  const long long ntiles = (N + tc::TR - 1) / tc::TR;
  long long tile = blockIdx.x;
  if (tile < ntiles) {
    st::ring_start(ring);
    stage_x(x, N, tile, stage);
  }
  for (; tile < ntiles; tile += gridDim.x) {
    const bool more = tile + gridDim.x < ntiles;
    tc::cp_async_wait_all();
    // every thread's copy has landed; the barrier also keeps x's tile until
    // the previous tile's products have finished
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
    tc::fence_proxy_async();
    __syncthreads();                  // x is in place; the stage is free
    if (more) stage_x(x, N, tile + gridDim.x, stage);
    st::decode(w, xs, hA, hB, part, ring, more, out, N, tile);
  }
}

// ---- K3 ----

// (w1 and wc_x stream at in_dim 64: decoder_stream.cuh)
constexpr int K3_SMEM = tc::TC_SMALL_SMEM - (st::NX > 0 ? tc::TC_X_SMEM : 0)
                        + st::RING_SMEM
                        + pad16(tc::TR * D * 2) + 3 * pad16(tc::TR * W * 2)
                        + pad16(tc::TR * SD * 2) + pad16(tc::TR * 4 * 4)
                        + pad16(4 * W * 4);
static_assert(K3_SMEM <= 232448, "one block's shared memory");

__global__ void __launch_bounds__(st::THREADS, 1)
decoder_backward_kernel(const float* __restrict__ x,
                        const float* __restrict__ g, Params prm,
                        const bf16* wpack, float* __restrict__ dx,
                        float* __restrict__ partial, long long N,
                        int tiles_per_block, int want_wgrad) {
  extern __shared__ __align__(16) char smem[];
  Arena arena{smem};
  tc::TcWeights w;
  tc::carve_small<st::NX == 0>(arena, w);
  st::Ring ring = st::ring_init(arena, wpack, 2 * st::NFWD3);
  bf16* xs = arena.take<bf16>(tc::TR * D);
  bf16* h1 = arena.take<bf16>(tc::TR * W);    // later dh1
  bf16* h2 = arena.take<bf16>(tc::TR * W);    // later dh2
  bf16* dhc = arena.take<bf16>(tc::TR * W);   // hc, then dhc
  bf16* feat = arena.take<bf16>(tc::TR * SD); // later dso[:, :SD]
  float* rowv = arena.take<float>(tc::TR * 4);   // [dzo (3) | g_sdf]
  float* cs = arena.take<float>(4 * W);
  tc::load_weights<st::NX == 0>(w, prm);    // ends with a barrier

  const int tid = threadIdx.x, wg = tid / tc::WG;
  const Lane ln = st::lane();
  const int c0 = HALF * wg;
  float* slab = partial + static_cast<long long>(blockIdx.x) * NPARAM;
  const long long ntiles = (N + tc::TR - 1) / tc::TR;
  const long long tile0 = static_cast<long long>(blockIdx.x) * tiles_per_block;
  const long long tile1 = min(ntiles, tile0 + tiles_per_block);
  float acc[W / 4];
  float accs[SD / 4];
  float ac[st::CR / 4];               // a chunk's columns of a cotangent
  if (tile0 < tile1) st::ring_start(ring);

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

    // forward recompute: h1, h2, feat, hc (bf16, shared memory)
    if constexpr (st::NX > 0)
      st::fwd_stream<W, D>(acc, xs, ring, more, false);
    else
      st::product<HALF, 0, 0>(acc, tc::desc_k(xs, D), tc::KSTEP_K,
                              tc::desc_k(w.w1 + tc::tofs(c0, 0, D), D),
                              tc::KSTEP_K, D / 16, false);
    st::store_tile(h1, W, acc, w.b1, true, c0, ln);
    tc::fence_proxy_async();
    st::fwd_stream<W, W>(acc, h1, ring, more, false);
    st::store_tile(h2, W, acc, w.b2, true, c0, ln);
    tc::fence_proxy_async();
    st::fwd_stream<SD, W>(accs, h2, ring, more, false);
    st::store_tile(feat, SD, accs, w.bs, false, SD / 2 * wg, ln);
    tc::fence_proxy_async();
    if constexpr (st::NX > 0)
      st::fwd_stream<W, D>(acc, xs, ring, more, false);
    else
      st::product<HALF, 0, 0>(acc, tc::desc_k(xs, D), tc::KSTEP_K,
                              tc::desc_k(w.wc_x + tc::tofs(c0, 0, D), D),
                              tc::KSTEP_K, D / 16, false);
    st::fwd_stream<W, SD>(acc, feat, ring, more, true);
    st::store_tile(dhc, W, acc, w.bc, true, c0, ln);    // hc
    __syncthreads();

    // color head and dzo = g_rgb * rgb * (1 - rgb): thread (r, q) sums
    // hc[r, q W/4 : (q + 1) W/4] . wo, the four quarters are summed across
    // lanes; rowv[r] = [dzo (3) | g_sdf] in f32
    {
      float p[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < W / 32; ++m) {
        const int k0 = q * (W / 4) + 8 * m;
        const uint4 v = *reinterpret_cast<const uint4*>(dhc + tc::tofs(r, k0, W));
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

    // dhc = (dzo wo^T) * (hc > 0), on the FMA units
    {
      float dz[2][3];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          dz[h][c] = tc::rbf(rowv[(ln.r0 + 8 * h) * 4 + c]);
#pragma unroll
      for (int i = 0; i < W / 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* wo = w.wo + 4 * (c0 + 8 * i + ln.c2 + (e & 1));
          const float* d = dz[e >> 1];
          acc[4 * i + e] = fmaf(d[2], wo[2], fmaf(d[1], wo[1], d[0] * wo[0]));
        }
    }
    st::relu_mask(acc, dhc, W, c0, ln);
    if (want_wgrad) {
      col_sums(acc, cs, c0);                              // dbc
      // dwo[k][c] = sum_r hc[r][k] dzo[r][c]; dbo[c] = sum_r dzo[r][c]
      for (int e = tid; e < W * 3; e += st::THREADS) {
        const int k = e / 3, c = e - 3 * k;
        float s = 0.f;
        for (int rr = 0; rr < tc::TR; ++rr)
          s = fmaf(__bfloat162float(dhc[tc::tofs(rr, k, W)]),
                   tc::rbf(rowv[rr * 4 + c]), s);
        put(slab + OFF_WO + e, s, first);
      }
      if (tid < 3) {
        float s = 0.f;
        for (int rr = 0; rr < tc::TR; ++rr) s += rowv[rr * 4 + tid];
        put(slab + OFF_BO + tid, s, first);
      }
    }
    __syncthreads();                  // hc's readers are done
    if (want_wgrad) fold(cs, slab + OFF_BC, W, first);
    st::store_tile(dhc, W, acc, nullptr, false, c0, ln);
    tc::fence_proxy_async();
    __syncthreads();                  // dhc is in place; cs is free

    if (want_wgrad) {
      wgrad<SD, W>(feat, dhc, slab + S_WCF, first, ln);   // feat^T dhc
      wgrad_x<W>(dhc, xs, slab + OFF_WCX, first, ln);     // x^T dhc
      if (tid == 0) {
        float s = 0.f;
        for (int rr = 0; rr < tc::TR; ++rr) s += rowv[rr * 4 + 3];
        put(slab + S_BS + SD, s, first);
      }
    }

    // dso[:, :SD] = dfeat = dhc wc_f^T, over feat (its readers are done at
    // the first chunk's barrier)
#pragma unroll 1
    for (int c = 0; c < st::NWC; ++c) {
      const bf16* wc = st::acquire(ring, more);
      st::bwd_chunk<W>(ac, dhc, wc);
      const int col0 = st::CR * c + st::CR / 2 * wg;
      if (want_wgrad) col_sums(ac, cs, col0);            // dbs[:SD]
      st::store_tile(feat, SD, ac, nullptr, false, col0, ln);
    }
    tc::fence_proxy_async();
    __syncthreads();                  // dso is in place
    if (want_wgrad) {
      fold(cs, slab + S_BS, SD, first);
      wgrad<W, SD>(h2, feat, slab + OFF_WS, first, ln);   // h2^T dso[:, :SD]
      if (tid < W) {                                      // h2^T g_sdf
        float s = 0.f;
        for (int rr = 0; rr < tc::TR; ++rr)
          s = fmaf(__bfloat162float(h2[tc::tofs(rr, tid, W)]),
                   tc::rbf(rowv[rr * 4 + 3]), s);
        put(slab + S_WS_SDF + tid, s, first);
      }
    }

    // dh2 = (dso ws^T) * (h2 > 0), over h2: the SD feature columns on the
    // tensor cores, the sdf column's rank-1 term g_sdf ws[:, SD]^T on the
    // FMA units
    const float gs[2] = {tc::rbf(rowv[ln.r0 * 4 + 3]),
                         tc::rbf(rowv[(ln.r0 + 8) * 4 + 3])};
#pragma unroll 1
    for (int c = 0; c < st::NWS; ++c) {
      const bf16* ws = st::acquire(ring, more);
      st::bwd_chunk<SD>(ac, feat, ws);
      const int col0 = st::CR * c + st::CR / 2 * wg;
#pragma unroll
      for (int i = 0; i < st::CR / 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ac[4 * i + e] = fmaf(gs[e >> 1],
                               w.ws_sdf[col0 + 8 * i + ln.c2 + (e & 1)],
                               ac[4 * i + e]);
      st::relu_mask(ac, h2, W, col0, ln);
      if (want_wgrad) col_sums(ac, cs, col0);            // db2
      st::store_tile(h2, W, ac, nullptr, false, col0, ln);
    }
    tc::fence_proxy_async();
    __syncthreads();                  // dh2 is in place
    if (want_wgrad) {
      fold(cs, slab + OFF_B2, W, first);
      wgrad<W, W>(h1, h2, slab + OFF_W2, first, ln);      // h1^T dh2
    }

    // dh1 = (dh2 w2^T) * (h1 > 0), over h1
#pragma unroll 1
    for (int c = 0; c < st::NW2; ++c) {
      const bf16* w2 = st::acquire(ring, more);
      st::bwd_chunk<W>(ac, h2, w2);
      const int col0 = st::CR * c + st::CR / 2 * wg;
      st::relu_mask(ac, h1, W, col0, ln);
      if (want_wgrad) col_sums(ac, cs, col0);            // db1
      st::store_tile(h1, W, ac, nullptr, false, col0, ln);
    }
    tc::fence_proxy_async();
    __syncthreads();                  // dh1 is in place
    if (want_wgrad) fold(cs, slab + OFF_B1, W, first);

    // dx = dh1 w1^T + dhc wc_x^T. At in_dim 64 from the chunks of w1 and
    // wc_x in turn: chunk c of each gives columns [CR c, CR c + CR), CR / 2
    // a warpgroup
    if constexpr (st::NX > 0) {
#pragma unroll 1
      for (int c = 0; c < st::NX; ++c) {
        float dd[st::CR / 4];
        st::bwd_chunk<W>(dd, h1, st::acquire(ring, more));
        const bf16* wx = st::acquire(ring, more);
        st::product<st::CR / 2, 0, 1>(
            dd, tc::desc_k(dhc, W), tc::KSTEP_K,
            tc::desc_mn(wx + tc::tofs(0, st::CR / 2 * wg, st::CR), st::CR),
            tc::kstep_mn(st::CR), W / 16, true);
#pragma unroll
        for (int i = 0; i < st::CR / 16; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rr = ln.r0 + 8 * h;
            if (rr < nvalid)
              *reinterpret_cast<float2*>(
                  dx + (row0 + rr) * D + st::CR * c + st::CR / 2 * wg
                  + 8 * i + ln.c2) =
                  make_float2(dd[4 * i + 2 * h], dd[4 * i + 2 * h + 1]);
          }
      }
    } else {                          // warpgroup wg: [D / 2 wg, D / 2 (wg + 1))
      float dd[D / 4];
      const int n0 = D / 2 * wg;
      st::product<D / 2, 0, 1>(dd, tc::desc_k(h1, W), tc::KSTEP_K,
                               tc::desc_mn(w.w1 + tc::tofs(0, n0, D), D),
                               tc::kstep_mn(D), W / 16, false);
      st::product<D / 2, 0, 1>(dd, tc::desc_k(dhc, W), tc::KSTEP_K,
                               tc::desc_mn(w.wc_x + tc::tofs(0, n0, D), D),
                               tc::kstep_mn(D), W / 16, true);
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
    if (want_wgrad) wgrad_x<W>(h1, xs, slab + OFF_W1, first, ln);   // x^T dh1
    __syncthreads();
  }
}

}  // namespace

// K2: out (N, 4) from x (N, D); `blocks` persistent blocks of two
// warpgroups (<= tiles). wpack: scratch of st::PACKED bf16.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int decoder_forward(const float* x, const void* const* params,
                               void* wpack, float* out, long long N,
                               int blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decoder_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K2_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params prm = params_from(params);
  err = st::pack_weights(prm, static_cast<bf16*>(wpack), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  decoder_forward_kernel<<<blocks, st::THREADS, K2_SMEM, stream>>>(
      x, prm, static_cast<const bf16*>(wpack), out, N);
  return static_cast<int>(cudaGetLastError());
}

// K3: dx (N, D); dparams (NPARAM,) in FusedParams order when want_wgrad;
// partial: (P, NPARAM) scratch; wpack: scratch of st::PACKED bf16. P blocks
// each take tiles_per_block tiles.
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
  err = st::pack_weights(prm, static_cast<bf16*>(wpack), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  decoder_backward_kernel<<<P, st::THREADS, K3_SMEM, stream>>>(
      x, g, prm, static_cast<const bf16*>(wpack), dx, partial, N,
      tiles_per_block, want_wgrad);
  err = cudaGetLastError();
  if (err != cudaSuccess || !want_wgrad) return static_cast<int>(err);
  reduce_partials_kernel<<<(NPARAM + 255) / 256, 256, 0, stream>>>(
      partial, dparams, P);
  return static_cast<int>(cudaGetLastError());
}
