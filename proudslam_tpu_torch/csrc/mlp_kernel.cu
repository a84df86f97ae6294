// Fused decoder forward (kernel K2) and backward (kernel K3) of the port.
//
// K2 replaces the TPU kernel `_fwd_kernel` of
// proudslam_tpu/ops/pallas/mlp_kernel.py (`_run_fwd`, bf16=True): inputs x
// (N, D) f32 -> out (N, 4) f32 [sigmoid(rgb), sdf], the five products with
// bf16 operands and f32 sums. What bounds it on an H100: arithmetic (~108k
// flops per row against 80 bytes of input and output), so everything but x
// and out stays on chip and the products run on the tensor cores. K2 has
// K1's block shape and runs K1's decoder (`tc::decode`, decoder_chain.cuh),
// without the blend: a persistent block of two warpgroups holds the
// weights in shared memory as bf16 wgmma tiles for its whole life, each
// warpgroup walks its own 64-row tiles (tile = 2 block + warpgroup, stride
// 2 grid), and the layers chain through registers, so only x goes through
// shared memory. The next tile's x (64 x 16 f32 = 4 KB, contiguous) is
// staged with 16-byte cp.async copies into the warpgroup's f32 buffer
// right after this tile's x is in place, while this tile's products run;
// at the next tile it is rounded to bf16 into the tile layout. cp.async
// rather than a bulk TMA copy: it needs no mbarrier or phase bookkeeping,
// a thread copies just the 32 bytes it later converts, and the ragged last
// tile is masked per row (missing rows are zeros and write nothing), the
// way K1's gather already works. x is rounded as K1 rounds its blended
// features (`pack_bf16x2`), so K2 on K1's f32 `feats` gives K1's `out` bit
// for bit.
//
// K3 replaces the TPU kernel `_bwd_kernel` of
// proudslam_tpu/ops/pallas/mlp_kernel.py (`_run_bwd`, bf16=True): per tile
// of rows it recomputes the decoder forward, then back-propagates the
// cotangent g (N, 4) [r, g, b, sdf] to dx (N, D) and to all 11 weight and
// bias gradients. Rounding points follow the TPU kernel exactly: every
// product operand, cotangents included, is rounded to bf16 and the products
// are summed in f32; the bias gradients are f32 sums of the unrounded
// cotangents; ReLU masks come from the forward activations.
//
// What bounds it on an H100: arithmetic again (~2 x 108k flops per row:
// forward recompute and input gradients; the weight gradients' products
// run in a second pass). The products run on the tensor cores (`wgmma`,
// decoder_tc.cuh). A block of two warpgroups works on one 64-row tile at a
// time: every 128-wide product of the forward and of the input-gradient
// chain is split by output columns (each warpgroup one m64n64 half); dx is
// split into two m64n8 halves. The tile's bf16 activations and cotangents
// live in shared memory in wgmma's layout, next to the bf16 weights (~200
// KB in all), and each is read in place as the next product's A (K-major).
// The odd widths run on the FMA units: the color head and its 3-wide
// gradients, the sdf column of ws and its rank-1 term in dh2.
//
// The weight gradients (decoder_wgrad.cuh): this kernel is pass 1. It sums
// the six small ones (bias sums, dwo, ws's sdf column) over its tiles into
// its block's f32 slab (P blocks, P <= the SM count, each a contiguous run
// of tiles), and stores each tile's bf16 operands of the five large ones
// (x, h1, h2, feat, dhc, dfeat, dh2, dh1) in the scratch, as the tiles are
// (16-byte stores of the shared-memory tiles, each once it is complete and
// before it is overwritten); pass 2 (mlp_wgrad.cu) sums those products and
// a fixed-order reduce the slabs: no float atomics, so the gradients are
// bitwise repeatable from run to run, which lockstep comparisons rely on.
// dx-only (want_wgrad 0) stores nothing. A ragged last tile is masked: its
// missing rows carry zero inputs and zero cotangents (so they add nothing
// to any gradient) and write no dx.

#include "decoder_chain.cuh"
#include "decoder_wgrad.cuh"

using namespace dec;

namespace {

// the resident plan; every other size builds the streamed sources
// (render_stream.cu, mlp_stream.cu)
static_assert(D == 16 && dec::W == 128 && dec::SD == 128,
              "this plan holds the (16, 128, 128) decoder's weights");

// ---- K3: the decoder backward on the tensor cores ----

constexpr int K3_THREADS = 2 * tc::WG;
constexpr int ACT = tc::TR * W;            // bf16 activation tile (TR, W)
constexpr int NBIAS = 4;                   // bias gradients summed per tile
constexpr int K3_SMEM = tc::TC_WEIGHT_SMEM + pad16(tc::TR * D * 2)
                        + 5 * pad16(ACT * 2) + pad16(tc::TR * 4 * 4)
                        + pad16(NBIAS * 8 * 64 * 4);

// the block's slab of small gradients
using SG = wg::SmallAt<W, SD>;

__device__ __forceinline__ void put(float* p, float v, bool first) {
  *p = first ? v : *p + v;
}

// acc = A (TR x 16*KS, K-major tile) times B's 64 columns at db (TB = 1:
// B is MN-major, the transposed weight of the backward)
template <int KS, int TB>
__device__ __forceinline__ void prod_n64(float (&acc)[32], uint64_t da,
                                         uint64_t db, uint64_t bstep) {
  tc::fence_regs(acc);
  tc::wg_fence();
#pragma unroll
  for (int j = 0; j < KS; ++j)
    tc::mma_m64n64<0, TB>(acc, da + j * tc::KSTEP_K, db + j * bstep, j > 0);
  tc::wg_commit();
  tc::wg_wait_all();
  tc::fence_regs(acc);
}

// Thread (warp w of its warpgroup, lane l) holds the m64n64 entries
// acc[4i + e] at row r0 + 8 (e / 2), column nb + 8i + 2 (l % 4) + e % 2.
struct Lane {
  int r0, c2, nb;   // first row, 2 (l % 4), the warpgroup's first column
};

// dst (tile layout, W columns) <- bf16(act(acc + bias))
__device__ __forceinline__ void store_tile(bf16* dst, const float (&acc)[32],
                                           const float* bias, bool relu,
                                           const Lane& ln) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = ln.nb + 8 * i + ln.c2;
    const float2 b = bias ? *reinterpret_cast<const float2*>(bias + col)
                          : make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * i + 2 * h] + b.x, v1 = acc[4 * i + 2 * h + 1] + b.y;
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      *reinterpret_cast<uint32_t*>(dst + tc::tofs(ln.r0 + 8 * h, col, W)) =
          tc::pack_bf16x2(v0, v1);
    }
  }
}

// acc *= (act > 0), the ReLU derivative from the forward tile
__device__ __forceinline__ void relu_mask(float (&acc)[32], const bf16* act,
                                          const Lane& ln) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 a = tc::unpack_bf16x2(*reinterpret_cast<const uint32_t*>(
          act + tc::tofs(ln.r0 + 8 * h, ln.nb + 8 * i + ln.c2, W)));
      if (!(a.x > 0.f)) acc[4 * i + 2 * h] = 0.f;
      if (!(a.y > 0.f)) acc[4 * i + 2 * h + 1] = 0.f;
    }
}

// Column sums of acc over this warp's 16 rows (f32, unrounded) into
// cs[warp][64]; at the end of the tile the four warps of each warpgroup
// are summed in a fixed order.
__device__ __forceinline__ void col_sums(const float (&acc)[32], float* cs) {
  const int l = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = acc[4 * i + e] + acc[4 * i + 2 + e];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (l < 4) cs[warp * 64 + 8 * i + 2 * l + e] = s;
    }
}

__global__ void __launch_bounds__(K3_THREADS, 1)
decoder_backward_kernel(const float* __restrict__ x,
                        const float* __restrict__ g, Params prm,
                        float* __restrict__ dx, float* __restrict__ partial,
                        bf16* __restrict__ scratch, long long N,
                        int tiles_per_block, int want_wgrad) {
  extern __shared__ __align__(16) char smem[];
  Arena arena{smem};
  tc::TcWeights w;
  tc::carve_weights(arena, w);
  bf16* xs = arena.take<bf16>(tc::TR * D);
  bf16* h1 = arena.take<bf16>(ACT);
  bf16* h2 = arena.take<bf16>(ACT);     // later dh1
  bf16* feat = arena.take<bf16>(ACT);   // later dso[:, :W] = dfeat
  bf16* hc = arena.take<bf16>(ACT);     // later dh2
  bf16* dhc = arena.take<bf16>(ACT);
  float* rowv = arena.take<float>(tc::TR * 4);   // [dzo (3) | g_sdf]
  float* cs = arena.take<float>(NBIAS * 8 * 64);
  tc::load_weights(w, prm);

  const int tid = threadIdx.x, wg = tid / tc::WG, l = tid & 31;
  const Lane ln{16 * ((tid % tc::WG) >> 5) + (l >> 2), 2 * (l & 3), 64 * wg};
  float* slab = partial + static_cast<long long>(blockIdx.x) * SG::n;
  const long long ntiles = (N + tc::TR - 1) / tc::TR;
  // tile `tile` of operand `op` in the scratch
  auto at = [&](int op, long long tile) {
    return scratch + wg::offset(op, tile, D, W, SD);
  };
  const long long tile0 = static_cast<long long>(blockIdx.x) * tiles_per_block;
  const long long tile1 = min(ntiles, tile0 + tiles_per_block);
  const uint64_t kmn = tc::kstep_mn(W);
  float acc[32];

  for (long long tile = tile0; tile < tile1; ++tile) {
    const bool first = tile == tile0;
    const long long row0 = tile * tc::TR;
    const int nvalid = static_cast<int>(min(static_cast<long long>(tc::TR), N - row0));

    // inputs: thread (r, q) = (tid / 4, tid % 4) takes x[r, 4q:4q+4] (bf16)
    // and keeps g[r, q]; missing rows are zeros
    const int r = tid >> 2, q = tid & 3;
    float gv = 0.f;
    {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nvalid) {
        v = *reinterpret_cast<const float4*>(x + (row0 + r) * D + 4 * q);
        gv = g[(row0 + r) * 4 + q];
      }
      *reinterpret_cast<uint2*>(xs + tc::tofs(r, 4 * q, D)) =
          make_uint2(tc::pack_bf16x2(v.x, v.y), tc::pack_bf16x2(v.z, v.w));
    }
    tc::fence_proxy_async();
    __syncthreads();
    if (want_wgrad && tid == 0) wg::store(at(wg::X, tile), xs, 2 * tc::TR * D);

    // forward recompute: h1, h2, feat, hc (bf16, shared memory)
    prod_n64<1, 0>(acc, tc::desc_k(xs, D),
                   tc::desc_k(w.w1 + tc::tofs(ln.nb, 0, D), D), tc::KSTEP_K);
    store_tile(h1, acc, w.b1, true, ln);
    tc::fence_proxy_async();
    __syncthreads();
    if (want_wgrad && tid == 0) wg::store(at(wg::H1, tile), h1, 2 * ACT);
    prod_n64<8, 0>(acc, tc::desc_k(h1, W),
                   tc::desc_k(w.w2 + tc::tofs(ln.nb, 0, W), W), tc::KSTEP_K);
    store_tile(h2, acc, w.b2, true, ln);
    tc::fence_proxy_async();
    __syncthreads();
    if (want_wgrad && tid == 0) wg::store(at(wg::H2, tile), h2, 2 * ACT);
    prod_n64<8, 0>(acc, tc::desc_k(h2, W),
                   tc::desc_k(w.ws + tc::tofs(ln.nb, 0, W), W), tc::KSTEP_K);
    store_tile(feat, acc, w.bs, false, ln);
    tc::fence_proxy_async();
    __syncthreads();
    if (want_wgrad && tid == 0) wg::store(at(wg::FEAT, tile), feat, 2 * ACT);
    {
      const uint64_t da = tc::desc_k(feat, W);
      const uint64_t db = tc::desc_k(w.wc_f + tc::tofs(ln.nb, 0, W), W);
      tc::fence_regs(acc);
      tc::wg_fence();
#pragma unroll
      for (int j = 0; j < 8; ++j)
        tc::mma_m64n64<0, 0>(acc, da + j * tc::KSTEP_K, db + j * tc::KSTEP_K,
                             j > 0);
      tc::mma_m64n64<0, 0>(acc, tc::desc_k(xs, D),
                           tc::desc_k(w.wc_x + tc::tofs(ln.nb, 0, D), D), 1);
      tc::wg_commit();
      tc::wg_wait_all();
      tc::fence_regs(acc);
    }
    store_tile(hc, acc, w.bc, true, ln);
    __syncthreads();

    // color head and dzo = g_rgb * rgb * (1 - rgb): thread (r, q) sums
    // hc[r, 32q:32q+32] . wo over its quarter, the four quarters are
    // summed across lanes; rowv[r] = [dzo (3) | g_sdf] in f32
    {
      float p[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            hc + tc::tofs(r, 32 * q + 8 * m, W));
        const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 h = tc::unpack_bf16x2(u[k]);
          const float* wo = w.wo + 4 * (32 * q + 8 * m + 2 * k);
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
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* wo = w.wo + 4 * (ln.nb + 8 * i + ln.c2 + (e & 1));
          const float* d = dz[e >> 1];
          acc[4 * i + e] = fmaf(d[2], wo[2], fmaf(d[1], wo[1], d[0] * wo[0]));
        }
    }
    relu_mask(acc, hc, ln);
    store_tile(dhc, acc, nullptr, false, ln);
    if (want_wgrad) {
      col_sums(acc, cs);                                  // dbc
      // dwo[k][c] = sum_r hc[r][k] dzo[r][c]; dbo[c] = sum_r dzo[r][c]
      for (int e = tid; e < W * 3; e += K3_THREADS) {
        const int k = e / 3, c = e - 3 * k;
        float s = 0.f;
        for (int rr = 0; rr < tc::TR; ++rr)
          s = fmaf(__bfloat162float(hc[tc::tofs(rr, k, W)]),
                   tc::rbf(rowv[rr * 4 + c]), s);
        put(slab + SG::wo + e, s, first);
      }
      if (tid < 3) {
        float s = 0.f;
        for (int rr = 0; rr < tc::TR; ++rr) s += rowv[rr * 4 + tid];
        put(slab + SG::bo + tid, s, first);
      }
    }
    tc::fence_proxy_async();
    __syncthreads();
    if (want_wgrad && tid == 0) wg::store(at(wg::DHC, tile), dhc, 2 * ACT);

    // dfeat = dhc wc_f^T; dso = [dfeat | g_sdf]
    prod_n64<8, 1>(acc, tc::desc_k(dhc, W),
                   tc::desc_mn(w.wc_f + tc::tofs(0, ln.nb, W), W), kmn);
    if (want_wgrad) {
      col_sums(acc, cs + 8 * 64);                         // dbs[:W]
      if (tid == 0) {
        float s = 0.f;
        for (int rr = 0; rr < tc::TR; ++rr) s += rowv[rr * 4 + 3];
        put(slab + SG::bs + SD, s, first);
      }
    }
    if (want_wgrad && tid == 0) wg::stored_read();      // feat's store read
    __syncthreads();                                      // feat's last reader done
    bf16* dso = feat;
    store_tile(dso, acc, nullptr, false, ln);
    tc::fence_proxy_async();
    __syncthreads();
    if (want_wgrad && tid == 0) wg::store(at(wg::DFEAT, tile), dso, 2 * ACT);

    // dh2 = (dso ws^T) * (h2 > 0): the 128 feature columns on the tensor
    // cores, the sdf column's rank-1 term g_sdf ws[:, W]^T on the FMA units
    prod_n64<8, 1>(acc, tc::desc_k(dso, W),
                   tc::desc_mn(w.ws + tc::tofs(0, ln.nb, W), W), kmn);
    {
      const float gs[2] = {tc::rbf(rowv[ln.r0 * 4 + 3]),
                           tc::rbf(rowv[(ln.r0 + 8) * 4 + 3])};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * i + e] = fmaf(gs[e >> 1],
                                w.ws_sdf[ln.nb + 8 * i + ln.c2 + (e & 1)],
                                acc[4 * i + e]);
    }
    relu_mask(acc, h2, ln);
    if (want_wgrad) {
      col_sums(acc, cs + 2 * 8 * 64);                     // db2
      if (tid < W) {                                      // h2^T g_sdf
        float s = 0.f;
        for (int rr = 0; rr < tc::TR; ++rr)
          s = fmaf(__bfloat162float(h2[tc::tofs(rr, tid, W)]),
                   tc::rbf(rowv[rr * 4 + 3]), s);
        put(slab + SG::ws_sdf + tid, s, first);
      }
    }
    bf16* dh2 = hc;                                       // hc's readers are done
    store_tile(dh2, acc, nullptr, false, ln);
    tc::fence_proxy_async();
    if (want_wgrad && tid == 0) wg::stored_read();      // h2's store read
    __syncthreads();
    if (want_wgrad && tid == 0) wg::store(at(wg::DH2, tile), dh2, 2 * ACT);

    // dh1 = (dh2 w2^T) * (h1 > 0)
    prod_n64<8, 1>(acc, tc::desc_k(dh2, W),
                   tc::desc_mn(w.w2 + tc::tofs(0, ln.nb, W), W), kmn);
    relu_mask(acc, h1, ln);
    if (want_wgrad) col_sums(acc, cs + 3 * 8 * 64);     // db1
    bf16* dh1 = h2;                                       // h2's readers are done
    store_tile(dh1, acc, nullptr, false, ln);
    tc::fence_proxy_async();
    __syncthreads();
    if (want_wgrad && tid == 0) wg::store(at(wg::DH1, tile), dh1, 2 * ACT);

    // dx = dh1 w1^T + dhc wc_x^T: warpgroup wg takes columns 8wg..8wg+7
    {
      float d8[4];
      const uint64_t b1 = tc::desc_mn(w.w1 + tc::tofs(0, 8 * wg, D), D);
      const uint64_t bx = tc::desc_mn(w.wc_x + tc::tofs(0, 8 * wg, D), D);
      const uint64_t a1 = tc::desc_k(dh1, W), ax = tc::desc_k(dhc, W);
      tc::fence_regs(d8);
      tc::wg_fence();
#pragma unroll
      for (int j = 0; j < 8; ++j)
        tc::mma_m64n8<0, 1>(d8, a1 + j * tc::KSTEP_K,
                            b1 + j * tc::kstep_mn(D), j > 0);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        tc::mma_m64n8<0, 1>(d8, ax + j * tc::KSTEP_K,
                            bx + j * tc::kstep_mn(D), 1);
      tc::wg_commit();
      tc::wg_wait_all();
      tc::fence_regs(d8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = ln.r0 + 8 * h;
        if (rr < nvalid)
          *reinterpret_cast<float2*>(dx + (row0 + rr) * D + 8 * wg + ln.c2) =
              make_float2(d8[2 * h], d8[2 * h + 1]);
      }
    }
    if (want_wgrad) {
      // the tile's bias gradients: warps' column sums in a fixed order
      if (tid < W) {
        const int half = tid >> 6, col = tid & 63;
        const int off[NBIAS] = {SG::bc, SG::bs, SG::b2, SG::b1};
        float old[NBIAS];
#pragma unroll
        for (int b = 0; b < NBIAS; ++b)
          old[b] = first ? 0.f : slab[off[b] + tid];
#pragma unroll
        for (int b = 0; b < NBIAS; ++b) {
          const float* c = cs + b * 8 * 64 + 4 * half * 64 + col;
          slab[off[b] + tid] = old[b] + (((c[0] + c[64]) + c[128]) + c[192]);
        }
      }
      if (tid == 0) wg::stored_read();    // the tile's stores read
    }
    __syncthreads();
  }
  if (want_wgrad && tid == 0) wg::stored();
}

// ---- K2: the decoder forward on the tensor cores ----

constexpr int K2_THREADS = 2 * tc::WG;      // two warpgroups, own tiles each
constexpr int XSTAGE = tc::TR * D * 4;      // f32 staging of one tile's x
constexpr int XTILE = tc::TR * D;           // bf16 input tile (TR, D)
constexpr int K2_SMEM = tc::TC_WEIGHT_SMEM
                        + 2 * (pad16(XSTAGE) + pad16(XTILE * 2));

// Thread (row, half) of a warpgroup copies x[row, 8 half:8 half + 8] of
// `tile` (32 bytes) into its staging buffer, if the row exists.
__device__ __forceinline__ void stage_x(const float* __restrict__ x,
                                        long long N, long long tile, int row,
                                        int half, float* stage) {
  const long long n = tile * tc::TR + row;
  if (n < N) {
    const float* src = x + n * D + 8 * half;
    float* dst = stage + row * D + 8 * half;
    tc::cp_async16(dst, src);
    tc::cp_async16(dst + 4, src + 4);
  }
  tc::cp_async_commit();
}

__global__ void __launch_bounds__(K2_THREADS, 1)
decoder_forward_kernel(const float* __restrict__ x, Params prm,
                       float* __restrict__ out, long long N) {
  extern __shared__ __align__(16) char smem[];
  Arena arena{smem};
  tc::TcWeights w;
  tc::carve_weights(arena, w);
  float* stages = arena.take<float>(2 * tc::TR * D);
  bf16* xbuf = arena.take<bf16>(2 * XTILE);
  tc::load_weights(w, prm);

  const int wg = threadIdx.x / tc::WG, t = threadIdx.x % tc::WG;
  const int row = t % tc::TR, half = t / tc::TR;
  float* stage = stages + wg * tc::TR * D;
  bf16* xs = xbuf + wg * XTILE;
  const long long ntiles = (N + tc::TR - 1) / tc::TR;
  const long long stride = 2LL * gridDim.x;
  long long tile = 2LL * blockIdx.x + wg;
  if (tile < ntiles) stage_x(x, N, tile, row, half, stage);
  for (; tile < ntiles; tile += stride) {
    tc::cp_async_wait_all();
    // this thread's copies have landed; the barrier also keeps x's tile
    // until every warp's products of the previous tile have finished
    tc::wg_barrier(wg);
    float f[8];
    const float* src = stage + row * D + 8 * half;
    const bool live = tile * tc::TR + row < N;
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = live ? src[i] : 0.f;
    tc::put_x(xs, row, half, f);
    tc::fence_proxy_async();
    tc::wg_barrier(wg);               // x is in place
    if (tile + stride < ntiles) stage_x(x, N, tile + stride, row, half, stage);
    tc::decode(w, xs, out, N, tile, t);
  }
}

}  // namespace

// K2: out (N, 4) from x (N, D); `blocks` persistent blocks of two
// warpgroups (<= ceil(tiles / 2)).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int decoder_forward(const float* x, const void* const* params,
                               float* out, long long N, int blocks,
                               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decoder_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K2_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  decoder_forward_kernel<<<blocks, K2_THREADS, K2_SMEM, stream>>>(
      x, params_from(params), out, N);
  return static_cast<int>(cudaGetLastError());
}

// K3's pass 1: dx (N, D); when want_wgrad the small gradients' slabs
// (P, wg::small(W, SD).n) and the operands of the large ones in `scratch`
// (decoder_wgrad.cuh's layout). P blocks each take
// tiles_per_block tiles.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int decoder_backward(const float* x, const float* g,
                                const void* const* params, float* dx,
                                float* slab, void* scratch, long long N,
                                int P, int tiles_per_block, int want_wgrad,
                                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decoder_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K3_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  decoder_backward_kernel<<<P, K3_THREADS, K3_SMEM, stream>>>(
      x, g, params_from(params), dx, slab, static_cast<bf16*>(scratch), N,
      tiles_per_block, want_wgrad);
  return static_cast<int>(cudaGetLastError());
}
