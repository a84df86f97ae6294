// The wide plan of the bf16 decoder kernels K1 (render_wide.cu), K2 and K3
// (mlp_wide.cu): the decoder sizes of width 384 and 512 (sdf_dim 128 to the
// width, a multiple of 128), built with -DDEC_W > 256, and every size of
// in_dim 128 (widths 128 to 512). The parked plan of widths 768 and 1024
// (decoder_park.cuh) takes its packing, ring and products from here.
//
// Why another plan. The streamed plan (decoder_stream.cuh) splits each
// product's output columns between the block's two warpgroups, one m64nN
// accumulator of N = W / 2 columns each, and keeps w1 and wc_x resident. At
// width 512 that accumulator would be m64n256, 128 registers a thread (K3
// already uses 242-255 at width 256), and K1's block would take ~350 KB of
// shared memory, K3's ~455 KB, against the 232,448 bytes a block may use.
// So here:
//   - every weight streams through the ring, w1 and wc_x too, in chunks of
//     CR = 64 input rows (D for w1 and wc_x) by NP = 128 output columns:
//     16 KB a slot, a 32 KB ring. A forward product runs in passes of NP
//     output columns (NP / 2 per warpgroup: an m64n64 accumulator, 32
//     registers), each pass a sum over its K / CR chunks; a backward
//     product (dy w^T) takes the chunks of a row block c, one per pass, and
//     sums them into the row block's CR finished columns (CR / 2 per
//     warpgroup). The chunks are packed (pack_weights_kernel) in the
//     backward's order, row block by row block, so the forward reads them
//     strided and every weight is read once per product;
//   - only the f32 vectors stay resident (~18 KB at width 512), beside two
//     (TR, W) bf16 activation tiles (128 KB at width 512);
//   - K3 keeps two activation tiles, not four: it parks h1 and h2 as bf16
//     tiles in a per-block scratch in global memory (L2: 128 KB a block at
//     width 512) as it computes them, and loads each back over a tile that
//     has fallen free when its weight gradient and ReLU mask are due (see
//     mlp_wide.cu);
//   - K1 keeps no gather buffer: each thread loads its sample's corners for
//     the next tile into registers before this tile's decoder (render_wide
//     .cu);
//   - at in_dim 128 a w1 or wc_x chunk of all D input rows (32 KB) would
//     not fit a slot, so those come as XC = 2 chunks of XR = 64 input rows
//     for each pass of 128 columns: an x-side forward pass sums its two
//     K-slices into one accumulator, and dx takes XR / 2 columns of each
//     chunk a warpgroup (dx_passes2). The streamed plan does not reach
//     in_dim 128 at width 256: its K1 and K2, with w1 and wc_x streamed
//     too, hold 64-column accumulators per warpgroup beside the ring's
//     state and spilled at (128, 256, 256) in every variant tried (52-600
//     bytes), while this plan's 32-register accumulators leave room.
// The rounding points are the other plans': every product operand bf16
// (round to nearest even), f32 sums; K1 and K2 run one `decode`, so K2 on
// K1's features gives K1's outputs bit for bit. A wait on a ring slot that
// does not complete within 2 s traps (a launch error, never a hang).
#pragma once

#include "bulk_copy.cuh"
#include "decoder_stream.cuh"

namespace wd {

using dec::bf16;
using dec::D;
using dec::SD;
using dec::SO;
using dec::W;
using dec::pad16;
using st::Lane;
using tc::TR;
using tc::WG;

constexpr int THREADS = 2 * WG;            // two warpgroups on one tile
constexpr int NP = 128;                    // output columns of a chunk (a pass)
constexpr int CR = 64;                     // input rows of a w2, ws or wc_f chunk
constexpr int PW = W / NP, PS = SD / NP;   // passes over W and SD columns
constexpr int KW = W / CR, KS = SD / CR;   // row blocks of W and SD inputs
constexpr int SLOT = CR * NP;              // bf16 elements of a ring slot
constexpr int RING_SMEM = 2 * SLOT * 2 + 16;   // two slots, two mbarriers
static_assert((W > 256 || D > 64) && W <= 1024 && W % NP == 0
                  && SD % NP == 0 && SD <= W,
              "the wide plan: width 384 to 1024 or in_dim 128, widths "
              "multiples of 128 (above 512 decoder_park.cuh's kernels)");
// input rows of a w1 or wc_x chunk (all D up to in_dim 64), and the
// chunks of a pass
constexpr int XR = D > 64 ? 64 : D, XC = D / XR;
static_assert(XR * NP <= SLOT, "a w1 or wc_x chunk fits a slot");

// the packed bf16 weights: [w1 | w2 | ws's feature part | wc_f | wc_x]
constexpr int P_W1 = 0, P_W2 = D * W, P_WS = P_W2 + W * W;
constexpr int P_WC = P_WS + W * SD, P_WX = P_WC + SD * W;
constexpr int PACKED = P_WX + D * W;
// K3's park after them: per block, h1 then h2 as (TR, W) tiles
constexpr int PARK = 2 * TR * W;

// chunks of one tile's forward and of K3's backward, in the order taken
constexpr int F_W1 = PW * XC, F_W2 = KW * PW, F_WS = KW * PS;
constexpr int F_HC = PW * (XC + KS);
constexpr int NFWD = F_W1 + F_W2 + F_WS + F_HC;
constexpr int B_WX = PW * XC, B_WC = KS * PW, B_WS = KW * PS, B_W2 = KW * PW;
constexpr int NBWD = B_WX + B_WC + B_WS + B_W2 + PW * XC;

// Where element (k, n) of a weight (input k, output n) goes: the chunk of
// input rows [rows (k / rows), ...) and outputs [NP (n / NP), ...), chunks
// in row-block order with `passes` chunks a row block, each stored as the
// tile (decoder_tc.cuh) of its transpose: rows = NP outputs, cols = `rows`
// inputs.
__host__ __device__ constexpr int place(int rows, int passes, int k, int n) {
  return ((k / rows) * passes + n / NP) * rows * NP
         + tc::tofs(n % NP, k % rows, rows);
}

// f32 FusedParams -> the packed bf16 chunks (round to nearest even)
__global__ void pack_weights_kernel(dec::Params p, bf16* __restrict__ dst) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < PACKED;
       e += gridDim.x * blockDim.x) {
    float v;
    int o;
    if (e < P_W2) {
      v = p.w1[e];
      o = P_W1 + place(XR, PW, e / W, e % W);
    } else if (e < P_WS) {
      const int i = e - P_W2;
      v = p.w2[i];
      o = P_W2 + place(CR, PW, i / W, i % W);
    } else if (e < P_WC) {
      const int i = e - P_WS, k = i / SD, n = i % SD;
      v = p.ws[k * SO + n];
      o = P_WS + place(CR, PS, k, n);
    } else if (e < P_WX) {
      const int i = e - P_WC;
      v = p.wc_f[i];
      o = P_WC + place(CR, PW, i / W, i % W);
    } else {
      const int i = e - P_WX;
      v = p.wc_x[i];
      o = P_WX + place(XR, PW, i / W, i % W);
    }
    dst[o] = __float2bfloat16_rn(v);
  }
}

inline cudaError_t pack_weights(const dec::Params& p, bf16* dst,
                                cudaStream_t stream) {
  pack_weights_kernel<<<(PACKED + 255) / 256, 256, 0, stream>>>(p, dst);
  return cudaGetLastError();
}

// The offset of chunk j of w1's or wc_x's run (pass j / XC, its input
// rows' block j % XC) from the weight's first element
__host__ __device__ constexpr int x_chunk(int j) {
  return ((j % XC) * PW + j / XC) * XR * NP;
}

// Chunk i of a tile's sequence -> its first element and size in the packed
// buffer. Forward: w1 by pass (XC chunks a pass); w2 and ws pass by pass,
// each pass's row blocks in order; then per pass of hc wc_x's chunks and
// wc_f's row blocks. Backward (K3): wc_x by pass (dx's x part), then wc_f,
// ws and w2 row block by row block (each row block's passes in order),
// then w1 by pass.
__device__ inline void chunk_at(int i, int& off, int& n) {
  n = SLOT;
  if (i < F_W1) {
    off = P_W1 + x_chunk(i);
    n = XR * NP;
    return;
  }
  i -= F_W1;
  if (i < F_W2) {
    off = P_W2 + ((i % KW) * PW + i / KW) * SLOT;
    return;
  }
  i -= F_W2;
  if (i < F_WS) {
    off = P_WS + ((i % KW) * PS + i / KW) * SLOT;
    return;
  }
  i -= F_WS;
  if (i < F_HC) {
    const int p = i / (XC + KS), j = i % (XC + KS);
    if (j < XC) {
      off = P_WX + x_chunk(p * XC + j);
      n = XR * NP;
    } else {
      off = P_WC + ((j - XC) * PW + p) * SLOT;
    }
    return;
  }
  i -= F_HC;
  if (i < B_WX) {
    off = P_WX + x_chunk(i);
    n = XR * NP;
    return;
  }
  i -= B_WX;
  if (i < B_WC) {
    off = P_WC + i * SLOT;
    return;
  }
  i -= B_WC;
  if (i < B_WS) {
    off = P_WS + i * SLOT;
    return;
  }
  i -= B_WS;
  if (i < B_W2) {
    off = P_W2 + i * SLOT;
    return;
  }
  i -= B_W2;
  off = P_W1 + x_chunk(i);
  n = XR * NP;
}

// ---- the ring (decoder_stream.cuh's, over chunk_at's sequence) ----

__device__ __forceinline__ bool mbar_test(uint64_t* b, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bulk::saddr(b)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// the wait for a slot's phase; traps after 2 s (a chunk that never comes)
__device__ inline void wait_slot(uint64_t* b, uint32_t parity) {
  if (mbar_test(b, parity)) return;
  const unsigned long long t0 = now_ns();
  while (!mbar_test(b, parity))
    if (now_ns() - t0 > 2000000000ull) __trap();
}

struct Ring {
  bf16* slot;         // two slots of SLOT elements
  uint64_t* bar;      // their mbarriers
  const bf16* src;    // the packed weights
  int len;            // chunks per tile
  int next;           // sequence index of the chunk the next acquire returns
  int cur;            // its slot
  uint32_t phase;     // bit s: the parity slot s completes next
};

// thread 0: the bulk copy of sequence index i into slot s
__device__ __forceinline__ void issue(const Ring& r, int i, int s) {
  int off, n;
  chunk_at(i, off, n);
  bulk::mbar_expect(r.bar + s, n * 2);
  bulk::bulk_copy(r.slot + s * SLOT, r.src + off, n * 2, r.bar + s);
}

__device__ inline Ring ring_init(dec::Arena& ar, const bf16* src, int len) {
  Ring r;
  r.slot = ar.take<bf16>(2 * SLOT);
  r.bar = ar.take<uint64_t>(2);
  r.src = src;
  r.len = len;
  r.next = 0;
  r.cur = 0;
  r.phase = 0;
  if (threadIdx.x == 0) {
    bulk::mbar_init(r.bar);
    bulk::mbar_init(r.bar + 1);
    bulk::mbar_fence_init();
  }
  return r;
}

// thread 0 starts the first tile's first chunk (after the barrier that
// follows ring_init)
__device__ __forceinline__ void ring_start(const Ring& r) {
  if (threadIdx.x == 0) issue(r, 0, 0);
}

// The next chunk of the sequence, once it has landed: st::acquire's
// contract (every thread, after its products that read the other slot and
// its shared-memory writes the coming products read, with
// fence_proxy_async).
__device__ __forceinline__ const bf16* acquire(Ring& r, bool more) {
  __syncthreads();
  const int s = r.cur;
  int nx = r.next + 1;
  bool go = true;
  if (nx == r.len) {
    nx = 0;
    go = more;
  }
  if (threadIdx.x == 0 && go) issue(r, nx, s ^ 1);
  wait_slot(r.bar + s, (r.phase >> s) & 1u);
  r.phase ^= 1u << s;
  r.cur = s ^ 1;
  r.next = nx;
  return r.slot + s * SLOT;
}

// ---- products ----

// pass p's x-side product: acc (this warpgroup's NP / 2 columns) = x w with
// w = w1 or wc_x, its chunk of the pass from the ring (at in_dim 128 its
// XC chunks, each a K-slice of XR input rows)
__device__ __forceinline__ void x_pass(float (&acc)[NP / 4], const bf16* xs,
                                       Ring& r, bool more) {
  const int wg = threadIdx.x / WG;
  if constexpr (XC > 1) {
#pragma unroll 1
    for (int c = 0; c < XC; ++c) {
      const bf16* w = acquire(r, more);
      st::product<NP / 2, 0, 0>(
          acc, tc::desc_k(xs + tc::tofs(0, XR * c, D), D), tc::KSTEP_K,
          tc::desc_k(w + tc::tofs(NP / 2 * wg, 0, XR), XR), tc::KSTEP_K,
          XR / 16, c > 0);
    }
  } else {
    const bf16* w = acquire(r, more);
    st::product<NP / 2, 0, 0>(acc, tc::desc_k(xs, D), tc::KSTEP_K,
                              tc::desc_k(w + tc::tofs(NP / 2 * wg, 0, D), D),
                              tc::KSTEP_K, D / 16, false);
  }
}

// A pass of a forward product with a streamed weight of K inputs: acc =
// (accum ? acc : 0) + a w over the pass's K / CR chunks, a the (TR, K)
// activation tile
template <int K>
__device__ inline void fwd_pass(float (&acc)[NP / 4], const bf16* a, Ring& r,
                                bool more, bool accum) {
  const int wg = threadIdx.x / WG;
#pragma unroll 1
  for (int c = 0; c < K / CR; ++c) {
    const bf16* w = acquire(r, more);
    st::product<NP / 2, 0, 0>(acc, tc::desc_k(a + tc::tofs(0, CR * c, K), K),
                              tc::KSTEP_K,
                              tc::desc_k(w + tc::tofs(NP / 2 * wg, 0, CR), CR),
                              tc::KSTEP_K, CR / 16, accum || c > 0);
  }
}

// A row block of a backward product: acc = dy w[CR c + CR / 2 wg .. + CR / 2,
// :]^T (this warpgroup's CR / 2 of the block's CR output columns) over the
// block's K / NP chunks, dy the (TR, K) cotangent tile
template <int K>
__device__ inline void bwd_block(float (&acc)[CR / 4], const bf16* dy,
                                 Ring& r, bool more) {
  const int wg = threadIdx.x / WG;
#pragma unroll 1
  for (int p = 0; p < K / NP; ++p) {
    const bf16* w = acquire(r, more);
    st::product<CR / 2, 0, 1>(acc, tc::desc_k(dy + tc::tofs(0, NP * p, K), K),
                              tc::KSTEP_K,
                              tc::desc_mn(w + tc::tofs(0, CR / 2 * wg, CR), CR),
                              tc::kstep_mn(CR), NP / 16, p > 0);
  }
}

// dx's part (this warpgroup's D / 2 columns) (+)= dy w^T, w = w1 or wc_x
// over its PW chunks, dy a (TR, W) cotangent tile
__device__ inline void dx_passes(float (&acc)[D / 4], const bf16* dy, Ring& r,
                                 bool more, bool accum) {
  const int wg = threadIdx.x / WG;
#pragma unroll 1
  for (int p = 0; p < PW; ++p) {
    const bf16* w = acquire(r, more);
    st::product<D / 2, 0, 1>(acc, tc::desc_k(dy + tc::tofs(0, NP * p, W), W),
                             tc::KSTEP_K,
                             tc::desc_mn(w + tc::tofs(0, D / 2 * wg, D), D),
                             tc::kstep_mn(D), NP / 16, accum || p > 0);
  }
}

// dx_passes at in_dim 128 (XC chunks a pass): acc[c] (+)= dy w^T on dx's
// columns [XR c + XR / 2 wg, XR c + XR / 2 (wg + 1)), from chunk c of each
// pass
__device__ inline void dx_passes2(float (&acc)[XC][XR / 4], const bf16* dy,
                                  Ring& r, bool more, bool accum) {
  const int wg = threadIdx.x / WG;
#pragma unroll 1
  for (int p = 0; p < PW; ++p)
#pragma unroll
    for (int c = 0; c < XC; ++c) {
      const bf16* w = acquire(r, more);
      st::product<XR / 2, 0, 1>(
          acc[c], tc::desc_k(dy + tc::tofs(0, NP * p, W), W), tc::KSTEP_K,
          tc::desc_mn(w + tc::tofs(0, XR / 2 * wg, XR), XR),
          tc::kstep_mn(XR), NP / 16, accum || p > 0);
    }
}

// ---- the f32 vectors, resident ----

struct Vecs {
  float *ws_sdf;                  // (W): ws[:, SD], bf16-rounded
  float *wo;                      // (W, 4): wo, bf16-rounded, rows padded to 4
  float *b1, *b2, *bc, *bs, *bo;
};

constexpr int VEC_SMEM = pad16(W * 4) + pad16(W * 4 * 4) + 3 * pad16(W * 4)
                         + pad16(SO * 4) + pad16(3 * 4);

__device__ inline Vecs carve_vecs(dec::Arena& ar) {
  Vecs v;
  v.ws_sdf = ar.take<float>(W);
  v.wo = ar.take<float>(W * 4);
  v.b1 = ar.take<float>(W);
  v.b2 = ar.take<float>(W);
  v.bc = ar.take<float>(W);
  v.bs = ar.take<float>(SO);
  v.bo = ar.take<float>(3);
  return v;
}

// global f32 FusedParams -> the vectors; ends with a barrier
__device__ inline void load_vecs(const Vecs& v, const dec::Params& p) {
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    v.ws_sdf[i] = tc::rbf(p.ws[i * SO + SD]);
    v.b1[i] = p.b1[i];
    v.b2[i] = p.b2[i];
    v.bc[i] = p.bc[i];
  }
  for (int i = threadIdx.x; i < W * 4; i += blockDim.x)
    v.wo[i] = (i & 3) < 3 ? tc::rbf(p.wo[(i >> 2) * 3 + (i & 3)]) : 0.f;
  for (int i = threadIdx.x; i < SO; i += blockDim.x) v.bs[i] = p.bs[i];
  if (threadIdx.x < 3) v.bo[threadIdx.x] = p.bo[threadIdx.x];
  __syncthreads();
}

// ---- the forward of K1 and K2 ----

constexpr int PART_SMEM = 2 * TR * 4 * 4;

// st::decode in passes: the decoder of one tile whose input xs (bf16, tile
// layout) is in place and visible to the block; hA and hB are (TR, W) bf16
// tiles; the ring's next chunk is the tile's first. Writes out[tile rows <
// N] = [sigmoid(hc wo + bo), sdf].
__device__ inline void decode(const Vecs& w, const bf16* xs, bf16* hA,
                              bf16* hB, float* part, Ring& r, bool more,
                              float* __restrict__ out, long long N,
                              long long tile) {
  const int wg = threadIdx.x / WG;
  const Lane ln = st::lane();
  const int cw = NP / 2 * wg;            // this warpgroup's columns of a pass
  const bool lead = (threadIdx.x & 3) == 0;
  float acc[NP / 4];

  // h1 = relu(x w1 + b1) -> hA
#pragma unroll 1
  for (int p = 0; p < PW; ++p) {
    x_pass(acc, xs, r, more);
    st::store_tile(hA, W, acc, w.b1, true, NP * p + cw, ln);
  }
  tc::fence_proxy_async();

  // h2 = relu(h1 w2 + b2) -> hB; this thread's part of h2 . ws[:, SD]
  float s0 = 0.f, s1 = 0.f;
#pragma unroll 1
  for (int p = 0; p < PW; ++p) {
    fwd_pass<W>(acc, hA, r, more, false);
    st::store_tile(hB, W, acc, w.b2, true, NP * p + cw, ln);
#pragma unroll
    for (int i = 0; i < NP / 16; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(
          w.ws_sdf + NP * p + cw + 8 * i + ln.c2);
      s0 = fmaf(acc[4 * i], v.x, fmaf(acc[4 * i + 1], v.y, s0));
      s1 = fmaf(acc[4 * i + 2], v.x, fmaf(acc[4 * i + 3], v.y, s1));
    }
  }
  tc::fence_proxy_async();
  s0 = tc::quad_sum(s0);
  s1 = tc::quad_sum(s1);
  if (lead) {
    part[(wg * TR + ln.r0) * 4 + 3] = s0;
    part[(wg * TR + ln.r0 + 8) * 4 + 3] = s1;
  }

  // feat = h2 ws[:, :SD] + bs[:SD] -> hA (h1's readers are done at the
  // first chunk's barrier)
#pragma unroll 1
  for (int p = 0; p < PS; ++p) {
    fwd_pass<W>(acc, hB, r, more, false);
    st::store_tile(hA, SD, acc, w.bs, false, NP * p + cw, ln);
  }
  tc::fence_proxy_async();

  // hc = relu(x wc_x + feat wc_f + bc); this thread's part of hc wo
  float p0[3] = {0.f, 0.f, 0.f}, p1[3] = {0.f, 0.f, 0.f};
#pragma unroll 1
  for (int p = 0; p < PW; ++p) {
    x_pass(acc, xs, r, more);
    fwd_pass<SD>(acc, hA, r, more, true);
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

}  // namespace wd
