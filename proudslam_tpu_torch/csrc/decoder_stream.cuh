// The streamed plan of the bf16 decoder kernels K1 (render_stream.cu), K2
// and K3 (mlp_stream.cu): every decoder size up to width 256 other than
// (16, 128, 128), in_dim 64 at most (in_dim 128 runs the wide plan,
// decoder_wide.cuh, which includes this file for its products).
//
// Why another plan. At (16, 128, 128) a block holds all its bf16 weights in
// shared memory (111 KB, decoder_tc.cuh's TcWeights) and each of its two
// warpgroups chains a 64-row tile's layers through registers
// (decoder_chain.cuh). Neither holds at width 256: the weights take
// ~287 KB at (16, 256, 128), more than a block's 227 KB, and a 64 x 256 f32
// accumulator takes 128 registers a thread before the next layer's operand.
// So here:
//   - the small weights stay resident (w1 and wc_x as bf16 tiles, the f32
//     vectors: ~25 KB at (16, 256, *), ~41 KB at (32, 256, *)), and the
//     three large ones (w2, ws's feature part, wc_f) stream from L2 through
//     a ring of two shared-memory slots, one chunk of CR input rows at a
//     time (CR = 64 at in_dim 16, <= 32 KB; CR = 32 at in_dim 32, <= 16 KB,
//     which leaves room for the doubled w1, wc_x and x tile and K1's
//     doubled gather buffer: at (32, 256, 256) 64-row chunks would take
//     K1's block to 245,808 bytes and K3's to 247,856, over the 232,448 a
//     block may use), each a single bulk copy (`cp.async.bulk`, the Tensor
//     Memory Accelerator) that completes on the slot's mbarrier. The next
//     chunk is in flight while this one's products run; the chunk after the
//     last of a tile is the next tile's first. Per 64-row tile that is one
//     read of the large
//     weights (K1, K2: 256 KB at (16, 256, 128)) or two (K3, forward and
//     backward), from L2: 1.3 GB per K1 launch at the mapping shape, which
//     L2 serves at several TB/s;
//   - at in_dim 64 K3 streams w1 and wc_x through the same ring (D / CR
//     chunks each): resident, they take 64 KB at width 256, and K3's four
//     activation tiles would not fit beside them (251,952 bytes at (64,
//     256, 256)). Its tile then takes w1's chunks first, wc_x's before
//     wc_f's for hc, and for dx w1's and wc_x's chunks again in turn, each
//     pair giving CR finished columns of dx. K1 and K2 keep them
//     resident (streamed, K1 and K2 sat at the 255-register cap at (64,
//     256, 256) and spilled);
//   - a per-launch pass (pack_weights_kernel) first writes the large
//     weights as bf16 in exactly the chunks' shared-memory layout into a
//     scratch buffer, so each chunk is one contiguous copy;
//   - the block's two warpgroups share one 64-row tile and split every
//     product by its output columns (each m64n(N/2): at most 64 f32
//     accumulator registers a thread at width 256), so the activations go
//     through shared memory as bf16 tiles (decoder_tc.cuh's layout), read
//     K-major as the next product's A and MN-major as a weight-gradient
//     operand. A chunk of weight rows [CR c, CR c + CR) gives the forward
//     product a K-slice (summed over the chunks) and the backward product
//     with the transposed weight CR finished output columns (CR / 2 per
//     warpgroup). Each output is the same sum over the same k16 steps
//     whatever CR is;
//   - the odd widths run on the FMA units as in the resident plan: the sdf
//     column and the 3-wide color head as per-row partial dots, one per
//     warpgroup's columns, added in a fixed order.
// K1 and K2 run one forward (`decode`) on inputs rounded the same way, so K2
// on K1's features gives K1's outputs bit for bit, as in the resident plan.
// The rounding points are the resident plan's and the plain versions':
// every product operand bf16 (round to nearest even), f32 sums.
#pragma once

#include "bulk_copy.cuh"
#include "decoder_chain.cuh"

namespace st {

using dec::bf16;
using dec::D;
using dec::SD;
using dec::SO;
using dec::W;
using dec::pad16;
using tc::TR;
using tc::WG;

constexpr int THREADS = 2 * WG;            // two warpgroups on one tile
constexpr int CR = D == 16 ? 64 : 32;      // weight rows in a chunk
constexpr int NW2 = W / CR, NWS = W / CR, NWC = SD / CR;   // chunks of each
// K3's chunks of w1 and of wc_x at in_dim 64, else none
constexpr int NX = D > 32 ? D / CR : 0;
constexpr int NFWD = NW2 + NWS + NWC;      // chunks of K1's and K2's forward
constexpr int NFWD3 = NFWD + 2 * NX;       // and of K3's
// the packed streamed weights (bf16): [w2 chunks | ws chunks | wc_f chunks
// (| w1 chunks | wc_x chunks)]
constexpr int P_WS = W * W, P_WC = W * W + W * SD;
constexpr int P_X = W * W + W * SD + SD * W;
constexpr int PACKED = W * W + W * SD + SD * W + 2 * NX * CR * W;
// the chunk ids of w1's first chunk and wc_x's (chunk_of)
constexpr int ID_W1 = NW2 + NWS + NWC, ID_WX = ID_W1 + NX;
constexpr int SLOT = CR * W;               // bf16 elements of a ring slot
constexpr int RING_SMEM = 2 * SLOT * 2 + 16;   // two slots, two mbarriers
constexpr int HALF = W / 2;                // a warpgroup's columns of W

// Chunk `id` of the packed weights: rows [CR c, CR c + CR) of w2 (id <
// NW2), of ws's feature part, of wc_f, or (in_dim 64, id >= ID_W1) of w1
// then wc_x, stored as the tile (decoder_tc.cuh) of the chunk's transpose:
// rows = the weight's outputs, cols = the chunk's CR inputs. -> its first
// element and size in the packed buffer.
__device__ __forceinline__ void chunk_of(int id, int& off, int& n) {
  if constexpr (NX > 0) {
    if (id >= ID_W1) {
      off = P_X + (id - ID_W1) * CR * W;
      n = CR * W;
      return;
    }
  }
  if (id < NW2) {
    off = id * CR * W;
    n = CR * W;
  } else if (id < NW2 + NWS) {
    off = P_WS + (id - NW2) * CR * SD;
    n = CR * SD;
  } else {
    off = P_WC + (id - NW2 - NWS) * CR * W;
    n = CR * W;
  }
}

// (not in the wide plan's builds, which pack their own chunks and run their
// own decode: decoder_wide.cuh)
#if DEC_W <= 256 && DEC_D <= 64
// f32 FusedParams -> the packed bf16 chunks (round to nearest even)
__global__ void pack_weights_kernel(dec::Params p, bf16* __restrict__ dst) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < PACKED;
       e += gridDim.x * blockDim.x) {
    float v;
    int o;
    if (e < P_WS) {
      const int k = e / W, n = e - k * W;
      v = p.w2[e];
      o = (k / CR) * CR * W + tc::tofs(n, k % CR, CR);
    } else if (e < P_WC) {
      const int i = e - P_WS, k = i / SD, n = i - k * SD;
      v = p.ws[k * SO + n];
      o = P_WS + (k / CR) * CR * SD + tc::tofs(n, k % CR, CR);
    } else if (NX == 0 || e < P_X) {
      const int i = e - P_WC, k = i / W, n = i - k * W;
      v = p.wc_f[i];
      o = P_WC + (k / CR) * CR * W + tc::tofs(n, k % CR, CR);
    } else {                                 // w1, then wc_x (in_dim 64)
      const int i = e - P_X, m = i / (D * W), j = i - m * D * W;
      const int k = j / W, n = j - k * W;
      v = (m ? p.wc_x : p.w1)[j];
      o = P_X + m * D * W + (k / CR) * CR * W + tc::tofs(n, k % CR, CR);
    }
    dst[o] = __float2bfloat16_rn(v);
  }
}

inline cudaError_t pack_weights(const dec::Params& p, bf16* dst,
                                cudaStream_t stream) {
  pack_weights_kernel<<<(PACKED + 255) / 256, 256, 0, stream>>>(p, dst);
  return cudaGetLastError();
}
#endif

// ---- the ring ----

using bulk::bulk_copy;
using bulk::mbar_expect;
using bulk::mbar_fence_init;
using bulk::mbar_init;
using bulk::mbar_wait;

// The chunks a block consumes, in order: `len` per tile (the forward's
// NFWD, or K3's 2 NFWD3: the forward's, then wc_f, ws and w2 again for the
// backward, and at in_dim 64 w1 and wc_x for both), the same sequence for
// every tile.
struct Ring {
  bf16* slot;         // two slots of SLOT elements
  uint64_t* bar;      // their mbarriers
  const bf16* src;    // the packed weights
  int len;            // chunks per tile
  int next;           // sequence index of the chunk the next acquire returns
  int cur;            // its slot
  uint32_t phase;     // bit s: the parity slot s completes next
};

__device__ __forceinline__ int chunk_id(int len, int i) {
  if constexpr (NX > 0) {
    // K3 at in_dim 64. Forward: w1, w2, ws, wc_x, wc_f; backward: wc_f,
    // ws, w2, then the chunks of w1 and wc_x in turn (dx)
    if (len != NFWD) {
      if (i < NFWD3) {
        if (i < NX) return ID_W1 + i;
        i -= NX;
        if (i < NW2 + NWS) return i;
        i -= NW2 + NWS;
        return i < NX ? ID_WX + i : NW2 + NWS + (i - NX);
      }
      i -= NFWD3;
      if (i < NWC) return NW2 + NWS + i;
      if (i < NWC + NWS) return NW2 + (i - NWC);
      if (i < NWC + NWS + NW2) return i - NWC - NWS;
      i -= NWC + NWS + NW2;                       // w1, wc_x in turn
      return (i & 1 ? ID_WX : ID_W1) + i / 2;
    }
  }
  if (i < NFWD || len == NFWD) return i;
  i -= NFWD;                                       // the backward's order
  if (i < NWC) return NW2 + NWS + i;               // wc_f
  if (i < NWC + NWS) return NW2 + (i - NWC);       // ws
  return i - NWC - NWS;                            // w2
}

// thread 0: the bulk copy of sequence index i into slot s
__device__ __forceinline__ void issue(const Ring& r, int i, int s) {
  int off, n;
  chunk_of(chunk_id(r.len, i), off, n);
  mbar_expect(r.bar + s, n * 2);
  bulk_copy(r.slot + s * SLOT, r.src + off, n * 2, r.bar + s);
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
    mbar_init(r.bar);
    mbar_init(r.bar + 1);
    mbar_fence_init();
  }
  return r;
}

// thread 0 starts the first tile's first chunk (after the barrier that
// follows ring_init)
__device__ __forceinline__ void ring_start(const Ring& r) {
  if (threadIdx.x == 0) issue(r, 0, 0);
}

// The next chunk of the sequence, once it has landed. Every thread of the
// block calls it at the same point, after its products that read the other
// slot have completed (wgmma wait) and after its shared-memory writes that
// the coming products read (with fence_proxy_async). It starts the chunk
// after it into the other slot: the sequence's next, or, after a tile's
// last chunk, the next tile's first if `more`.
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
  mbar_wait(r.bar + s, (r.phase >> s) & 1u);
  r.phase ^= 1u << s;
  r.cur = s ^ 1;
  r.next = nx;
  return r.slot + s * SLOT;
}

// ---- products ----

// Thread t of a warpgroup (warp w, lane l) holds the m64nN accumulator
// entries acc[4i + e] at row r0 + 8 (e / 2), column 8i + c2 + e % 2.
struct Lane {
  int r0, c2;
};
__device__ __forceinline__ Lane lane() {
  const int t = threadIdx.x % WG, l = t & 31;
  return Lane{16 * (t >> 5) + (l >> 2), 2 * (l & 3)};
}

// one product of the warpgroup: acc (= or +=) A B over KS k16 steps
template <int N, int TA, int TB>
__device__ __forceinline__ void product(float (&acc)[N / 2], uint64_t da,
                                        uint64_t astep, uint64_t db,
                                        uint64_t bstep, int ks, bool accum) {
  tc::fence_regs(acc);
  tc::wg_fence();
#pragma unroll 4
  for (int j = 0; j < ks; ++j)
    tc::mma_ss<N, TA, TB>(acc, da + j * astep, db + j * bstep,
                          accum || j > 0);
  tc::wg_commit();
  tc::wg_wait_all();
  tc::fence_regs(acc);
}

// Forward product with a streamed weight (K inputs, N outputs): acc (this
// warpgroup's N / 2 columns) = (accum ? acc : 0) + a w, with a the (TR, K)
// activation tile; K / CR chunks from the ring.
template <int N, int K>
__device__ inline void fwd_stream(float (&acc)[N / 4], const bf16* a,
                                  Ring& r, bool more, bool accum) {
  const int wg = threadIdx.x / WG;
#pragma unroll 1
  for (int c = 0; c < K / CR; ++c) {
    const bf16* w = acquire(r, more);
    product<N / 2, 0, 0>(acc, tc::desc_k(a + tc::tofs(0, CR * c, K), K),
                         tc::KSTEP_K,
                         tc::desc_k(w + tc::tofs(N / 2 * wg, 0, CR), CR),
                         tc::KSTEP_K, CR / 16, accum || c > 0);
  }
}

// Backward product with chunk w (the rows [CR c, CR c + CR) of a weight of
// K outputs): acc = dy w[CR c + CR / 2 wg .. + CR / 2, :]^T, this
// warpgroup's CR / 2 of the chunk's CR output columns, with dy the (TR, K)
// cotangent tile
template <int K>
__device__ __forceinline__ void bwd_chunk(float (&acc)[CR / 4],
                                          const bf16* dy, const bf16* w) {
  const int wg = threadIdx.x / WG;
  product<CR / 2, 0, 1>(acc, tc::desc_k(dy, K), tc::KSTEP_K,
                        tc::desc_mn(w + tc::tofs(0, CR / 2 * wg, CR), CR),
                        tc::kstep_mn(CR), K / 16, false);
}

// dst (tile layout, LD columns) <- bf16(act(acc + bias)) at this
// warpgroup's columns from col0; acc then holds the rounded values
template <int NA>
__device__ __forceinline__ void store_tile(bf16* dst, int ld, float (&acc)[NA],
                                           const float* bias, bool relu,
                                           int col0, const Lane& ln) {
#pragma unroll
  for (int i = 0; i < NA / 4; ++i) {
    const int col = col0 + 8 * i + ln.c2;
    const float2 b = bias ? *reinterpret_cast<const float2*>(bias + col)
                          : make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * i + 2 * h] + b.x, v1 = acc[4 * i + 2 * h + 1] + b.y;
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      acc[4 * i + 2 * h] = tc::rbf(v0);
      acc[4 * i + 2 * h + 1] = tc::rbf(v1);
      *reinterpret_cast<uint32_t*>(dst + tc::tofs(ln.r0 + 8 * h, col, ld)) =
          tc::pack_bf16x2(v0, v1);
    }
  }
}

// acc *= (act > 0) at the same entries of the tile act (LD columns)
template <int NA>
__device__ __forceinline__ void relu_mask(float (&acc)[NA], const bf16* act,
                                          int ld, int col0, const Lane& ln) {
#pragma unroll
  for (int i = 0; i < NA / 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 a = tc::unpack_bf16x2(*reinterpret_cast<const uint32_t*>(
          act + tc::tofs(ln.r0 + 8 * h, col0 + 8 * i + ln.c2, ld)));
      if (!(a.x > 0.f)) acc[4 * i + 2 * h] = 0.f;
      if (!(a.y > 0.f)) acc[4 * i + 2 * h + 1] = 0.f;
    }
}

// ---- the forward of K1 and K2 ----

#if DEC_W <= 256 && DEC_D <= 64

// the partial dots of the two warpgroups: part[wg][row] = [rgb logits | sdf]
constexpr int PART_SMEM = 2 * TR * 4 * 4;

// The decoder of one tile whose input xs (bf16, tile layout) is in place
// and visible to the block; hA and hB are (TR, W) bf16 tiles; the ring's
// next chunk is the tile's first. Writes out[tile rows < N] = [sigmoid(hc
// wo + bo), sdf].
__device__ inline void decode(const tc::TcWeights& w, const bf16* xs,
                              bf16* hA, bf16* hB, float* part, Ring& r,
                              bool more, float* __restrict__ out, long long N,
                              long long tile) {
  const int wg = threadIdx.x / WG;
  const Lane ln = lane();
  const int c0 = HALF * wg;                // this warpgroup's first column
  const bool lead = (threadIdx.x & 3) == 0;
  float acc[W / 4];
  float accs[SD / 4];

  // h1 = relu(x w1 + b1) -> hA
  product<HALF, 0, 0>(acc, tc::desc_k(xs, D), tc::KSTEP_K,
                      tc::desc_k(w.w1 + tc::tofs(c0, 0, D), D), tc::KSTEP_K,
                      D / 16, false);
  store_tile(hA, W, acc, w.b1, true, c0, ln);
  tc::fence_proxy_async();

  // h2 = relu(h1 w2 + b2) -> hB; this warpgroup's part of h2 . ws[:, SD]
  fwd_stream<W, W>(acc, hA, r, more, false);
  store_tile(hB, W, acc, w.b2, true, c0, ln);
  tc::fence_proxy_async();
  {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < W / 16; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(
          w.ws_sdf + c0 + 8 * i + ln.c2);
      s0 = fmaf(acc[4 * i], v.x, fmaf(acc[4 * i + 1], v.y, s0));
      s1 = fmaf(acc[4 * i + 2], v.x, fmaf(acc[4 * i + 3], v.y, s1));
    }
    s0 = tc::quad_sum(s0);
    s1 = tc::quad_sum(s1);
    if (lead) {
      part[(wg * TR + ln.r0) * 4 + 3] = s0;
      part[(wg * TR + ln.r0 + 8) * 4 + 3] = s1;
    }
  }

  // feat = h2 ws[:, :SD] + bs[:SD] -> hA (h1's readers are done at the
  // first chunk's barrier)
  fwd_stream<SD, W>(accs, hB, r, more, false);
  store_tile(hA, SD, accs, w.bs, false, SD / 2 * wg, ln);
  tc::fence_proxy_async();

  // hc = relu(x wc_x + feat wc_f + bc); this warpgroup's part of hc wo
  product<HALF, 0, 0>(acc, tc::desc_k(xs, D), tc::KSTEP_K,
                      tc::desc_k(w.wc_x + tc::tofs(c0, 0, D), D), tc::KSTEP_K,
                      D / 16, false);
  fwd_stream<W, SD>(acc, hA, r, more, true);
  {
    float p0[3] = {0.f, 0.f, 0.f}, p1[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < W / 16; ++i) {
      const int col = c0 + 8 * i + ln.c2;
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

#endif  // DEC_W <= 256 && DEC_D <= 64

}  // namespace st
