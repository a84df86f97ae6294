// Fused decoder forward (kernel K2-f32) and backward (kernel K3-f32) with f32
// operands at every decoder size other than (16, 128, 128): the streamed f32
// plan.
//
// They replace the TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// proudslam_tpu/ops/pallas/mlp_kernel.py traced with bf16=False (`_run_fwd`,
// `_run_bwd`), which take any decoder size; mlp_kernel_f32.cu is the same
// pair at (16, 128, 128), where the f32 weights but w1 fit a stage buffer
// beside the activation tiles. The functions and the arithmetic are
// mlp_kernel_f32.cu's: K2-f32 maps x (N, D) to out (N, 4) [sigmoid(rgb),
// sdf]; K3-f32 recomputes the forward per tile and returns dx (N, D) and,
// unless dx-only, the 11 parameter gradients summed over all rows. K2-f32's
// products and K3-f32's backward products run on the tensor cores as three
// TF32 products with f32 sums (3xTF32, tf32x3.cuh); K3-f32's forward
// recompute, whose ReLU masks its backward takes, runs as FFMA in the plain
// version's order (each output a sequential sum over k): 3xTF32 there
// flipped masks of pre-activations within ~1e-6 of 0 (mlp_kernel_f32.cu);
// the sdf column and the color logits are FFMA partial dots added in a
// fixed order; bias add, ReLU, sigmoid, dzo and the column sums are exact
// f32.
//
// What bounds them on an H100: arithmetic (~2 * 140k flops per row forward
// at (16, 256, 128), 2x that for K3-f32's dx, against 80 bytes of input
// and output), then the f32 weights' traffic from L2 and, for the full
// backward, the f32 operands it stores (4 (D + 5W + 2SD) bytes a row, and
// the padding). Shared memory is
// the wall: the f32 weights take 565 KB at (16, 256, 128) and 827 KB at
// (16, 256, 256), and a 64-row f32 activation tile of width 256 takes 68 KB,
// so K3-f32's four would not fit a block's 227 KB. So here:
//   - tiles of RT = 32 rows, feature-major (act[k][row], row stride AP = 36
//     floats: conflict-free fragment reads, as mlp_kernel_f32.cu's 68):
//     36,864 bytes each at width 256;
//   - at in_dim 16, w1 and wc_x (D x W) stay resident; w2, ws's feature
//     part and wc_f stream from L2 through a ring of two shared-memory
//     slots, 16 weight rows (a K-slice of a forward product) at a time, each
//     slot filled by one bulk copy (bulk_copy.cuh) that completes on the
//     slot's mbarrier, the next chunk in flight while this one's products
//     run;
//   - at in_dim 32 the resident w1 and wc_x would take K3-f32's block to
//     255,504 bytes at width 256 (219,920 at in_dim 16), over the 232,448 a
//     block may use, so there they stream through the ring too, D / 16
//     chunks each (188,944 bytes at (32, 256, 256)): w1 before the forward's
//     first product, wc_x after wc_f for hc's x part, and K3-f32's dx reads
//     each again as D / 16 chunks, each giving 16 finished columns of dx.
//     The products' sums are the resident plan's, term for term. At in_dim
//     64 the same, with four chunks each (193,552 bytes at (64, 256,
//     256)); there dx's 32 x 64 tile is 16 tiles of 16 x 8, two a warp
//     (dx_part2). At in_dim 128 eight chunks each (202,768 bytes at (128, 256, 256)), the
//     x tile 18,432 bytes, and dx's tile 32 tiles of 16 x 8, four a warp
//     (dx_partn; two a warp at 16-row tiles);
//   - a per-launch pass (pack_weights_kernel) writes the streamed weights
//     into a scratch buffer in exactly the chunks' layout (row stride WP =
//     W + 4 floats), in the order a tile takes them: (w1,) w2, ws's feature
//     part, wc_f (, wc_x) for the forward, then (K3-f32) (wc_x,) the
//     transposes wc_f^T, ws^T, w2^T (, w1) for the backward, so that each
//     backward product (dy w^T) is again a sum over K-slices of a row-major
//     weight: the same product, the same warp tiling, every warp busy;
//   - the 8 warps split each row x column product by its columns (32 rows
//     x N / 8 columns a warp).
// At the wide sizes (widths 384 to 1024) w1 and wc_x stream at either
// in_dim, and K2-f32's h1 and h2 products run on the FP32 units, as
// K3-f32's recompute: the sdf column is a dot of the W values of h2 whose
// terms can nearly cancel, and with 3xTF32's h1 and h2 (each product
// within ~2^-21 of the true one, a few times f32's rounding) K2-f32's sdf
// was 1.9e-5 of its largest magnitude from the float64 forward at (32,
// 512, 384) on the pcd features, the f32 plain version 3.6e-6 (an H100,
// 700 W), against a tolerance of 1e-5. The same at in_dim 64 (FFMA_H): on
// in_dim 48 zero-padded to (64, 256, 128), 3xTF32's h1 and h2 put K2-f32's
// sdf 1.04e-5 from the float64 forward (the plain version 6.8e-6; an H100,
// 700 W); the older sizes keep their 3xTF32 h1 and h2. In_dim 128 keeps
// FFMA_H.
// Both kernels at the wide sizes keep two live f32 tiles of RT3 rows and
// take their ring's chunks from one packed layout (pack_k3_kernel; K2-f32
// packs and reads only the forward's chunks). K2-f32's A holds h1, then
// feat, and B h2, then hc; its h1 and h2 are Fma3 products (below), feat
// and hc 3xTF32 ones, the sdf column and the color logits 16 partial dots
// a row (row_partials3), each sum the 16-row plan's term for term, so its
// output is the same bit for bit. Its sdf partials, written while ws's
// chunks stream, take a place of their own, its color partials the ring's
// free slot. At width 1024 its tile B lies in park3's place: there h1
// stays in shared memory for h2's FFMA product, the largest, and h2 and hc
// are read through L1 by the 3xTF32 products and the partial dots
// (parking B took 0.945-0.951 of parking A's time at the three sizes of
// width 1024 at the mapping shape, an H100 at 700 W).
// K3-f32 at the wide sizes keeps only two live f32 tiles (RT3 rows): A
// holds h1, then feat, dfeat, dh1, and B h2, then hc (dhc in place), dh2,
// each written over one that no later step reads. Its backward reads h1
// and h2 only through their ReLU masks, which the recompute keeps as bits
// (a 32-bit word a feature column) when it writes them; dws's sdf column
// is taken while h2 is in B, dwo while hc is. So its tiles have RT3 = 32
// rows at widths 384 and 512 (209,680 bytes at (128, 512, 512)) and 16 at
// 768 and 1024, where none is parked at 768 (192,016 bytes at (128, 768,
// 768)) and A is at 1024 (two 16-row tiles of width 1024 and the ring's
// 8-row chunks would take 251,408 bytes). Its recompute runs on the FP32
// units with each weight element read from shared memory once a block per
// k (Fma3: a lane holds 4 rows x CC columns of its warp's N / 8), each
// output the same sequential sum as Fma's; the color logits take the
// 16-row plan's 16 partial dots a row. dx's x-side products (dhc wc_x^T,
// dh1 w1^T) stream wc_x^T and w1^T as K-slices of KX rows, so that every
// warp holding dx tiles works on every chunk and keeps its sums across
// them, each output the same k8 steps as one product over K = W: dx and
// every stored operand are the 16-row plan's bit for bit.
// K3-f32 is pass 1 of two, as in mlp_kernel_f32.cu: each block walks a
// contiguous run of tiles, computes dx and adds the six small gradients
// into its own f32 slab (wg::small's offsets), and stores the f32 operands
// of the five large weight-gradient products to the scratch tile by tile
// (decoder_wgrad.cuh's f32 layout, tiles of its height at row stride
// height + 4), each finished tile in shared memory by one bulk copy from
// thread 0; tile A at width 1024 it writes in the scratch, at each
// operand's place. Pass 2 (mlp_wgrad_f32.cu) sums the products over long
// runs of rows and K3's reduce (mlp_wgrad.cu) adds its partials and the
// slabs in a fixed order: no float atomics, bitwise repeatable. The
// dx-only form (tracking) stores nothing and writes no slab. A ragged last
// tile is masked: its missing rows carry zero inputs and zero cotangents
// (they add nothing to any gradient) and write no output.

#include <type_traits>

#include "bulk_copy.cuh"
#include "decoder_wgrad.cuh"
#include "tf32x3.cuh"

using namespace dec;
namespace tf = tf32x3;

namespace {

using SG = wg::SmallAt<W, SD>;
constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
// the plan up to width 256 (the wide sizes' own below, `#if DEC_W > 256`)
constexpr int RT = 32;              // rows of a tile
constexpr int AP = RT + 4;          // activation row stride (floats)
constexpr int CR = 16;              // weight rows of a streamed chunk
constexpr int NQ = THREADS / RT;    // partial dots of a row (row_partials)
constexpr int WP = W + 4;           // weight row stride (floats)
constexpr int CHUNK = CR * WP;      // floats of a chunk, and of a ring slot
constexpr int ACT = W * AP;         // one (W, RT) activation tile
constexpr int XT = D * AP;          // the input tile
// in_dim 32 and the wide sizes: w1 and wc_x stream through the ring (XS
// chunks each) rather than stay resident (RES floats each)
constexpr bool XSTREAM = D > 16 || W > 256;
constexpr int XS = XSTREAM ? D / CR : 0;
constexpr int RES = XSTREAM ? 0 : D * WP;
// chunks of each streamed weight, in the order a tile takes them
constexpr int N_W2 = W / CR, N_WS = W / CR, N_WC = SD / CR;     // forward
constexpr int N_WCT = W / CR, N_WST = SD / CR, N_W2T = W / CR;  // backward
// forward: w1, w2, ws, wc_f, wc_x; backward: wc_x, wc_f^T, ws^T, w2^T, w1
constexpr int NFWD = XS + N_W2 + N_WS + N_WC + XS;
constexpr int NBWD = XS + N_WCT + N_WST + N_W2T + XS;
// the packed buffer: NFWD + NBWD chunks, then ws's sdf column (W floats)
constexpr int SDF_COL = (NFWD + NBWD) * CHUNK;
constexpr int PACKED = SDF_COL + W;
static_assert(THREADS == 8 * 32 && (D == 16 || D == 32 || D == 64 || D == 128)
                  && W % 64 == 0
                  && SD % 64 == 0 && SD <= W && W <= 1024,
              "the warp tilings below");
static_assert(SO <= WP, "a chunk row holds any streamed weight's row");

constexpr int RING_SMEM = 2 * CHUNK * 4 + 16;   // two slots, two mbarriers
constexpr int PART = 3 * NQ * RT;   // NQ partial color logits x 3 per row
// K2-f32's h1 and h2 on the FP32 units at in_dim 64 (the note on the
// wide sizes)
constexpr bool FFMA_H = D > 32;
// dx's 16 x 8 tiles a warp holds: RT / 16 x D / 8 tiles over the warps,
// two a warp at in_dim 64 with 32-row tiles (dx_part2); at in_dim 128
// DXN a warp (dx_partn)
constexpr int DXT = (RT / 16) * (D / 8) > NWARP ? 2 : 1;
constexpr int DXN = D > 64 ? (RT / 16) * (D / 8) / NWARP : 1;
static_assert((ACT * 4) % 16 == 0 && (XT * 4) % 16 == 0 && (RES * 4) % 16 == 0
                  && (CHUNK * 4) % 16 == 0,
              "16-byte aligned pieces and bulk copies");

#if DEC_W > 256
// both kernels at the wide sizes (the notes on them): two (W, RT3) tiles,
// A and B
constexpr int RT3 = W <= 512 ? 32 : 16;   // rows of a tile
constexpr int AP3 = RT3 + 4;              // activation row stride (floats)
constexpr int ACT3 = W * AP3;             // one activation tile
constexpr int XT3 = D * AP3;              // the input tile
constexpr int NQ3 = 16;                   // partial dots of a row
// width 1024: tile A lies in global memory (park3)
constexpr bool PARK3 = W > 768;
// the ReLU masks: bit r of word k for row r, a word of RT3 bits
using Mask = std::conditional_t<RT3 == 32, uint32_t, uint16_t>;
// a block's shared memory with ring chunks of `cr` weight rows (the color
// logits' partial dots lie in the ring's free slot, row_partials3's note)
constexpr int k3f_smem(int cr) {
  return 4 * ((PARK3 ? 1 : 2) * ACT3 + XT3 + 4 * RT3)
         + 2 * W * static_cast<int>(sizeof(Mask)) + 2 * cr * WP * 4 + 16;
}
// its ring's chunks: 16 weight rows where the block has room, else 8
constexpr int CR3 = k3f_smem(16) <= 232448 ? 16 : 8;
constexpr int CHUNK3 = CR3 * WP;
// chunks of a weight of W or SD rows
constexpr int NW3 = W / CR3, NSD3 = SD / CR3;
// dx's x-side products take wc_x^T and w1^T (W x D) as K-slices of KX rows
// at row stride DP, NXT chunks each: the most rows (a power of two
// dividing W) a ring slot holds
constexpr int DP = D + 4;
constexpr int kx_rows() {
  int k = 256;
  while (k > 8 && (k * DP > CHUNK3 || W % k != 0)) k /= 2;
  return k;
}
constexpr int KX = kx_rows(), NXT = W / KX;
// forward: w1, w2, ws, wc_f, wc_x; backward: wc_x^T, wc_f^T, ws^T, w2^T,
// w1^T; after them ws's sdf column
constexpr int NFWD3 = D / CR3 + NW3 + NW3 + NSD3 + D / CR3;
constexpr int NBWD3 = NXT + NW3 + NSD3 + NW3 + NXT;
constexpr int SDF3 = (NFWD3 + NBWD3) * CHUNK3;
constexpr int PACKED3 = SDF3 + W;
constexpr int K3F_SMEM = k3f_smem(CR3);
static_assert(XSTREAM && D % CR3 == 0 && KX % 8 == 0 && KX * DP <= CHUNK3
                  && W % KX == 0 && THREADS % RT3 == 0
                  && 3 * NQ3 * RT3 <= CHUNK3,
              "the wide K3-f32's chunks");
static_assert(K3F_SMEM <= 232448, "one block's shared memory");
// K2-f32's block: its tiles (B parked at width 1024), the input tile, the
// sdf partial dots (NQ3 a row) and the ring; at (128, 512, *) and (128,
// 768, 768), where K3-f32's ring has 8-row chunks, 16-row ones would take
// it to 234,000 and 232,976 bytes
constexpr int K2F_SMEM =
    4 * ((PARK3 ? 1 : 2) * ACT3 + XT3 + NQ3 * RT3) + 2 * CHUNK3 * 4 + 16;
static_assert(K2F_SMEM <= 232448, "one block's shared memory");
// dx's (RT3 / 16) x (D / 8) tiles of 16 x 8: with more than NWARP, warp w
// holds all RT3 rows of dx's columns [w D / 8, (w + 1) D / 8) (DXM x DXN
// tiles); else warp w < DX_TILES holds tile (w % (RT3 / 16), w / (RT3 /
// 16)) (at in_dim 16 four warps at 32-row tiles, two at 16-row ones: the
// x-side products are ~2% of the MACs there, so they take no K split)
constexpr int DX_TILES = (RT3 / 16) * (D / 8);
constexpr bool DX_ALL = DX_TILES > NWARP;
constexpr int DXM = DX_ALL ? RT3 / 16 : 1, DXN3 = DX_ALL ? D / 64 : 1;
static_assert(!DX_ALL || DXM * DXN3 * NWARP == DX_TILES, "dx's warp tiling");
#else
constexpr int K2F_SMEM =
    4 * (2 * ACT + XT + 2 * RES + NQ * RT + PART) + RING_SMEM;
constexpr int K3F_SMEM =
    4 * (4 * ACT + XT + 2 * RES + 4 * RT + PART) + RING_SMEM;
static_assert(K2F_SMEM <= 232448 && K3F_SMEM <= 232448,
              "one block's shared memory");
#endif

__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }

#if DEC_W <= 256
// f32 FusedParams -> the packed chunks (row stride WP, zeros past a row's
// end): the first `nchunks` of the sequence and ws's sdf column
__global__ void pack_weights_kernel(Params p, float* __restrict__ dst,
                                    int nchunks) {
  const int n = nchunks * CHUNK;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n + W;
       e += gridDim.x * blockDim.x) {
    if (e >= n) {
      const int k = e - n;
      dst[SDF_COL + k] = p.ws[k * SO + SD];
      continue;
    }
    int i = e / CHUNK;
    const int q = e - i * CHUNK, r = q / WP, c = q - r * WP;
    float v = 0.f;
    if (i < XS) {                                    // w1 (D, W)
      if (c < W) v = p.w1[(i * CR + r) * W + c];
    } else if ((i -= XS) < N_W2) {                   // w2 (W, W)
      if (c < W) v = p.w2[(i * CR + r) * W + c];
    } else if ((i -= N_W2) < N_WS) {                 // ws[:, :SD] (W, SD)
      if (c < SD) v = p.ws[(i * CR + r) * SO + c];
    } else if ((i -= N_WS) < N_WC) {                 // wc_f (SD, W)
      if (c < W) v = p.wc_f[(i * CR + r) * W + c];
    } else if ((i -= N_WC) < 2 * XS) {               // wc_x (D, W), twice
      if (i >= XS) i -= XS;
      if (c < W) v = p.wc_x[(i * CR + r) * W + c];
    } else if ((i -= 2 * XS) < N_WCT) {              // wc_f^T (W, SD)
      if (c < SD) v = p.wc_f[c * W + i * CR + r];
    } else if ((i -= N_WCT) < N_WST) {               // ws[:, :SD]^T (SD, W)
      if (c < W) v = p.ws[c * SO + i * CR + r];
    } else if ((i -= N_WST) < N_W2T) {               // w2^T (W, W)
      if (c < W) v = p.w2[c * W + i * CR + r];
    } else {                                         // w1 (D, W)
      i -= N_W2T;
      if (c < W) v = p.w1[(i * CR + r) * W + c];
    }
    dst[e] = v;
  }
}

cudaError_t pack_weights(const Params& p, float* dst, int nchunks,
                         cudaStream_t stream) {
  pack_weights_kernel<<<(nchunks * CHUNK + W + 255) / 256, 256, 0, stream>>>(
      p, dst, nchunks);
  return cudaGetLastError();
}
#endif

// ---- the ring ----

// The chunks a block consumes, in order: `len` per tile (NFWD for K2-f32,
// NFWD + NBWD for K3-f32; NFWD3 + NBWD3 for K3-f32 at the wide sizes), the
// same sequence for every tile; chunk i of the sequence is chunk i of the
// packed buffer. A chunk is ROWS weight rows at stride WP (CR; K3-f32 at
// the wide sizes CR3).
template <int ROWS_>
struct RingT {
  static constexpr int ROWS = ROWS_, FLOATS = ROWS_ * WP;
  float* slot;        // two slots of FLOATS floats
  uint64_t* bar;      // their mbarriers
  const float* src;   // the packed weights
  int len;            // chunks per tile
  int next;           // sequence index of the chunk the next acquire returns
  int cur;            // its slot
  uint32_t phase;     // bit s: the parity slot s completes next
};
using Ring = RingT<CR>;

// thread 0: the bulk copy of sequence index i into slot s
template <class R>
__device__ __forceinline__ void issue(const R& r, int i, int s) {
  constexpr int F = R::FLOATS;
  bulk::mbar_expect(r.bar + s, F * 4);
  bulk::bulk_copy(r.slot + s * F, r.src + static_cast<long long>(i) * F,
                  F * 4, r.bar + s);
}

template <class R = Ring>
__device__ inline R ring_init(Arena& ar, const float* src, int len) {
  R r;
  r.slot = ar.take<float>(2 * R::FLOATS);
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

// The next chunk of the sequence, once it has landed. Every thread of the
// block calls it at the same point, after its reads of the chunk before
// (which lies in the other slot) and after its shared-memory writes that
// the coming products read. It starts the chunk after it into the other
// slot: the sequence's next, or, after a tile's last chunk, the next
// tile's first if `more`.
template <class R>
__device__ __forceinline__ const float* acquire(R& r, bool more) {
  bulk::fence_proxy_async();
  __syncthreads();
  const int s = r.cur;
  int nx = r.next + 1;
  bool go = true;
  if (nx == r.len) {
    nx = 0;
    go = more;
  }
  if (threadIdx.x == 0 && go) issue(r, nx, s ^ 1);
  bulk::mbar_wait(r.bar + s, (r.phase >> s) & 1u);
  r.phase ^= 1u << s;
  r.cur = s ^ 1;
  r.next = nx;
  return r.slot + s * R::FLOATS;
}

// ---- products ----

// A row x column product on the tensor cores: out(row, n) = sum over
// K-slices of act[k][row] w[k][n] (act feature-major at stride AP, w
// row-major at stride WP), N output columns, warp w taking columns
// [w N / 8, (w + 1) N / 8) of all RT rows (RT / 16 x N / 64 tiles of
// 16 x 8).
template <int N, int R = RT>
struct Tc {
  static constexpr int TM = R / 16, TN = N / 64, LDA = R + 4;
  float acc[TM][TN][4];
  __device__ __forceinline__ int n0() const { return (threadIdx.x >> 5) * (N / 8); }
  __device__ __forceinline__ void zero() { tf::zero(acc); }
  template <int K>
  __device__ __forceinline__ void mm(const float* act, const float* w) {
    tf::mm_fm<TM, TN, K, true>(acc, act, LDA, w, WP, 0, n0());
  }
  // dst[n][row] = act(out + bias[n])
  __device__ __forceinline__ void store(float* dst,
                                        const float* __restrict__ bias,
                                        bool relu) {
    tf::for_each_acc(acc, 0, n0(), [&](int r, int c, float& v) {
      const float o = v + ldg(bias + c);
      dst[c * LDA + r] = relu ? fmaxf(o, 0.f) : o;
    });
  }
};

// The same product on the FP32 units, each output a sequential fused
// multiply-add over k (K3-f32's forward recompute up to width 256, K2-f32's h1
// and h2 at in_dim 64). Thread (ty, l) = (tid / 32, tid % 32) owns the RR = RT
// / 8 = 4 rows RR ty .. RR ty + RR - 1 and the column pairs 64 j + 2 l, 64 j +
// 2 l + 1 (j < N / 64).
template <int N>
struct Fma {
  static constexpr int NP = N / 64, RR = RT / 8, LDA = AP;
  static_assert(RR == 4, "a thread's rows");
  float acc[RR][2 * NP];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < RR; ++i)
#pragma unroll
      for (int j = 0; j < 2 * NP; ++j) acc[i][j] = 0.f;
  }
  template <int K>
  __device__ __forceinline__ void mm(const float* act, const float* w) {
    const int ty = threadIdx.x >> 5, l = threadIdx.x & 31;
#pragma unroll 4
    for (int r = 0; r < K; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(act + r * AP + 4 * ty);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const float2 b =
            *reinterpret_cast<const float2*>(w + r * WP + 64 * j + 2 * l);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][2 * j] = fmaf(av[i], b.x, acc[i][2 * j]);
          acc[i][2 * j + 1] = fmaf(av[i], b.y, acc[i][2 * j + 1]);
        }
      }
    }
  }
  __device__ __forceinline__ void store(float* dst,
                                        const float* __restrict__ bias,
                                        bool relu) {
    const int ty = threadIdx.x >> 5, l = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j) {
      const int c = 64 * (j >> 1) + 2 * l + (j & 1);
      const float b = ldg(bias + c);
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = acc[i][j] + b;
        if (relu) v[i] = fmaxf(v[i], 0.f);
      }
      *reinterpret_cast<float4*>(dst + c * AP + 4 * ty) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
};

// out = sum over the streamed chunks of act's K-slices times the chunks:
// the `nchunks` next chunks of the ring, act's rows [CR c, CR c + CR) with
// chunk c
template <class P, class R>
__device__ __forceinline__ void stream_mm(P& f, const float* act, int nchunks,
                                          R& r, bool more) {
#pragma unroll 1
  for (int c = 0; c < nchunks; ++c) {
    const float* w = acquire(r, more);
    f.template mm<R::ROWS>(act + c * R::ROWS * P::LDA, w);
  }
}

// dx's part (RT x D) += cot wt^T on dx's columns [n_lo, n_lo + ROWS): cot
// feature-major (W, RT), wt those rows of a (D, W) weight at stride WP
// (all D of them resident, or a chunk of the ring); warp w < D / 4 holds
// dx's 16 x 8 tile at (16 (w & 1), 8 (w >> 1)) (K3-f32 up to width 256)
template <int ROWS>
__device__ __forceinline__ void dx_mm(float (&acc)[1][1][4], const float* cot,
                                      const float* wt, int n_lo) {
  const int w = threadIdx.x >> 5, n0 = 8 * (w >> 1);
  if (w < D / 4 && n0 >= n_lo && n0 < n_lo + ROWS)
    tf::mm_fm<1, 1, W, false>(acc, cot, AP, wt, WP, 16 * (w & 1), n0 - n_lo);
}

// the forward's x-side product f (+)= x w with w = w1 or wc_x: resident, or
// its D / R::ROWS chunks from the ring (XS for K2-f32)
template <class P, class R>
__device__ __forceinline__ void x_mm(P& f, const float* xs, const float* res,
                                     R& r, bool more) {
  if constexpr (XSTREAM)
    stream_mm(f, xs, D / R::ROWS, r, more);
  else
    f.template mm<D>(xs, res);
}

// dx's part += cot w^T with w = wc_x or w1: resident, or its XS chunks from
// the ring (chunk c: dx's columns [CR c, CR c + CR))
__device__ __forceinline__ void dx_part(float (&acc)[1][1][4],
                                        const float* cot, const float* res,
                                        Ring& r, bool more) {
  if constexpr (XSTREAM) {
#pragma unroll 1
    for (int c = 0; c < XS; ++c) dx_mm<CR>(acc, cot, acquire(r, more), CR * c);
  } else {
    dx_mm<D>(acc, cot, res, 0);
  }
}

// dx_part at in_dim 64 with 32-row tiles (DXT == 2): warp w holds dx's
// 16 x 8 tiles at (16 (w & 1), 8 (w >> 1)) in a0 and 32 columns right of
// it in a1; w's XS chunks from the ring (chunk c: dx's columns [CR c,
// CR c + CR))
__device__ __forceinline__ void dx_part2(float (&a0)[1][1][4],
                                         float (&a1)[1][1][4],
                                         const float* cot, Ring& r,
                                         bool more) {
  const int w = threadIdx.x >> 5, m0 = 16 * (w & 1), n0 = 8 * (w >> 1);
#pragma unroll 1
  for (int c = 0; c < XS; ++c) {
    const float* wt = acquire(r, more);
    if (n0 >= CR * c && n0 < CR * c + CR)
      tf::mm_fm<1, 1, W, false>(a0, cot, AP, wt, WP, m0, n0 - CR * c);
    if (n0 + 32 >= CR * c && n0 + 32 < CR * c + CR)
      tf::mm_fm<1, 1, W, false>(a1, cot, AP, wt, WP, m0, n0 + 32 - CR * c);
  }
}

// dx_part at in_dim 128: warp w holds dx's 16 x 8 tiles t = w + NWARP j
// (j < DXN), tile t at rows 16 (t % (RT / 16)), columns 8 (t / (RT / 16));
// w's XS chunks from the ring (chunk c: dx's columns [CR c, CR c + CR))
// (K3-f32 up to width 256)
__device__ __forceinline__ void dx_partn(float (&a)[DXN][1][1][4],
                                         const float* cot, Ring& r,
                                         bool more) {
  const int w = threadIdx.x >> 5;
#pragma unroll 1
  for (int c = 0; c < XS; ++c) {
    const float* wt = acquire(r, more);
#pragma unroll
    for (int j = 0; j < DXN; ++j) {
      const int t = w + NWARP * j, n0 = 8 * (t / (RT / 16));
      if (n0 >= CR * c && n0 < CR * c + CR)
        tf::mm_fm<1, 1, W, false>(a[j], cot, AP, wt, WP, 16 * (t % (RT / 16)),
                                  n0 - CR * c);
    }
  }
}

// Column sums over the tile's rows of a feature-major tile of NC columns,
// added into out[col]
template <int NC, int R = RT>
__device__ __forceinline__ void col_sum(float* __restrict__ out,
                                        const float* cot, bool first) {
  for (int k = threadIdx.x; k < NC; k += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < R; r += 4) {
      const float4 v = *reinterpret_cast<const float4*>(cot + k * (R + 4) + r);
      s += v.x;
      s += v.y;
      s += v.z;
      s += v.w;
    }
    out[k] = first ? s : out[k] + s;
  }
}

// a (D, W) weight into shared memory at row stride WP
__device__ __forceinline__ void load_resident(float* dst,
                                              const float* __restrict__ src) {
  for (int e = threadIdx.x; e < D * W / 4; e += THREADS) {
    const int r = e / (W / 4), c = 4 * (e - r * (W / 4));
    *reinterpret_cast<float4*>(dst + r * WP + c) =
        __ldg(reinterpret_cast<const float4*>(src + r * W + c));
  }
}

// x's tile of R rows (zeros past the last row) into xs, feature-major at
// row stride R + 4: thread (row, q) = (tid / 4, tid % 4) < (R, 4) reads
// x[row, 16k + 4q : 16k + 4q + 4] for k < D / 16
template <int R = RT>
__device__ __forceinline__ void load_x(float* xs, const float* __restrict__ x,
                                       long long row0, int nvalid) {
  constexpr int LD = R + 4;
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  if (r >= R) return;
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    const int c = 16 * k + 4 * q;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nvalid)
      v = __ldg(reinterpret_cast<const float4*>(x + (row0 + r) * D + c));
    xs[(c + 0) * LD + r] = v.x;
    xs[(c + 1) * LD + r] = v.y;
    xs[(c + 2) * LD + r] = v.z;
    xs[(c + 3) * LD + r] = v.w;
  }
}

// Partial dots of each row with a W-vector: thread (r, q) = (tid % RT,
// tid / RT) sums act[k][r] v[k] over k in [q W / NQ, (q + 1) W / NQ) into
// part[(C q + c) RT + r] for each of the C columns of v (v[C k + c])
template <int C>
__device__ __forceinline__ void row_partials(float* part, const float* act,
                                             const float* __restrict__ v) {
  const int r = threadIdx.x % RT, q = threadIdx.x / RT;
  float s[C];
#pragma unroll
  for (int c = 0; c < C; ++c) s[c] = 0.f;
#pragma unroll 8
  for (int k = q * (W / NQ); k < (q + 1) * (W / NQ); ++k) {
    const float h = act[k * AP + r];
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] = fmaf(h, ldg(v + C * k + c), s[c]);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) part[(C * q + c) * RT + r] = s[c];
}

// the sum of row r's Q partials of column c, in order, plus b (tiles of R
// rows)
template <int C, int Q = NQ, int R = RT>
__device__ __forceinline__ float row_sum(const float* part, int r, int c,
                                         float b) {
  float z = 0.f;
#pragma unroll
  for (int q = 0; q < Q; ++q) z += part[(C * q + c) * R + r];
  return z + b;
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

#if DEC_W <= 256
__global__ void __launch_bounds__(THREADS, 1)
decoder_forward_f32_kernel(const float* __restrict__ x, Params p,
                           const float* wpack, float* __restrict__ out,
                           long long N) {
  extern __shared__ __align__(16) char smem[];
  Arena ar{smem};
  float* a = ar.take<float>(ACT);
  float* b = ar.take<float>(ACT);
  float* xs = ar.take<float>(XT);
  float* w1s = ar.take<float>(RES);
  float* wcx = ar.take<float>(RES);
  float* sdfp = ar.take<float>(NQ * RT);      // partial sdf dots
  float* part = ar.take<float>(PART);         // partial color logits
  Ring ring = ring_init(ar, wpack, NFWD);
  const float* ws_sdf = wpack + SDF_COL;
  if constexpr (!XSTREAM) {
    load_resident(w1s, p.w1);
    load_resident(wcx, p.wc_x);
  }
  __syncthreads();                  // the mbarriers and resident weights
  const long long ntiles = (N + RT - 1) / RT;
  if (threadIdx.x == 0 && blockIdx.x < ntiles) issue(ring, 0, 0);
  Tc<W> f;
  Tc<SD> fs;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const bool more = tile + gridDim.x < ntiles;
    const long long row0 = tile * RT;
    const int nvalid = static_cast<int>(min(static_cast<long long>(RT), N - row0));
    __syncthreads();                // the last tile's readers
    load_x(xs, x, row0, nvalid);
    __syncthreads();
    if constexpr (FFMA_H) {
      // h1 -> a, h2 -> b on the FP32 units (the note on the wide sizes)
      Fma<W> h;
      h.zero();
      x_mm(h, xs, w1s, ring, more);
      h.store(a, p.b1, true);
      h.zero();
      stream_mm(h, a, N_W2, ring, more);
      h.store(b, p.b2, true);
    } else {
    // h1 = relu(x w1 + b1) -> a
    f.zero();
    x_mm(f, xs, w1s, ring, more);
    f.store(a, p.b1, true);
    // h2 = relu(h1 w2 + b2) -> b (the first chunk's barrier: h1 in place)
    f.zero();
    stream_mm(f, a, N_W2, ring, more);
    f.store(b, p.b2, true);
    }
    // feat = h2 ws[:, :SD] + bs[:SD] -> a, and h2's sdf dots
    fs.zero();
    stream_mm(fs, b, N_WS, ring, more);
    row_partials<1>(sdfp, b, ws_sdf);
    fs.store(a, p.bs, false);
    // hc = relu(feat wc_f + x wc_x + bc) -> b (h2's last readers are
    // before the first wc_f chunk's barrier)
    f.zero();
    stream_mm(f, a, N_WC, ring, more);
    x_mm(f, xs, wcx, ring, more);
    f.store(b, p.bc, true);
    __syncthreads();
    row_partials<3>(part, b, p.wo);
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < nvalid) {
      const int r = threadIdx.x;
      *reinterpret_cast<float4*>(out + (row0 + r) * 4) = make_float4(
          sigmoid(row_sum<3>(part, r, 0, ldg(p.bo))),
          sigmoid(row_sum<3>(part, r, 1, ldg(p.bo + 1))),
          sigmoid(row_sum<3>(part, r, 2, ldg(p.bo + 2))),
          row_sum<1>(sdfp, r, 0, ldg(p.bs + SD)));
    }
  }
}
#endif

#if DEC_W > 256
// ---- the wide sizes: two live tiles (K3-f32: ReLU bit masks) ----

using Ring3 = RingT<CR3>;

// The packed chunks at the wide sizes (CR3 weight rows at stride WP, zeros
// past a row's end), in the order a tile takes them: w1, w2, ws's feature
// part, wc_f, wc_x (K2-f32's NFWD3); then wc_x^T's NXT K-slices of KX rows
// (KX x D at row stride DP, zeros past a slice's end), wc_f^T, ws^T and
// w2^T, w1^T's NXT K-slices; then ws's sdf column at SDF3. Writes the
// first `nchunks` chunks and the column.
__global__ void pack_k3_kernel(Params p, float* __restrict__ dst,
                               int nchunks) {
  const int n = nchunks * CHUNK3;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n + W;
       e += gridDim.x * blockDim.x) {
    if (e >= n) {
      const int k = e - n;
      dst[SDF3 + k] = p.ws[k * SO + SD];
      continue;
    }
    int i = e / CHUNK3;
    const int q = e - i * CHUNK3, r = q / WP, c = q - r * WP;
    float v = 0.f;
    if (i < NFWD3) {
      if (i < D / CR3) {                             // w1 (D, W)
        if (c < W) v = p.w1[(i * CR3 + r) * W + c];
      } else if ((i -= D / CR3) < NW3) {             // w2 (W, W)
        if (c < W) v = p.w2[(i * CR3 + r) * W + c];
      } else if ((i -= NW3) < NW3) {                 // ws[:, :SD] (W, SD)
        if (c < SD) v = p.ws[(i * CR3 + r) * SO + c];
      } else if ((i -= NW3) < NSD3) {                // wc_f (SD, W)
        if (c < W) v = p.wc_f[(i * CR3 + r) * W + c];
      } else {                                       // wc_x (D, W)
        i -= NSD3;
        if (c < W) v = p.wc_x[(i * CR3 + r) * W + c];
      }
    } else if ((i -= NFWD3) < NXT || i >= NBWD3 - NXT) {
      const float* src = i < NXT ? p.wc_x : p.w1;    // wc_x^T, w1^T (W, D)
      if (i >= NXT) i -= NBWD3 - NXT;
      const int rx = q / DP, cx = q - rx * DP;
      if (rx < KX && cx < D) v = src[cx * W + i * KX + rx];
    } else if ((i -= NXT) < NW3) {                   // wc_f^T (W, SD)
      if (c < SD) v = p.wc_f[c * W + i * CR3 + r];
    } else if ((i -= NW3) < NSD3) {                  // ws[:, :SD]^T (SD, W)
      if (c < W) v = p.ws[c * SO + i * CR3 + r];
    } else {                                         // w2^T (W, W)
      i -= NSD3;
      if (c < W) v = p.w2[c * W + i * CR3 + r];
    }
    dst[e] = v;
  }
}

cudaError_t pack_k3(const Params& p, float* dst, int nchunks,
                    cudaStream_t stream) {
  pack_k3_kernel<<<(nchunks * CHUNK3 + W + 255) / 256, 256, 0, stream>>>(
      p, dst, nchunks);
  return cudaGetLastError();
}

// The products on the FP32 units at the wide sizes (K2-f32's h1 and h2,
// K3-f32's forward recompute), each output a sequential fused multiply-add over
// k in the chunks' order (Fma's sums, term for term). Warp w takes the columns
// [w N / 8, (w + 1) N / 8) of all RT3 rows, as Tc splits its products; lane l =
// LC lr + lc holds the R rows R lr .. R lr + R - 1 and the C columns w N / 8 +
// V lc + V LC j + v (j < C / V, v < V). Per k a lane reads R / 4 float4 of act
// (the same for the LC lanes of its rows) and C / V vectors of V floats of the
// weight row (the same for the LR lanes of its columns): the block reads each
// weight element from shared memory once per k, and a lane's R + C values feed
// R C FFMA (8 x 8 where a warp has 48 columns or more, else 4 rows). UNROLL:
// the k steps unrolled at once, 0 all of a chunk.
template <int N, int UNROLL>
struct Fma3 {
  static constexpr int NW = N / NWARP, R = NW >= 48 ? 8 : 4, LR = RT3 / R,
                       LC = 32 / LR, C = NW / LC, V = C % 4 == 0 ? 4 : 2,
                       LDA = AP3;
  static_assert(LR * R == RT3 && LC * C == NW && C % V == 0,
                "a lane's rows and columns");
  float acc[R][C];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
  }
  __device__ __forceinline__ int col(int j) const {
    const int l = threadIdx.x & 31;
    return (threadIdx.x >> 5) * NW + V * (l % LC) + V * LC * (j / V) + j % V;
  }
  template <int K>
  __device__ __forceinline__ void mm(const float* act, const float* w) {
    const int l = threadIdx.x & 31;
    const float* a0 = act + R * (l / LC);
    const float* w0 = w + col(0);
    if constexpr (UNROLL == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) step(a0, w0, k);
    } else {
#pragma unroll UNROLL
      for (int k = 0; k < K; ++k) step(a0, w0, k);
    }
  }
  // acc += act[k][rows] w[k][cols]
  __device__ __forceinline__ void step(const float* a0, const float* w0,
                                       int k) {
    float av[R], b[C];
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(a0 + k * AP3 + i);
      av[i] = a.x;
      av[i + 1] = a.y;
      av[i + 2] = a.z;
      av[i + 3] = a.w;
    }
#pragma unroll
    for (int j = 0; j < C; j += V) {
      const float* q = w0 + k * WP + LC * j;
      if constexpr (V == 4) {
        const float4 v = *reinterpret_cast<const float4*>(q);
        b[j] = v.x;
        b[j + 1] = v.y;
        b[j + 2] = v.z;
        b[j + 3] = v.w;
      } else {
        const float2 v = *reinterpret_cast<const float2*>(q);
        b[j] = v.x;
        b[j + 1] = v.y;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = fmaf(av[i], b[j], acc[i][j]);
  }
  // dst[n][row] = act(out + bias[n]); with `mask`, bit r of mask[n] set
  // where dst[n][r] > 0 (the lanes of a column OR their bits together)
  __device__ __forceinline__ void store(float* dst,
                                        const float* __restrict__ bias,
                                        bool relu, Mask* mask) {
    const int lr = (threadIdx.x & 31) / LC;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int c = col(j);
      const float b = ldg(bias + c);
      float v[R];
      uint32_t bits = 0;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        v[i] = acc[i][j] + b;
        if (relu) v[i] = fmaxf(v[i], 0.f);
        bits |= static_cast<uint32_t>(v[i] > 0.f) << (R * lr + i);
      }
#pragma unroll
      for (int i = 0; i < R; i += 4)
        *reinterpret_cast<float4*>(dst + c * AP3 + R * lr + i) =
            make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
      if (mask != nullptr) {
#pragma unroll
        for (int o = LC; o < 32; o *= 2)
          bits |= __shfl_xor_sync(0xffffffffu, bits, o);
        if (lr == 0) mask[c] = static_cast<Mask>(bits);
      }
    }
  }
};

// dx's x-side products, cot (W, RT3) times wc_x^T or w1^T (W, D): the NXT
// K-slices from the ring, each feeding every warp that holds dx tiles
// (DX_ALL's note), which keep their sums over the slices; each output the
// same k8 steps in the same order as one product over K = W
struct Dx3 {
  float acc[DXM][DXN3][4];
  __device__ __forceinline__ bool holds() const {
    return DX_ALL || (threadIdx.x >> 5) < DX_TILES;
  }
  __device__ __forceinline__ int m0() const {
    return DX_ALL ? 0 : 16 * ((threadIdx.x >> 5) % (RT3 / 16));
  }
  __device__ __forceinline__ int n0() const {
    return DX_ALL ? (threadIdx.x >> 5) * (D / NWARP)
                  : 8 * ((threadIdx.x >> 5) / (RT3 / 16));
  }
  __device__ __forceinline__ void zero() { tf::zero(acc); }
  __device__ __forceinline__ void part(const float* cot, Ring3& r, bool more) {
#pragma unroll 1
    for (int c = 0; c < NXT; ++c) {
      const float* wt = acquire(r, more);
      if (holds())
        tf::mm_fm<DXM, DXN3, KX, true>(acc, cot + c * KX * AP3, AP3, wt, DP,
                                       m0(), n0());
    }
  }
  __device__ __forceinline__ void write(float* __restrict__ dx, long long row0,
                                        int nvalid) {
    if (holds())
      tf::for_each_acc(acc, m0(), n0(), [&](int r, int c, float& v) {
        if (r < nvalid) dx[(row0 + r) * D + c] = v;
      });
  }
};

// Partial dots of each row with a W-vector, NQ3 a row as the 16-row plan
// takes them: (r, q) = (e % RT3, e / RT3) for e = tid, tid + THREADS, ...
// sums act[k][r] v[k] over k in [q W / NQ3, (q + 1) W / NQ3) into
// part[(C q + c) RT3 + r] for each of the C columns of v (v[C k + c]). The
// kernel puts `part` in the ring slot of the chunk last read: free from the
// barrier after its readers to the next acquire, which issues the next
// copy into it after its proxy fence and barrier
template <int C>
__device__ __forceinline__ void row_partials3(float* part, const float* act,
                                              const float* __restrict__ v) {
#pragma unroll 1
  for (int e = threadIdx.x; e < NQ3 * RT3; e += THREADS) {
    const int r = e % RT3, q = e / RT3;
    float s[C];
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] = 0.f;
#pragma unroll 8
    for (int k = q * (W / NQ3); k < (q + 1) * (W / NQ3); ++k) {
      const float h = act[k * AP3 + r];
#pragma unroll
      for (int c = 0; c < C; ++c) s[c] = fmaf(h, ldg(v + C * k + c), s[c]);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) part[(C * q + c) * RT3 + r] = s[c];
  }
}

// this block's parked tile at width 1024 (K3-f32's A in its dx-only form,
// K2-f32's B): ACT3 floats after the packed weights
__device__ __forceinline__ float* park3(const float* wpack) {
  return const_cast<float*>(wpack) + PACKED3
         + static_cast<long long>(blockIdx.x) * ACT3;
}

// K2-f32 at the wide sizes (the note on them): persistent blocks, block b
// taking the RT3-row tiles b, b + blocks, ...; the ring's chunks the first
// NFWD3 of the packed layout, the same for every tile.
__global__ void __launch_bounds__(THREADS, 1)
decoder_forward_f32_kernel(const float* __restrict__ x, Params p,
                           const float* wpack, float* __restrict__ out,
                           long long N) {
  extern __shared__ __align__(16) char smem[];
  Arena ar{smem};
  float* A = ar.take<float>(ACT3);
  float* B = PARK3 ? park3(wpack) : ar.take<float>(ACT3);
  float* xs = ar.take<float>(XT3);
  float* sdfp = ar.take<float>(NQ3 * RT3);      // partial sdf dots
  Ring3 ring = ring_init<Ring3>(ar, wpack, NFWD3);
  const float* ws_sdf = wpack + SDF3;
  __syncthreads();                  // the mbarriers
  const long long ntiles = (N + RT3 - 1) / RT3;
  if (threadIdx.x == 0 && blockIdx.x < ntiles) issue(ring, 0, 0);
  Fma3<W, 0> h;
  Tc<SD, RT3> fs;
  Tc<W, RT3> fc;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const bool more = tile + gridDim.x < ntiles;
    const long long row0 = tile * RT3;
    const int nvalid = static_cast<int>(min(static_cast<long long>(RT3), N - row0));
    __syncthreads();                // the last tile's readers
    load_x<RT3>(xs, x, row0, nvalid);
    __syncthreads();
    // h1 = relu(x w1 + b1) -> A
    h.zero();
    x_mm(h, xs, nullptr, ring, more);
    h.store(A, p.b1, true, nullptr);
    // h2 = relu(h1 w2 + b2) -> B (the first chunk's barrier: h1 in place)
    h.zero();
    stream_mm(h, A, NW3, ring, more);
    h.store(B, p.b2, true, nullptr);
    // feat = h2 ws[:, :SD] + bs[:SD] -> A, and h2's sdf dots (h1's last
    // readers are before the first chunk's barrier)
    fs.zero();
    stream_mm(fs, B, NW3, ring, more);
    row_partials3<1>(sdfp, B, ws_sdf);
    fs.store(A, p.bs, false);
    // hc = relu(feat wc_f + x wc_x + bc) -> B (h2's last readers are
    // before the first chunk's barrier)
    fc.zero();
    stream_mm(fc, A, NSD3, ring, more);
    x_mm(fc, xs, nullptr, ring, more);
    fc.store(B, p.bc, true);
    __syncthreads();
    // the color logits' partials in the ring's slot of hc's last chunk,
    // free since the barrier above
    float* part = ring.slot + (ring.cur ^ 1) * CHUNK3;
    row_partials3<3>(part, B, p.wo);
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < nvalid) {
      const int r = threadIdx.x;
      *reinterpret_cast<float4*>(out + (row0 + r) * 4) = make_float4(
          sigmoid(row_sum<3, NQ3, RT3>(part, r, 0, ldg(p.bo))),
          sigmoid(row_sum<3, NQ3, RT3>(part, r, 1, ldg(p.bo + 1))),
          sigmoid(row_sum<3, NQ3, RT3>(part, r, 2, ldg(p.bo + 2))),
          row_sum<1, NQ3, RT3>(sdfp, r, 0, ldg(p.bs + SD)));
    }
  }
}

// K3-f32's pass 1 at the wide sizes. Two (W, RT3) f32 tiles hold every
// activation a tile needs at once: A takes h1, feat, dfeat, dh1 and B h2,
// hc (dhc in place), dh2, each written over one that no later step reads;
// the backward reads h1 and h2 only through their `> 0` masks, kept as bits
// (m1, m2: bit r of word k for row r) when they are written, and takes
// dws's sdf column while h2 is in B and dwo while hc is. At width 1024 A
// lies in global memory (at each operand's place in the scratch in the full
// form, else in park3). FORM: 0 dx-only, 1 full, 2 either by `want_wgrad`
// (one kernel for both at widths 768 and 1024, where the parent plan's full
// form compiled alone spilled at (16, 1024, 512)).
template <int FORM>
__global__ void __launch_bounds__(THREADS, 1)
decoder_backward_f32_kernel(const float* __restrict__ x,
                            const float* __restrict__ g, Params p,
                            const float* wpack, float* __restrict__ dx,
                            float* __restrict__ slabs,
                            float* __restrict__ scratch, long long N,
                            int tiles_per_block, int want_wgrad) {
  const bool wgrad = FORM == 2 ? want_wgrad != 0 : FORM == 1;
  extern __shared__ __align__(16) char smem[];
  Arena ar{smem};
  float* A = PARK3 ? park3(wpack) : ar.take<float>(ACT3);
  float* B = ar.take<float>(ACT3);
  float* xs = ar.take<float>(XT3);
  Mask* m1 = ar.take<Mask>(W);                  // h1 > 0
  Mask* m2 = ar.take<Mask>(W);                  // h2 > 0
  float* rowv = ar.take<float>(4 * RT3);        // per row [dzo (3) | g_sdf]
  Ring3 ring = ring_init<Ring3>(ar, wpack, NFWD3 + NBWD3);
  const float* ws_sdf = wpack + SDF3;
  __syncthreads();
  const int tid = threadIdx.x;
  float* slab = slabs + static_cast<long long>(blockIdx.x) * SG::n;
  const long long ntiles = (N + RT3 - 1) / RT3;
  const long long tile0 = static_cast<long long>(blockIdx.x) * tiles_per_block;
  const long long tile1 = min(ntiles, tile0 + tiles_per_block);
  if (tid == 0 && tile0 < tile1) issue(ring, 0, 0);
  // the full form's recompute unrolls 4 k steps at a time: fully unrolled
  // it took 1.06-1.14x as long at widths 384 and 512, dx-only 0.99-1.22x
  // the other way (an H100 at 700 W, in turns, the mapping shape)
  constexpr int UNROLL = FORM == 1 ? 4 : 0;
  Fma3<W, UNROLL> f;
  Fma3<SD, UNROLL> fs;
  Tc<W, RT3> u;
  Tc<SD, RT3> us;
  Dx3 dxp;
  // tile `tile` of operand `op` in the scratch (decoder_wgrad.cuh)
  auto at = [&](int op, long long tile) {
    return scratch + wg::offset_f32(op, tile, D, W, SD, RT3);
  };
  // thread 0: the (cols, RT3) tile at `src` in shared memory, finished (its
  // writers fenced and past a barrier), to operand `op`'s place
  auto store = [&](int op, long long tile, const float* src, int cols) {
    wg::store(at(op, tile), src, 4 * cols * AP3);
  };
  // thread 0, before B's (or, in shared memory, A's) next write: the store
  // of the tile's last contents has read it (at most the one store issued
  // since may still read; none are of A's at width 1024)
  constexpr int LAG = PARK3 ? 0 : 1;

  for (long long tile = tile0; tile < tile1; ++tile) {
    const bool first = tile == tile0, more = tile + 1 < tile1;
    const long long row0 = tile * RT3;
    const int nvalid = static_cast<int>(min(static_cast<long long>(RT3), N - row0));
    float *h1 = A, *feat = A, *dfeat = A, *dh1 = A;
    if constexpr (PARK3) {
      if (wgrad) {
        h1 = at(wg::H1, tile);
        feat = at(wg::FEAT, tile);
        dfeat = at(wg::DFEAT, tile);
        dh1 = at(wg::DH1, tile);
      }
    }
    __syncthreads();                // the last tile's readers
    load_x<RT3>(xs, x, row0, nvalid);
    if (tid < RT3) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (tid < nvalid)
        v = __ldg(reinterpret_cast<const float4*>(g + (row0 + tid) * 4));
      *reinterpret_cast<float4*>(rowv + 4 * tid) = v;   // [g_rgb | g_sdf]
    }
    if (wgrad) bulk::fence_proxy_async();
    __syncthreads();
    if (wgrad && tid == 0) store(wg::X, tile, xs, D);

    // h1 = relu(x w1 + b1) -> A, its mask
    f.zero();
    x_mm(f, xs, nullptr, ring, more);
    f.store(h1, p.b1, true, m1);
    // h2 = relu(h1 w2 + b2) -> B, its mask
    f.zero();
    stream_mm(f, h1, NW3, ring, more);
    f.store(B, p.b2, true, m2);
    if (wgrad) {
      bulk::fence_proxy_async();
      __syncthreads();
      if (tid == 0) {
        if constexpr (!PARK3) store(wg::H1, tile, A, W);
        store(wg::H2, tile, B, W);
      }
      // dws's sdf column h2^T g_sdf
      for (int k = tid; k < W; k += THREADS) {
        float s = 0.f;
        for (int r = 0; r < RT3; ++r) s = fmaf(B[k * AP3 + r], rowv[4 * r + 3], s);
        float* o = slab + SG::ws_sdf + k;
        *o = first ? s : *o + s;
      }
    }
    // feat = h2 ws[:, :SD] + bs[:SD] -> A (h1's store read before the first
    // chunk's barrier)
    if (!PARK3 && wgrad && tid == 0) wg::stored_read_but<1>();
    fs.zero();
    stream_mm(fs, B, NW3, ring, more);
    fs.store(feat, p.bs, false, nullptr);
    if (!PARK3 && wgrad) {
      bulk::fence_proxy_async();
      __syncthreads();
      if (tid == 0) store(wg::FEAT, tile, A, SD);
    }
    // hc = relu(feat wc_f + x wc_x + bc) -> B (h2's store read and h2's
    // readers before the first chunk's barrier)
    if (wgrad && tid == 0) wg::stored_read_but<LAG>();
    f.zero();
    stream_mm(f, feat, NSD3, ring, more);
    x_mm(f, xs, nullptr, ring, more);
    f.store(B, p.bc, true, nullptr);
    __syncthreads();

    // dzo = g_rgb * rgb * (1 - rgb), per row (the partials in the ring's
    // slot of hc's last chunk, free since the barrier above)
    float* part = ring.slot + (ring.cur ^ 1) * CHUNK3;
    row_partials3<3>(part, B, p.wo);
    __syncthreads();
    if (tid < RT3) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float z = 0.f;
#pragma unroll
        for (int q = 0; q < NQ3; ++q) z += part[(3 * q + c) * RT3 + tid];
        const float rgb = sigmoid(z + ldg(p.bo + c));
        rowv[4 * tid + c] = rowv[4 * tid + c] * rgb * (1.f - rgb);
      }
    }
    __syncthreads();
    if (wgrad) {
      // dwo[k][c] = sum_r hc[k][r] dzo[r][c]; dbo[c] = sum_r dzo[r][c]
      for (int k = tid; k < W; k += THREADS) {
        float s[3] = {0.f, 0.f, 0.f};
        for (int r = 0; r < RT3; ++r) {
          const float h = B[k * AP3 + r];
#pragma unroll
          for (int c = 0; c < 3; ++c) s[c] = fmaf(h, rowv[4 * r + c], s[c]);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float* o = slab + SG::wo + 3 * k + c;
          *o = first ? s[c] : *o + s[c];
        }
      }
      if (tid < 3) {
        float s = 0.f;
        for (int r = 0; r < RT3; ++r) s += rowv[4 * r + tid];
        float* o = slab + SG::bo + tid;
        *o = first ? s : *o + s;
      }
      __syncthreads();              // hc's readers are done
    }
    // dhc = (dzo wo^T) * (hc > 0), in place over hc (B)
    for (int e = tid; e < W * (RT3 / 4); e += THREADS) {
      const int k = e / (RT3 / 4), r4 = 4 * (e - k * (RT3 / 4));
      const float w0 = ldg(p.wo + 3 * k), w1 = ldg(p.wo + 3 * k + 1),
                  w2 = ldg(p.wo + 3 * k + 2);
      float* h = B + k * AP3 + r4;
      const float4 hv = *reinterpret_cast<const float4*>(h);
      const float hh[4] = {hv.x, hv.y, hv.z, hv.w};
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* z = rowv + 4 * (r4 + i);
        const float v = fmaf(z[2], w2, fmaf(z[1], w1, z[0] * w0));
        d[i] = hh[i] > 0.f ? v : 0.f;
      }
      *reinterpret_cast<float4*>(h) = make_float4(d[0], d[1], d[2], d[3]);
    }
    if (wgrad) {
      bulk::fence_proxy_async();
      __syncthreads();
      if (tid == 0) store(wg::DHC, tile, B, W);
      col_sum<W, RT3>(slab + SG::bc, B, first);
    }

    // dx = dhc wc_x^T: every warp that holds dx tiles, on every K-slice
    dxp.zero();
    dxp.part(B, ring, more);
    // dfeat = dhc wc_f^T -> A (feat's store read before the first chunk's
    // barrier, feat's last readers before it)
    if (!PARK3 && wgrad && tid == 0) wg::stored_read_but<1>();
    us.zero();
    stream_mm(us, B, NW3, ring, more);
    tf::for_each_acc(us.acc, 0, us.n0(),
                     [&](int r, int c, float& v) { dfeat[c * AP3 + r] = v; });
    if (wgrad) {
      bulk::fence_proxy_async();
      __syncthreads();              // dfeat in place
      if (tid == 0) {
        if constexpr (!PARK3) store(wg::DFEAT, tile, A, SD);
        float s = 0.f;              // dbs's sdf entry: sum_r g_sdf[r]
        for (int r = 0; r < RT3; ++r) s += rowv[4 * r + 3];
        float* o = slab + SG::bs + SD;
        *o = first ? s : *o + s;
      }
      col_sum<SD, RT3>(slab + SG::bs, dfeat, first);
    }
    // dh2 = (dfeat ws[:, :SD]^T + g_sdf ws[:, SD]^T) * (h2 > 0) -> B (dhc's
    // store read and dhc's last readers before the first chunk's barrier)
    if (wgrad && tid == 0) wg::stored_read_but<LAG>();
    u.zero();
    stream_mm(u, dfeat, NSD3, ring, more);
    tf::for_each_acc(u.acc, 0, u.n0(), [&](int r, int c, float& v) {
      const float d = fmaf(rowv[4 * r + 3], ldg(ws_sdf + c), v);
      B[c * AP3 + r] = (m2[c] >> r) & 1u ? d : 0.f;
    });
    if (wgrad) {
      bulk::fence_proxy_async();
      __syncthreads();              // dh2 in place
      if (tid == 0) store(wg::DH2, tile, B, W);
      col_sum<W, RT3>(slab + SG::b2, B, first);
    }
    // dh1 = (dh2 w2^T) * (h1 > 0) -> A (dfeat's store read and dfeat's last
    // readers before the first chunk's barrier)
    if (!PARK3 && wgrad && tid == 0) wg::stored_read_but<1>();
    u.zero();
    stream_mm(u, B, NW3, ring, more);
    tf::for_each_acc(u.acc, 0, u.n0(), [&](int r, int c, float& v) {
      dh1[c * AP3 + r] = (m1[c] >> r) & 1u ? v : 0.f;
    });
    if (wgrad) {
      bulk::fence_proxy_async();
      __syncthreads();              // dh1 in place
      if (!PARK3 && tid == 0) store(wg::DH1, tile, A, W);
      col_sum<W, RT3>(slab + SG::b1, dh1, first);
    }
    // dx += dh1 w1^T
    dxp.part(dh1, ring, more);
    dxp.write(dx, row0, nvalid);
    // the tile's stores have read x, A and B, which the next tile overwrites
    if (wgrad && tid == 0) wg::stored_read();
  }
  if (wgrad && tid == 0) wg::stored();
}

#else
// K3-f32's pass 1 up to width 256: four (W, RT) tiles. FORM: 0 dx-only,
// 1 full.
template <int FORM>
__global__ void __launch_bounds__(THREADS, 1)
decoder_backward_f32_kernel(const float* __restrict__ x,
                            const float* __restrict__ g, Params p,
                            const float* wpack, float* __restrict__ dx,
                            float* __restrict__ slabs,
                            float* __restrict__ scratch, long long N,
                            int tiles_per_block, int want_wgrad) {
  const bool wgrad = FORM == 1;
  extern __shared__ __align__(16) char smem[];
  Arena ar{smem};
  float* B0 = ar.take<float>(ACT);
  float* B1 = ar.take<float>(ACT);
  float* B2 = ar.take<float>(ACT);
  float* B3 = ar.take<float>(ACT);
  float* xs = ar.take<float>(XT);
  float* w1s = ar.take<float>(RES);
  float* wcx = ar.take<float>(RES);
  float* rowv = ar.take<float>(4 * RT);       // per row [dzo (3) | g_sdf]
  float* part = ar.take<float>(PART);
  Ring ring = ring_init(ar, wpack, NFWD + NBWD);
  const float* ws_sdf = wpack + SDF_COL;
  if constexpr (!XSTREAM) {
    load_resident(w1s, p.w1);
    load_resident(wcx, p.wc_x);
  }
  __syncthreads();
  const int tid = threadIdx.x;
  float* slab = slabs + static_cast<long long>(blockIdx.x) * SG::n;
  const long long ntiles = (N + RT - 1) / RT;
  const long long tile0 = static_cast<long long>(blockIdx.x) * tiles_per_block;
  const long long tile1 = min(ntiles, tile0 + tiles_per_block);
  if (tid == 0 && tile0 < tile1) issue(ring, 0, 0);
  Fma<W> f;
  Fma<SD> fs;
  Tc<W> u;
  Tc<SD> us;
  // tile `tile` of operand `op` in the scratch (decoder_wgrad.cuh)
  auto at = [&](int op, long long tile) {
    return scratch + wg::offset_f32(op, tile, D, W, SD, RT);
  };
  // thread 0: the (cols, RT) tile at `src` in shared memory, finished (its
  // writers fenced and past a barrier), to operand `op`'s place
  auto store = [&](int op, long long tile, const float* src, int cols) {
    wg::store(at(op, tile), src, 4 * cols * AP);
  };

  for (long long tile = tile0; tile < tile1; ++tile) {
    const bool first = tile == tile0, more = tile + 1 < tile1;
    const long long row0 = tile * RT;
    const int nvalid = static_cast<int>(min(static_cast<long long>(RT), N - row0));
    // the tile's buffers: h1, h2 (later dh1) and feat (later dfeat)
    float *h1 = B0, *h2 = B1, *dh1 = B1, *feat = B2, *dfeat = B2;
    __syncthreads();                // the last tile's readers
    load_x(xs, x, row0, nvalid);
    if (tid < RT) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (tid < nvalid)
        v = __ldg(reinterpret_cast<const float4*>(g + (row0 + tid) * 4));
      *reinterpret_cast<float4*>(rowv + 4 * tid) = v;   // [g_rgb | g_sdf]
    }
    if (wgrad) bulk::fence_proxy_async();
    __syncthreads();
    if (wgrad && tid == 0) store(wg::X, tile, xs, D);

    // forward recompute on the FP32 units: h1, h2, feat, hc -> B3
    f.zero();
    x_mm(f, xs, w1s, ring, more);
    f.store(h1, p.b1, true);
    f.zero();
    stream_mm(f, h1, N_W2, ring, more);
    f.store(h2, p.b2, true);
    fs.zero();
    stream_mm(fs, h2, N_WS, ring, more);
    fs.store(feat, p.bs, false);
    f.zero();
    stream_mm(f, feat, N_WC, ring, more);
    x_mm(f, xs, wcx, ring, more);
    f.store(B3, p.bc, true);
    if (wgrad) bulk::fence_proxy_async();
    __syncthreads();
    if (wgrad && tid == 0) {
      store(wg::H1, tile, h1, W);
      store(wg::H2, tile, h2, W);
      store(wg::FEAT, tile, feat, SD);
    }

    // dzo = g_rgb * rgb * (1 - rgb), per row
    row_partials<3>(part, B3, p.wo);
    __syncthreads();
    if (tid < RT) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float rgb = sigmoid(row_sum<3>(part, tid, c, ldg(p.bo + c)));
        rowv[4 * tid + c] = rowv[4 * tid + c] * rgb * (1.f - rgb);
      }
    }
    __syncthreads();
    if (wgrad) {
      // dwo[k][c] = sum_r hc[k][r] dzo[r][c]; dbo[c] = sum_r dzo[r][c]
      for (int k = tid; k < W; k += THREADS) {
        float s[3] = {0.f, 0.f, 0.f};
        for (int r = 0; r < RT; ++r) {
          const float h = B3[k * AP + r];
#pragma unroll
          for (int c = 0; c < 3; ++c) s[c] = fmaf(h, rowv[4 * r + c], s[c]);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float* o = slab + SG::wo + 3 * k + c;
          *o = first ? s[c] : *o + s[c];
        }
      }
      if (tid < 3) {
        float s = 0.f;
        for (int r = 0; r < RT; ++r) s += rowv[4 * r + tid];
        float* o = slab + SG::bo + tid;
        *o = first ? s : *o + s;
      }
      __syncthreads();              // hc's readers are done
    }
    // dhc = (dzo wo^T) * (hc > 0), in place over hc (B3)
    for (int e = tid; e < W * (RT / 4); e += THREADS) {
      const int k = e / (RT / 4), r4 = 4 * (e - k * (RT / 4));
      const float w0 = ldg(p.wo + 3 * k), w1 = ldg(p.wo + 3 * k + 1),
                  w2 = ldg(p.wo + 3 * k + 2);
      float* h = B3 + k * AP + r4;
      const float4 hv = *reinterpret_cast<const float4*>(h);
      const float hh[4] = {hv.x, hv.y, hv.z, hv.w};
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* z = rowv + 4 * (r4 + i);
        const float v = fmaf(z[2], w2, fmaf(z[1], w1, z[0] * w0));
        d[i] = hh[i] > 0.f ? v : 0.f;
      }
      *reinterpret_cast<float4*>(h) = make_float4(d[0], d[1], d[2], d[3]);
    }
    if (wgrad) bulk::fence_proxy_async();
    __syncthreads();
    if (wgrad && tid == 0) store(wg::DHC, tile, B3, W);

    // with dhc (B3): dbc; dx's part dhc wc_x^T; dfeat = dhc wc_f^T (after
    // the chunks' barriers, feat's last readers being before the first)
    if (wgrad) col_sum<W>(slab + SG::bc, B3, first);
    float dxa[1][1][4];
    tf::zero(dxa);
    float dxb[1][1][4];               // DXT == 2: the warp's second tile
    float dxn[DXN][1][1][4];          // D > 64: the warp's DXN tiles
    if constexpr (D > 64) {
#pragma unroll
      for (int j = 0; j < DXN; ++j) tf::zero(dxn[j]);
      dx_partn(dxn, B3, ring, more);
    } else if constexpr (DXT == 2) {
      tf::zero(dxb);
      dx_part2(dxa, dxb, B3, ring, more);
    } else {
      dx_part(dxa, B3, wcx, ring, more);
    }
    if (wgrad && tid == 0) wg::stored_read();      // feat's store read
    us.zero();
    stream_mm(us, B3, N_WCT, ring, more);
    tf::for_each_acc(us.acc, 0, us.n0(),
                     [&](int r, int c, float& v) { dfeat[c * AP + r] = v; });
    if (wgrad) bulk::fence_proxy_async();
    __syncthreads();                // dfeat in place
    if (wgrad && tid == 0) store(wg::DFEAT, tile, dfeat, SD);

    // with dso = [dfeat | g_sdf]: dbs, and dws's sdf column h2^T g_sdf
    if (wgrad) {
      col_sum<SD>(slab + SG::bs, dfeat, first);
      for (int k = tid; k < W; k += THREADS) {
        float s = 0.f;
        for (int r = 0; r < RT; ++r) s = fmaf(h2[k * AP + r], rowv[4 * r + 3], s);
        float* o = slab + SG::ws_sdf + k;
        *o = first ? s : *o + s;
      }
      if (tid == 0) {
        float s = 0.f;
        for (int r = 0; r < RT; ++r) s += rowv[4 * r + 3];
        float* o = slab + SG::bs + SD;
        *o = first ? s : *o + s;
        wg::stored_read();          // dhc's store read
      }
    }
    // dh2 = (dfeat ws[:, :SD]^T + g_sdf ws[:, SD]^T) * (h2 > 0) -> B3 (dhc's
    // last readers are before the first chunk's barrier)
    u.zero();
    stream_mm(u, dfeat, N_WST, ring, more);
    tf::for_each_acc(u.acc, 0, u.n0(), [&](int r, int c, float& v) {
      const float d = fmaf(rowv[4 * r + 3], ldg(ws_sdf + c), v);
      B3[c * AP + r] = h2[c * AP + r] > 0.f ? d : 0.f;
    });
    if (wgrad) bulk::fence_proxy_async();
    __syncthreads();                // dh2 in place
    if (wgrad && tid == 0) store(wg::DH2, tile, B3, W);

    // db2; dh1 = (dh2 w2^T) * (h1 > 0) (h2's last readers are before the
    // first chunk's barrier)
    if (wgrad) {
      col_sum<W>(slab + SG::b2, B3, first);
      if (tid == 0) wg::stored_read();              // h2's store read
    }
    u.zero();
    stream_mm(u, B3, N_W2T, ring, more);
    tf::for_each_acc(u.acc, 0, u.n0(), [&](int r, int c, float& v) {
      dh1[c * AP + r] = h1[c * AP + r] > 0.f ? v : 0.f;
    });
    if (wgrad) bulk::fence_proxy_async();
    __syncthreads();                // dh1 in place
    if (wgrad && tid == 0) store(wg::DH1, tile, dh1, W);

    // db1; dx = dhc wc_x^T + dh1 w1^T
    if (wgrad) col_sum<W>(slab + SG::b1, dh1, first);
    if constexpr (D > 64) {
      dx_partn(dxn, dh1, ring, more);
      const int w = tid >> 5;
#pragma unroll
      for (int j = 0; j < DXN; ++j) {
        const int t = w + NWARP * j;
        tf::for_each_acc(dxn[j], 16 * (t % (RT / 16)), 8 * (t / (RT / 16)),
                         [&](int r, int c, float& v) {
                           if (r < nvalid) dx[(row0 + r) * D + c] = v;
                         });
      }
    } else if constexpr (DXT == 2) {
      dx_part2(dxa, dxb, dh1, ring, more);
      const int w = tid >> 5;
      tf::for_each_acc(dxa, 16 * (w & 1), 8 * (w >> 1),
                       [&](int r, int c, float& v) {
                         if (r < nvalid) dx[(row0 + r) * D + c] = v;
                       });
      tf::for_each_acc(dxb, 16 * (w & 1), 8 * (w >> 1) + 32,
                       [&](int r, int c, float& v) {
                         if (r < nvalid) dx[(row0 + r) * D + c] = v;
                       });
    } else {
    dx_part(dxa, dh1, w1s, ring, more);
    const int w = tid >> 5;
    if (w < D / 4)
      tf::for_each_acc(dxa, 16 * (w & 1), 8 * (w >> 1),
                       [&](int r, int c, float& v) {
                         if (r < nvalid) dx[(row0 + r) * D + c] = v;
                       });
    }
    // the tile's stores have read x, h1, dfeat, dh2 and dh1, which the next
    // tile overwrites
    if (wgrad && tid == 0) wg::stored_read();
  }
  if (wgrad && tid == 0) wg::stored();
}
#endif

}  // namespace

// K2-f32: out (N, 4) from x (N, D); wpack: the packed-weight scratch
// (decoder_f32_layout's floats); `blocks` persistent blocks (<= tiles of
// the plan's rows, <= the SMs). Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int decoder_forward_f32(const float* x, const void* const* params,
                                   void* wpack, float* out, long long N,
                                   int blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decoder_forward_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K2F_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params prm = params_from(params);
#if DEC_W > 256
  err = pack_k3(prm, static_cast<float*>(wpack), NFWD3, stream);
#else
  err = pack_weights(prm, static_cast<float*>(wpack), NFWD, stream);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  decoder_forward_f32_kernel<<<blocks, THREADS, K2F_SMEM, stream>>>(
      x, prm, static_cast<const float*>(wpack), out, N);
  return static_cast<int>(cudaGetLastError());
}

// K3-f32's pass 1: dx (N, D); when want_wgrad the small gradients' slabs
// (P, wg::small(W, SD).n) and the f32 operands of the large ones in
// `scratch` (decoder_wgrad.cuh's f32 layout, tiles of its height: RT up to
// width 256, RT3 above); wpack: as K2-f32's. P blocks each take
// tiles_per_block tiles. Returns cudaGetLastError() after the launches (0 =
// launched).
extern "C" int decoder_backward_f32(const float* x, const float* g,
                                    const void* const* params, void* wpack,
                                    float* dx, float* slab, float* scratch,
                                    long long N, int P, int tiles_per_block,
                                    int want_wgrad, cudaStream_t stream) {
  // the full form and the dx-only one (tracking), each its own kernel: in
  // one kernel with a run-time switch the dx-only form took up to 18% longer
  // than before the stores (an H100 at 700 W, (64, 512, 128)); one kernel
  // for both at widths 768 and 1024 (FORM's note)
  constexpr int FULL = W > 512 ? 2 : 1, DX_ONLY = W > 512 ? 2 : 0;
  auto kernel = want_wgrad ? decoder_backward_f32_kernel<FULL>
                           : decoder_backward_f32_kernel<DX_ONLY>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K3F_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params prm = params_from(params);
#if DEC_W > 256
  err = pack_k3(prm, static_cast<float*>(wpack), NFWD3 + NBWD3, stream);
#else
  err = pack_weights(prm, static_cast<float*>(wpack), NFWD + NBWD, stream);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<P, THREADS, K3F_SMEM, stream>>>(
      x, g, prm, static_cast<const float*>(wpack), dx, slab, scratch, N,
      tiles_per_block, want_wgrad);
  return static_cast<int>(cudaGetLastError());
}

// The plan's layout: out[0] the tile rows of both kernels, out[1] K3-f32's
// block's shared-memory bytes, out[2] the floats of the packed-weight
// scratch that `blocks` persistent blocks of either kernel need: the
// chunks and ws's sdf column, and at width 1024 each block's parked tile
// after them (park3). Returns 0.
extern "C" int decoder_f32_layout(int blocks, long long* out) {
#if DEC_W > 256
  out[0] = RT3;
  out[2] = PACKED3 + (PARK3 ? static_cast<long long>(blocks) * ACT3 : 0);
#else
  out[0] = RT;
  out[2] = PACKED;
#endif
  out[1] = K3F_SMEM;
  return 0;
}
