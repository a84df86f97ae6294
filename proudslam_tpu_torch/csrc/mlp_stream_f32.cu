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
// At the wide sizes (width 384 and 512) four (W, 32) tiles alone would take
// 294,912 bytes at width 512, so there tiles have RT = 16 rows (the
// `mma.sync` minimum; AP = 20, still conflict-free), w1 and wc_x stream at
// either in_dim, and the ring's chunks have 8 weight rows (16 rows would
// take K3-f32's block to 234,512 bytes at (16, 512, *)): 202,768 bytes at
// (32, 512, 512). Each warp then takes 16 rows x N / 8 columns, the FFMA
// recompute 2 rows a thread, and a row's partial dots are 16. And there
// K2-f32's h1 and h2 products run on the FP32 units too, as K3-f32's
// recompute: the sdf column is a dot of the W values of h2 whose terms can
// nearly cancel, and with 3xTF32's h1 and h2 (each product within ~2^-21
// of the true one, a few times f32's rounding) K2-f32's sdf was 1.9e-5 of
// its largest magnitude from the float64 forward at (32, 512, 384) on the
// pcd features, the f32 plain version 3.6e-6 (an H100, 700 W), against a
// tolerance of 1e-5. The same
// at in_dim 64 (FFMA_H): on in_dim 48 zero-padded to (64, 256, 128),
// 3xTF32's h1 and h2 put K2-f32's sdf 1.04e-5 from the float64 forward
// (the plain version 6.8e-6; an H100, 700 W); the older sizes keep their
// 3xTF32 h1 and h2. In_dim 128 keeps FFMA_H.
// At widths 768 and 1024 (PARK) not even K2-f32's two 16-row tiles fit
// beside the ring (243,984 bytes at (128, 1024, *)), nor K3-f32's four
// (327,680 bytes of tiles at width 1024). There each kernel keeps in shared
// memory as many of its tiles as fit (K2_TILES, K3_TILES: one at width
// 1024, two at 768), and the others lie in a per-block scratch in global
// memory after the packed weights (PARK_F32 tiles at most), read and written
// by the same plain loads and stores as the tiles in shared memory, through
// L1 and L2: every product, sum and mask is the same.
// K3-f32 is pass 1 of two, as in mlp_kernel_f32.cu: each block walks a
// contiguous run of tiles, computes dx and adds the six small gradients
// into its own f32 slab (wg::small's offsets), and stores the f32 operands
// of the five large weight-gradient products to the scratch tile by tile
// (decoder_wgrad.cuh's f32 layout, RT-row tiles at row stride AP), each
// finished tile in shared memory by one bulk copy from thread 0; a tile
// that the kernel parks (widths 768 and 1024) it writes in the scratch, at
// its operand's place, instead of the park. Pass 2 (mlp_wgrad_f32.cu) sums
// the products over long runs of rows and K3's reduce (mlp_wgrad.cu) adds
// its partials and the slabs in a fixed order: no float atomics, bitwise
// repeatable. The dx-only form (tracking) stores nothing and writes no
// slab. A ragged last tile is
// masked: its missing rows carry zero inputs and zero cotangents (they add
// nothing to any gradient) and write no output.

#include "bulk_copy.cuh"
#include "decoder_wgrad.cuh"
#include "tf32x3.cuh"

using namespace dec;
namespace tf = tf32x3;

namespace {

using SG = wg::SmallAt<W, SD>;
constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
// widths above 256 (the wide sizes): 16-row tiles and 8-row chunks
constexpr bool WIDE = W > 256;
constexpr int RT = WIDE ? 16 : 32;  // rows of a tile
constexpr int AP = RT + 4;          // activation row stride (floats)
constexpr int CR = WIDE ? 8 : 16;   // weight rows of a streamed chunk
constexpr int NQ = THREADS / RT;    // partial dots of a row (row_partials)
constexpr int WP = W + 4;           // weight row stride (floats)
constexpr int CHUNK = CR * WP;      // floats of a chunk, and of a ring slot
constexpr int ACT = W * AP;         // one (W, RT) activation tile
constexpr int XT = D * AP;          // the input tile
// in_dim 32 and the wide sizes: w1 and wc_x stream through the ring (XS
// chunks each) rather than stay resident (RES floats each)
constexpr bool XSTREAM = D > 16 || WIDE;
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
// K2-f32's h1 and h2 on the FP32 units (the note on the wide sizes)
constexpr bool FFMA_H = WIDE || D > 32;
// dx's 16 x 8 tiles a warp holds: RT / 16 x D / 8 tiles over the warps,
// two a warp at in_dim 64 with 32-row tiles (dx_part2); at in_dim 128
// DXN a warp (dx_partn)
constexpr int DXT = (RT / 16) * (D / 8) > NWARP ? 2 : 1;
constexpr int DXN = D > 64 ? (RT / 16) * (D / 8) / NWARP : 1;
// widths 768 and 1024: the tiles that do not fit a block lie in global
// memory (the note above), PARK_F32 of them at most a block
constexpr bool PARK = W > 512;
constexpr int PARK_F32 = 3;
constexpr int K2F_REST = 4 * (XT + 2 * RES + NQ * RT + PART) + RING_SMEM;
constexpr int K3F_REST = 4 * (XT + 2 * RES + 4 * RT + PART) + RING_SMEM;
constexpr int tiles_in_smem(int rest, int n) {
  return PARK && (232448 - rest) / (4 * ACT) < n ? (232448 - rest) / (4 * ACT)
                                                 : n;
}
constexpr int K2_TILES = tiles_in_smem(K2F_REST, 2);
constexpr int K3_TILES = tiles_in_smem(K3F_REST, 4);
static_assert(K2_TILES >= 1 && K3_TILES >= 1 && 4 - K3_TILES <= PARK_F32,
              "the tiles in shared memory and in the park");
constexpr int K2F_SMEM = 4 * K2_TILES * ACT + K2F_REST;
constexpr int K3F_SMEM = 4 * K3_TILES * ACT + K3F_REST;
static_assert(K2F_SMEM <= 232448 && K3F_SMEM <= 232448,
              "one block's shared memory");
static_assert((ACT * 4) % 16 == 0 && (XT * 4) % 16 == 0 && (RES * 4) % 16 == 0
                  && (CHUNK * 4) % 16 == 0,
              "16-byte aligned pieces and bulk copies");

__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }

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

// ---- the ring ----

// The chunks a block consumes, in order: `len` per tile (NFWD for K2-f32,
// NFWD + NBWD for K3-f32), the same sequence for every tile; chunk i of
// the sequence is chunk i of the packed buffer.
struct Ring {
  float* slot;        // two slots of CHUNK floats
  uint64_t* bar;      // their mbarriers
  const float* src;   // the packed weights
  int len;            // chunks per tile
  int next;           // sequence index of the chunk the next acquire returns
  int cur;            // its slot
  uint32_t phase;     // bit s: the parity slot s completes next
};

// thread 0: the bulk copy of sequence index i into slot s
__device__ __forceinline__ void issue(const Ring& r, int i, int s) {
  bulk::mbar_expect(r.bar + s, CHUNK * 4);
  bulk::bulk_copy(r.slot + s * CHUNK, r.src + static_cast<long long>(i) * CHUNK,
                  CHUNK * 4, r.bar + s);
}

__device__ inline Ring ring_init(Arena& ar, const float* src, int len) {
  Ring r;
  r.slot = ar.take<float>(2 * CHUNK);
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
__device__ __forceinline__ const float* acquire(Ring& r, bool more) {
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
  return r.slot + s * CHUNK;
}

// ---- products ----

// A row x column product on the tensor cores: out(row, n) = sum over
// K-slices of act[k][row] w[k][n] (act feature-major at stride AP, w
// row-major at stride WP), N output columns, warp w taking columns
// [w N / 8, (w + 1) N / 8) of all RT rows (RT / 16 x N / 64 tiles of
// 16 x 8).
template <int N>
struct Tc {
  static constexpr int TM = RT / 16, TN = N / 64;
  float acc[TM][TN][4];
  __device__ __forceinline__ int n0() const { return (threadIdx.x >> 5) * (N / 8); }
  __device__ __forceinline__ void zero() { tf::zero(acc); }
  template <int K>
  __device__ __forceinline__ void mm(const float* act, const float* w) {
    tf::mm_fm<TM, TN, K, true>(acc, act, AP, w, WP, 0, n0());
  }
  // dst[n][row] = act(out + bias[n])
  __device__ __forceinline__ void store(float* dst,
                                        const float* __restrict__ bias,
                                        bool relu) {
    tf::for_each_acc(acc, 0, n0(), [&](int r, int c, float& v) {
      const float o = v + ldg(bias + c);
      dst[c * AP + r] = relu ? fmaxf(o, 0.f) : o;
    });
  }
};

// The same product on the FP32 units, each output a sequential fused
// multiply-add over k (K3-f32's forward recompute). Thread (ty, l) = (tid /
// 32, tid % 32) owns the RR = RT / 8 rows RR ty .. RR ty + RR - 1 and the
// column pairs 64 j + 2 l, 64 j + 2 l + 1 (j < N / 64).
template <int N>
struct Fma {
  static constexpr int NP = N / 64, RR = RT / 8;
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
      if constexpr (RR == 4) {
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
      } else {
        const float2 a = *reinterpret_cast<const float2*>(act + r * AP + 2 * ty);
        const float av[2] = {a.x, a.y};
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const float2 b =
              *reinterpret_cast<const float2*>(w + r * WP + 64 * j + 2 * l);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            acc[i][2 * j] = fmaf(av[i], b.x, acc[i][2 * j]);
            acc[i][2 * j + 1] = fmaf(av[i], b.y, acc[i][2 * j + 1]);
          }
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
      if constexpr (RR == 4) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i] = acc[i][j] + b;
          if (relu) v[i] = fmaxf(v[i], 0.f);
        }
        *reinterpret_cast<float4*>(dst + c * AP + 4 * ty) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
        float v[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          v[i] = acc[i][j] + b;
          if (relu) v[i] = fmaxf(v[i], 0.f);
        }
        *reinterpret_cast<float2*>(dst + c * AP + 2 * ty) =
            make_float2(v[0], v[1]);
      }
    }
  }
};

// out = sum over the streamed chunks of act's K-slices times the chunks:
// the `nchunks` next chunks of the ring, act's rows [CR c, CR c + CR) with
// chunk c
template <class P>
__device__ __forceinline__ void stream_mm(P& f, const float* act, int nchunks,
                                          Ring& r, bool more) {
#pragma unroll 1
  for (int c = 0; c < nchunks; ++c) {
    const float* w = acquire(r, more);
    f.template mm<CR>(act + c * CR * AP, w);
  }
}

// dx's part (RT x D) += cot wt^T on dx's columns [n_lo, n_lo + ROWS): cot
// feature-major (W, RT), wt those rows of a (D, W) weight at stride WP
// (all D of them resident, or a chunk of the ring); warp w < D / 4 holds
// dx's 16 x 8 tile at (16 (w & 1), 8 (w >> 1)) with 32-row tiles, warp
// w < D / 8 the tile at (0, 8 w) with 16-row ones
template <int ROWS>
__device__ __forceinline__ void dx_mm(float (&acc)[1][1][4], const float* cot,
                                      const float* wt, int n_lo) {
  if constexpr (RT == 32) {
    const int w = threadIdx.x >> 5, n0 = 8 * (w >> 1);
    if (w < D / 4 && n0 >= n_lo && n0 < n_lo + ROWS)
      tf::mm_fm<1, 1, W, false>(acc, cot, AP, wt, WP, 16 * (w & 1), n0 - n_lo);
  } else {
    const int w = threadIdx.x >> 5, n0 = 8 * w;
    if (w < D / 8 && n0 >= n_lo && n0 < n_lo + ROWS)
      tf::mm_fm<1, 1, W, false>(acc, cot, AP, wt, WP, 0, n0 - n_lo);
  }
}

// the forward's x-side product f (+)= x w with w = w1 or wc_x: resident, or
// its XS chunks from the ring
template <class P>
__device__ __forceinline__ void x_mm(P& f, const float* xs, const float* res,
                                     Ring& r, bool more) {
  if constexpr (XSTREAM)
    stream_mm(f, xs, XS, r, more);
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
template <int NC>
__device__ __forceinline__ void col_sum(float* __restrict__ out,
                                        const float* cot, bool first) {
  for (int k = threadIdx.x; k < NC; k += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < RT; r += 4) {
      const float4 v = *reinterpret_cast<const float4*>(cot + k * AP + r);
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

// x's tile (zeros past the last row) into xs, feature-major: thread
// (row, q) = (tid / 4, tid % 4) < (RT, 4) reads x[row, 16k + 4q : 16k +
// 4q + 4] for k < D / 16
__device__ __forceinline__ void load_x(float* xs, const float* __restrict__ x,
                                       long long row0, int nvalid) {
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  if (r >= RT) return;
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    const int c = 16 * k + 4 * q;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nvalid)
      v = __ldg(reinterpret_cast<const float4*>(x + (row0 + r) * D + c));
    xs[(c + 0) * AP + r] = v.x;
    xs[(c + 1) * AP + r] = v.y;
    xs[(c + 2) * AP + r] = v.z;
    xs[(c + 3) * AP + r] = v.w;
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

// the sum of row r's NQ partials of column c, in order, plus b
template <int C>
__device__ __forceinline__ float row_sum(const float* part, int r, int c,
                                         float b) {
  float z = 0.f;
#pragma unroll
  for (int q = 0; q < NQ; ++q) z += part[(C * q + c) * RT + r];
  return z + b;
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

// this block's parked tiles (widths 768 and 1024): PARK_F32 (W, RT) tiles
// after the packed weights
__device__ __forceinline__ float* park_of(const float* wpack) {
  return const_cast<float*>(wpack) + PACKED
         + static_cast<long long>(blockIdx.x) * PARK_F32 * ACT;
}

__global__ void __launch_bounds__(THREADS, 1)
decoder_forward_f32_kernel(const float* __restrict__ x, Params p,
                           const float* wpack, float* __restrict__ out,
                           long long N) {
  extern __shared__ __align__(16) char smem[];
  Arena ar{smem};
  float* a = ar.take<float>(ACT);
  float* b = K2_TILES > 1 ? ar.take<float>(ACT) : park_of(wpack);
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

// FORM: 0 dx-only, 1 full, 2 either by `want_wgrad` (one kernel for both:
// at widths 768 and 1024, where the full form compiled alone spilled 28
// bytes at 255 registers at (16, 1024, 512))
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
  // at widths 768 and 1024 the first 4 - K3_TILES in the park
  float* B0 = K3_TILES > 3 ? ar.take<float>(ACT) : park_of(wpack);
  float* B1 = K3_TILES > 2 ? ar.take<float>(ACT) : park_of(wpack) + ACT;
  float* B2 = K3_TILES > 1 ? ar.take<float>(ACT) : park_of(wpack) + 2 * ACT;
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
    // the tile's buffers: h1, h2 (later dh1) and feat (later dfeat); where
    // one is parked (K3_TILES < 4) and the operands are stored, it lies in
    // the scratch itself, at its operand's place
    float *h1 = B0, *h2 = B1, *dh1 = B1, *feat = B2, *dfeat = B2;
    if constexpr (PARK) {
      if (wgrad) {
        if constexpr (K3_TILES <= 3) h1 = at(wg::H1, tile);
        if constexpr (K3_TILES <= 2) {
          h2 = at(wg::H2, tile);
          dh1 = at(wg::DH1, tile);
        }
        if constexpr (K3_TILES <= 1) {
          feat = at(wg::FEAT, tile);
          dfeat = at(wg::DFEAT, tile);
        }
      }
    }
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
      if constexpr (K3_TILES > 3) store(wg::H1, tile, h1, W);
      if constexpr (K3_TILES > 2) store(wg::H2, tile, h2, W);
      if constexpr (K3_TILES > 1) store(wg::FEAT, tile, feat, SD);
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
    if (wgrad && tid == 0 && K3_TILES > 1)
      store(wg::DFEAT, tile, dfeat, SD);

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
    if (wgrad && tid == 0 && K3_TILES > 2) store(wg::DH1, tile, dh1, W);

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
    if constexpr (RT == 32) {
      if (w < D / 4)
        tf::for_each_acc(dxa, 16 * (w & 1), 8 * (w >> 1),
                         [&](int r, int c, float& v) {
                           if (r < nvalid) dx[(row0 + r) * D + c] = v;
                         });
    } else {
      if (w < D / 8)
        tf::for_each_acc(dxa, 0, 8 * w, [&](int r, int c, float& v) {
          if (r < nvalid) dx[(row0 + r) * D + c] = v;
        });
    }
    }
    // the tile's stores have read x, h1, dfeat, dh2 and dh1, which the next
    // tile overwrites
    if (wgrad && tid == 0) wg::stored_read();
  }
  if (wgrad && tid == 0) wg::stored();
}

}  // namespace

// K2-f32: out (N, D) from x (N, D); wpack: scratch of PACKED floats (at
// widths 768 and 1024 then PARK_F32 tiles of ACT floats for each block);
// `blocks` persistent blocks (<= tiles of RT rows, <= the SMs). Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int decoder_forward_f32(const float* x, const void* const* params,
                                   void* wpack, float* out, long long N,
                                   int blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decoder_forward_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K2F_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params prm = params_from(params);
  err = pack_weights(prm, static_cast<float*>(wpack), NFWD, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  decoder_forward_f32_kernel<<<blocks, THREADS, K2F_SMEM, stream>>>(
      x, prm, static_cast<const float*>(wpack), out, N);
  return static_cast<int>(cudaGetLastError());
}

// K3-f32's pass 1: dx (N, D); when want_wgrad the small gradients' slabs
// (P, wg::small(W, SD).n) and the f32 operands of the large ones in
// `scratch` (decoder_wgrad.cuh's f32 layout, RT-row tiles); wpack: as
// K2-f32's. P blocks each take tiles_per_block tiles of RT rows. Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int decoder_backward_f32(const float* x, const float* g,
                                    const void* const* params, void* wpack,
                                    float* dx, float* slab, float* scratch,
                                    long long N, int P, int tiles_per_block,
                                    int want_wgrad, cudaStream_t stream) {
  // the full form and the dx-only one (tracking), each its own kernel: in
  // one kernel with a run-time switch the dx-only form took up to 18% longer
  // than before the stores (an H100 at 700 W, (64, 512, 128)); one kernel
  // for both at widths 768 and 1024 (FORM's note)
  constexpr int FULL = PARK ? 2 : 1, DX_ONLY = PARK ? 2 : 0;
  auto kernel = want_wgrad ? decoder_backward_f32_kernel<FULL>
                           : decoder_backward_f32_kernel<DX_ONLY>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K3F_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params prm = params_from(params);
  err = pack_weights(prm, static_cast<float*>(wpack), NFWD + NBWD, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<P, THREADS, K3F_SMEM, stream>>>(
      x, g, prm, static_cast<const float*>(wpack), dx, slab, scratch, N,
      tiles_per_block, want_wgrad);
  return static_cast<int>(cudaGetLastError());
}
