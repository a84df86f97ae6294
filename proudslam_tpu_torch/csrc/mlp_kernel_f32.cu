// Fused decoder forward (kernel K2-f32) and backward (kernel K3-f32) with
// f32 operands.
//
// They replace the TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// proudslam_tpu/ops/pallas/mlp_kernel.py traced with bf16=False (`_run_fwd`,
// `_run_bwd`): there `_make_dot` does not cast, so every product takes f32
// operands. The JAX package checks that form against true f32 products
// (Pallas interpret mode, XLA at "highest" precision), so these kernels
// keep f32 accuracy, with no bf16 rounding anywhere. K2-f32's products and
// K3-f32's backward products of width 16 or more run on the tensor cores
// as three TF32 products with f32 sums (3xTF32, tf32x3.cuh), within a few
// f32 ulps of the true product. K3-f32 recomputes the forward, whose ReLU
// masks its backward takes, with FFMA on the FP32 units (FwdFma), in the
// order of the plain version's f32 matmuls: on an H100 at 327,680 rows,
// 3xTF32 there flipped the mask of pre-activations within ~1e-6 of 0
// against the plain version (dx off by 4e-2 of its largest magnitude),
// FFMA none. The sdf column (N = 1) and the color logits (N = 3) are FFMA,
// spread over all 256 threads as 4 partial sums per row added in a fixed
// order; bias add, ReLU, sigmoid, dzo and the column sums run in exact f32
// as in the bf16 kernels (mlp_kernel.cu). The functions are the same:
// K2-f32 maps x (N, D) to out (N, 4) [sigmoid(rgb), sdf]; K3-f32 recomputes
// the forward per tile and returns dx (N, D) and, unless dx-only, the 11
// parameter gradients summed over all rows.
//
// What bounds them on an H100: arithmetic, ~108k flops per row forward
// (2x that for K3-f32's dx and its stores, 3x with pass 2's) against 80
// bytes of input and output (and K3-f32's 3,648 bytes a row stored): at
// the tensor cores' 495 TFLOP/s in TF32, a third of that in 3xTF32, which
// `mma.sync` reaches only in part; the issue slots of the splits and the
// shared-memory reads that feed it; the FP32 units' 67 TFLOP/s for
// K3-f32's forward. Design, simple first: persistent blocks of 256 threads
// (8 warps) walk 64-row tiles (K2-f32: tile = block + k * grid; K3-f32: a
// contiguous run per block, `backward_partition`). A tile's activations
// live in shared memory feature-major (act[k][row], row stride AP = 68
// floats, so float4 reads along rows and the tensor cores' fragment reads
// avoid bank conflicts). The 8 warps share each product: a 64 x 128 output
// as 2 x 4 warp tiles of 32 x 32, the 64 x 16 input gradient dx as 4 x 2
// tiles of 16 x 8.
//
// Shared memory is the constraint: the f32 weights (FusedParams, 54,276
// floats, 217 KB) do not fit beside the activation tiles in a block's
// 227 KB. So only w1 (8 KB) stays resident; w2, ws and [wc_f; wc_x] are
// staged in turn through one 76 KB buffer (row stride WP = 132 floats,
// as w1's: conflict-free fragment reads of w[k][n], one 8-byte read a lane
// of w[n][k]) with asynchronous copies (cp.async), all of a stage in flight
// at once, and the small vectors (biases, wo, ws's sdf column) are read
// through the read-only data path. The backward visits the staged matrices
// in mirror order (w2, ws, wc | wc, ws, w2), so it stages 4 per tile and
// the forward 3; they come from L2, where the 212 KB of weights stay.
//
// K3-f32 is the first of two passes, as K3 is (decoder_wgrad.cuh): it
// computes dx and the six small gradients (the five bias sums, wo's and
// ws's sdf column, added per tile into a per-block f32 slab at
// wg::small's offsets) and stores the f32 operands of the five large
// weight-gradient products, x, h1, h2, feat, dhc, dfeat, dh2 and dh1, each
// finished (TR, cols) tile copied byte for byte from shared memory to the
// scratch by one bulk copy from thread 0 (decoder_wgrad.cuh's f32 layout:
// the tiles feature-major at row stride AP, padding included), which runs
// while the block goes on. Pass 2 (mlp_wgrad_f32.cu) sums those products
// over long runs of rows in registers and K3's reduce (mlp_wgrad.cu) adds
// its partials and the slabs in a fixed order: no float atomics, bitwise
// repeatable. The dx-only form (tracking) stores nothing and writes no
// slab.
// A ragged last tile is masked: its missing rows carry zero inputs and zero
// cotangents (they add nothing to any gradient) and write no output.

#include "decoder_wgrad.cuh"
#include "tf32x3.cuh"

using namespace dec;
namespace tf = tf32x3;

namespace {

using SG = wg::SmallAt<W, SD>;

constexpr int THREADS = 256;
constexpr int AP = TR + 4;        // activation row stride (floats), 17 float4
constexpr int WP = W + 4;         // staged weight row stride, 33 float4
constexpr int ACT = W * AP;       // one feature-major (W, TR) activation tile
constexpr int XT = D * AP;        // the input tile (D, TR)
constexpr int STAGE = (W + D) * WP;   // w2 | ws (W x SO) | [wc_f; wc_x]
constexpr int W1S = D * WP;       // w1, resident
static_assert(SO <= WP, "ws fits a staged row");
static_assert(THREADS == 8 * 32 && TR == 64 && W == 128 && SD == 128
                  && D == 16,
              "the warp tilings below");

// what the stage buffer holds
enum Staged { NONE = 0, ST_W2 = 1, ST_WS = 2, ST_WC = 3 };

constexpr int PART = 12 * TR;     // 4 partial sums x 3 columns per row
constexpr int K2F_SMEM = 4 * (2 * ACT + XT + STAGE + W1S + TR * 4 + PART);
constexpr int K3F_SMEM = 4 * (4 * ACT + XT + STAGE + W1S + TR * 4 + PART);
static_assert(K3F_SMEM <= 232448, "one block's shared memory");

__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }

// Asynchronous global-to-shared copies (cp.async): every copy of a stage
// is in flight at once, then one wait
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// Copy a row-major (rows, cols) f32 matrix from global memory into shared
// memory at row stride WP (asynchronously: copy_wait() completes it).
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int rows, int cols) {
  if (cols % 4 == 0) {
    const int c4 = cols / 4;
    for (int e = threadIdx.x; e < rows * c4; e += THREADS) {
      const int r = e / c4, c = 4 * (e - r * c4);
      copy16(dst + r * WP + c, src + r * cols + c);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
      const int r = e / cols;
      copy4(dst + r * WP + (e - r * cols), src + e);
    }
  }
}

// Make the stage hold `want` (block-uniform); a barrier before (the old
// contents' last readers) and after (the new contents are in place).
__device__ __forceinline__ void ensure_stage(float* stage, int& held, int want,
                                             const Params& p) {
  if (held == want) return;
  __syncthreads();
  if (want == ST_W2) {
    stage_rows(stage, p.w2, W, W);
  } else if (want == ST_WS) {
    stage_rows(stage, p.ws, W, SO);
  } else {
    stage_rows(stage, p.wc_f, W, W);
    stage_rows(stage + W * WP, p.wc_x, D, W);
  }
  copy_wait();
  held = want;
  __syncthreads();
}

// Thread layout of the elementwise passes and of the FFMA forward: ty =
// tid / 16 owns rows 4 ty .. 4 ty + 3, tx = tid % 16 owns 8 columns.
struct Lane {
  int ty, tx;
};

// Warp tile of a 64-row x 128-column product on the tensor cores: rows
// m0 .. m0 + 31, columns n0 .. n0 + 31, as 2 x 4 tiles of 16 x 8.
struct Tile {
  int m0, n0;
};
typedef float Acc[2][4][4];

__device__ __forceinline__ Tile row_tile() {
  const int w = threadIdx.x >> 5;
  return Tile{32 * (w & 1), 32 * (w >> 1)};
}

// The forward's products (out(row, n) += sum_k act[k][row] w[k][n], act
// feature-major at stride AP, w row-major at stride WP) and their epilogue
// (dst[n][row] = act(out + bias[n])), in two forms with one interface.
// FwdTC: 3xTF32 on the tensor cores (K2-f32).
struct FwdTC {
  Tile tl;
  Acc acc;
  __device__ __forceinline__ void zero() { tf::zero(acc); }
  template <int K>
  __device__ __forceinline__ void mm(const float* act, const float* w) {
    tf::mm_fm<2, 4, K, true>(acc, act, AP, w, WP, tl.m0, tl.n0);
  }
  __device__ __forceinline__ void store(float* dst,
                                        const float* __restrict__ bias,
                                        bool relu) {
    tf::for_each_acc(acc, tl.m0, tl.n0, [&](int r, int c, float& v) {
      const float o = v + ldg(bias + c);
      dst[c * AP + r] = relu ? fmaxf(o, 0.f) : o;
    });
  }
};

// FwdFma: FFMA on the FP32 units, each output a sequential fused
// multiply-add over k (K3-f32's forward recompute, whose ReLU masks must
// agree with the plain version's: see the top of this file). A thread owns
// rows 4 ty + i and columns 4 tx + j (j < 4) and 64 + 4 tx + j - 4.
struct FwdFma {
  Lane ln;
  float acc[4][8];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  template <int K>
  __device__ __forceinline__ void mm(const float* act, const float* w) {
#pragma unroll 4
    for (int r = 0; r < K; ++r) {
      const float4 a =
          *reinterpret_cast<const float4*>(act + r * AP + 4 * ln.ty);
      const float4 b0 =
          *reinterpret_cast<const float4*>(w + r * WP + 4 * ln.tx);
      const float4 b1 =
          *reinterpret_cast<const float4*>(w + r * WP + 64 + 4 * ln.tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  __device__ __forceinline__ void store(float* dst,
                                        const float* __restrict__ bias,
                                        bool relu) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j < 4 ? 4 * ln.tx + j : 64 + 4 * ln.tx + (j - 4);
      const float b = ldg(bias + c);
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = acc[i][j] + b;
        if (relu) v[i] = fmaxf(v[i], 0.f);
      }
      *reinterpret_cast<float4*>(dst + c * AP + 4 * ln.ty) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
};

// Input-gradient product: acc(row, k) += sum_c cot[c][row] w[k][c], cot
// feature-major, w staged row-major (stride WP): cot times w^T, read
// without a transposed copy
__device__ __forceinline__ void bwd_mm(Acc& acc, const float* cot,
                                       const float* w, const Tile& tl) {
  tf::mm_fm<2, 4, W, false>(acc, cot, AP, w, WP, tl.m0, tl.n0);
}

// dst[k][row] = acc * (h[k][row] > 0) (the ReLU derivative from the forward
// tile h)
__device__ __forceinline__ void bwd_store(float* dst, Acc& acc,
                                          const float* h, const Tile& tl) {
  tf::for_each_acc(acc, tl.m0, tl.n0, [&](int r, int c, float& v) {
    dst[c * AP + r] = h[c * AP + r] > 0.f ? v : 0.f;
  });
}

// dx's part (tile, 64 x 16) += dcot wt^T: dcot feature-major (W, TR), wt
// the (D, W) weight at stride WP; warp tiles of 16 x 8 (4 x 2)
__device__ __forceinline__ void dx_mm(float (&acc)[1][1][4], const float* dcot,
                                      const float* wt) {
  const int w = threadIdx.x >> 5;
  tf::mm_fm<1, 1, W, false>(acc, dcot, AP, wt, WP, 16 * (w & 3), 8 * (w >> 2));
}

// Column sums over the tile's rows of a feature-major tile, threads 0..W-1
// one column each, added into out[col]
__device__ __forceinline__ void col_sum(float* __restrict__ out,
                                        const float* cot, bool first) {
  const int k = threadIdx.x;
  if (k >= W) return;
  float s = 0.f;
#pragma unroll 4
  for (int r = 0; r < TR; r += 4) {
    const float4 v = *reinterpret_cast<const float4*>(cot + k * AP + r);
    s += v.x;
    s += v.y;
    s += v.z;
    s += v.w;
  }
  out[k] = first ? s : out[k] + s;
}

// x's tile (zeros past the last row) into xs, feature-major: thread
// (row, q) = (tid / 4, tid % 4) reads x[row, 4q:4q+4]
__device__ __forceinline__ void load_x(float* xs, const float* __restrict__ x,
                                       long long row0, int nvalid) {
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r < nvalid)
    v = __ldg(reinterpret_cast<const float4*>(x + (row0 + r) * D + 4 * q));
  xs[(4 * q + 0) * AP + r] = v.x;
  xs[(4 * q + 1) * AP + r] = v.y;
  xs[(4 * q + 2) * AP + r] = v.z;
  xs[(4 * q + 3) * AP + r] = v.w;
}

// The forward through the feature head, with the products of `f` (FwdTC
// or FwdFma): h1 (-> a), h2 (-> b), then the feature product of the sdf
// head (-> c; c may alias a). With `sdf`, threads 0..TR-1 also write each
// row's sdf output into sdf[row] (the stage then holds ws). Leaves the
// stage holding ws.
template <class F>
__device__ __forceinline__ void forward_feat(F& f, float* a, float* b,
                                             float* c, const float* xs,
                                             const float* w1s, float* stage,
                                             int& held, const Params& p,
                                             float* sdf) {
  f.zero();
  f.template mm<D>(xs, w1s);
  f.store(a, p.b1, true);
  ensure_stage(stage, held, ST_W2, p);
  __syncthreads();                                  // h1 in place
  f.zero();
  f.template mm<W>(a, stage);
  f.store(b, p.b2, true);
  ensure_stage(stage, held, ST_WS, p);              // h2 in place
  f.zero();
  f.template mm<W>(b, stage);
  if (sdf != nullptr) {             // 4 partial sums per row, 32 k each
    const int r = threadIdx.x & (TR - 1), q = threadIdx.x / TR;
    float s = 0.f;
#pragma unroll 8
    for (int k = 32 * q; k < 32 * q + 32; ++k)
      s = fmaf(b[k * AP + r], stage[k * WP + W], s);
    sdf[q * TR + r] = s;
  }
  if (c == a) __syncthreads();      // c overwrites h1: its readers are done
  f.store(c, p.bs, false);
}

// hc = relu(feat wc_f + x wc_x + bc) -> d (the stage then holds wc)
template <class F>
__device__ __forceinline__ void forward_color(F& f, float* d,
                                              const float* feat,
                                              const float* xs, float* stage,
                                              int& held, const Params& p) {
  ensure_stage(stage, held, ST_WC, p);              // feat in place
  f.zero();
  f.template mm<W>(feat, stage);
  f.template mm<D>(xs, stage + W * WP);
  f.store(d, p.bc, true);
}

// The color head's partial logits: thread (r, q) = (tid % TR, tid / TR)
// sums hc[k][r] wo[k][c] over k in [32 q, 32 q + 32) into part[q][c][r]
__device__ __forceinline__ void color_partials(float* part, const float* hc,
                                               const Params& p) {
  const int r = threadIdx.x & (TR - 1), q = threadIdx.x / TR;
  float s[3] = {0.f, 0.f, 0.f};
#pragma unroll 8
  for (int k = 32 * q; k < 32 * q + 32; ++k) {
    const float h = hc[k * AP + r];
#pragma unroll
    for (int c = 0; c < 3; ++c) s[c] = fmaf(h, ldg(p.wo + 3 * k + c), s[c]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) part[(3 * q + c) * TR + r] = s[c];
}

// sigmoid of row r's logit of channel c from its 4 partials
__device__ __forceinline__ float color_out(const float* part, int r, int c,
                                           const Params& p) {
  const float z = part[c * TR + r] + part[(3 + c) * TR + r] +
                  part[(6 + c) * TR + r] + part[(9 + c) * TR + r] +
                  ldg(p.bo + c);
  return 1.f / (1.f + expf(-z));
}

__global__ void __launch_bounds__(THREADS, 1)
decoder_forward_f32_kernel(const float* __restrict__ x, Params p,
                           float* __restrict__ out, long long N) {
  extern __shared__ __align__(16) float sm[];
  float* a = sm;
  float* b = a + ACT;
  float* xs = b + ACT;
  float* stage = xs + XT;
  float* w1s = stage + STAGE;
  float* sdf = w1s + W1S;           // 4 partial sdf sums per row
  float* part = sdf + 4 * TR;
  stage_rows(w1s, p.w1, D, W);
  copy_wait();
  FwdTC f{row_tile()};
  int held = NONE;
  const long long ntiles = (N + TR - 1) / TR;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = tile * TR;
    const int nvalid = static_cast<int>(min(static_cast<long long>(TR), N - row0));
    __syncthreads();                                // the last tile's readers
    load_x(xs, x, row0, nvalid);
    __syncthreads();
    forward_feat(f, a, b, a, xs, w1s, stage, held, p, sdf);   // feat -> a
    forward_color(f, b, a, xs, stage, held, p);               // hc -> b
    __syncthreads();
    color_partials(part, b, p);
    __syncthreads();
    if (threadIdx.x < TR && static_cast<int>(threadIdx.x) < nvalid) {
      const int r = threadIdx.x;
      const float s = sdf[r] + sdf[TR + r] + sdf[2 * TR + r] + sdf[3 * TR + r]
                      + ldg(p.bs + W);
      *reinterpret_cast<float4*>(out + (row0 + r) * 4) = make_float4(
          color_out(part, r, 0, p), color_out(part, r, 1, p),
          color_out(part, r, 2, p), s);
    }
  }
}

template <bool WGRAD>
__global__ void __launch_bounds__(THREADS, 1)
decoder_backward_f32_kernel(const float* __restrict__ x,
                            const float* __restrict__ g, Params p,
                            float* __restrict__ dx, float* __restrict__ slabs,
                            float* __restrict__ scratch, long long N,
                            int tiles_per_block) {
  extern __shared__ __align__(16) float sm[];
  float* B0 = sm;
  float* B1 = B0 + ACT;
  float* B2 = B1 + ACT;
  float* B3 = B2 + ACT;
  float* xs = B3 + ACT;
  float* stage = xs + XT;
  float* w1s = stage + STAGE;
  float* rowv = w1s + W1S;          // per row [dzo (3) | g_sdf]
  float* part = rowv + 4 * TR;
  stage_rows(w1s, p.w1, D, W);
  copy_wait();
  const int tid = threadIdx.x;
  const Lane ln{tid >> 4, tid & 15};
  const Tile tl = row_tile();
  FwdFma f{ln};
  float* slab = slabs + static_cast<long long>(blockIdx.x) * SG::n;
  const long long ntiles = (N + TR - 1) / TR;
  const long long tile0 = static_cast<long long>(blockIdx.x) * tiles_per_block;
  const long long tile1 = min(ntiles, tile0 + tiles_per_block);
  int held = NONE;
  // thread 0: tile `tile`'s (cols, TR) tile of operand `op`, finished in
  // shared memory at `src` (its writers fenced and past a barrier), to the
  // scratch (decoder_wgrad.cuh)
  auto store = [&](int op, long long tile, const float* src, int cols) {
    wg::store(scratch + wg::offset_f32(op, tile, D, W, SD, TR), src,
              4 * cols * AP);
  };

  for (long long tile = tile0; tile < tile1; ++tile) {
    const bool first = tile == tile0;
    const long long row0 = tile * TR;
    const int nvalid = static_cast<int>(min(static_cast<long long>(TR), N - row0));
    __syncthreads();                                // the last tile's readers
    load_x(xs, x, row0, nvalid);
    if (tid < TR) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (tid < nvalid)
        v = __ldg(reinterpret_cast<const float4*>(g + (row0 + tid) * 4));
      *reinterpret_cast<float4*>(rowv + 4 * tid) = v;   // [g_rgb | g_sdf]
    }
    if (WGRAD) bulk::fence_proxy_async();
    __syncthreads();
    if (WGRAD && tid == 0) store(wg::X, tile, xs, D);

    // forward recompute: h1 -> B0, h2 -> B1, feat -> B2, hc -> B3
    forward_feat(f, B0, B1, B2, xs, w1s, stage, held, p, nullptr);
    forward_color(f, B3, B2, xs, stage, held, p);
    if (WGRAD) bulk::fence_proxy_async();
    __syncthreads();
    if (WGRAD && tid == 0) {
      store(wg::H1, tile, B0, W);
      store(wg::H2, tile, B1, W);
      store(wg::FEAT, tile, B2, SD);
    }

    // dzo = g_rgb * rgb * (1 - rgb), per row
    color_partials(part, B3, p);
    __syncthreads();
    if (tid < TR) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float rgb = color_out(part, tid, c, p);
        rowv[4 * tid + c] = rowv[4 * tid + c] * rgb * (1.f - rgb);
      }
    }
    __syncthreads();
    if (WGRAD) {
      // dwo[k][c] = sum_r hc[k][r] dzo[r][c]; dbo[c] = sum_r dzo[r][c]
      if (tid < W) {
        float s[3] = {0.f, 0.f, 0.f};
        for (int r = 0; r < TR; ++r) {
          const float h = B3[tid * AP + r];
#pragma unroll
          for (int c = 0; c < 3; ++c) s[c] = fmaf(h, rowv[4 * r + c], s[c]);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float* o = slab + SG::wo + 3 * tid + c;
          *o = first ? s[c] : *o + s[c];
        }
      } else if (tid < W + 3) {
        const int c = tid - W;
        float s = 0.f;
        for (int r = 0; r < TR; ++r) s += rowv[4 * r + c];
        float* o = slab + SG::bo + c;
        *o = first ? s : *o + s;
      }
      __syncthreads();                              // hc's readers are done
    }
    // dhc = (dzo wo^T) * (hc > 0), in place over hc (B3)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = ln.tx + 16 * j;
      const float w0 = ldg(p.wo + 3 * k), w1 = ldg(p.wo + 3 * k + 1),
                  w2 = ldg(p.wo + 3 * k + 2);
      float* h = B3 + k * AP + 4 * ln.ty;
      const float4 hv = *reinterpret_cast<const float4*>(h);
      const float hh[4] = {hv.x, hv.y, hv.z, hv.w};
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* z = rowv + 4 * (4 * ln.ty + i);
        const float v = fmaf(z[2], w2, fmaf(z[1], w1, z[0] * w0));
        d[i] = hh[i] > 0.f ? v : 0.f;
      }
      *reinterpret_cast<float4*>(h) = make_float4(d[0], d[1], d[2], d[3]);
    }
    if (WGRAD) bulk::fence_proxy_async();
    __syncthreads();
    if (WGRAD && tid == 0) store(wg::DHC, tile, B3, W);

    // with dhc (B3): dbc; dx's part dhc wc_x^T; dfeat = dhc wc_f^T (-> B2
    // once feat's readers are done)
    if (WGRAD) col_sum(slab + SG::bc, B3, first);
    float dxa[1][1][4];
    tf::zero(dxa);
    dx_mm(dxa, B3, stage + W * WP);
    Acc acc;
    tf::zero(acc);
    bwd_mm(acc, B3, stage, tl);
    if (WGRAD && tid == 0) wg::stored_read();      // feat's store read
    __syncthreads();                                // feat's readers are done
    tf::for_each_acc(acc, tl.m0, tl.n0,
                     [&](int r, int c, float& v) { B2[c * AP + r] = v; });
    if (WGRAD) bulk::fence_proxy_async();
    __syncthreads();                                // dfeat in place
    if (WGRAD && tid == 0) store(wg::DFEAT, tile, B2, SD);

    // with dso = [dfeat (B2) | g_sdf]: dbs, and dws's sdf column h2^T g_sdf
    if (WGRAD) {
      col_sum(slab + SG::bs, B2, first);
      if (tid < W) {
        float s = 0.f;
        for (int r = 0; r < TR; ++r) s = fmaf(B1[tid * AP + r], rowv[4 * r + 3], s);
        float* o = slab + SG::ws_sdf + tid;
        *o = first ? s : *o + s;
      } else if (tid == W) {
        float s = 0.f;
        for (int r = 0; r < TR; ++r) s += rowv[4 * r + 3];
        float* o = slab + SG::bs + SD;
        *o = first ? s : *o + s;
      }
      if (tid == 0) wg::stored_read();              // dhc's store read
    }
    // dh2 = (dfeat ws[:, :W]^T + g_sdf ws[:, W]^T) * (h2 > 0) -> B3
    ensure_stage(stage, held, ST_WS, p);
    tf::zero(acc);
    bwd_mm(acc, B2, stage, tl);
    tf::for_each_acc(acc, tl.m0, tl.n0, [&](int r, int c, float& v) {
      const float d = fmaf(rowv[4 * r + 3], stage[c * WP + W], v);
      B3[c * AP + r] = B1[c * AP + r] > 0.f ? d : 0.f;
    });
    if (WGRAD) bulk::fence_proxy_async();
    __syncthreads();                                // dh2 in place
    if (WGRAD && tid == 0) store(wg::DH2, tile, B3, W);

    // db2; dh1 = (dh2 w2^T) * (h1 > 0) -> B1
    if (WGRAD) {
      col_sum(slab + SG::b2, B3, first);
      if (tid == 0) wg::stored_read();              // h2's store read
    }
    ensure_stage(stage, held, ST_W2, p);
    tf::zero(acc);
    bwd_mm(acc, B3, stage, tl);
    bwd_store(B1, acc, B0, tl);
    if (WGRAD) bulk::fence_proxy_async();
    __syncthreads();                                // dh1 in place
    if (WGRAD && tid == 0) store(wg::DH1, tile, B1, W);

    // db1; dx = dh1 w1^T + dhc wc_x^T
    if (WGRAD) col_sum(slab + SG::b1, B1, first);
    dx_mm(dxa, B1, w1s);
    const int w = tid >> 5;
    tf::for_each_acc(dxa, 16 * (w & 3), 8 * (w >> 2),
                     [&](int r, int c, float& v) {
                       if (r < nvalid) dx[(row0 + r) * D + c] = v;
                     });
    // the tile's stores have read x, h1, dfeat, dh2 and dh1, which the next
    // tile overwrites
    if (WGRAD && tid == 0) wg::stored_read();
  }
  if (WGRAD && tid == 0) wg::stored();
}

}  // namespace

// K2-f32: out (N, 4) from x (N, D); `blocks` persistent blocks (<= tiles).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int decoder_forward_f32(const float* x, const void* const* params,
                                   float* out, long long N, int blocks,
                                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decoder_forward_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K2F_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  decoder_forward_f32_kernel<<<blocks, THREADS, K2F_SMEM, stream>>>(
      x, params_from(params), out, N);
  return static_cast<int>(cudaGetLastError());
}

// K3-f32's pass 1: dx (N, D); when want_wgrad the small gradients' slabs
// (P, wg::small(W, SD).n) and the f32 operands of the large ones in
// `scratch` (decoder_wgrad.cuh's f32 layout, TR-row tiles). P blocks each
// take tiles_per_block tiles. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int decoder_backward_f32(const float* x, const float* g,
                                    const void* const* params, float* dx,
                                    float* slab, float* scratch, long long N,
                                    int P, int tiles_per_block,
                                    int want_wgrad, cudaStream_t stream) {
  // the full form and the dx-only one (tracking), each its own kernel: in
  // one kernel with a run-time switch the dx-only form took up to 18% longer
  // than before the stores (an H100 at 700 W, (64, 512, 128))
  auto kernel = want_wgrad ? decoder_backward_f32_kernel<true>
                           : decoder_backward_f32_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K3F_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<P, THREADS, K3F_SMEM, stream>>>(
      x, g, params_from(params), dx, slab, scratch, N, tiles_per_block);
  return static_cast<int>(cudaGetLastError());
}
