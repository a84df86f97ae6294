// Fused decoder forward (kernel K2-f32) and backward (kernel K3-f32) with
// f32 operands.
//
// They replace the TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// proudslam_tpu/ops/pallas/mlp_kernel.py traced with bf16=False (`_run_fwd`,
// `_run_bwd`): there `_make_dot` does not cast, so every product takes f32
// operands. The JAX package checks that form against true f32 products
// (Pallas interpret mode, XLA at "highest" precision), so these kernels
// compute in true f32: every product is an FFMA on the FP32 units, with no
// TF32 and no bf16 rounding anywhere. Bias add, ReLU and sigmoid run in f32
// as in the bf16 kernels (mlp_kernel.cu), and the functions are the same:
// K2-f32 maps x (N, D) to out (N, 4) [sigmoid(rgb), sdf]; K3-f32 recomputes
// the forward per tile and returns dx (N, D) and, unless dx-only, the 11
// parameter gradients summed over all rows.
//
// What bounds them on an H100: arithmetic, ~108k FMA-flops per row forward
// (3x that for the full backward) against 80 bytes of input and output, at
// the FP32 units' 67 TFLOP/s. Design, simple first: persistent blocks of 256
// threads walk 64-row tiles (K2-f32: tile = block + k * grid; K3-f32: a
// contiguous run per block, `backward_partition`). A tile's activations
// live in shared memory feature-major (act[k][row], row stride AP = 68
// floats, so both float4 reads along rows and reads down a feature column
// avoid bank conflicts). Each product is a register-tiled FFMA loop: a
// thread owns a 4-row x 8-column (or, for weight gradients, 8 x 8) block of
// the output and reads float4 operands, 12 or 16 shared loads per 128 or
// 256 FMAs.
//
// Shared memory is the constraint: the f32 weights (FusedParams, 54,276
// floats, 217 KB) do not fit beside the activation tiles in a block's
// 227 KB. So only w1 (8 KB) stays resident; w2, ws and [wc_f; wc_x] are
// staged in turn through one 76 KB buffer (row stride WP = 132 floats:
// conflict-free reads of a weight row and of a weight column's float4
// groups), and the small vectors (biases, wo, ws's sdf column) are read
// through the read-only data path. The backward visits the staged matrices
// in mirror order (w2, ws, wc | wc, ws, w2), so it stages 4 per tile and
// the forward 3; they come from L2, where the 212 KB of weights stay.
//
// K3-f32 keeps the bf16 K3's reduction (decoder_slab.cuh): each block owns
// one f32 slab of partial weight gradients, adds each tile's products into
// it in tile order, and reduce_partials_kernel sums the slabs in a fixed
// order: no float atomics, bitwise repeatable. The dx-only form (tracking)
// writes no slab. A ragged last tile is masked: its missing rows carry zero
// inputs and zero cotangents (they add nothing to any gradient) and write
// no output.

#include "decoder_slab.cuh"

using namespace dec;

namespace {

constexpr int THREADS = 256;
constexpr int AP = TR + 4;        // activation row stride (floats), 17 float4
constexpr int WP = W + 4;         // staged weight row stride, 33 float4
constexpr int ACT = W * AP;       // one feature-major (W, TR) activation tile
constexpr int XT = D * AP;        // the input tile (D, TR)
constexpr int STAGE = (W + D) * WP;   // w2 | ws (W x SO) | [wc_f; wc_x]
constexpr int W1S = D * W;        // w1, resident (row stride W)
static_assert(SO <= WP, "ws fits a staged row");

// what the stage buffer holds
enum Staged { NONE = 0, ST_W2 = 1, ST_WS = 2, ST_WC = 3 };

constexpr int K2F_SMEM = 4 * (2 * ACT + XT + STAGE + W1S + TR * 4);
constexpr int K3F_SMEM = 4 * (4 * ACT + XT + STAGE + W1S + TR * 4);
static_assert(K3F_SMEM <= 232448, "one block's shared memory");

__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }

// Copy a row-major (rows, cols) f32 matrix from global memory into the
// stage at row stride WP.
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int rows, int cols) {
  if (cols % 4 == 0) {
    const int c4 = cols / 4;
    for (int e = threadIdx.x; e < rows * c4; e += THREADS) {
      const int r = e / c4, c = 4 * (e - r * c4);
      *reinterpret_cast<float4*>(dst + r * WP + c) =
          __ldg(reinterpret_cast<const float4*>(src + r * cols + c));
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
      const int r = e / cols;
      dst[r * WP + (e - r * cols)] = __ldg(src + e);
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
  held = want;
  __syncthreads();
}

// Thread layout of the row x column products: ty = tid / 16 owns rows
// 4 ty .. 4 ty + 3, tx = tid % 16 owns 8 columns.
struct Lane {
  int ty, tx;
};

// Forward product: acc[i][j] += sum_r act[r][4 ty + i] w[r][col(j)], with
// col(j) = 4 tx + j (j < 4) or 64 + 4 tx + j - 4; act feature-major (stride
// AP), w row-major (stride ldw).
template <int R>
__device__ __forceinline__ void fwd_mm(float (&acc)[4][8],
                                       const float* act, const float* w,
                                       int ldw, const Lane& ln) {
#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(act + r * AP + 4 * ln.ty);
    const float4 b0 = *reinterpret_cast<const float4*>(w + r * ldw + 4 * ln.tx);
    const float4 b1 =
        *reinterpret_cast<const float4*>(w + r * ldw + 64 + 4 * ln.tx);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ int fcol(int j, const Lane& ln) {
  return j < 4 ? 4 * ln.tx + j : 64 + 4 * ln.tx + (j - 4);
}

__device__ __forceinline__ void zero(float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// dst[col][rows] = act(acc + bias[col]) for the forward product's columns
__device__ __forceinline__ void fwd_store(float* dst, const float (&acc)[4][8],
                                          const float* __restrict__ bias,
                                          bool relu, const Lane& ln) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = fcol(j, ln);
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

// Input-gradient product: acc[i][j] += sum_c cot[c][4 ty + i] w[k][c] with
// k = tx + 16 j: cot feature-major, w staged row-major (stride WP), so this
// is cot times w^T read without a transposed copy.
__device__ __forceinline__ void bwd_mm(float (&acc)[4][8], const float* cot,
                                       const float* w, const Lane& ln) {
#pragma unroll 2
  for (int c = 0; c < W; c += 4) {
    float av[4][4];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float4 a =
          *reinterpret_cast<const float4*>(cot + (c + cc) * AP + 4 * ln.ty);
      av[cc][0] = a.x; av[cc][1] = a.y; av[cc][2] = a.z; av[cc][3] = a.w;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 b =
          *reinterpret_cast<const float4*>(w + (ln.tx + 16 * j) * WP + c);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i][j] = fmaf(av[cc][i], bv[cc], acc[i][j]);
    }
  }
}

// dst[k][rows] = acc * (h[k][rows] > 0) for the input-gradient product's
// columns k = tx + 16 j (the ReLU derivative from the forward tile h)
__device__ __forceinline__ void bwd_store(float* dst, const float (&acc)[4][8],
                                          const float* h, const Lane& ln) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = ln.tx + 16 * j;
    const float4 m = *reinterpret_cast<const float4*>(h + k * AP + 4 * ln.ty);
    *reinterpret_cast<float4*>(dst + k * AP + 4 * ln.ty) = make_float4(
        m.x > 0.f ? acc[0][j] : 0.f, m.y > 0.f ? acc[1][j] : 0.f,
        m.z > 0.f ? acc[2][j] : 0.f, m.w > 0.f ? acc[3][j] : 0.f);
  }
}

// Weight-gradient product over the tile's rows, added into the slab:
// out[m][n] (+)= sum_row act[m][row] cot[n][row] for m = ty + 16 i (i < MI),
// n = tx + 16 j, with out row-major (stride W) in global memory.
template <int MI>
__device__ __forceinline__ void wgrad_mm(float* __restrict__ out,
                                         const float* act, const float* cot,
                                         bool first, const Lane& ln) {
  float acc[MI][8];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int r = 0; r < TR; r += 4) {
    float bv[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 b =
          *reinterpret_cast<const float4*>(cot + (ln.tx + 16 * j) * AP + r);
      bv[j][0] = b.x; bv[j][1] = b.y; bv[j][2] = b.z; bv[j][3] = b.w;
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(act + (ln.ty + 16 * i) * AP + r);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(av[rr], bv[j][rr], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* o = out + (ln.ty + 16 * i) * W + ln.tx + 16 * j;
      *o = first ? acc[i][j] : *o + acc[i][j];
    }
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

// The forward through the feature head: h1 (-> a), h2 (-> b), then the
// feature product of the sdf head (-> c; c may alias a). With `sdf`,
// threads 0..TR-1 also write each row's sdf output into sdf[row] (the
// stage then holds ws). Leaves the stage holding ws.
__device__ __forceinline__ void forward_feat(float* a, float* b, float* c,
                                             const float* xs, const float* w1s,
                                             float* stage, int& held,
                                             const Params& p, float* sdf,
                                             const Lane& ln) {
  float acc[4][8];
  zero(acc);
  fwd_mm<D>(acc, xs, w1s, W, ln);
  fwd_store(a, acc, p.b1, true, ln);
  ensure_stage(stage, held, ST_W2, p);
  __syncthreads();                                  // h1 in place
  zero(acc);
  fwd_mm<W>(acc, a, stage, WP, ln);
  fwd_store(b, acc, p.b2, true, ln);
  ensure_stage(stage, held, ST_WS, p);              // h2 in place
  zero(acc);
  fwd_mm<W>(acc, b, stage, WP, ln);
  if (sdf != nullptr && threadIdx.x < TR) {
    const int r = threadIdx.x;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < W; ++k) s = fmaf(b[k * AP + r], stage[k * WP + W], s);
    sdf[r] = s + ldg(p.bs + W);
  }
  if (c == a) __syncthreads();      // c overwrites h1: its readers are done
  fwd_store(c, acc, p.bs, false, ln);
}

// hc = relu(feat wc_f + x wc_x + bc) -> d (the stage then holds wc)
__device__ __forceinline__ void forward_color(float* d, const float* feat,
                                              const float* xs, float* stage,
                                              int& held, const Params& p,
                                              const Lane& ln) {
  ensure_stage(stage, held, ST_WC, p);              // feat in place
  float acc[4][8];
  zero(acc);
  fwd_mm<W>(acc, feat, stage, WP, ln);
  fwd_mm<D>(acc, xs, stage + W * WP, WP, ln);
  fwd_store(d, acc, p.bc, true, ln);
}

// the color head's pre-sigmoid logit of row r, channel c, from hc
__device__ __forceinline__ float color_logit(const float* hc, int r, int c,
                                             const Params& p) {
  float s = 0.f;
#pragma unroll 8
  for (int k = 0; k < W; ++k) s = fmaf(hc[k * AP + r], ldg(p.wo + 3 * k + c), s);
  return s + ldg(p.bo + c);
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
  float* sdf = w1s + W1S;
  for (int e = threadIdx.x; e < W1S / 4; e += THREADS)
    reinterpret_cast<float4*>(w1s)[e] =
        __ldg(reinterpret_cast<const float4*>(p.w1) + e);
  const Lane ln{static_cast<int>(threadIdx.x) >> 4,
                static_cast<int>(threadIdx.x) & 15};
  int held = NONE;
  const long long ntiles = (N + TR - 1) / TR;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = tile * TR;
    const int nvalid = static_cast<int>(min(static_cast<long long>(TR), N - row0));
    __syncthreads();                                // the last tile's readers
    load_x(xs, x, row0, nvalid);
    __syncthreads();
    forward_feat(a, b, a, xs, w1s, stage, held, p, sdf, ln);   // feat -> a
    forward_color(b, a, xs, stage, held, p, ln);               // hc -> b
    __syncthreads();
    if (threadIdx.x < TR && static_cast<int>(threadIdx.x) < nvalid) {
      const int r = threadIdx.x;
      float rgb[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        rgb[c] = 1.f / (1.f + expf(-color_logit(b, r, c, p)));
      *reinterpret_cast<float4*>(out + (row0 + r) * 4) =
          make_float4(rgb[0], rgb[1], rgb[2], sdf[r]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
decoder_backward_f32_kernel(const float* __restrict__ x,
                            const float* __restrict__ g, Params p,
                            float* __restrict__ dx, float* __restrict__ partial,
                            long long N, int tiles_per_block, int want_wgrad) {
  extern __shared__ __align__(16) float sm[];
  float* B0 = sm;
  float* B1 = B0 + ACT;
  float* B2 = B1 + ACT;
  float* B3 = B2 + ACT;
  float* xs = B3 + ACT;
  float* stage = xs + XT;
  float* w1s = stage + STAGE;
  float* rowv = w1s + W1S;          // per row [dzo (3) | g_sdf]
  for (int e = threadIdx.x; e < W1S / 4; e += THREADS)
    reinterpret_cast<float4*>(w1s)[e] =
        __ldg(reinterpret_cast<const float4*>(p.w1) + e);
  const int tid = threadIdx.x;
  const Lane ln{tid >> 4, tid & 15};
  float* slab = partial + static_cast<long long>(blockIdx.x) * NPARAM;
  const long long ntiles = (N + TR - 1) / TR;
  const long long tile0 = static_cast<long long>(blockIdx.x) * tiles_per_block;
  const long long tile1 = min(ntiles, tile0 + tiles_per_block);
  int held = NONE;
  // dx's owner: thread (row, kq) = (tid % TR, tid / TR) takes dx[row,
  // 4 kq : 4 kq + 4]
  const int xr = tid & (TR - 1), kq = tid / TR;

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
    __syncthreads();

    // forward recompute: h1 -> B0, h2 -> B1, feat -> B2, hc -> B3
    forward_feat(B0, B1, B2, xs, w1s, stage, held, p, nullptr, ln);
    forward_color(B3, B2, xs, stage, held, p, ln);
    __syncthreads();

    // dzo = g_rgb * rgb * (1 - rgb), per row
    if (tid < TR) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float rgb = 1.f / (1.f + expf(-color_logit(B3, tid, c, p)));
        rowv[4 * tid + c] = rowv[4 * tid + c] * rgb * (1.f - rgb);
      }
    }
    __syncthreads();
    if (want_wgrad) {
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
          float* o = slab + OFF_WO + 3 * tid + c;
          *o = first ? s[c] : *o + s[c];
        }
      } else if (tid < W + 3) {
        const int c = tid - W;
        float s = 0.f;
        for (int r = 0; r < TR; ++r) s += rowv[4 * r + c];
        float* o = slab + OFF_BO + c;
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
    __syncthreads();

    // with dhc (B3): dwc_f = feat^T dhc, dwc_x = x^T dhc, dbc; dx's part
    // dhc wc_x^T; dfeat = dhc wc_f^T (-> B2 once feat's readers are done)
    if (want_wgrad) {
      wgrad_mm<8>(slab + S_WCF, B2, B3, first, ln);
      wgrad_mm<1>(slab + OFF_WCX, xs, B3, first, ln);
      col_sum(slab + OFF_BC, B3, first);
    }
    float dxa[4] = {0.f, 0.f, 0.f, 0.f};
    {
      const float* wx = stage + (W + 4 * kq) * WP;    // wc_x rows 4kq..
#pragma unroll 4
      for (int c = 0; c < W; ++c) {
        const float d = B3[c * AP + xr];
#pragma unroll
        for (int i = 0; i < 4; ++i) dxa[i] = fmaf(d, wx[i * WP + c], dxa[i]);
      }
    }
    float acc[4][8];
    zero(acc);
    bwd_mm(acc, B3, stage, ln);
    __syncthreads();                                // feat's readers are done
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = ln.tx + 16 * j;
      *reinterpret_cast<float4*>(B2 + k * AP + 4 * ln.ty) =
          make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    }
    __syncthreads();                                // dfeat in place

    // with dso = [dfeat (B2) | g_sdf]: dws = h2^T dso, dbs
    if (want_wgrad) {
      wgrad_mm<8>(slab + OFF_WS, B1, B2, first, ln);
      col_sum(slab + S_BS, B2, first);
      if (tid < W) {
        float s = 0.f;
        for (int r = 0; r < TR; ++r) s = fmaf(B1[tid * AP + r], rowv[4 * r + 3], s);
        float* o = slab + S_WS_SDF + tid;
        *o = first ? s : *o + s;
      } else if (tid == W) {
        float s = 0.f;
        for (int r = 0; r < TR; ++r) s += rowv[4 * r + 3];
        float* o = slab + S_BS + W;
        *o = first ? s : *o + s;
      }
    }
    // dh2 = (dfeat ws[:, :W]^T + g_sdf ws[:, W]^T) * (h2 > 0) -> B3
    ensure_stage(stage, held, ST_WS, p);
    zero(acc);
    bwd_mm(acc, B2, stage, ln);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float wsdf = stage[(ln.tx + 16 * j) * WP + W];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i][j] = fmaf(rowv[4 * (4 * ln.ty + i) + 3], wsdf, acc[i][j]);
    }
    bwd_store(B3, acc, B1, ln);
    __syncthreads();                                // dh2 in place

    // dw2 = h1^T dh2, db2; dh1 = (dh2 w2^T) * (h1 > 0) -> B1
    if (want_wgrad) {
      wgrad_mm<8>(slab + OFF_W2, B0, B3, first, ln);
      col_sum(slab + OFF_B2, B3, first);
    }
    ensure_stage(stage, held, ST_W2, p);
    zero(acc);
    bwd_mm(acc, B3, stage, ln);
    bwd_store(B1, acc, B0, ln);
    __syncthreads();                                // dh1 in place

    // dw1 = x^T dh1, db1; dx = dh1 w1^T + dhc wc_x^T
    if (want_wgrad) {
      wgrad_mm<1>(slab + OFF_W1, xs, B1, first, ln);
      col_sum(slab + OFF_B1, B1, first);
    }
    {
      const float* w1r = w1s + 4 * kq * W;            // w1 rows 4kq..
#pragma unroll 4
      for (int c = 0; c < W; ++c) {
        const float d = B1[c * AP + xr];
#pragma unroll
        for (int i = 0; i < 4; ++i) dxa[i] = fmaf(d, w1r[i * W + c], dxa[i]);
      }
      if (xr < nvalid)
        *reinterpret_cast<float4*>(dx + (row0 + xr) * D + 4 * kq) =
            make_float4(dxa[0], dxa[1], dxa[2], dxa[3]);
    }
  }
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

// K3-f32: dx (N, D); dparams (NPARAM,) in FusedParams order when
// want_wgrad; partial: (P, NPARAM) scratch. P blocks each take
// tiles_per_block tiles. Returns cudaGetLastError() after the launches.
extern "C" int decoder_backward_f32(const float* x, const float* g,
                                    const void* const* params, float* dx,
                                    float* dparams, float* partial,
                                    long long N, int P, int tiles_per_block,
                                    int want_wgrad, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decoder_backward_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K3F_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  decoder_backward_f32_kernel<<<P, THREADS, K3F_SMEM, stream>>>(
      x, g, params_from(params), dx, partial, N, tiles_per_block, want_wgrad);
  err = cudaGetLastError();
  if (err != cudaSuccess || !want_wgrad) return static_cast<int>(err);
  reduce_partials_kernel<<<(NPARAM + 255) / 256, 256, 0, stream>>>(
      partial, dparams, P);
  return static_cast<int>(cudaGetLastError());
}
