// Shared pieces of the two decoder kernels (render_kernel.cu, mlp_kernel.cu):
// the decoder's weights held in shared memory as bf16, and the forward pass
// of one tile of TR rows. Every matrix product takes bf16-rounded operands
// (round to nearest even) and accumulates their exact products in f32; bias
// add, ReLU and sigmoid run in f32. This is the arithmetic of the TPU
// kernels' `_dot` (bf16 operands, preferred_element_type=f32).
//
// Layout (the JAX package's `FusedParams`, all f32 row-major in global
// memory): w1 (D,W) b1 (W) w2 (W,W) b2 (W) ws (W,W+1) [feat cols | sdf col
// last] bs (W+1) wc_f (W,W) wc_x (D,W) bc (W) wo (W,3) bo (3).
//
// Work split inside a tile: 256 threads = 8 warps; warp w owns rows
// 8w..8w+7 and lane l owns the 4 columns l, l+32, l+64, l+96 of every
// 128-wide product, so one thread keeps an 8x4 block of sums in registers.
// Operand rows are read by all lanes of a warp at once (a broadcast); weight
// rows are padded to LDW = 130 bf16 (65 words), so the transposed weight
// reads of the backward pass hit 32 distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dec {

constexpr int D = 16;              // decoder input (embedding) width
constexpr int W = 128;             // hidden width == sdf feature width
constexpr int SO = W + 1;          // sdf head outputs: [feat | sdf]
constexpr int LDW = W + 2;         // padded row stride of 128/129-wide tiles
constexpr int LDO = 4;             // row stride of wo (W,3) in shared memory
constexpr int TR = 64;             // rows per tile
constexpr int THREADS = 256;
constexpr int RPT = TR / (THREADS / 32);   // rows per warp (8)
constexpr int NPARAM = D * W + W + W * W + W + W * SO + SO + W * W + D * W
                       + W + W * 3 + 3;    // 54,276 floats

typedef __nv_bfloat16 bf16;

// the 11 parameter arrays, in FusedParams order
struct Params {
  const float *w1, *b1, *w2, *b2, *ws, *bs, *wc_f, *wc_x, *bc, *wo, *bo;
};

inline Params params_from(const void* const* p) {
  Params q;
  q.w1 = (const float*)p[0]; q.b1 = (const float*)p[1];
  q.w2 = (const float*)p[2]; q.b2 = (const float*)p[3];
  q.ws = (const float*)p[4]; q.bs = (const float*)p[5];
  q.wc_f = (const float*)p[6]; q.wc_x = (const float*)p[7];
  q.bc = (const float*)p[8]; q.wo = (const float*)p[9];
  q.bo = (const float*)p[10];
  return q;
}

// offsets of each parameter's gradient in a flat NPARAM slab
constexpr int OFF_W1 = 0;
constexpr int OFF_B1 = OFF_W1 + D * W;
constexpr int OFF_W2 = OFF_B1 + W;
constexpr int OFF_B2 = OFF_W2 + W * W;
constexpr int OFF_WS = OFF_B2 + W;
constexpr int OFF_BS = OFF_WS + W * SO;
constexpr int OFF_WCF = OFF_BS + SO;
constexpr int OFF_WCX = OFF_WCF + W * W;
constexpr int OFF_BC = OFF_WCX + D * W;
constexpr int OFF_WO = OFF_BC + W;
constexpr int OFF_BO = OFF_WO + W * 3;

// shared-memory bump allocator (16-byte aligned pieces)
struct Arena {
  char* p;
  template <typename T>
  __device__ T* take(int n) {
    T* out = reinterpret_cast<T*>(p);
    p += (static_cast<size_t>(n) * sizeof(T) + 15) / 16 * 16;
    return out;
  }
};

__host__ __device__ constexpr int pad16(int bytes) { return (bytes + 15) / 16 * 16; }

// the decoder's weights in shared memory
struct Weights {
  bf16 *w1, *w2, *ws, *wc_f, *wc_x, *wo;
  float *b1, *b2, *bs, *bc, *bo;
};

constexpr int WEIGHT_SMEM =
    pad16(D * LDW * 2) + 3 * pad16(W * LDW * 2) + pad16(D * LDW * 2)
    + pad16(W * LDO * 2) + 3 * pad16(W * 4) + pad16(SO * 4) + pad16(3 * 4);

// forward activations of one tile, bf16 (the rounded values are all that
// any later product or ReLU mask reads)
struct Acts {
  bf16 *x;      // (TR, D)
  bf16 *h1;     // (TR, LDW)
  bf16 *h2;     // (TR, LDW)
  bf16 *feat;   // (TR, LDW) sdf-head feature columns
  bf16 *hc;     // (TR, LDW)
  float *out;   // (TR, 4) f32 [r, g, b, sdf]
};

constexpr int ACT_SMEM = pad16(TR * D * 2) + 4 * pad16(TR * LDW * 2)
                         + pad16(TR * 4 * 4);

__device__ inline float ldb(const bf16* p) { return __bfloat162float(*p); }
__device__ inline float rbf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ inline void carve_weights(Arena& a, Weights& w) {
  w.w1 = a.take<bf16>(D * LDW);
  w.w2 = a.take<bf16>(W * LDW);
  w.ws = a.take<bf16>(W * LDW);
  w.wc_f = a.take<bf16>(W * LDW);
  w.wc_x = a.take<bf16>(D * LDW);
  w.wo = a.take<bf16>(W * LDO);
  w.b1 = a.take<float>(W);
  w.b2 = a.take<float>(W);
  w.bs = a.take<float>(SO);
  w.bc = a.take<float>(W);
  w.bo = a.take<float>(3);
}

__device__ inline void carve_acts(Arena& a, Acts& t) {
  t.x = a.take<bf16>(TR * D);
  t.h1 = a.take<bf16>(TR * LDW);
  t.h2 = a.take<bf16>(TR * LDW);
  t.feat = a.take<bf16>(TR * LDW);
  t.hc = a.take<bf16>(TR * LDW);
  t.out = a.take<float>(TR * 4);
}

__device__ inline void load_matrix(bf16* dst, int ldd, const float* src,
                                   int rows, int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    dst[(i / cols) * ldd + i % cols] = __float2bfloat16_rn(src[i]);
  }
}

__device__ inline void load_vector(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// global f32 weights -> shared bf16 (biases stay f32); ends with a barrier
__device__ inline void load_weights(const Weights& w, const Params& p) {
  load_matrix(w.w1, LDW, p.w1, D, W);
  load_matrix(w.w2, LDW, p.w2, W, W);
  load_matrix(w.ws, LDW, p.ws, W, SO);
  load_matrix(w.wc_f, LDW, p.wc_f, W, W);
  load_matrix(w.wc_x, LDW, p.wc_x, D, W);
  load_matrix(w.wo, LDO, p.wo, W, 3);
  load_vector(w.b1, p.b1, W);
  load_vector(w.b2, p.b2, W);
  load_vector(w.bs, p.bs, SO);
  load_vector(w.bc, p.bc, W);
  load_vector(w.bo, p.bo, 3);
  __syncthreads();
}

__device__ inline void zero(float acc[RPT][4]) {
#pragma unroll
  for (int p = 0; p < RPT; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
}

// acc[p][q] += sum_k A[r][k] * B(k, c) over k < K, for this thread's rows
// r = 8*warp + p and columns c = lane + 32q. B(k, c) = M[k][c] when
// TRANS is false and M[c][k] when it is true (a product with M^T).
template <bool TRANS>
__device__ inline void mm(const bf16* A, int lda, int K, const bf16* M,
                          int ldm, float acc[RPT][4]) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * RPT;
  for (int k = 0; k < K; ++k) {
    float a[RPT], b[4];
#pragma unroll
    for (int p = 0; p < RPT; ++p) a[p] = ldb(A + (r0 + p) * lda + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = lane + 32 * q;
      b[q] = TRANS ? ldb(M + c * ldm + k) : ldb(M + k * ldm + c);
    }
#pragma unroll
    for (int p = 0; p < RPT; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
  }
}

// out[r][c] = bf16(act(acc + bias[c])) for this thread's block
__device__ inline void store_act(bf16* out, const float acc[RPT][4],
                                 const float* bias, bool relu) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * RPT;
#pragma unroll
  for (int p = 0; p < RPT; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = lane + 32 * q;
      float v = acc[p][q] + bias[c];
      if (relu) v = fmaxf(v, 0.f);
      out[(r0 + p) * LDW + c] = __float2bfloat16_rn(v);
    }
}

// Decoder forward of the tile whose inputs t.x are in place. Fills
// t.h1/h2/feat/hc and t.out = [sigmoid(hc wo + bo), sdf]. Starts and ends
// with a barrier.
__device__ inline void forward_tile(const Weights& w, const Acts& t) {
  float acc[RPT][4];
  __syncthreads();
  zero(acc);
  mm<false>(t.x, D, D, w.w1, LDW, acc);
  store_act(t.h1, acc, w.b1, true);
  __syncthreads();
  zero(acc);
  mm<false>(t.h1, LDW, W, w.w2, LDW, acc);
  store_act(t.h2, acc, w.b2, true);
  __syncthreads();
  zero(acc);
  mm<false>(t.h2, LDW, W, w.ws, LDW, acc);     // feat columns 0..W-1
  store_act(t.feat, acc, w.bs, false);
  __syncthreads();
  zero(acc);
  mm<false>(t.feat, LDW, W, w.wc_f, LDW, acc);
  mm<false>(t.x, D, D, w.wc_x, LDW, acc);
  store_act(t.hc, acc, w.bc, true);
  __syncthreads();
  // heads: thread (r, c) = (tid / 4, tid % 4); c < 3 color, c == 3 sdf
  {
    const int r = threadIdx.x >> 2, c = threadIdx.x & 3;
    float s = 0.f;
    if (c < 3) {
      for (int k = 0; k < W; ++k)
        s = fmaf(ldb(t.hc + r * LDW + k), ldb(w.wo + k * LDO + c), s);
      s = 1.f / (1.f + expf(-(s + w.bo[c])));
    } else {
      for (int k = 0; k < W; ++k)
        s = fmaf(ldb(t.h2 + r * LDW + k), ldb(w.ws + k * LDW + W), s);
      s += w.bs[W];
    }
    t.out[r * 4 + c] = s;
  }
  __syncthreads();
}

}  // namespace dec
