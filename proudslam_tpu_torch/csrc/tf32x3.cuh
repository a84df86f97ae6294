// f32 matrix products on Hopper's tensor cores as three TF32 products
// ("3xTF32"), for the f32-operand decoder kernels (mlp_kernel_f32.cu):
// K2-f32's products and K3-f32's backward products.
//
// They replace the products of the TPU kernels `_fwd_kernel` (:132) and
// `_bwd_kernel` (:141) of proudslam_tpu/ops/pallas/mlp_kernel.py traced with
// bf16=False, where every product takes f32 operands. On the FP32 units an
// H100 peaks at 67 TFLOP/s, so an FFMA form of these kernels cannot beat
// ~108k flops per row forward at that rate. The tensor cores take TF32
// operands (10 explicit mantissa bits) at 495 TFLOP/s, and three TF32
// products per f32 product keep f32 accuracy at a third of that:
//
//   hi = cvt.rna.tf32.f32(a),  lo = cvt.rna.tf32.f32(a - hi)
//   a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi      (f32 sums; a_lo b_lo dropped)
//
// hi + lo is a to within 2^-21 relative, and the dropped term is below
// 2^-22 of |a b|, so each product is within a few f32 ulps of the true one
// (tests/test_torch_tf32x3.py emulates this arithmetic on the CPU against
// the plain f32 decoder).
//
// What bounds these products: the tensor cores at 495 / 3 TFLOP/s, which
// `mma.sync` reaches only in part (measured on an H100 at 700 W: ~310
// TFLOP/s TF32 alone, scripts/torch_mma_rate.py), the issue slots of the
// splits and the shared-memory reads that feed them. `wgmma` would reach
// the full rate, but with TF32 it reads only K-major operands from shared
// memory and needs hi and lo copies of every B operand there, which do not
// fit beside K3-f32's activation tiles (it uses 232,192 of a block's
// 232,448 bytes). So this is `mma.sync.m16n8k8`, whose fragments come from
// registers: a warp reads them by hand from the f32 tiles and weights
// where they already lie and splits them into hi and lo in registers; the
// shared-memory plan stays the FFMA form's. Each warp reuses a split A
// fragment over its N tiles and a split B fragment over its M tiles.
//
// Operands, as the kernels store them (f32, in shared memory):
//   - a feature-major tile t[k][row] (row stride ld): the A operand of the
//     row x column products, A(m, k) = t[k * ld + m];
//   - a K-contiguous tile t[m][k]: the A operand of a weight-gradient
//     product (K = the tile's rows), A(m, k) = t[m * ld + k];
//   - a row-major weight w[k][n]: the forward's B(k, n) = w[k * ld + n];
//   - its transpose read in place, and a cotangent tile read as a weight
//     gradient's B operand: B(k, n) = w[n * ld + k].
//
// Fragment layout of m16n8k8 with TF32 operands (PTX ISA), lane l, g = l/4,
// t = l%4: a0..a3 = A(g, t), A(g + 8, t), A(g, t + 4), A(g + 8, t + 4);
// b0, b1 = B(t, g), B(t + 4, g); d0..d3 = D(g, 2t), D(g, 2t + 1),
// D(g + 8, 2t), D(g + 8, 2t + 1). Within one k8 step the products may take
// the 8 k in any order, as long as A and B take the same one. With row
// strides of 68 floats (activations) and 132 (weights), the PTX order
// (k = t, t + 4) reads t[k][row] and w[k][n] at bank (4t + g) mod 32, two
// lanes a bank; the PAIRED order (k = 2t, 2t + 1) reads them at bank
// (8t + g) mod 32, one lane a bank, and puts a transposed weight's pair
// w[n][2t], w[n][2t + 1] side by side (one 8-byte read, at bank
// (4g + 2t) mod 32: two lanes a bank in each half warp). A K-contiguous
// tile read in the PTX order is at bank (4g + t) mod 32, one lane a bank.
// So row x column products use PAIRED and weight-gradient products the PTX
// order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// rna-rounded TF32 value (an f32 bit pattern with its 13 low bits zero)
__device__ __forceinline__ uint32_t to_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
}

// d += A B on one m16n8k8 tile, TF32 operands, f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// split A (m16 x k8) and B (k8 x n8) fragments
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// the k of a lane's first fragment register in a k8 step (the second is
// the next k if PAIRED, else k + 4)
template <bool PAIRED>
__device__ __forceinline__ int k_first(int t) { return PAIRED ? 2 * t : t; }

__device__ __forceinline__ void set_a(FragA& f, float v0, float v1, float v2,
                                      float v3) {
  split(v0, f.hi[0], f.lo[0]);
  split(v1, f.hi[1], f.lo[1]);
  split(v2, f.hi[2], f.lo[2]);
  split(v3, f.hi[3], f.lo[3]);
}

// A(m0.., k0..) from a feature-major tile t[k][row], PAIRED order
__device__ __forceinline__ void load_a_fm(FragA& f, const float* t, int ld,
                                          int m0, int k0) {
  const int g = lane_g(), k = k0 + 2 * lane_t();
  const float* p = t + k * ld + m0 + g;
  set_a(f, p[0], p[8], p[ld], p[ld + 8]);
}

// A(m0.., k0..) from a K-contiguous tile t[m][k], PTX order
__device__ __forceinline__ void load_a_km(FragA& f, const float* t, int ld,
                                          int m0, int k0) {
  const float* p = t + (m0 + lane_g()) * ld + k0 + lane_t();
  set_a(f, p[0], p[8 * ld], p[4], p[8 * ld + 4]);
}

// B(k0.., n0..) from a row-major weight w[k][n], PAIRED order
__device__ __forceinline__ void load_b_kn(FragB& f, const float* w, int ld,
                                          int k0, int n0) {
  const float* p = w + (k0 + 2 * lane_t()) * ld + n0 + lane_g();
  split(p[0], f.hi[0], f.lo[0]);
  split(p[ld], f.hi[1], f.lo[1]);
}

// B(k0.., n0..) = w[n][k] (a transposed weight, a cotangent tile), in the
// order PAIRED or not (the pair is one 8-byte read: ld, k0 and w's offset
// even)
template <bool PAIRED>
__device__ __forceinline__ void load_b_nk(FragB& f, const float* w, int ld,
                                          int k0, int n0) {
  const float* p = w + (n0 + lane_g()) * ld + k0 + k_first<PAIRED>(lane_t());
  float v0, v1;
  if (PAIRED) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    v0 = v.x;
    v1 = v.y;
  } else {
    v0 = p[0];
    v1 = p[4];
  }
  split(v0, f.hi[0], f.lo[0]);
  split(v1, f.hi[1], f.lo[1]);
}

// d += A B in three TF32 products, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// the row and column of accumulator entry e of the tile at (m0, n0)
__device__ __forceinline__ int acc_row(int m0, int e) {
  return m0 + lane_g() + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int n0, int e) {
  return n0 + 2 * lane_t() + (e & 1);
}

// Epilogue: op(row, col, entry) for each entry (a reference) of a warp's
// TM x TN accumulator tiles of 16 x 8 at (m0 + 16 i, n0 + 8 j)
template <int TM, int TN, class Op>
__device__ __forceinline__ void for_each_acc(float (&acc)[TM][TN][4], int m0,
                                             int n0, Op op) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        op(acc_row(m0 + 16 * i, e), acc_col(n0 + 8 * j, e), acc[i][j][e]);
}

// Epilogue over pairs: op(row, col, e0, e1) for the two entries of each
// row of each tile (columns col and col + 1, col even)
template <int TM, int TN, class Op>
__device__ __forceinline__ void for_each_pair(float (&acc)[TM][TN][4], int m0,
                                              int n0, Op op) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        op(acc_row(m0 + 16 * i, 2 * h), acc_col(n0 + 8 * j, 0),
           acc[i][j][2 * h], acc[i][j][2 * h + 1]);
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN][4]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// acc[i][j] += sum_k A(m0 + 16 i + .., k) B(k, n0 + 8 j + ..) over k < K,
// A from a feature-major tile (stride lda), B = w[k][n] (kn) or w[n][k]
// (!kn), both in the PAIRED order
template <int TM, int TN, int K, bool KN>
__device__ __forceinline__ void mm_fm(float (&acc)[TM][TN][4], const float* a,
                                      int lda, const float* w, int ldw, int m0,
                                      int n0) {
#pragma unroll 2
  for (int k = 0; k < K; k += 8) {
    FragA fa[TM];
    FragB fb[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) load_a_fm(fa[i], a, lda, m0 + 16 * i, k);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (KN)
        load_b_kn(fb[j], w, ldw, k, n0 + 8 * j);
      else
        load_b_nk<true>(fb[j], w, ldw, k, n0 + 8 * j);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) mma3(acc[i][j], fa[i], fb[j]);
  }
}

// acc[i][j] += sum_k a[m][k] b[n][k] over k < K (a weight gradient: both
// tiles K-contiguous, K = rows), PTX order
template <int TM, int TN, int K>
__device__ __forceinline__ void mm_kk(float (&acc)[TM][TN][4], const float* a,
                                      const float* b, int ld, int m0, int n0) {
#pragma unroll 2
  for (int k = 0; k < K; k += 8) {
    FragA fa[TM];
    FragB fb[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) load_a_km(fa[i], a, ld, m0 + 16 * i, k);
#pragma unroll
    for (int j = 0; j < TN; ++j) load_b_nk<false>(fb[j], b, ld, k, n0 + 8 * j);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) mma3(acc[i][j], fa[i], fb[j]);
  }
}

}  // namespace tf32x3
