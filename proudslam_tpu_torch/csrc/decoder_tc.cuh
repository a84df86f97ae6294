// Tensor-core pieces of the decoder kernels K1 (render_kernel.cu,
// render_stream.cu), K2 and K3 (mlp_kernel.cu, mlp_stream.cu): the weights
// in shared memory as bf16 in the layout that Hopper's warpgroup matrix
// multiply (`wgmma`) reads, shared-memory matrix descriptors, and the
// `wgmma.mma_async` shapes the kernels issue (m64nNk16, bf16 operands, f32
// sums). The forward that K1 and K2 share is in decoder_chain.cuh (the
// resident plan, (16, 128, 128)) and decoder_stream.cuh (every other size).
//
// Tile layout. A bf16 matrix of `rows` x `cols` (cols is its inner
// dimension, a multiple of 8) is stored as 8x8 core matrices of 128
// contiguous bytes: element (r, c) sits at
//   ((r / 8) * (cols / 8) + c / 8) * 64 + (r % 8) * 8 + c % 8.
// `wgmma` reads such a matrix without swizzle either way round:
//   - K-major (the inner dimension is K): LBO, the step to the next 8 along
//     K, is 128 bytes; SBO, the step to the next 8 rows along M or N, is
//     cols * 16 bytes; one k16 step moves the start by 256 bytes;
//   - MN-major (the inner dimension is M or N): LBO, the step to the next 8
//     along K, is cols * 16 bytes; SBO, the step to the next 8 along M or
//     N, is 128 bytes; one k16 step moves the start by cols * 32 bytes.
// So one copy of a weight serves the forward product (K-major B) and the
// backward product with its transpose (MN-major B), and one copy of an
// activation serves as the A operand of the next product (K-major) and as
// the transposed A or the B operand of a weight-gradient product
// (MN-major). A thread that holds a wgmma accumulator writes its bf16 pairs
// into this layout without bank conflicts: the 32 lanes of a warp cover one
// core matrix.
//
// Accumulator layout of m64nNk16 (f32): thread t of the warpgroup (warp
// w = t / 32, lane l) holds d[4i + e] = D(16w + l/4 + 8*(e/2),
// 8i + 2*(l%4) + e%2) for i < N/8. The A operand of the register form
// m64n128k16 for k-step j is {A(r, 16j + 2c..), A(r + 8, 16j + 2c..),
// A(r, 16j + 8 + 2c..), A(r + 8, 16j + 8 + 2c..)} with r = 16w + l/4,
// c = l%4, two bf16 a register (the lower column in the low half): the same
// positions as accumulator entries 8j..8j+7, so one layer's sums become the
// next layer's A operand in registers.
//
// Shared-memory writes of the generic proxy must be made visible to the
// async proxy (`fence_proxy_async`) before a barrier that precedes the
// `wgmma` that reads them.
#pragma once

#include "decoder_tile.cuh"

namespace tc {

using dec::bf16;
using dec::D;
using dec::SD;
using dec::SO;
using dec::W;

constexpr int TR = dec::TR;        // rows per tile (64): one warpgroup's M
constexpr int WG = 128;           // threads of a warpgroup

__host__ __device__ constexpr int tofs(int r, int c, int cols) {
  return (((r >> 3) * (cols >> 3) + (c >> 3)) << 6) + ((r & 7) << 3) + (c & 7);
}

// shared-memory matrix descriptor without swizzle (layout type 0)
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// descriptors of a tile-layout matrix with `cols` inner elements, and the
// descriptor increment of one k16 step (in the descriptor's 16-byte units)
__device__ __forceinline__ uint64_t desc_k(const bf16* p, int cols) {
  return make_desc(p, 128, cols * 16);
}
__device__ __forceinline__ uint64_t desc_mn(const bf16* p, int cols) {
  return make_desc(p, cols * 16, 128);
}
constexpr uint64_t KSTEP_K = 16;
__host__ __device__ constexpr uint64_t kstep_mn(int cols) { return cols * 2; }

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving register reads or writes across the
// asynchronous products (the registers are "modified" here)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// barrier of the 128 threads of warpgroup `wg` (ids 1, 2, ...; 0 is
// __syncthreads)
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// The decoder's weights in shared memory. A weight w (a inputs x b
// outputs) is held as the tile of its transpose: rows = b, cols = a, so
// the forward product reads it K-major and the backward product MN-major.
// The odd widths (the sdf column of ws, wo) run on the FMA units and are
// kept as f32 holding their bf16-rounded values; biases are f32.
struct TcWeights {
  bf16 *w1, *w2, *ws, *wc_f, *wc_x;   // (W, D), (W, W), (SD, W), (W, SD), (W, D)
  float *ws_sdf;                      // (W): ws[:, SD]
  float *wo;                          // (W, 4): wo, rows padded to 4
  float *b1, *b2, *bs, *bc, *bo;
};

// the small ones: w1 and wc_x as bf16 tiles, the f32 vectors
constexpr int TC_SMALL_SMEM =
    2 * dec::pad16(W * D * 2) + dec::pad16(W * 4) + dec::pad16(W * 4 * 4)
    + 3 * dec::pad16(W * 4) + dec::pad16(SO * 4) + dec::pad16(3 * 4);
// of which w1 and wc_x: 64 KB at (64, 256, *), which K3 at in_dim 64
// streams through its ring instead (decoder_stream.cuh)
constexpr int TC_X_SMEM = 2 * dec::pad16(W * D * 2);
constexpr int TC_WEIGHT_SMEM =
    TC_SMALL_SMEM + dec::pad16(W * W * 2) + 2 * dec::pad16(W * SD * 2);

// carves the small weights only (w2, ws and wc_f stay null, and w1 and
// wc_x unless X)
template <bool X = true>
__device__ inline void carve_small(dec::Arena& ar, TcWeights& w) {
  if constexpr (X) {
    w.w1 = ar.take<bf16>(W * D);
    w.wc_x = ar.take<bf16>(W * D);
  } else {
    w.w1 = w.wc_x = nullptr;
  }
  w.w2 = w.ws = w.wc_f = nullptr;
  w.ws_sdf = ar.take<float>(W);
  w.wo = ar.take<float>(W * 4);
  w.b1 = ar.take<float>(W);
  w.b2 = ar.take<float>(W);
  w.bc = ar.take<float>(W);
  w.bs = ar.take<float>(SO);
  w.bo = ar.take<float>(3);
}

__device__ inline void carve_weights(dec::Arena& ar, TcWeights& w) {
  w.w1 = ar.take<bf16>(W * D);
  w.wc_x = ar.take<bf16>(W * D);
  w.w2 = ar.take<bf16>(W * W);
  w.ws = ar.take<bf16>(SD * W);
  w.wc_f = ar.take<bf16>(W * SD);
  w.ws_sdf = ar.take<float>(W);
  w.wo = ar.take<float>(W * 4);
  w.b1 = ar.take<float>(W);
  w.b2 = ar.take<float>(W);
  w.bc = ar.take<float>(W);
  w.bs = ar.take<float>(SO);
  w.bo = ar.take<float>(3);
}

// src (a, lds) f32 row-major; its first b columns -> dst, tile of the
// transpose (rows b, cols a), rounded to bf16
__device__ inline void load_wtile(bf16* dst, const float* src, int a, int b,
                                  int lds) {
  for (int i = threadIdx.x; i < a * b; i += blockDim.x) {
    const int ai = i / b, bi = i - ai * b;
    dst[tofs(bi, ai, a)] = __float2bfloat16_rn(src[ai * lds + bi]);
  }
}

// global f32 FusedParams -> shared memory (the large three only where
// carved, w1 and wc_x if X); ends with the proxy fence and a barrier, so
// the first wgmma may read the tiles
template <bool X = true>
__device__ inline void load_weights(const TcWeights& w, const dec::Params& p) {
  if constexpr (X) {
    load_wtile(w.w1, p.w1, D, W, W);
    load_wtile(w.wc_x, p.wc_x, D, W, W);
  }
  if (w.w2 != nullptr) {
    load_wtile(w.w2, p.w2, W, W, W);
    load_wtile(w.ws, p.ws, W, SD, SO);
    load_wtile(w.wc_f, p.wc_f, SD, W, W);
  }
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    w.ws_sdf[i] = rbf(p.ws[i * SO + SD]);
    w.b1[i] = p.b1[i];
    w.b2[i] = p.b2[i];
    w.bc[i] = p.bc[i];
  }
  for (int i = threadIdx.x; i < W * 4; i += blockDim.x)
    w.wo[i] = (i & 3) < 3 ? rbf(p.wo[(i >> 2) * 3 + (i & 3)]) : 0.f;
  for (int i = threadIdx.x; i < SO; i += blockDim.x) w.bs[i] = p.bs[i];
  if (threadIdx.x < 3) w.bo[threadIdx.x] = p.bo[threadIdx.x];
  fence_proxy_async();
  __syncthreads();
}

// The wgmma shapes: mma_m64nN<TA, TB>(d, desc_a, desc_b, scale_d) with A
// and B in shared memory (TA/TB = 1: that operand is MN-major), and
// mma_m64n128_rs<TB> with A in registers. scale_d = 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void mma_m64n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_m64n96(float (&d)[48], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47"
      "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_m64n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_m64n32(float (&d)[16], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_m64n16(float (&d)[8], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_m64n8(float (&d)[4], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// m64nNk16 with A and B in shared memory, for the N the kernels issue
template <int N, int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64 || N == 96
                || N == 128, "an issued wgmma shape");
  if constexpr (N == 128) mma_m64n128<TA, TB>(d, da, db, scale_d);
  else if constexpr (N == 96) mma_m64n96<TA, TB>(d, da, db, scale_d);
  else if constexpr (N == 64) mma_m64n64<TA, TB>(d, da, db, scale_d);
  else if constexpr (N == 32) mma_m64n32<TA, TB>(d, da, db, scale_d);
  else if constexpr (N == 16) mma_m64n16<TA, TB>(d, da, db, scale_d);
  else mma_m64n8<TA, TB>(d, da, db, scale_d);
}

template <int TB>
__device__ __forceinline__ void mma_m64n128_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

}  // namespace tc
