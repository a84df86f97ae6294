// The decoder's parameter layout and sizes, shared by the decoder kernels
// (K1 render_kernel.cu and render_stream.cu, K2 and K3 mlp_kernel.cu and
// mlp_stream.cu, K2-f32 and K3-f32 mlp_kernel_f32.cu): the widths, the
// 64-row tile, the 11 parameter pointers in FusedParams order, the offsets
// of each parameter's gradient in a flat slab, and a shared-memory bump
// allocator. In K1, K2 and K3 every matrix product takes bf16-rounded
// operands (round to nearest even) and accumulates their exact products in
// f32; bias add, ReLU and sigmoid run in f32. This is the arithmetic of the
// TPU kernels' `_dot` with bf16=True (preferred_element_type=f32), run on
// the tensor cores (decoder_tc.cuh, decoder_chain.cuh, decoder_stream.cuh).
// K2-f32 and K3-f32 are the bf16=False form: f32 operands, products as
// three TF32 products on the tensor cores (tf32x3.cuh), K3-f32's forward
// recompute as FFMA.
//
// The sizes are set per build: -DDEC_D (in_dim, 16, 32, 64 or 128),
// -DDEC_W (the hidden width) and -DDEC_SD (sdf_dim, the sdf head's feature width), by
// default the bench decoder's 16, 128, 128; each size is its own library
// (ops/kernels/build.py). At (16, 128, 128) the weights stay in shared
// memory for a block's life (render_kernel.cu, mlp_kernel.cu); every other
// size up to width 256 streams the large ones through it
// (decoder_stream.cuh), and the widths 384 and 512 stream them all
// (decoder_wide.cuh; mlp_stream_f32.cu for K2-f32 and K3-f32), as do 768
// and 1024, whose activation tiles are parked in global memory
// (decoder_park.cuh; mlp_stream_f32.cu). A row's
// inputs are read as D / 16 chunks of 16 floats, and a product over the
// inputs (x w1, x wc_x) takes D / 16 k16 steps. At in_dim 64 the streamed
// K3 streams w1 and wc_x too (decoder_stream.cuh), and K1 gathers a
// sample's corners in passes where a whole row does not fit
// (render_gather.cuh); in_dim 128 runs the wide plan at every width
// (decoder_wide.cuh), which takes w1 and wc_x there in chunks of 64 input
// rows.
//
// Layout (the JAX package's `FusedParams`, all f32 row-major in global
// memory): w1 (D,W) b1 (W) w2 (W,W) b2 (W) ws (W,SD+1) [feat cols | sdf col
// last] bs (SD+1) wc_f (SD,W) wc_x (D,W) bc (W) wo (W,3) bo (3).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dec {

#ifndef DEC_D
#define DEC_D 16
#endif
#ifndef DEC_W
#define DEC_W 128
#endif
#ifndef DEC_SD
#define DEC_SD 128
#endif

constexpr int D = DEC_D;           // decoder input (embedding) width
constexpr int W = DEC_W;           // hidden width
constexpr int SD = DEC_SD;         // sdf feature width
constexpr int SO = SD + 1;         // sdf head outputs: [feat | sdf]
constexpr int TR = 64;             // rows per tile
constexpr int NPARAM = D * W + W + W * W + W + W * SO + SO + SD * W + D * W
                       + W + W * 3 + 3;    // 54,276 floats at (16, 128, 128)
static_assert(D == 16 || D == 32 || D == 64 || D == 128,
              "the kernels read a row's inputs as D / 16 chunks of 16 floats");
static_assert(W % 64 == 0 && SD % 64 == 0 && SD <= W && W <= 1024,
              "widths are multiples of 64, sdf_dim <= width <= 1024");

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
constexpr int OFF_WCX = OFF_WCF + SD * W;
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

}  // namespace dec
