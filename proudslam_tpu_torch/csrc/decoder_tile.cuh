// The decoder's parameter layout and sizes, shared by the decoder kernels
// (K1 render_kernel.cu, K2 and K3 mlp_kernel.cu, K2-f32 and K3-f32
// mlp_kernel_f32.cu): the widths, the 64-row tile, the 11 parameter
// pointers in FusedParams order, the offsets of each parameter's gradient
// in a flat slab, and a shared-memory bump allocator. In K1, K2 and K3
// every matrix product takes bf16-rounded operands (round to nearest even)
// and accumulates their exact products in f32; bias add, ReLU and sigmoid
// run in f32. This is the arithmetic of the TPU kernels' `_dot` with
// bf16=True (preferred_element_type=f32), run on the tensor cores
// (decoder_tc.cuh, decoder_chain.cuh). K2-f32 and K3-f32 are the
// bf16=False form: f32 operands, FFMA on the FP32 units.
//
// Layout (the JAX package's `FusedParams`, all f32 row-major in global
// memory): w1 (D,W) b1 (W) w2 (W,W) b2 (W) ws (W,W+1) [feat cols | sdf col
// last] bs (W+1) wc_f (W,W) wc_x (D,W) bc (W) wo (W,3) bo (3).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dec {

constexpr int D = 16;              // decoder input (embedding) width
constexpr int W = 128;             // hidden width == sdf feature width
constexpr int SO = W + 1;          // sdf head outputs: [feat | sdf]
constexpr int TR = 64;             // rows per tile
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

}  // namespace dec
