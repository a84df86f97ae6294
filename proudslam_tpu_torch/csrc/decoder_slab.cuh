// The decoder backward's weight-gradient slabs, shared by K3 (bf16 operands,
// mlp_kernel.cu) and K3-f32 (f32 operands, mlp_kernel_f32.cu): each block
// of the backward owns one f32 slab of NPARAM partial gradients, which only
// it touches, and reduce_partials_kernel sums the P slabs in slab order.
// There are no float atomics, so the gradients are bitwise repeatable.
//
// A slab holds the gradients in FusedParams order, except that ws is stored
// as its W x SD feature part (row stride SD) then its sdf column, and wc_f
// comes before bs: so the three large blocks start at even offsets and can
// be read and written as float pairs. The reduce pass maps back.
#pragma once

#include "decoder_tile.cuh"

namespace dec {

constexpr int S_WS_SDF = OFF_WS + W * SD;
constexpr int S_WCF = OFF_BS;
constexpr int S_BS = OFF_BS + SD * W;
static_assert(OFF_W2 % 2 == 0 && OFF_WS % 2 == 0 && S_WCF % 2 == 0,
              "float-pair slab blocks");
static_assert(S_BS + SO == OFF_WCX, "the slab has FusedParams' size");

// out[e] = sum over the P slabs, in slab order (the slab layout is above)
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int P) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= NPARAM) return;
  int src = e;
  if (e >= OFF_WS && e < OFF_BS) {
    const int m = (e - OFF_WS) / SO, n = (e - OFF_WS) - m * SO;
    src = n < SD ? OFF_WS + m * SD + n : S_WS_SDF + m;
  } else if (e >= OFF_BS && e < OFF_WCF) {
    src = S_BS + (e - OFF_BS);
  } else if (e >= OFF_WCF && e < OFF_WCX) {
    src = S_WCF + (e - OFF_WCF);
  }
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += partial[static_cast<long long>(p) * NPARAM + src];
  out[e] = s;
}

}  // namespace dec
