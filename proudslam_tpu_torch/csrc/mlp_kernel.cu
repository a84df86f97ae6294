// Fused decoder forward (kernel K2) and backward (kernel K3) of the port.
//
// K2 replaces the TPU kernel `_fwd_kernel` of
// proudslam_tpu/ops/pallas/mlp_kernel.py (`_run_fwd`, bf16=True): inputs x
// (N, D) f32 -> out (N, 4) f32 [sigmoid(rgb), sdf], the five products with
// bf16 operands and f32 sums. What bounds it on an H100: arithmetic (~108k
// flops per row against 80 bytes of input and output), so the design keeps
// everything but x and out on chip: the weights sit in shared memory as
// bf16 for the block's whole life, and a persistent block (one per SM)
// walks 64-row tiles whose activations never leave shared memory
// (`forward_tile` of decoder_tile.cuh, the arithmetic K1 also runs). The
// last tile is masked, so the rows need no padding. This first form runs
// on the FMA units; tensor cores are later work.
//
// K3 replaces the TPU kernel `_bwd_kernel` of
// proudslam_tpu/ops/pallas/mlp_kernel.py (`_run_bwd`, bf16=True): per tile
// of rows it recomputes the decoder forward, then back-propagates the
// cotangent g (N, 4) [r, g, b, sdf] to dx (N, D) and to all 11 weight and
// bias gradients. Rounding points follow the TPU kernel exactly: every
// product operand, cotangents included, is rounded to bf16 and the products
// are summed in f32; the bias gradients are f32 sums of the unrounded
// cotangents; ReLU masks come from the forward activations.
//
// What bounds it on an H100: arithmetic again (~3 x 108k flops per row:
// forward recompute, input gradients, weight gradients) plus one cross-block
// reduction. The TPU kernel accumulated the weight gradients in one output
// block over a sequential grid; on the GPU blocks run in parallel and in no
// order. Each of P blocks therefore owns a contiguous run of tiles and its
// own f32 slab of partial gradients in device memory (only that block ever
// touches it, in tile order), and a second kernel sums the P slabs in a
// fixed order. There are no float atomics, so the gradients are bitwise
// repeatable from run to run, which lockstep comparisons rely on. The
// activations and cotangents of a tile live in shared memory as bf16
// (buffers are reused as soon as their last reader is done), next to the
// bf16 weights; a ragged last tile is masked (its missing rows carry zero
// cotangents and write nothing).

#include "decoder_tile.cuh"

using namespace dec;

namespace {

// per-tile backward scratch beyond the forward activations
constexpr int BWD_SMEM = pad16(TR * LDW * 2)      // dhc
                         + pad16(TR * 4 * 4)      // dzo (f32)
                         + pad16(TR * 4)          // g_sdf (f32)
                         + pad16(8 * LDW * 4);    // column-sum scratch

// Column sums of this thread's block (f32, masked rows are zero) reduced
// over the 8 warps in a fixed order; thread c < 128 adds the total for
// column c to dst[c]. Ends with a barrier.
__device__ inline void bias_sum(const float acc[RPT][4], float* cs,
                                float* dst, bool first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < RPT; ++p) s += acc[p][q];
    cs[warp * LDW + lane + 32 * q] = s;
  }
  __syncthreads();
  if (threadIdx.x < W) {
    float s = 0.f;
    for (int wp = 0; wp < THREADS / 32; ++wp) s += cs[wp * LDW + threadIdx.x];
    dst[threadIdx.x] = first ? s : dst[threadIdx.x] + s;
  }
  __syncthreads();
}

// dst[k][c] (+)= sum_r A[r][k] * B[r][c] for k < K (a multiple of 32 / 8 =
// 4 per warp pass) and c < 128; each thread owns a 4x4 block (k = kb..kb+3,
// c = lane + 32q). dst is this block's slab, row stride ldd.
__device__ inline void wgrad(const bf16* A, int lda, int K, const bf16* B,
                             int ldb_, float* dst, int ldd, bool first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int kb = warp * 4; kb < K; kb += 32) {
    float acc[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
    for (int r = 0; r < TR; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) a[p] = ldb(A + r * lda + kb + p);
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = ldb(B + r * ldb_ + lane + 32 * q);
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float* o = dst + (kb + p) * ldd + lane + 32 * q;
        *o = first ? acc[p][q] : *o + acc[p][q];
      }
  }
}

// rows r >= nvalid of this thread's block are zeroed
__device__ inline void mask_rows(float acc[RPT][4], int nvalid) {
  const int r0 = (threadIdx.x >> 5) * RPT;
#pragma unroll
  for (int p = 0; p < RPT; ++p)
    if (r0 + p >= nvalid)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
}

// acc *= (act > 0) elementwise (ReLU derivative from the forward tile)
__device__ inline void relu_mask(float acc[RPT][4], const bf16* act) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * RPT;
#pragma unroll
  for (int p = 0; p < RPT; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (!(ldb(act + (r0 + p) * LDW + lane + 32 * q) > 0.f)) acc[p][q] = 0.f;
}

__device__ inline void store_bf16(bf16* dst, const float acc[RPT][4]) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * RPT;
#pragma unroll
  for (int p = 0; p < RPT; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dst[(r0 + p) * LDW + lane + 32 * q] = __float2bfloat16_rn(acc[p][q]);
}

__global__ void __launch_bounds__(THREADS, 1)
decoder_backward_kernel(const float* __restrict__ x,
                        const float* __restrict__ g, Params prm,
                        float* __restrict__ dx, float* __restrict__ partial,
                        long long N, int tiles_per_block, int want_wgrad) {
  extern __shared__ __align__(16) char smem[];
  Arena arena{smem};
  Weights w;
  Acts t;
  carve_weights(arena, w);
  carve_acts(arena, t);
  bf16* dhc = arena.take<bf16>(TR * LDW);
  float* dzo = arena.take<float>(TR * 4);
  float* gsdf = arena.take<float>(TR);
  float* cs = arena.take<float>(8 * LDW);
  load_weights(w, prm);

  float* slab = partial + static_cast<long long>(blockIdx.x) * NPARAM;
  const long long ntiles = (N + TR - 1) / TR;
  const long long tile0 = static_cast<long long>(blockIdx.x) * tiles_per_block;
  const long long tile1 = min(ntiles, tile0 + tiles_per_block);
  const int tid = threadIdx.x;
  float acc[RPT][4];

  for (long long tile = tile0; tile < tile1; ++tile) {
    const bool first = tile == tile0;
    const long long row0 = tile * TR;
    const int nvalid = static_cast<int>(min(static_cast<long long>(TR), N - row0));

    // inputs: x rounded to bf16 (missing rows: zeros)
    for (int i = tid; i < TR * D; i += THREADS) {
      const int r = i / D;
      t.x[i] = __float2bfloat16_rn(r < nvalid ? x[row0 * D + i] : 0.f);
    }
    forward_tile(w, t);

    // dzo = g_rgb * rgb * (1 - rgb); g_sdf kept in f32
    {
      const int r = tid >> 2, c = tid & 3;
      const float gv = r < nvalid ? g[(row0 + r) * 4 + c] : 0.f;
      if (c < 3) {
        const float rgb = t.out[r * 4 + c];
        dzo[r * 4 + c] = gv * rgb * (1.f - rgb);
      } else {
        gsdf[r] = gv;
      }
    }
    __syncthreads();

    if (want_wgrad) {
      // dwo[k][c] = sum_r hc[r][k] dzo[r][c]; dbo[c] = sum_r dzo[r][c]
      for (int e = tid; e < W * 3; e += THREADS) {
        const int k = e / 3, c = e % 3;
        float s = 0.f;
        for (int r = 0; r < TR; ++r)
          s = fmaf(ldb(t.hc + r * LDW + k), rbf(dzo[r * 4 + c]), s);
        float* o = slab + OFF_WO + e;
        *o = first ? s : *o + s;
      }
      if (tid < 3) {
        float s = 0.f;
        for (int r = 0; r < TR; ++r) s += dzo[r * 4 + tid];
        float* o = slab + OFF_BO + tid;
        *o = first ? s : *o + s;
      }
    }

    // dhc = (dzo wo^T) * (hc > 0)
    {
      const int lane = tid & 31, r0 = (tid >> 5) * RPT;
#pragma unroll
      for (int p = 0; p < RPT; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = lane + 32 * q;
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < 3; ++j)
            s = fmaf(rbf(dzo[(r0 + p) * 4 + j]), ldb(w.wo + c * LDO + j), s);
          acc[p][q] = s;
        }
    }
    relu_mask(acc, t.hc);
    mask_rows(acc, nvalid);
    store_bf16(dhc, acc);
    if (want_wgrad) bias_sum(acc, cs, slab + OFF_BC, first);
    __syncthreads();

    if (want_wgrad) {
      wgrad(t.feat, LDW, W, dhc, LDW, slab + OFF_WCF, W, first);
      wgrad(t.x, D, D, dhc, LDW, slab + OFF_WCX, W, first);
    }
    // dfeat = dhc wc_f^T
    zero(acc);
    mm<true>(dhc, LDW, W, w.wc_f, LDW, acc);
    mask_rows(acc, nvalid);
    if (want_wgrad) {
      bias_sum(acc, cs, slab + OFF_BS, first);        // dbs[0..W)
      if (tid == 0) {
        float s = 0.f;
        for (int r = 0; r < TR; ++r) s += gsdf[r];
        float* o = slab + OFF_BS + W;
        *o = first ? s : *o + s;
      }
    }
    __syncthreads();                                  // feat's last reader done
    bf16* dso = t.feat;                               // [dfeat | g_sdf]
    store_bf16(dso, acc);
    if (tid < TR) dso[tid * LDW + W] = __float2bfloat16_rn(gsdf[tid]);
    __syncthreads();

    if (want_wgrad) {
      // dws = h2^T dso: 128 feature columns, then the sdf column
      wgrad(t.h2, LDW, W, dso, LDW, slab + OFF_WS, SO, first);
      if (tid < W) {
        float s = 0.f;
        for (int r = 0; r < TR; ++r)
          s = fmaf(ldb(t.h2 + r * LDW + tid), ldb(dso + r * LDW + W), s);
        float* o = slab + OFF_WS + tid * SO + W;
        *o = first ? s : *o + s;
      }
    }
    // dh2 = (dso ws^T) * (h2 > 0)
    zero(acc);
    mm<true>(dso, LDW, SO, w.ws, LDW, acc);
    relu_mask(acc, t.h2);
    mask_rows(acc, nvalid);
    if (want_wgrad) bias_sum(acc, cs, slab + OFF_B2, first);
    __syncthreads();                                  // hc's last reader done
    bf16* dh2 = t.hc;
    store_bf16(dh2, acc);
    __syncthreads();

    if (want_wgrad) wgrad(t.h1, LDW, W, dh2, LDW, slab + OFF_W2, W, first);
    // dh1 = (dh2 w2^T) * (h1 > 0)
    zero(acc);
    mm<true>(dh2, LDW, W, w.w2, LDW, acc);
    relu_mask(acc, t.h1);
    mask_rows(acc, nvalid);
    if (want_wgrad) bias_sum(acc, cs, slab + OFF_B1, first);
    __syncthreads();                                  // h2's last reader done
    bf16* dh1 = t.h2;
    store_bf16(dh1, acc);
    __syncthreads();

    if (want_wgrad) wgrad(t.x, D, D, dh1, LDW, slab + OFF_W1, W, first);
    // dx = dh1 w1^T + dhc wc_x^T
    for (int e = tid; e < TR * D; e += THREADS) {
      const int r = e / D, i = e % D;
      if (r < nvalid) {
        float s1 = 0.f, s2 = 0.f;
        for (int j = 0; j < W; ++j) {
          s1 = fmaf(ldb(dh1 + r * LDW + j), ldb(w.w1 + i * LDW + j), s1);
          s2 = fmaf(ldb(dhc + r * LDW + j), ldb(w.wc_x + i * LDW + j), s2);
        }
        dx[(row0 + r) * D + i] = s1 + s2;
      }
    }
    __syncthreads();
  }
}

// out[e] = sum over the P slabs, in slab order
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int P) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= NPARAM) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += partial[static_cast<long long>(p) * NPARAM + e];
  out[e] = s;
}

// K2: persistent blocks stride over the 64-row tiles
__global__ void __launch_bounds__(THREADS, 1)
decoder_forward_kernel(const float* __restrict__ x, Params prm,
                       float* __restrict__ out, long long N) {
  extern __shared__ __align__(16) char smem[];
  Arena arena{smem};
  Weights w;
  Acts t;
  carve_weights(arena, w);
  carve_acts(arena, t);
  load_weights(w, prm);

  const long long ntiles = (N + TR - 1) / TR;
  const int tid = threadIdx.x;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = tile * TR;
    const int nvalid = static_cast<int>(min(static_cast<long long>(TR), N - row0));
    // inputs rounded to bf16 (missing rows: zeros); forward_tile starts
    // with a barrier, and the previous tile's last reader of t.x finished
    // before its closing one
    for (int i = tid; i < TR * D; i += THREADS) {
      const int r = i / D;
      t.x[i] = __float2bfloat16_rn(r < nvalid ? x[row0 * D + i] : 0.f);
    }
    forward_tile(w, t);
    for (int i = tid; i < TR * 4; i += THREADS)
      if (i / 4 < nvalid) out[row0 * 4 + i] = t.out[i];
  }
}

}  // namespace

// K2: out (N, 4) from x (N, D); `blocks` persistent blocks (<= tiles).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int decoder_forward(const float* x, const void* const* params,
                               float* out, long long N, int blocks,
                               cudaStream_t stream) {
  const int smem = WEIGHT_SMEM + ACT_SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      decoder_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decoder_forward_kernel<<<blocks, THREADS, smem, stream>>>(
      x, params_from(params), out, N);
  return static_cast<int>(cudaGetLastError());
}

// K3: dx (N, D); dparams (NPARAM,) in FusedParams order when want_wgrad;
// partial: (P, NPARAM) scratch. P blocks each take tiles_per_block tiles.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int decoder_backward(const float* x, const float* g,
                                const void* const* params, float* dx,
                                float* dparams, float* partial, long long N,
                                int P, int tiles_per_block, int want_wgrad,
                                cudaStream_t stream) {
  const int smem = WEIGHT_SMEM + ACT_SMEM + BWD_SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      decoder_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decoder_backward_kernel<<<P, THREADS, smem, stream>>>(
      x, g, params_from(params), dx, partial, N, tiles_per_block, want_wgrad);
  err = cudaGetLastError();
  if (err != cudaSuccess || !want_wgrad) return static_cast<int>(err);
  reduce_partials_kernel<<<(NPARAM + 255) / 256, 256, 0, stream>>>(
      partial, dparams, P);
  return static_cast<int>(cudaGetLastError());
}
