// K3's weight gradients in two passes: the layouts pass 1 (the backward
// kernel of each plan: mlp_kernel.cu, mlp_stream.cu, mlp_wide.cu,
// mlp_park.cu) and pass 2 (mlp_wgrad.cu) share, and the store pass 1 makes;
// and the same for K3-f32 (pass 1 in mlp_kernel_f32.cu and
// mlp_stream_f32.cu, pass 2 in mlp_wgrad_f32.cu), whose scratch holds f32
// tiles (`offset_f32`).
// Every size here is a run-time value, so pass 2 is built once for all
// decoder sizes.
//
// Why two passes. The TPU kernel `_bwd_kernel` adds each tile's weight
// gradients into output blocks that stay in VMEM across its sequential grid
// (`dw[:] += _dotg(...)`). On Hopper no block holds those sums across the
// grid, and one slab per block read and rewritten after every 64-row tile
// (four k16 steps of `wgmma`) made K3 wait on memory. So pass 1 computes dx
// and the six small gradients (five bias sums, wo's, ws's sdf column; a
// per-block f32 slab, `Small`) and stores the bf16 operands of the five
// large products, act^T cot over the rows:
//   dw2 = h1^T dh2, dws[:, :SD] = h2^T dfeat, dwc_f = feat^T dhc, and, with
//   in_dim rows, dwc_x and dw1 computed transposed (dhc^T x, dh1^T x).
// `_dotg` rounds both operands to bf16, so the stored bf16 operands are
// exactly the products' operands. Pass 2 sums each product over long runs
// of rows in registers, and a fixed-order reduce adds the runs' partial sums
// and the slabs: no float atomics, so the gradients are bitwise repeatable.
//
// The scratch of a chunk: its 64-row tiles in order, and within each the
// operands' (TR, cols) bf16 tiles in `Operand` order, each as the kernels
// hold it in shared memory (decoder_tc.cuh's layout), stored byte for byte;
// so every address pass 1 stores to is the scratch plus the tile's index
// times a constant plus a constant. Row group g of a tile (rows 8g .. 8g +
// 7) holds columns [c, c + 8k) as k core matrices in a row, so pass 2 takes
// any run of a tile's columns as 8 contiguous pieces.
#pragma once

#include "bulk_copy.cuh"
#include "decoder_tc.cuh"

namespace wg {

using dec::bf16;

constexpr int TR = dec::TR;   // rows of a tile

// the operands pass 1 stores, in scratch order
enum Operand { X, H1, H2, FEAT, DHC, DFEAT, DH2, DH1, NOPS };

__host__ __device__ constexpr int cols(int op, int d, int w, int sd) {
  return op == X ? d : (op == FEAT || op == DFEAT ? sd : w);
}

// the columns of all operands: a tile holds TR rows of them
__host__ __device__ constexpr int row_cols(int d, int w, int sd) {
  return d + 5 * w + 2 * sd;
}

// bf16 elements before operand `op`'s tile of row tile `tile`
__host__ __device__ constexpr long long offset(int op, long long tile, int d,
                                               int w, int sd) {
  int c = 0;
  for (int o = 0; o < op; ++o) c += cols(o, d, w, sd);
  return (tile * row_cols(d, w, sd) + c) * TR;
}

// K3-f32's scratch (pass 1 in mlp_kernel_f32.cu and mlp_stream_f32.cu,
// pass 2 in mlp_wgrad_f32.cu): the chunk's tiles of `tr` rows (its plan's
// tile height: 64, 32 or 16) in order, and within each the operands' f32
// tiles in `Operand` order, each feature-major as the kernels hold it in
// shared memory (element (r, c) at c * (tr + 4) + r; the 4 floats past a
// column's rows are padding, copied with it and never read), stored byte
// for byte. Columns [c0, c1) of a tile are one contiguous run.
// Floats before operand `op`'s tile of row tile `tile`:
__host__ __device__ constexpr long long offset_f32(int op, long long tile,
                                                   int d, int w, int sd,
                                                   int tr) {
  int c = 0;
  for (int o = 0; o < op; ++o) c += cols(o, d, w, sd);
  return (tile * row_cols(d, w, sd) + c) * (tr + 4);
}

// The five large products of pass 2, in their order (their partial sums
// follow each other in it, each M x N row-major): A^T B over the rows, M =
// A's columns, N = B's.
constexpr int NJOBS = 5;
constexpr int JOB_A[NJOBS] = {H1, H2, FEAT, DHC, DH1};
constexpr int JOB_B[NJOBS] = {DH2, DFEAT, DHC, X, X};

// The six small gradients in a pass-1 block's f32 slab: b1, b2, bs (SD + 1,
// the sdf bias last), bc, wo (W x 3), bo, and ws's sdf column (W).
struct Small {
  int b1, b2, bs, bc, wo, bo, ws_sdf, n;
};
__host__ __device__ constexpr Small small(int w, int sd) {
  return Small{0, w, 2 * w, 2 * w + sd + 1, 3 * w + sd + 1, 6 * w + sd + 1,
               6 * w + sd + 4, 7 * w + sd + 4};
}
// the same at a size known when compiling, as scalars device code may read
template <int W, int SD>
struct SmallAt {
  static constexpr int b1 = small(W, SD).b1, b2 = small(W, SD).b2,
                       bs = small(W, SD).bs, bc = small(W, SD).bc,
                       wo = small(W, SD).wo, bo = small(W, SD).bo,
                       ws_sdf = small(W, SD).ws_sdf, n = small(W, SD).n;
};

// Pass 1's stores: thread 0 copies a complete tile from shared memory to
// its place in the scratch with one bulk copy (the Tensor Memory
// Accelerator, no register of the other threads), which runs while the
// block goes on. The tile's writes must be fenced for the async proxy and
// behind a barrier (as for a `wgmma` that reads it); before the barrier
// that precedes the tile's next write, thread 0 waits until the copies
// have read their sources (`stored_read`), and before the kernel ends
// until they are done (`stored`).
__device__ __forceinline__ void store(void* dst, const void* src,
                                      int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(bulk::saddr(src)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void stored_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// the same for all but the N copies issued last, which may still read
template <int N>
__device__ __forceinline__ void stored_read_but() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void stored() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace wg
