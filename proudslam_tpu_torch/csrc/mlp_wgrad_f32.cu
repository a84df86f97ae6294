// Pass 2 of K3-f32 (decoder_wgrad.cuh): the five large weight gradients of
// the f32-operand decoder backward, summed over long runs of rows from the
// f32 operands pass 1 stored (mlp_kernel_f32.cu, mlp_stream_f32.cu). The
// reduce that writes all 11 gradients is K3's (mlp_wgrad.cu): its inputs,
// the splits' partial sums and pass 1's small-gradient slabs, are f32 in
// both forms.
//
// It replaces the weight-gradient sums of the TPU kernel `_bwd_kernel` of
// proudslam_tpu/ops/pallas/mlp_kernel.py (`dw[:] += _dotg(...)`, its lines
// 172-193) traced with bf16=False: f32 products of f32 operands at `_PREC`,
// which on the TPU sum in VMEM across the sequential grid.
//
// What bounds it on an H100: the products' flops, 2 (W W + W SD + SD W +
// 2 D W) a row, as three TF32 products each (3xTF32, tf32x3.cuh) on the
// tensor cores, which `mma.sync` feeds at ~310 TFLOP/s of TF32 (an H100 at
// 700 W, scripts/torch_mma_rate.py), so ~100 TFLOP/s of f32 products at
// most; against the operands' bytes, 4 (D + 5W + 2SD) a row plus the
// padding (3,648 at (16, 128, 128)), each read once from device memory.
// Design:
//   - a block owns one output tile of up to 128 x 128 of one product (8
//     warps, 64 x 32 each: 4 x 4 tiles of m16n8k8) and a run of the
//     chunk's 64-row groups (a split); its f32 sums stay in registers over
//     the whole run, each 64-row group's products summed apart and added
//     in f32 (the note in `product`), and are written once, as the split's
//     partial sum;
//   - the stored tiles are feature-major (t[col][row], row stride TR + 4,
//     TR = 64, 32 or 16 rows), so both operands of A^T B are K-contiguous
//     over the rows, and `ldmatrix` (.b16, four 8 x 8 matrices of 16-bit
//     halves: four 8-row x 4-float pieces) gives a warp an A fragment or
//     two B fragments of m16n8k8 in one instruction, conflict-free at every
//     stride (the rows start 4 banks apart). Each value is split into hi
//     and lo in registers (tf32x3.cuh), lo kept as the f32 a - hi, which
//     the tensor cores read truncated to TF32: hi + lo is a within 2^-21
//     of a, as with lo rounded, one instruction fewer a value (on an
//     H100 this form took 0.854 ms at (16, 128, 128) against 1.026 for
//     per-lane loads and a rounded lo, errors 9.2e-7 and 9.8e-7 of the
//     largest gradient);
//   - a k-block is one 64-row group, the 64 / TR stored tiles of A's
//     columns [m0, m0 + bm) and of B's [n0, n0 + bn), each one contiguous
//     bulk copy, through a ring of STAGES stages (two or three, as many as
//     fit) on mbarriers, which thread 0 refills once the block's products
//     of a stage are done;
//   - `wgmma` with TF32 would need K-major operands in shared memory and
//     hi and lo copies of both: this pass holds no activation tiles, so it
//     could, but `mma.sync` is the simple form, right first;
//   - splits: the wrapper cuts a chunk's rows so that the output tiles,
//     weighted by their area, x splits >= the SMs (mlp_kernel.wgrad_fill,
//     wgrad_splits); the reduce sums the splits' partials and pass 1's
//     per-block slabs of small gradients in a fixed order, so the
//     gradients are bitwise repeatable;
//   - every size and the tile height are run-time arguments: one build
//     serves all decoder sizes.
// A ring wait that does not complete within 2 s traps (a launch error,
// never a hang).

#include "decoder_wgrad.cuh"
#include "tf32x3.cuh"

namespace {

namespace tf = tf32x3;

constexpr int THREADS = 256;
constexpr int BM = 128, BN = 128;   // the output tile
constexpr int KROWS = 64;           // rows of a k-block
constexpr int SMEM_MAX = 232448;

// The ring at tile height TR: a stage holds KT = 64 / TR stored tiles of A
// (BM columns) and of B (BN columns) at row stride AP; as many stages as
// fit a block, at most 4, and their mbarriers.
template <int TR>
struct Ring {
  static constexpr int AP = TR + 4, KT = KROWS / TR;
  static constexpr int STAGE = KT * (BM + BN) * AP;   // floats
  static constexpr int STAGES =
      (SMEM_MAX - 32) / (4 * STAGE) < 4 ? (SMEM_MAX - 32) / (4 * STAGE) : 4;
  static constexpr int SMEM = 4 * STAGES * STAGE + 8 * STAGES;
  static_assert(STAGES >= 2 && SMEM <= SMEM_MAX, "a ring of two stages");
};

// One product in a chunk's scratch: A's and B's tiles of row tile t at a
// + t * tstride and b + t * tstride, each (cols, TR + 4) feature-major.
struct Job {
  const float* a;
  const float* b;
  int m, n;
  int tiles_n;       // output tiles along n
  int tile0;         // the job's first output tile
  long long out;     // floats before its M x N block in a partial
};
struct Jobs {
  Job j[wg::NJOBS];
  int tiles;         // output tiles of all jobs
  long long part;    // floats of a partial
  long long tstride; // floats of a stored tile's operands
  long long ntiles;  // stored tiles of the chunk
  int tr;            // rows of a stored tile
};

// the hi and lo TF32 parts of v (lo the f32 v - hi: the note at the top)
__device__ __forceinline__ void split(uint32_t v, uint32_t& hi,
                                      uint32_t& lo) {
  const float a = __uint_as_float(v);
  hi = tf::to_tf32(a);
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// four 8 x 8 matrices of 16-bit halves from shared memory: lane l gives
// the row address of matrix l / 8, row l % 8, and receives from each
// matrix the 32-bit word (l % 4) of its row l / 4
__device__ __forceinline__ void ldm4(uint32_t (&r)[4], const float* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(bulk::saddr(row)));
}

// A(m0.., k0..) of m16n8k8 from a K-contiguous tile t[m][k] (stride AP):
// the matrices rows m0 .. m0 + 7 and m0 + 8 .. m0 + 15 at k0, then at k0 +
// 4 (a0..a3 = A(g, t), A(g + 8, t), A(g, t + 4), A(g + 8, t + 4))
template <int AP>
__device__ __forceinline__ void load_a(tf::FragA& f, const float* t, int m0,
                                       int k0) {
  const int l = threadIdx.x & 31;
  uint32_t r[4];
  ldm4(r, t + (m0 + (l & 15)) * AP + k0 + 4 * (l >> 4));
#pragma unroll
  for (int e = 0; e < 4; ++e) split(r[e], f.hi[e], f.lo[e]);
}

// B(k0.., n0..) and B(k0.., n0 + 8..) with B(k, n) = t[n][k] (stride AP):
// the matrices rows n0 .. n0 + 7 at k0 and k0 + 4, then rows n0 + 8 .. n0
// + 15 (b0, b1 = B(t, g), B(t + 4, g))
template <int AP>
__device__ __forceinline__ void load_b2(tf::FragB& f0, tf::FragB& f1,
                                        const float* t, int n0, int k0) {
  const int l = threadIdx.x & 31;
  uint32_t r[4];
  ldm4(r, t + (n0 + (l & 7) + 8 * (l >> 4)) * AP + k0 + 4 * ((l >> 3) & 1));
  split(r[0], f0.hi[0], f0.lo[0]);
  split(r[1], f0.hi[1], f0.lo[1]);
  split(r[2], f1.hi[0], f1.lo[0]);
  split(r[3], f1.hi[1], f1.lo[1]);
}

// thread 0: k-block kb (stored tiles [kb KT, kb KT + KT), the chunk's last
// fewer) of A's columns [m0, m0 + bm) and B's [n0, n0 + bn) -> a stage (A's
// tile i at sa + i BM AP, B's at sb + i BN AP)
template <int TR>
__device__ __forceinline__ void load(const Jobs& js, const Job& jb,
                                     long long kb, int m0, int bm, int n0,
                                     int bn, float* sa, float* sb,
                                     uint64_t* bar) {
  using R = Ring<TR>;
  const long long t0 = kb * R::KT;
  const int nt = static_cast<int>(min(static_cast<long long>(R::KT),
                                      js.ntiles - t0));
  bulk::mbar_expect(bar, nt * (bm + bn) * R::AP * 4);
  for (int i = 0; i < nt; ++i) {
    const long long t = (t0 + i) * js.tstride;
    bulk::bulk_copy(sa + i * BM * R::AP, jb.a + t + m0 * R::AP,
                    bm * R::AP * 4, bar);
    bulk::bulk_copy(sb + i * BN * R::AP, jb.b + t + n0 * R::AP,
                    bn * R::AP * 4, bar);
  }
}

// The block's tile [m0, m0 + bm) x [n0, n0 + BNT) of job jb summed over the
// k-blocks [kb0, kb0 + nk) -> its entries in the partial `out`. Warp w
// takes the TM x TN tiles of 16 x 8 at (16 TM (w % WM), 8 TN (w / WM));
// none where that row is past bm.
template <int TR, int TM, int TN, int WM>
__device__ inline void product(const Jobs& js, const Job& jb, int m0, int bm,
                               int n0, long long kb0, long long nk,
                               float* __restrict__ out, float* smem) {
  using R = Ring<TR>;
  constexpr int BNT = 8 * TN * (8 / WM);
  static_assert(16 * TM * WM == BM && BNT <= BN && TN % 2 == 0,
                "the warp tiling");
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::STAGES * R::STAGE);
  const int tid = threadIdx.x, w = tid >> 5;
  const int wm0 = 16 * TM * (w % WM), wn0 = 8 * TN * (w / WM);
  const bool live = wm0 < bm;
  if (tid == 0) {
    for (int s = 0; s < R::STAGES; ++s) bulk::mbar_init(full + s);
    bulk::mbar_fence_init();
  }
  __syncthreads();
  auto sa = [&](int s) { return smem + s * R::STAGE; };
  auto sb = [&](int s) { return sa(s) + R::KT * BM * R::AP; };
  if (tid == 0)
    for (int s = 0; s < R::STAGES && s < nk; ++s)
      load<TR>(js, jb, kb0 + s, m0, bm, n0, BNT, sa(s), sb(s), full + s);
  // the run's sums (acc) and a k-block's (blk): the tensor cores' f32
  // accumulation does not round to nearest, and over a run of thousands of
  // k-blocks its errors added up to ~5e-4 of a gradient's largest
  // magnitude (an H100, width 1024, 65,573 rows); so each k-block's 24
  // products of a tile of outputs sum in blk and blk is added to acc in
  // f32, rounded to nearest
  float acc[TM][TN][4], blk[TM][TN][4];
  tf::zero(acc);
#pragma unroll 1
  for (long long k = 0; k < nk; ++k) {
    const int s = static_cast<int>(k % R::STAGES);
    bulk::wait_stage(full + s, static_cast<uint32_t>(k / R::STAGES) & 1u);
    const long long t0 = (kb0 + k) * R::KT;
    const int nt = static_cast<int>(min(static_cast<long long>(R::KT),
                                        js.ntiles - t0));
    if (live) {
      tf::zero(blk);
#pragma unroll 1
      for (int i = 0; i < nt; ++i) {
        const float* a = sa(s) + i * BM * R::AP;
        const float* b = sb(s) + i * BN * R::AP;
#pragma unroll
        for (int kk = 0; kk < TR; kk += 8) {
          tf::FragA fa[TM];
          tf::FragB fb[TN];
#pragma unroll
          for (int x = 0; x < TM; ++x)
            load_a<R::AP>(fa[x], a, wm0 + 16 * x, kk);
#pragma unroll
          for (int y = 0; y < TN; y += 2)
            load_b2<R::AP>(fb[y], fb[y + 1], b, wn0 + 8 * y, kk);
#pragma unroll
          for (int x = 0; x < TM; ++x)
#pragma unroll
            for (int y = 0; y < TN; ++y) tf::mma3(blk[x][y], fa[x], fb[y]);
        }
      }
#pragma unroll
      for (int x = 0; x < TM; ++x)
#pragma unroll
        for (int y = 0; y < TN; ++y)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[x][y][e] += blk[x][y][e];
    }
    bulk::fence_proxy_async();        // the stage's reads before its refill
    __syncthreads();                  // the stage's products are done
    if (tid == 0 && k + R::STAGES < nk)
      load<TR>(js, jb, kb0 + k + R::STAGES, m0, bm, n0, BNT, sa(s), sb(s),
               full + s);
  }
  if (!live) return;
  float* o = out + jb.out + static_cast<long long>(m0) * jb.n + n0;
  tf::for_each_pair(acc, wm0, wn0, [&](int m, int n, float& v0, float& v1) {
    *reinterpret_cast<float2*>(o + static_cast<long long>(m) * jb.n + n) =
        make_float2(v0, v1);
  });
}

// the product at the block's output width: width and sdf_dim are
// multiples of 64 and in_dim is 16, 32, 64 or 128, so bn is one of these
template <int TR>
__device__ inline void product_at(const Jobs& js, const Job& jb, int m0,
                                  int bm, int n0, int bn, long long kb0,
                                  long long nk, float* out, float* smem) {
  switch (bn) {
    case 128:
      product<TR, 4, 4, 2>(js, jb, m0, bm, n0, kb0, nk, out, smem);
      break;
    case 64:
      product<TR, 4, 2, 2>(js, jb, m0, bm, n0, kb0, nk, out, smem);
      break;
    case 32:
      product<TR, 2, 2, 4>(js, jb, m0, bm, n0, kb0, nk, out, smem);
      break;
    default:
      product<TR, 1, 2, 8>(js, jb, m0, bm, n0, kb0, nk, out, smem);
  }
}

// block (split, tile) = (blockIdx / tiles, blockIdx % tiles); split s sums
// the chunk's 64-row groups [s per_split, (s + 1) per_split)
__global__ void __launch_bounds__(THREADS, 1)
decoder_wgrad_f32_kernel(Jobs js, float* __restrict__ part, long long kblocks,
                         int per_split) {
  extern __shared__ __align__(16) float smem[];
  const int tile = blockIdx.x % js.tiles;
  const long long split = blockIdx.x / js.tiles;
  int j = 0;
  while (j + 1 < wg::NJOBS && tile >= js.j[j + 1].tile0) ++j;
  const Job& jb = js.j[j];
  const int i = tile - jb.tile0;
  const int m0 = BM * (i / jb.tiles_n), n0 = BN * (i % jb.tiles_n);
  const int bm = min(BM, jb.m - m0), bn = min(BN, jb.n - n0);
  const long long kb0 = split * per_split;
  const long long nk = min(kblocks - kb0, static_cast<long long>(per_split));
  float* out = part + split * js.part;
  if (js.tr == 64)
    product_at<64>(js, jb, m0, bm, n0, bn, kb0, nk, out, smem);
  else if (js.tr == 32)
    product_at<32>(js, jb, m0, bm, n0, bn, kb0, nk, out, smem);
  else
    product_at<16>(js, jb, m0, bm, n0, bn, kb0, nk, out, smem);
}

}  // namespace

// Pass 2 of K3-f32 on one chunk of `rows` rows whose operands pass 1 stored
// in `scratch` (decoder_wgrad.cuh's f32 layout, tiles of `tile_rows` rows:
// 64, 32 or 16) at the decoder size (d, w, sd): `splits` splits of
// per_split 64-row groups each (the last fewer), each writing one partial of
// mlp_kernel.wgrad_part_floats floats into `part` (splits partials, in
// split order). Returns cudaGetLastError() after the launch (0 = launched),
// cudaErrorInvalidValue for another tile height.
extern "C" int decoder_wgrad_f32(const float* scratch, long long rows, int d,
                                 int w, int sd, int tile_rows, int splits,
                                 int per_split, float* part,
                                 cudaStream_t stream) {
  int smem;
  if (tile_rows == 64)
    smem = Ring<64>::SMEM;
  else if (tile_rows == 32)
    smem = Ring<32>::SMEM;
  else if (tile_rows == 16)
    smem = Ring<16>::SMEM;
  else
    return static_cast<int>(cudaErrorInvalidValue);
  Jobs js;
  js.tiles = 0;
  js.part = 0;
  js.tr = tile_rows;
  js.tstride = static_cast<long long>(wg::row_cols(d, w, sd)) *
               (tile_rows + 4);
  js.ntiles = (rows + tile_rows - 1) / tile_rows;
  for (int j = 0; j < wg::NJOBS; ++j) {
    Job& jb = js.j[j];
    jb.a = scratch + wg::offset_f32(wg::JOB_A[j], 0, d, w, sd, tile_rows);
    jb.b = scratch + wg::offset_f32(wg::JOB_B[j], 0, d, w, sd, tile_rows);
    jb.m = wg::cols(wg::JOB_A[j], d, w, sd);
    jb.n = wg::cols(wg::JOB_B[j], d, w, sd);
    jb.tiles_n = (jb.n + BN - 1) / BN;
    jb.tile0 = js.tiles;
    jb.out = js.part;
    js.tiles += (jb.m + BM - 1) / BM * jb.tiles_n;
    js.part += static_cast<long long>(jb.m) * jb.n;
  }
  cudaError_t err = cudaFuncSetAttribute(
      decoder_wgrad_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long kblocks = (rows + KROWS - 1) / KROWS;
  decoder_wgrad_f32_kernel<<<js.tiles * splits, THREADS, smem, stream>>>(
      js, part, kblocks, per_split);
  return static_cast<int>(cudaGetLastError());
}
