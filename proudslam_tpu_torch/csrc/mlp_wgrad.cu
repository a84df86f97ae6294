// Pass 2 of K3 (decoder_wgrad.cuh): the five large weight gradients of the
// decoder backward, summed over long runs of rows from the bf16 operands
// pass 1 stored, and the reduce that writes all 11 gradients.
//
// It replaces the weight-gradient sums of the TPU kernel `_bwd_kernel` of
// proudslam_tpu/ops/pallas/mlp_kernel.py (`dw[:] += _dotg(...)`, its lines
// 172-193, bf16=True): f32 sums of products of bf16 operands.
//
// What bounds it on an H100: the operands' bytes (2 (D + 5W + 2SD) a row,
// each read once from device memory; 1,824 bytes at (16, 128, 128), against
// 2 (D W + W W + W SD + SD W + D W) flops) up to width ~256, the tensor
// cores above. Design:
//   - a block owns one output tile of up to 128 x 256 (two warpgroups, each
//     m64nN, N = 256, 192, 128, 64, 32 or 16) of one product, and a run of
//     the chunk's 64-row tiles (a split); its f32 sums stay in registers
//     over the whole run and are written once, as the split's partial sum.
//     The tile is as wide as a warpgroup's 128 sums a thread allow: the
//     output tiles that share an operand's columns each read them from L2,
//     and at 128 x 128 that traffic, not device memory, set the pace above
//     width 256 (on an H100 128 x 256 tiles took half the time at (16,
//     512, 512) and (16, 1024, 1024): scripts/torch_wgrad_tiles.py);
//   - both operands are read MN-major from shared memory (A^T B: A's
//     columns are M, B's are N, the rows are K), as the stored tiles' bytes:
//     a k-block is one 64-row tile of A's and of B's columns, 8 bulk copies
//     of a row group's run of core matrices each (1 when the block takes
//     all the columns), through a ring of STAGES stages on mbarriers, which
//     thread 0 refills once the block's products of a stage are done;
//   - splits: the wrapper cuts a chunk's rows so that tiles x splits >= the
//     SMs (mlp_kernel.wgrad_splits); the reduce sums the splits' partials
//     and pass 1's per-block slabs of small gradients in a fixed order, so
//     the gradients are bitwise repeatable;
//   - every size is a run-time value: one build serves all decoder sizes.
// A ring wait that does not complete within 2 s traps (a launch error,
// never a hang).

#include "decoder_wgrad.cuh"

namespace {

using dec::bf16;
using wg::TR;

constexpr int THREADS = 2 * tc::WG;
constexpr int BM = 128, BN = 256;          // the largest output tile
constexpr int STAGES = 4;
constexpr int SMEM = STAGES * (BM + BN) * TR * 2 + STAGES * 8;

// One product in a chunk's scratch: A (TR, m) and B (TR, n) tiles, those
// of row tile kb at a + kb * kstride and b + kb * kstride.
struct Job {
  const bf16* a;
  const bf16* b;
  int m, n;
  int tiles_n;       // output tiles along n
  int tile0;         // the job's first output tile
  long long out;     // floats before its M x N block in a partial
};
struct Jobs {
  Job j[wg::NJOBS];
  int tiles;         // output tiles of all jobs
  long long part;    // floats of a partial
  long long kstride; // bf16 elements of a row tile's operands
};

template <int TA, int TB>
__device__ __forceinline__ void mma_m64n192(float (&d)[96], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_m64n256(float (&d)[128], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// m64nNk16 with both operands MN-major in shared memory
template <int N>
__device__ __forceinline__ void mma_mn(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  if constexpr (N == 256) mma_m64n256<1, 1>(d, da, db, scale_d);
  else if constexpr (N == 192) mma_m64n192<1, 1>(d, da, db, scale_d);
  else tc::mma_ss<N, 1, 1>(d, da, db, scale_d);
}

// columns [c0, c0 + bc) of a (TR, ld) tile at src -> the (TR, bc) tile at
// dst, in the same layout
__device__ __forceinline__ void piece(bf16* dst, const bf16* src, int ld,
                                      int c0, int bc, uint64_t* bar) {
  if (bc == ld) {
    bulk::bulk_copy(dst, src, TR * ld * 2, bar);
    return;
  }
#pragma unroll 1
  for (int g = 0; g < TR / 8; ++g)
    bulk::bulk_copy(dst + g * bc * 8, src + (g * (ld / 8) + c0 / 8) * 64,
                    bc * 16, bar);
}

// thread 0: k-block kb (the chunk's tile kb) of A's columns [m0, m0 + bm)
// and B's [n0, n0 + bn) -> a stage
__device__ __forceinline__ void load(const Job& jb, long long kb,
                                     long long kstride, int m0, int bm,
                                     int n0, int bn, bf16* sa, bf16* sb,
                                     uint64_t* bar) {
  bulk::mbar_expect(bar, (bm + bn) * TR * 2);
  piece(sa, jb.a + kb * kstride, jb.m, m0, bm, bar);
  piece(sb, jb.b + kb * kstride, jb.n, n0, bn, bar);
}

// The block's tile [m0, m0 + bm) x [n0, n0 + BNT) of job jb summed over
// the k-blocks [kb0, kb0 + nk) -> its entries in the partial `out`.
// Warpgroup w takes the tile's rows [64 w, 64 w + 64) (none where bm is 64).
template <int BNT>
__device__ inline void product(const Job& jb, long long kstride, int m0,
                               int bm, int n0, long long kb0, long long nk,
                               float* __restrict__ out, bf16* sa, bf16* sb,
                               uint64_t* full) {
  const int tid = threadIdx.x, w = tid / tc::WG;
  const bool live = 64 * w < bm;
  if (tid == 0)
    for (int s = 0; s < STAGES && s < nk; ++s)
      load(jb, kb0 + s, kstride, m0, bm, n0, BNT, sa + s * BM * TR,
           sb + s * BN * TR, full + s);
  float acc[BNT / 2];
#pragma unroll
  for (int i = 0; i < BNT / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (long long k = 0; k < nk; ++k) {
    const int s = static_cast<int>(k % STAGES);
    bulk::wait_stage(full + s, static_cast<uint32_t>(k / STAGES) & 1u);
    if (live) {
      const uint64_t da =
          tc::desc_mn(sa + s * BM * TR + tc::tofs(0, 64 * w, bm), bm);
      const uint64_t db = tc::desc_mn(sb + s * BN * TR, BNT);
      tc::fence_regs(acc);
      tc::wg_fence();
#pragma unroll
      for (int j = 0; j < TR / 16; ++j)
        mma_mn<BNT>(acc, da + j * tc::kstep_mn(bm),
                    db + j * tc::kstep_mn(BNT), k > 0 || j > 0);
      tc::wg_commit();
      tc::wg_wait_all();
      tc::fence_regs(acc);
    }
    __syncthreads();                  // the stage's products are done
    if (tid == 0 && k + STAGES < nk)
      load(jb, kb0 + k + STAGES, kstride, m0, bm, n0, BNT, sa + s * BM * TR,
           sb + s * BN * TR, full + s);
  }
  if (!live) return;
  // entry 4i + e: row r0 + 8 (e / 2), column 8i + c2 + e % 2
  const int l = tid & 31;
  const int r0 = 16 * ((tid % tc::WG) >> 5) + (l >> 2), c2 = 2 * (l & 3);
  float* o = out + jb.out + static_cast<long long>(m0 + 64 * w + r0) * jb.n
             + n0 + c2;
#pragma unroll
  for (int i = 0; i < BNT / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(o + 8 * h * jb.n + 8 * i) =
          make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
}

// block (split, tile) = (blockIdx / tiles, blockIdx % tiles); split s sums
// the chunk's tiles [s per_split, (s + 1) per_split)
__global__ void __launch_bounds__(THREADS, 1)
decoder_wgrad_kernel(Jobs js, float* __restrict__ part, long long ktiles,
                     int per_split) {
  extern __shared__ __align__(16) char smem[];
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = sa + STAGES * BM * TR;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * BN * TR);
  const int tile = blockIdx.x % js.tiles;
  const long long split = blockIdx.x / js.tiles;
  int j = 0;
  while (j + 1 < wg::NJOBS && tile >= js.j[j + 1].tile0) ++j;
  const Job& jb = js.j[j];
  const int i = tile - jb.tile0;
  const int m0 = BM * (i / jb.tiles_n), n0 = BN * (i % jb.tiles_n);
  const int bm = min(BM, jb.m - m0), bn = min(BN, jb.n - n0);
  const long long kb0 = split * per_split;
  const long long nk = min(ktiles - kb0, static_cast<long long>(per_split));
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) bulk::mbar_init(full + s);
    bulk::mbar_fence_init();
  }
  __syncthreads();
  float* out = part + split * js.part;
  switch (bn) {
    case 256:
      product<256>(jb, js.kstride, m0, bm, n0, kb0, nk, out, sa, sb, full);
      break;
    case 192:
      product<192>(jb, js.kstride, m0, bm, n0, kb0, nk, out, sa, sb, full);
      break;
    case 128:
      product<128>(jb, js.kstride, m0, bm, n0, kb0, nk, out, sa, sb, full);
      break;
    case 64:
      product<64>(jb, js.kstride, m0, bm, n0, kb0, nk, out, sa, sb, full);
      break;
    case 32:
      product<32>(jb, js.kstride, m0, bm, n0, kb0, nk, out, sa, sb, full);
      break;
    default:
      product<16>(jb, js.kstride, m0, bm, n0, kb0, nk, out, sa, sb, full);
  }
}

// out[e] (FusedParams order, all 11 gradients): the sum over the nparts
// partials (pass 2) or the nslabs slabs (pass 1's small gradients), in
// their order. ws's feature columns, wc_x and w1 come transposed or
// strided from the partials' blocks.
__global__ void decoder_wgrad_reduce_kernel(
    const float* __restrict__ part, int nparts, long long pfloats,
    const float* __restrict__ slab, int nslabs, int d, int w, int sd,
    float* __restrict__ out) {
  const long long so = sd + 1;
  const long long o_b1 = static_cast<long long>(d) * w, o_w2 = o_b1 + w;
  const long long o_b2 = o_w2 + static_cast<long long>(w) * w;
  const long long o_ws = o_b2 + w, o_bs = o_ws + w * so;
  const long long o_wcf = o_bs + so;
  const long long o_wcx = o_wcf + static_cast<long long>(sd) * w;
  const long long o_bc = o_wcx + static_cast<long long>(d) * w;
  const long long o_wo = o_bc + w, o_bo = o_wo + 3LL * w, nparam = o_bo + 3;
  // the jobs' blocks in a partial: w2, ws's features, wc_f, wc_x^T, w1^T
  const long long j_ws = static_cast<long long>(w) * w;
  const long long j_wcf = j_ws + static_cast<long long>(w) * sd;
  const long long j_wcx = j_wcf + static_cast<long long>(sd) * w;
  const long long j_w1 = j_wcx + static_cast<long long>(w) * d;
  const wg::Small sm = wg::small(w, sd);
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= nparam) return;
  long long src = -1;       // in a partial
  int s_src = -1;           // in a slab
  if (e < o_b1) {
    const long long k = e / w, n = e - k * w;
    src = j_w1 + n * d + k;
  } else if (e < o_w2) {
    s_src = sm.b1 + static_cast<int>(e - o_b1);
  } else if (e < o_b2) {
    src = e - o_w2;
  } else if (e < o_ws) {
    s_src = sm.b2 + static_cast<int>(e - o_b2);
  } else if (e < o_bs) {
    const long long k = (e - o_ws) / so, n = (e - o_ws) - k * so;
    if (n < sd)
      src = j_ws + k * sd + n;
    else
      s_src = sm.ws_sdf + static_cast<int>(k);
  } else if (e < o_wcf) {
    s_src = sm.bs + static_cast<int>(e - o_bs);
  } else if (e < o_wcx) {
    src = j_wcf + (e - o_wcf);
  } else if (e < o_bc) {
    const long long k = (e - o_wcx) / w, n = (e - o_wcx) - k * w;
    src = j_wcx + n * d + k;
  } else if (e < o_wo) {
    s_src = sm.bc + static_cast<int>(e - o_bc);
  } else if (e < o_bo) {
    s_src = sm.wo + static_cast<int>(e - o_wo);
  } else {
    s_src = sm.bo + static_cast<int>(e - o_bo);
  }
  float s = 0.f;
  if (src >= 0)
    for (int p = 0; p < nparts; ++p) s += part[p * pfloats + src];
  else
    for (int p = 0; p < nslabs; ++p)
      s += slab[static_cast<long long>(p) * sm.n + s_src];
  out[e] = s;
}

}  // namespace

// Pass 2 on one chunk of `rows` rows whose operands pass 1 stored in
// `scratch` (decoder_wgrad.cuh's layout) at the decoder size (d, w, sd):
// `splits` splits of per_split 64-row tiles each (the last fewer), each
// writing one partial of mlp_kernel.wgrad_part_floats floats into `part`
// (splits partials, in split order). Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int decoder_wgrad(const void* scratch, long long rows, int d,
                             int w, int sd, int splits, int per_split,
                             float* part, cudaStream_t stream) {
  const long long ktiles = (rows + TR - 1) / TR;
  const bf16* s = static_cast<const bf16*>(scratch);
  Jobs js;
  js.tiles = 0;
  js.part = 0;
  js.kstride = static_cast<long long>(wg::row_cols(d, w, sd)) * TR;
  for (int j = 0; j < wg::NJOBS; ++j) {
    Job& jb = js.j[j];
    jb.a = s + wg::offset(wg::JOB_A[j], 0, d, w, sd);
    jb.b = s + wg::offset(wg::JOB_B[j], 0, d, w, sd);
    jb.m = wg::cols(wg::JOB_A[j], d, w, sd);
    jb.n = wg::cols(wg::JOB_B[j], d, w, sd);
    jb.tiles_n = (jb.n + BN - 1) / BN;
    jb.tile0 = js.tiles;
    jb.out = js.part;
    js.tiles += (jb.m + BM - 1) / BM * jb.tiles_n;
    js.part += static_cast<long long>(jb.m) * jb.n;
  }
  cudaError_t err = cudaFuncSetAttribute(
      decoder_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  decoder_wgrad_kernel<<<js.tiles * splits, THREADS, SMEM, stream>>>(
      js, part, ktiles, per_split);
  return static_cast<int>(cudaGetLastError());
}

// dparams (FusedParams order, mlp_kernel.FusedParams) = the sums of the
// nparts partials in `part` and of the nslabs small-gradient slabs in
// `slab` at the decoder size (d, w, sd). Returns cudaGetLastError().
extern "C" int decoder_wgrad_reduce(const float* part, int nparts,
                                    const float* slab, int nslabs, int d,
                                    int w, int sd, float* dparams,
                                    cudaStream_t stream) {
  const long long so = sd + 1;
  // w1, wc_x; b1, b2, bc; w2; ws; bs; wc_f; wo; bo
  const long long nparam = 2LL * d * w + 3LL * w + static_cast<long long>(w) * w
                           + w * so + so + static_cast<long long>(sd) * w
                           + 3LL * w + 3;
  const long long pfloats = static_cast<long long>(w) * w
                            + 2LL * w * sd + 2LL * w * d;
  const int blocks = static_cast<int>((nparam + 255) / 256);
  decoder_wgrad_reduce_kernel<<<blocks, 256, 0, stream>>>(
      part, nparts, pfloats, slab, nslabs, d, w, sd, dparams);
  return static_cast<int>(cudaGetLastError());
}
