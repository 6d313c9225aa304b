// Transposed grouped matmul, the weight gradient:
// dW[e, K, N] = sum over the rows r of expert e of x[r, :]^T dy[r, :], f32.
//
// Replaces the TPU kernel flashmoe_tpu/ops/expert.py:_tgmm_kernel
// (launched by tgmm).  Same function: the rows are expert-major (a
// nondecreasing tile_gid), and an expert that owns no row gets exactly 0.
// On the TPU the grid ran in order and one expert's row tiles summed into
// the same VMEM output block on consecutive grid steps; blocks here run in
// no order, so each output tile is owned by one block, which loops over
// its expert's rows [row_start[e], row_end[e]) itself (the wrapper finds
// the range with a searchsorted over tile_gid).  The sum needs no atomics,
// its order is fixed (64-row steps in increasing row order), and every
// output element is written exactly once: an expert with an empty range
// writes zeros, so no select over uninitialised memory is needed.
//
// What bounds it on an H100: the bytes of its f32 output.  At the Mixtral
// training step one call writes [8, 4096, 14336] f32 (1.88 GB, 0.56 ms at
// 3.35 TB/s) from inputs of a few tens of MB, while its 2*T*K*N operations
// take about 0.3 ms at the bf16 tensor-core peak.  Behind the output come
// the re-reads of the inputs through L2: each output tile of Bk x Bn reads
// its expert's rows of x[:, k tile] and dy[:, n tile], so x is read N / Bn
// times over the grid and dy K / Bk times.
//
// Design, for bf16 (tgmm_hopper; f32 keeps the SIMT tile below):
//   * Both operands are MN-major (the contraction runs over rows): x
//     [T, K] and dy [T, N] arrive as TMA boxes of 64 columns by 64 rows
//     with 128-byte swizzle, and wgmma reads x^T with imm-trans-a = 1 and
//     dy with imm-trans-b = 1 (hopper_gemm.cuh: wgmma_stage_tn).
//   * A block tile is 128 k x 256 n: two consumer warpgroups each own 64
//     k rows (m64n256k16, f32 accumulators in registers), one producer
//     thread keeps a ring of 4 stages (64 rows each: two x boxes and four
//     dy boxes, 48 KB) filled by TMA.  Against 64 x 64 tiles this reads x
//     4x and dy 2x less often through L2 (56 and 32 times at d_w_up, for
//     224 and 64), about 2.8 GB of L2 reads a call against 7.5.
//   * The grid is persistent, one block per SM, walking the tiles (e, k
//     tile, n tile) with n fastest, so the blocks in flight share one
//     expert's x boxes and its dy rows in L2.
//   * The f32 epilogue writes 32-column chunks into two swizzled staging
//     boxes per warpgroup and hands them to TMA stores through a 3-D map
//     [E, K, N] (hopper_gemm.cuh: store_f32), which clips at K and N and
//     never writes into the next expert.  The consumers release the ring's
//     last stage before their epilogue, so the producer loads the next
//     tile's stages while the stores drain.
//   * An empty range runs no stage: its accumulators stay zero and are
//     stored as any tile's.
//   * Its barrier waits print before they trap, as B7's do; that printf
//     makes ptxas serialize the kernel's wgmma (hopper_gemm.cuh:
//     mbar_wait), which here measured faster than without it
//     (chip_ablate.py, cut b8_quiet): the products are not what bounds
//     the kernel.
#include "common.cuh"
#include "hopper_gemm.cuh"

namespace fm {

// ---- bf16: TMA + wgmma -----------------------------------------------

constexpr int TG_BN = 256;       // n columns of a block tile: wgmma N
constexpr int TG_STAGES = 4;
constexpr int TG_CONSUMERS = 2;  // 64-row k tiles of a block tile
constexpr int TG_BM = TG_CONSUMERS * hg::WG_ROWS;
constexpr int TG_THREADS = 128 * (TG_CONSUMERS + 1);
typedef hg::Ring<TG_STAGES, TG_CONSUMERS, TG_BN> TgRing;

// The ring, then for each consumer warpgroup two f32 staging boxes of its
// 64 rows x 32 columns (128-byte swizzled rows) for the TMA epilogue.
struct TgSmem {
  TgRing ring;
  alignas(1024) float out[TG_CONSUMERS][2][hg::WG_ROWS * hg::F32_BOX];
};

// Output tile t of the walk: expert e, k rows k0.., n columns n0..
struct TgTile {
  int e, k0, n0;
};
__device__ __forceinline__ TgTile tg_tile(int t, int ktiles, int ntiles) {
  const int per_e = ktiles * ntiles, rem = t % per_e;
  return {t / per_e, rem / ntiles * TG_BM, rem % ntiles * TG_BN};
}

__global__ void __launch_bounds__(TG_THREADS, 1)
tgmm_hopper(const __grid_constant__ CUtensorMap tx,
            const __grid_constant__ CUtensorMap tdy,
            const __grid_constant__ CUtensorMap tout,
            const int* __restrict__ row_start,
            const int* __restrict__ row_end, int E, int K, int N) {
  extern __shared__ unsigned char tg_raw[];
  TgSmem& smem = hg::smem_at<TgSmem>(tg_raw);
  TgRing& sm = smem.ring;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TG_STAGES; ++s) {
      hg::mbar_init(&sm.full[s], 1);
      hg::mbar_init(&sm.empty[s], TG_CONSUMERS);
    }
    hg::mbar_fence_init();
  }
  __syncthreads();
  const int ktiles = (K + TG_BM - 1) / TG_BM;
  const int ntiles = (N + TG_BN - 1) / TG_BN;
  const int total = E * ktiles * ntiles;
  hg::RingPos pos;

  if (wg == TG_CONSUMERS) {  // producer warpgroup: one thread issues TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 0) return;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const TgTile tl = tg_tile(t, ktiles, ntiles);
      // the boxes inside K and N (a tile past the edge stores none of
      // the outputs that the others would feed)
      const int na = min(TG_CONSUMERS, (K - tl.k0) / hg::WG_ROWS);
      const int nb = min(TG_BN / 64, (N - tl.n0) / 64);
      const uint32_t bytes = (na * hg::A_TILE + nb * 64 * hg::BK) *
                             sizeof(bf16);
      const int r1 = row_end[tl.e];
      for (int r = row_start[tl.e]; r < r1; r += hg::BK) {
        hg::mbar_wait(&sm.empty[pos.stage], pos.phase ^ 1);
        hg::mbar_expect_tx(&sm.full[pos.stage], bytes);
        for (int c = 0; c < na; ++c)
          hg::tma_load_2d(sm.a[pos.stage][c], &tx, &sm.full[pos.stage],
                          tl.k0 + c * hg::WG_ROWS, r);
        for (int j = 0; j < nb; ++j)
          hg::tma_load_2d(sm.b[pos.stage] + j * 64 * hg::BK, &tdy,
                          &sm.full[pos.stage], tl.n0 + 64 * j, r);
        pos.next<TG_STAGES>();
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const TgTile tl = tg_tile(t, ktiles, ntiles);
    const int nk = (row_end[tl.e] - row_start[tl.e]) / hg::BK;
    float d[128];  // the m64n256 accumulator
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    int prev = -1;
    for (int kb = 0; kb < nk; ++kb) {
      hg::mbar_wait(&sm.full[pos.stage], pos.phase);
      hg::wgmma_fence();
      hg::wgmma_stage_tn(d, sm.a[pos.stage][wg], sm.b[pos.stage]);
      hg::wgmma_commit();
      hg::wgmma_wait<1>();  // the previous stage's products are done
      if (prev >= 0 && tid == 0) hg::mbar_arrive(&sm.empty[prev]);
      prev = pos.stage;
      pos.next<TG_STAGES>();
    }
    hg::wgmma_wait<0>();
    hg::fence_acc(d);
    if (prev >= 0 && tid == 0) hg::mbar_arrive(&sm.empty[prev]);
    const int row0 = tl.k0 + wg * hg::WG_ROWS;
    if (row0 < K)  // the same for the whole warpgroup
      hg::store_f32(d, smem.out[wg][0], smem.out[wg][1], &tout, row0, tl.n0,
                    N, wg, tid, tl.e);
  }
  if (tid == 0) hg::bulk_wait<0>();  // the stores have left shared memory
}

int tgmm_hopper_launch(const void* x, const void* dy, const int* row_start,
                       const int* row_end, void* dw, int T, int E, int K,
                       int N, int grid, cudaStream_t stream) {
  CUtensorMap tx, tdy, tout;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint32_t in_box[2] = {64, hg::BK};
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)T};
  const cuuint64_t xs[1] = {(cuuint64_t)K * sizeof(bf16)};
  const cuuint64_t yd[2] = {(cuuint64_t)N, (cuuint64_t)T};
  const cuuint64_t ys[1] = {(cuuint64_t)N * sizeof(bf16)};
  const cuuint64_t od[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t os[2] = {(cuuint64_t)N * sizeof(float),
                            (cuuint64_t)K * N * sizeof(float)};
  const cuuint32_t ob[3] = {hg::F32_BOX, hg::WG_ROWS, 1};
  if (!hg::make_map(&tx, bf, x, 2, xd, xs, in_box) ||
      !hg::make_map(&tdy, bf, dy, 2, yd, ys, in_box) ||
      !hg::make_map(&tout, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, dw, 3, od, os,
                    ob))
    return (int)cudaErrorInvalidValue;
  const size_t smem = hg::smem_bytes<TgSmem>();
  cudaError_t err = cudaFuncSetAttribute(
      tgmm_hopper, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tgmm_hopper<<<grid, TG_THREADS, smem, stream>>>(tx, tdy, tout, row_start,
                                                 row_end, E, K, N);
  return (int)cudaGetLastError();
}

// ---- f32: SIMT ---------------------------------------------------------
//
// Each block of 128 threads owns one (expert, 64-wide K tile, 64-wide N
// tile) of dW; the x^T and dy row chunks arrive by 16-byte cp.async
// copies, two stages deep; thread (ty, tx) owns k rows 4*ty..+3 and n
// columns 8*tx..+7.  N tiles are the fastest grid axis, so blocks that
// share an x chunk run side by side and share it in L2.

constexpr int TBK = 64, TBN = 64, TTHREADS = 128;
constexpr int TBR = 16;       // rows per stage
constexpr int TLD = 64 + 4;  // row stride of a stage's chunks

struct TgmmSmem {
  float Xs[2][TBR][TLD];  // x[r, k0 : k0 + 64]
  float Ds[2][TBR][TLD];  // dy[r, n0 : n0 + 64]
};

__device__ __forceinline__ void tgmm_load(TgmmSmem& sm, int st,
                                          const float* x, const float* dy,
                                          int K, int N, int r) {
  for (int c = threadIdx.x; c < TBR * 16; c += TTHREADS) {
    const int rr = c / 16, cc = (c % 16) * 4;
    cp_async16(&sm.Xs[st][rr][cc], x + (size_t)(r + rr) * K + cc);
    cp_async16(&sm.Ds[st][rr][cc], dy + (size_t)(r + rr) * N + cc);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(TTHREADS)
tgmm_f32(const float* __restrict__ x, const float* __restrict__ dy,
         const int* __restrict__ row_start, const int* __restrict__ row_end,
         float* __restrict__ dw, int K, int N) {
  const int n0 = blockIdx.x * TBN, k0 = blockIdx.y * TBK, e = blockIdx.z;
  const int r0 = row_start[e], r1 = row_end[e];
  x += k0;
  dy += n0;
  dw += ((size_t)e * K + k0) * N + n0;
  __shared__ __align__(128) TgmmSmem sm;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  if (r0 < r1) tgmm_load(sm, 0, x, dy, K, N, r0);
  for (int r = r0, st = 0; r < r1; r += TBR, st ^= 1) {
    if (r + TBR < r1) {
      tgmm_load(sm, st ^ 1, x, dy, K, N, r + TBR);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < TBR; ++rr) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.Xs[st][rr][ty * 4 + i];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float b = sm.Ds[st][rr][tx * 8 + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(a[i], b, acc[i][c]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      dw[(size_t)(ty * 4 + i) * N + tx * 8 + c] = acc[i][c];
}

}  // namespace fm

// x [T, K], dy [T, N] (one dtype); row_start / row_end i32 [E], expert e's
// rows [row_start[e], row_end[e]) (multiples of 64 rows); dw f32 [E, K,
// N].  Needs K and N to be multiples of 64.  bf16 runs tgmm_hopper on
// `grid` persistent blocks (one per SM at most); f32 ignores grid.
extern "C" int fm_tgmm(int is_bf16, const void* x, const void* dy,
                       const int* row_start, const int* row_end, void* dw,
                       int T, int E, int K, int N, int grid,
                       cudaStream_t stream) {
  if (is_bf16)
    return fm::tgmm_hopper_launch(x, dy, row_start, row_end, dw, T, E, K, N,
                                  grid, stream);
  const dim3 g(N / fm::TBN, K / fm::TBK, E);
  fm::tgmm_f32<<<g, fm::TTHREADS, 0, stream>>>(
      (const float*)x, (const float*)dy, row_start, row_end, (float*)dw, K,
      N);
  return (int)cudaGetLastError();
}
