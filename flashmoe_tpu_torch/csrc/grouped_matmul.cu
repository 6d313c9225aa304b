// Grouped matmul: out[T, N] = x[T, K] @ w[tile_gid[t]], one expert per row
// tile, accumulated in f32.
//
// Replaces the TPU kernel flashmoe_tpu/ops/expert.py:_gmm_kernel
// (launched by grouped_matmul).  Same function: w is [E, K, N], or with
// transpose_w [E, N, K] and contracted on its last dim, so the backward's
// dHidden = dy @ w_down[e]^T and dX = d_up @ w_up[e]^T (+ d_gate @
// w_gate[e]^T) read the weights in their forward layout and no transposed
// copy is ever made.  The output is f32 or x's dtype.  A tile_gid entry
// of -1 marks a dead tile: it loads and multiplies nothing, and its rows
// are written as exact zeros (the fused layer's backward marks the slab
// tiles past each slab's row count so; its recompute reads every row).
//
// What bounds it on an H100: at the Mixtral training step (2560 rows, K
// and N of 4096 and 14336, 8 experts) one call reads the experts' weights
// (940 MB bf16) and writes an f32 [T, N] output; its 2*T*K*N operations
// take about as long at the tensor-core peak, so the two bounds sit
// within 10 % of each other.  At the fused backward's recompute (one
// expert's [8192, 4096] @ [4096, 14336]) the operations bound it.
//
// Two kernels, chosen by dtype (a dispatch, not a fallback):
//
// * gmm_hopper, for bf16 x and w in either layout: the training step's
//   backward (transpose_w) and the fused layer's recompute of u and g (w
//   [E, K, N]).  A persistent grid (one block per SM) walks output tiles
//   of 128 rows x 256 columns.  Each block has one producer warp that
//   keeps a ring of 4 shared-memory stages (64 of K each) filled by TMA,
//   and two consumer warpgroups that each own 64 rows and run wgmma
//   m64n256k16 on the stage with f32 accumulators in registers, releasing
//   a stage one wgmma group behind (one arrival a warpgroup:
//   wgmma.wait_group completes the whole warpgroup's reads).  x [T, K] is
//   K-major, wgmma's native A.  B is w[e] read in place: with transpose_w
//   ([N, K], K-major) one 256-row box a stage; with w [E, K, N] (MN-major)
//   the 64-column x 64-K-row boxes of the tile that lie inside N (four
//   for a whole tile) through a 3-D map over [E, K, N], multiplied with
//   the transposed-B wgmma (imm-trans-b = 1), as the forward FFN reads
//   w_up.  The f32 epilogue writes each 32-column chunk of a tile into a
//   swizzled staging box and hands it to a TMA store, so the stores drain
//   while the next tile's products run (a tile's f32 output written from
//   the registers held the tensor cores idle for about a tenth of a
//   K 4096 tile); bf16 output is stored from the registers.
//   Weight reuse: a work item is up to two consecutive 64-row tiles of
//   one expert, so each weight tile serves 128 rows in one block; items
//   never straddle two experts (an odd run of tiles ends in an item of
//   one, where one warpgroup idles).  The work list is built on the
//   device by a one-block launch before the GEMM (gmm_plan), with no host
//   sync.  Tiles are walked item-fastest, so the items of one expert run
//   side by side and share each weight tile through L2: the weights
//   stream from HBM about once.  Items of dead tiles or past *num_rows
//   (the ragged plan's padded tail) skip the loads and write zeros.
//   Tensor maps are encoded on the host for every call (hopper_gemm.cuh);
//   K and N past the tile edge are out-of-bounds zeros in the TMA box (or
//   boxes never loaded, whose columns are never stored) and masked (or,
//   in a TMA store, dropped) in the epilogue, so the wrapper takes every
//   multiple of 64.
// * gmm_kernel, for f32: each block of 4 warps owns one 64 x 64 output
//   tile, runs the whole K loop in registers (gemm_tile.cuh: SIMT FMA),
//   and writes the tile once.  Row tiles are the fastest grid axis, so the
//   row tiles of one expert share each weight tile in L2.  Dead row tiles
//   and those at or past *num_rows write zeros.
#include <type_traits>

#include "gemm_tile.cuh"
#include "hopper_gemm.cuh"

namespace fm {

template <bool TRANS>
__global__ void __launch_bounds__(FTHREADS)
gmm_kernel(const float* __restrict__ x, const int* __restrict__ tile_gid,
           int block_m, const int* __restrict__ num_rows,
           const float* __restrict__ w, float* __restrict__ out, int K,
           int N) {
  constexpr int LDC = FfnTile<float>::LDC;
  static_assert(sizeof(FfnSmem<float, 1, TRANS>) <= FFN_SMEM,
                "shared memory");
  __shared__ __align__(128) float Cs[FFN_SMEM / 4];

  const int row0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN;
  const int e = num_rows != nullptr && row0 >= *num_rows
                    ? -1
                    : tile_gid[row0 / block_m];
  if (e < 0) {  // a dead tile, or rows past *num_rows: zeros
    for (int i = threadIdx.x; i < FBM * FBN; i += FTHREADS)
      out[(size_t)(row0 + i / FBN) * N + n0 + i % FBN] = 0.f;
    return;
  }
  const float* B[1] = {w + (size_t)e * K * N +
                       (size_t)n0 * (TRANS ? K : 1)};
  ffn_mainloop<1, TRANS>(x + (size_t)row0 * K, K, B, N, Cs);
  __syncthreads();
  for (int i = threadIdx.x; i < FBM * FBN; i += FTHREADS) {
    const int r = i / FBN, c = i % FBN;
    out[(size_t)(row0 + r) * N + n0 + c] = Cs[r * LDC + c];
  }
}

constexpr int HG_BN = 256;       // columns of a block tile: wgmma N
constexpr int HG_STAGES = 4;
constexpr int HG_CONSUMERS = 2;  // 64-row tiles of a work item
constexpr int HG_THREADS = 128 * (HG_CONSUMERS + 1);
typedef hg::Ring<HG_STAGES, HG_CONSUMERS, HG_BN> HgRing;
// Whether a barrier wait that times out prints which block and thread
// before it traps (hopper_gemm.cuh: mbar_wait).  The printf is a call
// inside the wgmma pipeline, so ptxas then serializes every wgmma of the
// kernel (its info C7510).  Measured on an H100 (chip_ablate.py, cuts
// b7_report and b7_quiet), each arm keeps the faster: the w [E, K, N]
// arm without it (5-8 % faster), the transpose_w arm with it (without,
// 14 % slower at the train step's dHidden).
template <bool MN> constexpr bool HG_REPORT = !MN;

// The ring, then for each consumer warpgroup two f32 staging boxes of its
// 64 rows x 32 columns (128-byte swizzled rows) for the TMA epilogue.
struct HgSmem {
  HgRing ring;
  alignas(1024) float out[HG_CONSUMERS][2][hg::WG_ROWS * hg::F32_BOX];
};

template <typename OutT>
__device__ __forceinline__ void store_pair(OutT* p, float a, float b);
template <> __device__ __forceinline__ void store_pair<float>(float* p,
                                                              float a,
                                                              float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store_pair<bf16>(bf16* p, float a,
                                                             float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The work list, built on the device by one block before the GEMM: item
// j < *n_work is work[j] = (first 64-row tile, tiles in the item (1 or 2),
// expert or -1 past *num_rows, 0).  Each run of tiles with one expert is
// cut greedily from its start into items of two tiles and, when the run
// is odd, a last item of one, so rows never straddle two experts.
// ops/expert.py:gmm_work_list is this plan in Python.  The forward FFN
// (grouped_ffn.cu) walks the same list.
constexpr int PLAN_THREADS = 1024;

__device__ __forceinline__ int plan_key(int t, const int* tile_gid,
                                        int block_m, int live) {
  return t * hg::WG_ROWS >= live ? -1 : tile_gid[t * hg::WG_ROWS / block_m];
}

// block-wide inclusive scan (sum or max) of one int per thread
template <bool MAX>
__device__ int block_scan(int v, int* warp_tot) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v = MAX ? max(v, o) : v + o;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int u = lane < PLAN_THREADS / 32 ? warp_tot[lane] : (MAX ? -1 : 0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, u, off);
      if (lane >= off) u = MAX ? max(u, o) : u + o;
    }
    warp_tot[lane] = u;
  }
  __syncthreads();
  if (warp > 0) v = MAX ? max(v, warp_tot[warp - 1]) : v + warp_tot[warp - 1];
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(PLAN_THREADS)
gmm_plan(const int* __restrict__ tile_gid, int block_m,
         const int* __restrict__ num_rows, int T, int4* __restrict__ work,
         int* __restrict__ n_work) {
  __shared__ int warp_tot[32];
  const int tiles = T / hg::WG_ROWS;
  const int live = num_rows != nullptr ? *num_rows : T;
  int items = 0, run0 = -1;  // carried from chunk to chunk
  for (int base = 0; base < tiles; base += PLAN_THREADS) {
    const int i = base + threadIdx.x;
    const bool valid = i < tiles;
    const int k = valid ? plan_key(i, tile_gid, block_m, live) : -2;
    const bool start =
        valid && (i == 0 || plan_key(i - 1, tile_gid, block_m, live) != k);
    const int r0 = max(run0, block_scan<true>(start ? i : -1, warp_tot));
    const bool first = valid && (i - r0) % 2 == 0;
    const int before = block_scan<false>(first, warp_tot) - first;
    if (first) {
      const bool two =
          i + 1 < tiles && plan_key(i + 1, tile_gid, block_m, live) == k;
      work[items + before] = make_int4(i, two ? 2 : 1, k, 0);
    }
    // carry the chunk's last thread's run start and item count
    if (threadIdx.x == PLAN_THREADS - 1) {
      warp_tot[0] = r0;
      warp_tot[1] = before + first;
    }
    __syncthreads();
    run0 = warp_tot[0];
    items += warp_tot[1];
    __syncthreads();
  }
  if (threadIdx.x == 0) *n_work = items;
}

int hg::gmm_plan_launch(const int* tile_gid, int block_m,
                        const int* num_rows, int T, int4* work, int* n_work,
                        cudaStream_t stream) {
  gmm_plan<<<1, PLAN_THREADS, 0, stream>>>(tile_gid, block_m, num_rows, T,
                                           work, n_work);
  return (int)cudaGetLastError();
}

// Output tile t is item t % n_work of column block t / n_work: the items
// of one column block are neighbours, so the blocks that share an expert's
// weight tile run side by side.  The blocks stride over the tiles by the
// largest count <= gridDim.x that is coprime to n_work (the others exit;
// hg::stride_grid), so each block meets every item residue in turn rather
// than a fixed few.  The f32 epilogue is hg::store_f32.  MN: w is [E, K,
// N] (tw a map of 64-column x BK-row boxes); else [E, N, K] (boxes of BK
// x 256 rows).
template <typename OutT, bool MN>
__global__ void __launch_bounds__(HG_THREADS, 1)
gmm_hopper(const __grid_constant__ CUtensorMap tx,
           const __grid_constant__ CUtensorMap tw,
           const __grid_constant__ CUtensorMap tout,
           const int4* __restrict__ work, const int* __restrict__ n_work,
           OutT* __restrict__ out, int N, int K) {
  extern __shared__ unsigned char hg_raw[];
  HgSmem& smem = hg::smem_at<HgSmem>(hg_raw);
  HgRing& sm = smem.ring;
  const int items = *n_work;
  const int grid = hg::stride_grid(items);
  if ((int)blockIdx.x >= grid) return;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < HG_STAGES; ++s) {
      hg::mbar_init(&sm.full[s], 1);
      hg::mbar_init(&sm.empty[s], HG_CONSUMERS);
    }
    hg::mbar_fence_init();
  }
  __syncthreads();
  const int total = items * ((N + HG_BN - 1) / HG_BN);
  const int nk = K / hg::BK;
  hg::RingPos pos;

  if (wg == HG_CONSUMERS) {  // producer warpgroup: one thread issues TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 0) return;
    for (int t = blockIdx.x; t < total; t += grid) {
      const int4 it = work[t % items];
      if (it.z < 0) continue;
      const int n0 = (t / items) * HG_BN;
      // MN: the 64-column boxes inside N (the B tile's other columns keep
      // what they held; their outputs are never stored)
      const int boxes = MN ? min(HG_BN, N - n0) / 64 : 0;
      const uint32_t bytes =
          (uint32_t)(it.y * hg::A_TILE +
                     (MN ? boxes * 64 * hg::BK : HgRing::B_TILE)) *
          sizeof(bf16);
      for (int kb = 0; kb < nk; ++kb) {
        hg::mbar_wait<HG_REPORT<MN>>(&sm.empty[pos.stage], pos.phase ^ 1);
        hg::mbar_expect_tx(&sm.full[pos.stage], bytes);
        for (int c = 0; c < it.y; ++c)
          hg::tma_load_2d(sm.a[pos.stage][c], &tx, &sm.full[pos.stage],
                          kb * hg::BK, (it.x + c) * hg::WG_ROWS);
        if constexpr (MN)
          for (int j = 0; j < boxes; ++j)
            hg::tma_load_3d(sm.b[pos.stage] + 64 * j * hg::BK, &tw,
                            &sm.full[pos.stage], n0 + 64 * j, kb * hg::BK,
                            it.z);
        else
          hg::tma_load_3d(sm.b[pos.stage], &tw, &sm.full[pos.stage],
                          kb * hg::BK, n0, it.z);
        pos.next<HG_STAGES>();
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = tid / 32, lane = tid % 32;
  for (int t = blockIdx.x; t < total; t += grid) {
    const int4 it = work[t % items];
    const int n0 = (t / items) * HG_BN;
    const bool active = wg < it.y;
    OutT* orow =
        out + (size_t)((it.x + wg) * hg::WG_ROWS + warp * 16 + lane / 4) * N;
    if (it.z < 0) {  // dead tiles or rows past *num_rows: zeros, no loads
      if (active)
        for (int j = 0; j < HG_BN / 8; ++j) {
          const int c = n0 + 8 * j + 2 * (lane % 4);
          if (c < N) {
            store_pair(orow + c, 0.f, 0.f);
            store_pair(orow + 8 * (size_t)N + c, 0.f, 0.f);
          }
        }
      continue;
    }
    if (!active) {  // the item has one tile: keep the ring in step
      for (int kb = 0; kb < nk; ++kb) {
        hg::mbar_wait<HG_REPORT<MN>>(&sm.full[pos.stage], pos.phase);
        // every thread of the warpgroup has seen the phase before the
        // stage can be refilled
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg));
        if (tid == 0) hg::mbar_arrive(&sm.empty[pos.stage]);
        pos.next<HG_STAGES>();
      }
      continue;
    }
    float d[128];  // the m64n256 accumulator
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    int prev = -1;
    for (int kb = 0; kb < nk; ++kb) {
      hg::mbar_wait<HG_REPORT<MN>>(&sm.full[pos.stage], pos.phase);
      hg::wgmma_fence();
      if constexpr (MN)
        hg::wgmma_stage_mn<HG_BN>(d, sm.a[pos.stage][wg], sm.b[pos.stage]);
      else
        hg::wgmma_stage(d, sm.a[pos.stage][wg], sm.b[pos.stage]);
      hg::wgmma_commit();
      hg::wgmma_wait<1>();  // the previous stage's products are done
      if (prev >= 0 && tid == 0) hg::mbar_arrive(&sm.empty[prev]);
      prev = pos.stage;
      pos.next<HG_STAGES>();
    }
    hg::wgmma_wait<0>();
    hg::fence_acc(d);
    if (tid == 0) hg::mbar_arrive(&sm.empty[prev]);
    if constexpr (std::is_same<OutT, float>::value) {
      hg::store_f32(d, smem.out[wg][0], smem.out[wg][1], &tout,
                    (it.x + wg) * hg::WG_ROWS, n0, N, wg, tid);
    } else {
#pragma unroll
      for (int j = 0; j < HG_BN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * (lane % 4);
        if (c < N) {
          store_pair(orow + c, d[4 * j], d[4 * j + 1]);
          store_pair(orow + 8 * (size_t)N + c, d[4 * j + 2], d[4 * j + 3]);
        }
      }
    }
  }
  if (tid == 0) hg::bulk_wait<0>();  // the stores have left shared memory
}

template <typename OutT, bool MN>
int gmm_hopper_launch(const CUtensorMap& tx, const CUtensorMap& tw,
                      const CUtensorMap& tout, const int* tile_gid,
                      int block_m, const int* num_rows, int* plan, int grid,
                      void* out, int T_, int K, int N, cudaStream_t stream) {
  const size_t smem = hg::smem_bytes<HgSmem>();
  cudaError_t err = cudaFuncSetAttribute(
      gmm_hopper<OutT, MN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int4* work = reinterpret_cast<int4*>(plan);
  int* n_work = plan + 4 * (T_ / hg::WG_ROWS);
  err = (cudaError_t)hg::gmm_plan_launch(tile_gid, block_m, num_rows, T_,
                                         work, n_work, stream);
  if (err != cudaSuccess) return (int)err;
  gmm_hopper<OutT, MN><<<grid, HG_THREADS, smem, stream>>>(
      tx, tw, tout, work, n_work, (OutT*)out, N, K);
  return (int)cudaGetLastError();
}

}  // namespace fm

// f32 x [T, K]; tile_gid i32 [T / block_m] (-1: a dead tile); num_rows
// i32 [1] or null (every row live); f32 w [E, K, N], or [E, N, K] with
// transpose_w; f32 out [T, N].  Needs T, K, N and block_m to be
// multiples of 64.
extern "C" int fm_grouped_matmul(int transpose_w, const float* x,
                                 const int* tile_gid, int block_m,
                                 const int* num_rows, const float* w,
                                 float* out, int T, int K, int N,
                                 cudaStream_t stream) {
  const dim3 grid(T / fm::FBM, N / fm::FBN);
  if (transpose_w)
    fm::gmm_kernel<true><<<grid, fm::FTHREADS, 0, stream>>>(
        x, tile_gid, block_m, num_rows, w, out, K, N);
  else
    fm::gmm_kernel<false><<<grid, fm::FTHREADS, 0, stream>>>(
        x, tile_gid, block_m, num_rows, w, out, K, N);
  return (int)cudaGetLastError();
}

// bf16 on the Hopper kernel: x [T, K] bf16, w [E, N, K] bf16 with
// transpose_w, else [E, K, N]; tile_gid, block_m and num_rows as above;
// out [T, N] f32 (out_f32) or bf16; plan i32 [4 * T / 64 + 1] scratch for
// the work list; grid persistent blocks (one per SM).  Two launches: the
// plan, the GEMM.  Needs T, K, N and block_m to be multiples of 64.
extern "C" int fm_grouped_matmul_hopper(int transpose_w, int out_f32,
                                        const void* x, const int* tile_gid,
                                        int block_m, const int* num_rows,
                                        const void* w, void* out, int* plan,
                                        int T, int K, int N, int E, int grid,
                                        cudaStream_t stream) {
  using namespace fm;
  CUtensorMap tx, tw, tout;
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)T};
  const cuuint64_t xs[1] = {(cuuint64_t)K * sizeof(bf16)};
  const cuuint32_t xb[2] = {hg::BK, hg::WG_ROWS};
  // [E, N, K]: boxes of BK x HG_BN rows; [E, K, N]: 64 columns x BK rows
  const cuuint64_t wd[3] = {(cuuint64_t)(transpose_w ? K : N),
                            (cuuint64_t)(transpose_w ? N : K),
                            (cuuint64_t)E};
  const cuuint64_t ws[2] = {wd[0] * sizeof(bf16),
                            (cuuint64_t)N * K * sizeof(bf16)};
  const cuuint32_t wb[3] = {
      hg::BK, (cuuint32_t)(transpose_w ? HG_BN : hg::BK), 1};
  const cuuint64_t od[2] = {(cuuint64_t)N, (cuuint64_t)T};
  const cuuint64_t os[1] = {(cuuint64_t)N * sizeof(float)};
  const cuuint32_t ob[2] = {hg::F32_BOX, hg::WG_ROWS};
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!hg::make_map(&tx, bf, x, 2, xd, xs, xb) ||
      !hg::make_map(&tw, bf, w, 3, wd, ws, wb))
    return (int)cudaErrorInvalidValue;
  // the f32 output's map (the bf16 epilogue stores from registers)
  if (out_f32 && !hg::make_map(&tout, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, out,
                               2, od, os, ob))
    return (int)cudaErrorInvalidValue;
  if (!out_f32) tout = tx;
#define FM_GMM_LAUNCH(OUT, MN)                                             \
  gmm_hopper_launch<OUT, MN>(tx, tw, tout, tile_gid, block_m, num_rows,   \
                             plan, grid, out, T, K, N, stream)
  if (out_f32)
    return transpose_w ? FM_GMM_LAUNCH(float, false)
                       : FM_GMM_LAUNCH(float, true);
  return transpose_w ? FM_GMM_LAUNCH(bf16, false) : FM_GMM_LAUNCH(bf16, true);
#undef FM_GMM_LAUNCH
}
