// Grouped matmul: out[T, N] = x[T, K] @ w[tile_gid[t]], one expert per row
// tile, accumulated in f32.
//
// Replaces the TPU kernel flashmoe_tpu/ops/expert.py:_gmm_kernel
// (launched by grouped_matmul).  Same function: w is [E, K, N], or with
// transpose_w [E, N, K] and contracted on its last dim, so the backward's
// dHidden = dy @ w_down[e]^T and dX = d_up @ w_up[e]^T (+ d_gate @
// w_gate[e]^T) read the weights in their forward layout and no transposed
// copy is ever made.  The output is f32 or x's dtype.
//
// What bounds it on an H100: at the Mixtral training step (2560 rows, K
// and N of 4096 and 14336, 8 experts) one call reads the experts' weights
// (940 MB bf16) and writes an f32 [T, N] output; its 2*T*K*N operations
// take about as long at the tensor-core peak, so the two bounds sit
// within 10 % of each other.
//
// Two kernels, chosen by dtype and layout (a dispatch, not a fallback):
//
// * gmm_hopper, for bf16 x and w with transpose_w, which is every call of
//   the training step's backward.  There x [T, K] and w[e] [N, K] are both
//   K-major, wgmma's native layout.  A persistent grid (one block per SM)
//   walks output tiles of 128 rows x 256 columns.  Each block has one
//   producer warp that keeps a ring of 4 shared-memory stages (64 of K
//   each) filled by TMA, and two consumer warpgroups that each own 64 rows
//   and run wgmma m64n256k16 on the stage with f32 accumulators in
//   registers, releasing a stage one wgmma group behind (one arrival a
//   warpgroup: wgmma.wait_group completes the whole warpgroup's reads).
//   The f32 epilogue writes each 32-column chunk of a tile into a
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
//   stream from HBM about once.  Items past *num_rows (the ragged plan's
//   padded tail) skip the loads and write zeros.  Tensor maps are encoded
//   on the host for every call (hopper_gemm.cuh); K and N past the tile
//   edge are out-of-bounds zeros in the TMA box and masked (or, in a TMA
//   store, dropped) in the epilogue, so the wrapper takes every multiple
//   of 64.
// * gmm_kernel, for f32 and for bf16 with w [E, K, N]: each block of 4
//   warps owns one 64 x 64 output tile, runs the whole K loop in registers
//   (gemm_tile.cuh: WMMA for bf16, SIMT FMA for f32), and writes the tile
//   once.  Row tiles are the fastest grid axis, so the row tiles of one
//   expert share each weight tile in L2.  Row tiles at or past *num_rows
//   write zeros.
#include <type_traits>

#include "gemm_tile.cuh"
#include "hopper_gemm.cuh"

namespace fm {

template <typename T, bool TRANS, typename OutT>
__global__ void __launch_bounds__(FTHREADS)
gmm_kernel(const T* __restrict__ x, const int* __restrict__ tile_gid,
           int block_m, const int* __restrict__ num_rows,
           const T* __restrict__ w, OutT* __restrict__ out, int K, int N) {
  constexpr int LDC = FfnTile<T>::LDC;
  static_assert(sizeof(FfnSmem<T, 1, TRANS>) <= FFN_SMEM, "shared memory");
  __shared__ __align__(128) float Cs[FFN_SMEM / 4];

  const int row0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN;
  if (num_rows != nullptr && row0 >= *num_rows) {
    for (int i = threadIdx.x; i < FBM * FBN; i += FTHREADS)
      out[(size_t)(row0 + i / FBN) * N + n0 + i % FBN] = from_f<OutT>(0.f);
    return;
  }
  const int e = tile_gid[row0 / block_m];
  const T* B[1] = {w + (size_t)e * K * N + (size_t)n0 * (TRANS ? K : 1)};
  ffn_mainloop<1, TRANS>(x + (size_t)row0 * K, K, B, N, Cs);
  __syncthreads();
  for (int i = threadIdx.x; i < FBM * FBN; i += FTHREADS) {
    const int r = i / FBN, c = i % FBN;
    out[(size_t)(row0 + r) * N + n0 + c] = from_f<OutT>(Cs[r * LDC + c]);
  }
}

template <typename T, bool TRANS>
int gmm_launch(int out_f32, const void* x, const int* tile_gid, int block_m,
               const int* num_rows, const void* w, void* out, int T_, int K,
               int N, cudaStream_t stream) {
  const dim3 grid(T_ / FBM, N / FBN);
  if (out_f32)
    gmm_kernel<T, TRANS, float><<<grid, FTHREADS, 0, stream>>>(
        (const T*)x, tile_gid, block_m, num_rows, (const T*)w, (float*)out,
        K, N);
  else
    gmm_kernel<T, TRANS, T><<<grid, FTHREADS, 0, stream>>>(
        (const T*)x, tile_gid, block_m, num_rows, (const T*)w, (T*)out, K,
        N);
  return (int)cudaGetLastError();
}

constexpr int HG_BN = 256;       // columns of a block tile: wgmma N
constexpr int HG_STAGES = 4;
constexpr int HG_CONSUMERS = 2;  // 64-row tiles of a work item
constexpr int HG_THREADS = 128 * (HG_CONSUMERS + 1);
constexpr int EPI_COLS = 32;     // f32 columns of one TMA store box
typedef hg::Ring<HG_STAGES, HG_CONSUMERS, HG_BN> HgRing;

// The ring, then for each consumer warpgroup two f32 staging boxes of its
// 64 rows x 32 columns (128-byte swizzled rows) for the TMA epilogue.
struct HgSmem {
  HgRing ring;
  alignas(1024) float out[HG_CONSUMERS][2][hg::WG_ROWS * EPI_COLS];
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
// ops/expert.py:gmm_work_list is this plan in Python.
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

// Output tile t is item t % n_work of column block t / n_work: the items
// of one column block are neighbours, so the blocks that share an expert's
// weight tile run side by side.  The blocks stride over the tiles by the
// largest count <= gridDim.x that is coprime to n_work (the others exit),
// so each block meets every item residue in turn rather than a fixed few.
// The f32 epilogue of one consumer warpgroup's 64 x 256 tile: eight
// chunks of 32 columns, each written from the registers into one of the
// warpgroup's two staging boxes and handed to a TMA store, which drains
// while the next chunk, and then the next tile's products, go on.  A box
// is reused once the store two chunks back has read it.
__device__ __forceinline__ void hg_store_f32(float (&d)[128], float* stage0,
                                             float* stage1,
                                             const CUtensorMap* tout, int row0,
                                             int n0, int N, int wg, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  const int r = warp * 16 + lane / 4;
#pragma unroll
  for (int ch = 0; ch < HG_BN / EPI_COLS; ++ch) {
    if (n0 + EPI_COLS * ch < N) {  // the same for the whole warpgroup
      float* stage = ch & 1 ? stage1 : stage0;
      if (tid == 0) hg::bulk_wait_read<1>();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg));
      char* base = reinterpret_cast<char*>(stage);
#pragma unroll
      for (int jj = 0; jj < EPI_COLS / 8; ++jj) {
        const int j = ch * (EPI_COLS / 8) + jj;
        const int b = 4 * (8 * jj + 2 * (lane % 4));  // byte in the row
        *reinterpret_cast<float2*>(base + hg::sw128_offset(r, b)) =
            make_float2(d[4 * j], d[4 * j + 1]);
        *reinterpret_cast<float2*>(base + hg::sw128_offset(r + 8, b)) =
            make_float2(d[4 * j + 2], d[4 * j + 3]);
      }
      hg::fence_async_smem();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg));
      if (tid == 0) {
        hg::tma_store_2d(tout, stage, n0 + EPI_COLS * ch, row0);
        hg::bulk_commit();
      }
    }
  }
}

template <typename OutT>
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
  int grid = gridDim.x;
  auto coprime = [](int a, int b) {
    while (b) {
      const int r = a % b;
      a = b;
      b = r;
    }
    return a == 1;
  };
  while (grid > 1 && !coprime(grid, items)) --grid;
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
      const uint32_t bytes =
          (uint32_t)(it.y * hg::A_TILE + HgRing::B_TILE) * sizeof(bf16);
      for (int kb = 0; kb < nk; ++kb) {
        hg::mbar_wait(&sm.empty[pos.stage], pos.phase ^ 1);
        hg::mbar_expect_tx(&sm.full[pos.stage], bytes);
        for (int c = 0; c < it.y; ++c)
          hg::tma_load_2d(sm.a[pos.stage][c], &tx, &sm.full[pos.stage],
                          kb * hg::BK, (it.x + c) * hg::WG_ROWS);
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
    if (it.z < 0) {  // rows past *num_rows: zeros, no loads
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
        hg::mbar_wait(&sm.full[pos.stage], pos.phase);
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
      hg::mbar_wait(&sm.full[pos.stage], pos.phase);
      hg::wgmma_fence();
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
      hg_store_f32(d, smem.out[wg][0], smem.out[wg][1], &tout,
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

template <typename OutT>
int gmm_hopper_launch(const CUtensorMap& tx, const CUtensorMap& tw,
                      const CUtensorMap& tout, const int* tile_gid,
                      int block_m, const int* num_rows, int* plan, int grid,
                      void* out, int T_, int K, int N, cudaStream_t stream) {
  const size_t smem = hg::smem_bytes<HgSmem>();
  cudaError_t err = cudaFuncSetAttribute(
      gmm_hopper<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int4* work = reinterpret_cast<int4*>(plan);
  int* n_work = plan + 4 * (T_ / hg::WG_ROWS);
  gmm_plan<<<1, PLAN_THREADS, 0, stream>>>(tile_gid, block_m, num_rows, T_,
                                           work, n_work);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gmm_hopper<OutT><<<grid, HG_THREADS, smem, stream>>>(
      tx, tw, tout, work, n_work, (OutT*)out, N, K);
  return (int)cudaGetLastError();
}

}  // namespace fm

// x [T, K]; tile_gid i32 [T / block_m]; num_rows i32 [1] or null (every
// row live); w [E, K, N], or [E, N, K] with transpose_w; out [T, N] in f32
// (out_f32) or x's dtype.  Needs T, K, N and block_m to be multiples of
// 64.
extern "C" int fm_grouped_matmul(int is_bf16, int transpose_w, int out_f32,
                                 const void* x, const int* tile_gid,
                                 int block_m, const int* num_rows,
                                 const void* w, void* out, int T, int K,
                                 int N, cudaStream_t stream) {
  if (is_bf16)
    return transpose_w
               ? fm::gmm_launch<fm::bf16, true>(out_f32, x, tile_gid, block_m,
                                                num_rows, w, out, T, K, N,
                                                stream)
               : fm::gmm_launch<fm::bf16, false>(out_f32, x, tile_gid,
                                                 block_m, num_rows, w, out, T,
                                                 K, N, stream);
  return transpose_w
             ? fm::gmm_launch<float, true>(out_f32, x, tile_gid, block_m,
                                           num_rows, w, out, T, K, N, stream)
             : fm::gmm_launch<float, false>(out_f32, x, tile_gid, block_m,
                                            num_rows, w, out, T, K, N, stream);
}

// The bf16, transpose_w layout on the Hopper kernel: x [T, K] bf16, w
// [E, N, K] bf16, tile_gid, block_m and num_rows as above, out [T, N] f32
// (out_f32) or bf16; plan i32 [4 * T / 64 + 1] scratch for the work list;
// grid persistent blocks (one per SM).  Two launches: the plan, the GEMM.
// Needs T, K, N and block_m to be multiples of 64.
extern "C" int fm_grouped_matmul_hopper(int out_f32, const void* x,
                                        const int* tile_gid, int block_m,
                                        const int* num_rows, const void* w,
                                        void* out, int* plan, int T, int K,
                                        int N, int E, int grid,
                                        cudaStream_t stream) {
  using namespace fm;
  CUtensorMap tx, tw, tout;
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)T};
  const cuuint64_t xs[1] = {(cuuint64_t)K * sizeof(bf16)};
  const cuuint32_t xb[2] = {hg::BK, hg::WG_ROWS};
  const cuuint64_t wd[3] = {(cuuint64_t)K, (cuuint64_t)N, (cuuint64_t)E};
  const cuuint64_t ws[2] = {(cuuint64_t)K * sizeof(bf16),
                            (cuuint64_t)N * K * sizeof(bf16)};
  const cuuint32_t wb[3] = {hg::BK, HG_BN, 1};
  const cuuint64_t od[2] = {(cuuint64_t)N, (cuuint64_t)T};
  const cuuint64_t os[1] = {(cuuint64_t)N * sizeof(float)};
  const cuuint32_t ob[2] = {EPI_COLS, hg::WG_ROWS};
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!hg::make_map(&tx, bf, x, 2, xd, xs, xb) ||
      !hg::make_map(&tw, bf, w, 3, wd, ws, wb))
    return (int)cudaErrorInvalidValue;
  // the f32 output's map (the bf16 epilogue stores from registers)
  if (out_f32 && !hg::make_map(&tout, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, out,
                               2, od, os, ob))
    return (int)cudaErrorInvalidValue;
  if (!out_f32) tout = tx;
  return out_f32 ? gmm_hopper_launch<float>(tx, tw, tout, tile_gid, block_m,
                                            num_rows, plan, grid, out, T, K,
                                            N, stream)
                 : gmm_hopper_launch<bf16>(tx, tw, tout, tile_gid, block_m,
                                           num_rows, plan, grid, out, T, K, N,
                                           stream);
}
