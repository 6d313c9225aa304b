// Grouped expert FFN over expert-sorted rows, its gather-fused twin, and
// its residual-saving training forward.
//
// fm_grouped_ffn replaces the TPU kernel
// flashmoe_tpu/ops/expert.py:_ffn_kernel (launched by grouped_ffn).  Same
// function: each row tile t of x [T, H] belongs to expert tile_gid[t]; its
// rows go through that expert's up GEMM (and gate GEMM when gated), an f32
// bias and activation (act(g) * (up + b_up) when gated), the hidden
// activations rounded to x's dtype, the down GEMM accumulated in f32,
// + b_down, rounded to x's dtype.  Rows at or past *num_rows (the ragged
// plan's padded tail) come back zero.
//
// fm_grouped_ffn_tokens replaces flashmoe_tpu/ops/expert.py:_ffn_gather_kernel
// (launched by grouped_ffn_tokens, the gather-fused inference FFN): the
// same FFN over rows that are never gathered into a buffer.  Row r of the
// grouped layout is token src_tok[r] of x [S, H]; only the up pass's A
// loads differ.  An unpopulated slot computes its src_tok (token 0) and
// the combine never reads it.  Only the [T, H] grouped input buffer
// disappears; the [T, I] hidden buffer stays.
//
// fm_grouped_ffn_res replaces flashmoe_tpu/ops/expert.py:_ffn_res_kernel
// (launched by _grouped_ffn_res, the forward of grouped_ffn_ad): the same
// FFN, and the up pass's epilogue also writes the pre-activations the
// backward needs, u = x @ w_up[e] + b_up[e] and, when gated,
// g = x @ w_gate[e], both rounded to x's dtype.
//
// What bounds them on an H100: the expert weights.  Every live expert's
// w_up/w_gate/w_down is read once, so at decode and prefill sizes the
// bytes of the weights (2.8 GB a Mixtral layer) bound them, not the
// tensor-core operations; the residual-saving forward adds the bytes of u
// and g.  The TPU kernel held a whole [bm, H] f32 accumulator in VMEM
// across I-chunks; a [bm, 4096] f32 tile fits neither one block's
// registers nor its shared memory here, so each FFN is two launches:
//   1. the up pass: hidden[T, I] = act(x @ w_gate[e]) * (x @ w_up[e] +
//      b_up[e]), written in x's dtype (exactly the TPU kernel's rounding
//      point), and with RES u and g beside it,
//   2. the down pass: out[T, H] = hidden @ w_down[e] + b_down[e].
//
// Two designs, chosen by dtype and entry point (a dispatch, not a
// fallback):
//
// * ffn_hopper: bf16 fm_grouped_ffn and fm_grouped_ffn_tokens, on the
//   TMA + wgmma mainloop of hopper_gemm.cuh.  The weights are [K, N]
//   row-major (w_up/w_gate [E, H, I], w_down [E, I, H]) and read in place
//   as MN-major B operands (boxes of 64 columns x 64 K-rows, wgmma with
//   the transposed-B flag): no copy of a weight is ever made.  The work
//   list is the grouped matmul's (gmm_plan, grouped_matmul.cu): items of
//   up to two consecutive 64-row tiles of one expert, built on the device
//   by one block, with no host sync.  A persistent grid (one block per SM)
//   walks (item, column tile) pairs so that the items of one expert run
//   side by side and share each weight tile through L2 (FfnWalk):
//   item-fastest, so each weight tile streams once, unless the items
//   outnumber the SMs and the column tiles are few (Qwen3-Next's widths),
//   then column-fastest, so each item's rows are read once too.  Each
//   block has a producer warpgroup that keeps a ring of 4 stages (64 of
//   K) filled, and two consumer warpgroups, one per 64-row tile of the
//   item, each holding its f32 accumulators in registers: in the gated up
//   pass two of 64 x 128 (up and gate over the same columns), otherwise
//   one of 64 x 256.  The column tile stays that wide at every row count:
//   at decode fewer (item, column) tiles than SMs run, yet on an H100
//   narrower tiles that cover the card were slower (each reads its rows
//   again for fewer weight columns).  The epilogue adds the f32 bias,
//   applies the activation, rounds once to bf16 and writes
//   64-column chunks into swizzled staging boxes that TMA stores drain
//   while the next chunk, and then the next tile's products, go on.
//   Items past *num_rows load nothing; the down pass writes their rows'
//   zeros.
//   B3 differs from B2 only in the up pass's A loads: TMA has no row
//   gather, so the 128 threads of the producer warpgroup copy the item's
//   rows from x[src_tok[row]] by cp.async (8 threads a row, 16 bytes
//   each) to the places the TMA box would have put them (sw128_offset);
//   each thread's copies arrive on the stage's full barrier when they
//   land (cp.async.mbarrier.arrive.noinc), and the consumers fence the
//   generic-proxy writes before wgmma reads them.  The B loads, the
//   products, the epilogue and the down pass are B2's code on the same
//   bytes: B3 equals B2 on the dispatched buffer bit for bit.  No split-K,
//   and one K order and column tile for every T: a row's output never
//   depends on the other rows of the batch.
// * ffn_gemm (gemm_tile.cuh): f32 B2 and B3, and B6 in both dtypes, one
//   64 x 64 output tile per block of 4 warps (WMMA for bf16, SIMT FMA for
//   f32), row tiles the fastest grid axis; row tiles at or past *num_rows
//   skip their GEMMs and write zeros (to out, and with RES to u and g, so
//   that the backward never reads uninitialised memory there).
#include "gemm_tile.cuh"
#include "hopper_gemm.cuh"

namespace fm {

enum { MODE_UP = 0, MODE_UP_GATED = 1, MODE_DOWN = 2 };

// One grouped GEMM launch.  MODE_UP / MODE_UP_GATED: A = x [T, K=H] (with
// GATHER: x [S, K=H], row r of the layout at A[src_tok[r]]), B0 = w_up
// [E, H, N=I], B1 = w_gate, bias = b_up [E, I], C = hidden, and with RES
// U = u and G = g [T, I].  MODE_DOWN: A = hidden [T, K=I], B0 = w_down
// [E, I, N=H], bias = b_down, C = out.
template <typename T, int MODE, bool RES, bool GATHER = false>
__global__ void __launch_bounds__(FTHREADS)
ffn_gemm(const T* __restrict__ A, const int* __restrict__ src_tok,
         const int* __restrict__ tile_gid, int block_m,
         const int* __restrict__ num_rows,
         const T* __restrict__ B0, const T* __restrict__ B1,
         const float* __restrict__ bias, T* __restrict__ C,
         T* __restrict__ U, T* __restrict__ G, int K, int N, int act) {
  constexpr int NB = (MODE == MODE_UP_GATED) ? 2 : 1;
  constexpr int LDC = FfnTile<T>::LDC;
  static_assert(sizeof(FfnSmem<T, NB, false>) <= FFN_SMEM, "shared memory");
  __shared__ __align__(128) float Cs[FFN_SMEM / 4];

  const int row0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN;
  if (num_rows != nullptr && row0 >= *num_rows) {
    for (int i = threadIdx.x; i < FBM * FBN; i += FTHREADS) {
      const size_t at = (size_t)(row0 + i / FBN) * N + n0 + i % FBN;
      if (MODE == MODE_DOWN) C[at] = from_f<T>(0.f);
      if (RES) U[at] = from_f<T>(0.f);
      if (RES && MODE == MODE_UP_GATED) G[at] = from_f<T>(0.f);
    }
    return;
  }
  const int e = tile_gid[row0 / block_m];
  const T* Bs[NB];
  Bs[0] = B0 + (size_t)e * K * N + n0;
  if (NB == 2) Bs[NB - 1] = B1 + (size_t)e * K * N + n0;
  if constexpr (GATHER)
    ffn_mainloop<NB, false, true>(A, K, Bs, N, Cs, src_tok + row0);
  else
    ffn_mainloop<NB, false>(A + (size_t)row0 * K, K, Bs, N, Cs);
  __syncthreads();

  const float* bias_e = bias + (size_t)e * N + n0;
  for (int i = threadIdx.x; i < FBM * FBN; i += FTHREADS) {
    const int r = i / FBN, c = i % FBN;
    const size_t at = (size_t)(row0 + r) * N + n0 + c;
    float v = Cs[r * LDC + c] + bias_e[c];
    if (MODE == MODE_UP_GATED) {
      const float g = Cs[FBM * LDC + r * LDC + c];
      if (RES) {
        U[at] = from_f<T>(v);
        G[at] = from_f<T>(g);
      }
      v = act_f(g, act) * v;
    } else if (MODE == MODE_UP) {
      if (RES) U[at] = from_f<T>(v);
      v = act_f(v, act);
    }
    C[at] = from_f<T>(v);
  }
}

// ---- the Hopper FFN: bf16 B2 and B3 -----------------------------------

constexpr int FH_STAGES = 4;
constexpr int FH_CONSUMERS = 2;  // 64-row tiles of a work item
constexpr int FH_THREADS = 128 * (FH_CONSUMERS + 1);
// B columns of a stage, all operands: the output tile is 256 columns, or
// 128 in the gated up pass (its up and gate accumulators side by side)
constexpr int FH_COLS = 256;
constexpr int EPI_COLS = 64;     // bf16 columns of one TMA store box
typedef hg::Ring<FH_STAGES, FH_CONSUMERS, FH_COLS> FhRing;

// The ring, then for each consumer warpgroup two bf16 staging boxes of
// its 64 rows x 64 columns (128-byte swizzled rows) for the epilogue.
struct FhSmem {
  FhRing ring;
  alignas(1024) bf16 out[FH_CONSUMERS][2][hg::WG_ROWS * EPI_COLS];
};

// The order of a pass's (work item, column tile) pairs.  Tile t is item
// t % items against column tile t / items (item-fastest: the items of one
// expert run side by side and share each weight tile through L2, and a
// wave of the grid holds several column tiles of every item, whose rows
// it shares through L2 too), unless the items outnumber the grid and the
// column tiles number at most a quarter of it: then tile t is column tile
// t % ncols of item t / ncols (column-fastest: each item's rows are read
// once, and a wave holds every column tile of four or more items, so the
// items of one expert still run side by side).  On an H100
// column-fastest wins at Qwen3-Next's widths (about 1300 items, 4 and 8
// column tiles) and item-fastest at Mixtral's (20 items; 112 and 16
// column tiles), even in the down pass (chip_ablate.py, cuts itemfast and
// colfast).  gridDim.x is the SM count.
// ops/expert.py:ffn_tile_walk is this order in Python.
struct FfnWalk {
  int items, ncols;
  bool cols_inner;
  __device__ FfnWalk(int items_, int N, int BN)
      : items(items_), ncols((N + BN - 1) / BN),
        cols_inner(items_ > (int)gridDim.x && 4 * ncols <= (int)gridDim.x) {}
  __device__ int total() const { return items * ncols; }
  __device__ int item(int t) const {
    return cols_inner ? t / ncols : t % items;
  }
  __device__ int col(int t) const {
    return cols_inner ? t % ncols : t / items;
  }
};

// The producer warpgroup.  Thread 0 issues the TMA loads of each stage
// (the A boxes of x or hidden unless GATHER, the B boxes of each operand)
// onto the stage's full barrier with their byte count.  With GATHER every
// thread also copies its part of the item's A rows from x[src_tok[row]]
// by cp.async at the TMA box's swizzled offsets (8 threads a row, 16
// bytes each, so a warp's copy covers 4 whole 128-byte rows), and the
// stage's full barrier counts its arrival once those copies have landed
// (cp.async.mbarrier.arrive.noinc): no thread waits for its own copies,
// so every stage of the ring can be in flight.
template <int NB, bool GATHER>
__device__ __forceinline__ void ffn_produce(
    FhRing& sm, const CUtensorMap* ta, const CUtensorMap* tb0,
    const CUtensorMap* tb1, const int4* work, FfnWalk walk, int grid, int N,
    int K, const bf16* x, const int* src_tok, int tid) {
  constexpr int BN = FH_COLS / NB;
  if (!GATHER && tid != 0) return;
  const int nk = K / hg::BK;
  hg::RingPos pos;
  for (int t = blockIdx.x; t < walk.total(); t += grid) {
    const int4 it = work[walk.item(t)];
    if (it.z < 0) continue;
    const int n0 = walk.col(t) * BN;
    const int boxes = min(BN, N - n0) / 64;
    const uint32_t bytes =
        (uint32_t)((GATHER ? 0 : it.y * hg::A_TILE) + NB * boxes * 64 * 64) *
        sizeof(bf16);
    // GATHER: the tokens of rows tid / 8 + 16 i of the item (-1 for a
    // tile the item lacks); the thread copies 16-byte unit tid % 8 of each
    int tok[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      tok[i] = GATHER && i / 4 < it.y
                   ? src_tok[it.x * hg::WG_ROWS + tid / 8 + 16 * i]
                   : -1;
    for (int kb = 0; kb < nk; ++kb) {
      hg::mbar_wait(&sm.empty[pos.stage], pos.phase ^ 1);
      uint64_t* full = &sm.full[pos.stage];
      if (tid == 0) {
        hg::mbar_expect_tx(full, bytes);
        if (!GATHER)
          for (int c = 0; c < it.y; ++c)
            hg::tma_load_2d(sm.a[pos.stage][c], ta, full, kb * hg::BK,
                            (it.x + c) * hg::WG_ROWS);
        for (int m = 0; m < NB; ++m)
          for (int j = 0; j < boxes; ++j)
            hg::tma_load_3d(sm.b[pos.stage] + (m * BN + 64 * j) * hg::BK,
                            m ? tb1 : tb0, full, n0 + 64 * j, kb * hg::BK,
                            it.z);
      }
      if constexpr (GATHER) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (tok[i] >= 0)
            cp_async16(reinterpret_cast<char*>(sm.a[pos.stage][i / 4]) +
                           hg::sw128_offset(tid / 8 + 16 * (i % 4),
                                            16 * (tid % 8)),
                       x + (size_t)tok[i] * K + kb * hg::BK + 8 * (tid % 8));
        hg::cp_async_mbar_arrive(full);
      }
      pos.next<FH_STAGES>();
    }
  }
  if (GATHER) cp_async_wait<0>();  // leave no copy in flight at exit
}

// the f32 bias of a thread's columns in one 64-column chunk: columns
// 8 jj + 2 (lane % 4) + {0, 1}, from be = the chunk's column 2 (lane % 4)
__device__ __forceinline__ void ffn_bias(float2 (&bv)[EPI_COLS / 8],
                                         const float* be) {
#pragma unroll
  for (int jj = 0; jj < EPI_COLS / 8; ++jj)
    bv[jj] = __ldg(reinterpret_cast<const float2*>(be + 8 * jj));
}

// One output value from the accumulators: d0 (up or down) and d1 (gate).
// The activation is common.cuh's act_f (accurate expf, IEEE division), as
// in B5 and B6.  The special function unit's __expf and __fdividef make
// the gated up pass faster (chip_ablate.py, cut fast_act), but their
// one-ulp differences from B5's activation flip routing near ties
// between the single-device and the fused expert-parallel forward, which
// chip_smoke.py holds to one another.
template <int MODE, int ACT>
__device__ __forceinline__ float ffn_epi(float d0, float d1, float b) {
  const float v = d0 + b;
  if (MODE == MODE_UP_GATED) return act_f(d1, ACT) * v;
  if (MODE == MODE_UP) return act_f(v, ACT);
  return v;
}

// The epilogue of a consumer warpgroup's 64 x BN tile: 64-column chunks
// through its two staging boxes in turn (a box is rewritten once the
// store two chunks back has read it).  bv holds the first chunk's bias,
// be points at it (the thread's first column).
template <int MODE, int ACT, int NB, int BN>
__device__ __forceinline__ void ffn_epilogue(
    float (&d)[NB][BN / 2], float2 (&bv)[EPI_COLS / 8], const float* be,
    FhSmem& smem, const CUtensorMap* tout, int& stored, int n0, int N,
    int row0, int wg, int tid) {
  const int lane = tid % 32;
  const int r = tid / 32 * 16 + lane / 4;  // the thread's first row
#pragma unroll
  for (int ch = 0; ch < BN / EPI_COLS; ++ch) {
    if (n0 + EPI_COLS * ch < N) {  // the same for the whole warpgroup
      char* box = reinterpret_cast<char*>(smem.out[wg][stored++ & 1]);
      if (tid == 0) hg::bulk_wait_read<1>();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg));
#pragma unroll
      for (int jj = 0; jj < EPI_COLS / 8; ++jj) {
        const int j = ch * (EPI_COLS / 8) + jj;
        const int c = 8 * jj + 2 * (lane % 4);  // column in the box
        // d[NB - 1] is the gate's accumulator when gated (else unused)
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            ffn_epi<MODE, ACT>(d[0][4 * j], d[NB - 1][4 * j], bv[jj].x),
            ffn_epi<MODE, ACT>(d[0][4 * j + 1], d[NB - 1][4 * j + 1],
                               bv[jj].y));
        const __nv_bfloat162 hi = __floats2bfloat162_rn(
            ffn_epi<MODE, ACT>(d[0][4 * j + 2], d[NB - 1][4 * j + 2],
                               bv[jj].x),
            ffn_epi<MODE, ACT>(d[0][4 * j + 3], d[NB - 1][4 * j + 3],
                               bv[jj].y));
        *reinterpret_cast<__nv_bfloat162*>(
            box + hg::sw128_offset(r, 2 * c)) = lo;
        *reinterpret_cast<__nv_bfloat162*>(
            box + hg::sw128_offset(r + 8, 2 * c)) = hi;
      }
      if (ch + 1 < BN / EPI_COLS && n0 + EPI_COLS * (ch + 1) < N)
        ffn_bias(bv, be + EPI_COLS * (ch + 1));
      hg::fence_async_smem();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg));
      if (tid == 0) {
        hg::tma_store_2d(tout, box, n0 + EPI_COLS * ch, row0);
        hg::bulk_commit();
      }
    }
  }
}

// A consumer warpgroup: its 64-row tile of each work item against BN
// columns, NB accumulators of 64 x BN in registers; releases a stage one
// wgmma group behind (wgmma.wait_group completes the whole warpgroup's
// reads, so one arrival a warpgroup).  With GATHER the A tile was written
// by cp.async (the generic proxy): a proxy fence after the full barrier's
// wait orders those writes, which the wait made visible to this thread,
// before its wgmma reads them through the async proxy.
template <int MODE, bool GATHER>
__device__ __forceinline__ void ffn_consume(
    FhSmem& smem, const CUtensorMap* tout, const int4* work, FfnWalk walk,
    int grid, int N, int K, const float* bias, bf16* out, int act, int wg,
    int tid) {
  constexpr int NB = MODE == MODE_UP_GATED ? 2 : 1;
  constexpr int BN = FH_COLS / NB;
  FhRing& sm = smem.ring;
  const int nk = K / hg::BK;
  const int lane = tid % 32;
  hg::RingPos pos;
  int stored = 0;  // chunks stored so far: their boxes alternate
  for (int t = blockIdx.x; t < walk.total(); t += grid) {
    const int4 it = work[walk.item(t)];
    const int n0 = walk.col(t) * BN;
    const int row0 = (it.x + wg) * hg::WG_ROWS;
    const bool active = wg < it.y;
    if (it.z < 0) {  // rows past *num_rows: no loads; the down pass's zeros
      if (MODE == MODE_DOWN && active)
        for (int i = tid; i < hg::WG_ROWS * BN / 8; i += 128) {
          const int c = n0 + (i % (BN / 8)) * 8;
          if (c < N)
            *reinterpret_cast<uint4*>(
                out + (size_t)(row0 + i / (BN / 8)) * N + c) =
                make_uint4(0, 0, 0, 0);
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
        pos.next<FH_STAGES>();
      }
      continue;
    }
    float d[NB][BN / 2];
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) d[m][i] = 0.f;
    int prev = -1;
    for (int kb = 0; kb < nk; ++kb) {
      hg::mbar_wait(&sm.full[pos.stage], pos.phase);
      if (GATHER) hg::fence_async_smem();
      hg::wgmma_fence();
#pragma unroll
      for (int m = 0; m < NB; ++m)
        hg::wgmma_stage_mn<BN>(d[m], sm.a[pos.stage][wg],
                               sm.b[pos.stage] + m * BN * hg::BK);
      hg::wgmma_commit();
      hg::wgmma_wait<1>();  // the previous stage's products are done
      if (prev >= 0 && tid == 0) hg::mbar_arrive(&sm.empty[prev]);
      prev = pos.stage;
      pos.next<FH_STAGES>();
    }
    // the first chunk's bias, loaded while the last products drain: the
    // loads of a chunk go out together, ahead of its stores (issued among
    // the shared-memory stores they would wait one by one)
    const float* be = bias + (size_t)it.z * N + n0 + 2 * (lane % 4);
    float2 bv[EPI_COLS / 8];
    ffn_bias(bv, be);
    hg::wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < NB; ++m) hg::fence_acc(d[m]);
    if (tid == 0) hg::mbar_arrive(&sm.empty[prev]);

    // the activation as a constant: a runtime code keeps its branches
    // between the chunk's independent values, which then cannot overlap
    // (the down pass has none)
    if (MODE == MODE_DOWN || act == ACT_RELU)
      ffn_epilogue<MODE, ACT_RELU, NB, BN>(d, bv, be, smem, tout, stored,
                                           n0, N, row0, wg, tid);
    else if constexpr (MODE != MODE_DOWN) {
      if (act == ACT_GELU)
        ffn_epilogue<MODE, ACT_GELU, NB, BN>(d, bv, be, smem, tout, stored,
                                             n0, N, row0, wg, tid);
      else
        ffn_epilogue<MODE, ACT_SILU, NB, BN>(d, bv, be, smem, tout, stored,
                                             n0, N, row0, wg, tid);
    }
  }
  if (tid == 0) hg::bulk_wait<0>();  // the stores have left shared memory
}

// One pass of the Hopper FFN.  MODE_UP / MODE_UP_GATED: A = x [T, K=H]
// through ta (with GATHER: x [S, K] read by src_tok instead), B0 = w_up,
// B1 = w_gate [E, H, N=I], bias = b_up [E, I], the output hidden [T, I]
// through tout.  MODE_DOWN: A = hidden [T, K=I], B0 = w_down [E, I, N=H],
// bias = b_down, the output out [T, H] through tout (zeros past *num_rows
// written through out).
template <int MODE, bool GATHER>
__global__ void __launch_bounds__(FH_THREADS, 1)
ffn_hopper(const __grid_constant__ CUtensorMap ta,
           const __grid_constant__ CUtensorMap tb0,
           const __grid_constant__ CUtensorMap tb1,
           const __grid_constant__ CUtensorMap tout,
           const int4* __restrict__ work, const int* __restrict__ n_work,
           const float* __restrict__ bias, bf16* __restrict__ out,
           const bf16* __restrict__ x, const int* __restrict__ src_tok,
           int N, int K, int act) {
  constexpr int NB = MODE == MODE_UP_GATED ? 2 : 1;
  extern __shared__ unsigned char fh_raw[];
  FhSmem& smem = hg::smem_at<FhSmem>(fh_raw);
  FhRing& sm = smem.ring;
  const int items = *n_work;
  const int grid = hg::stride_grid(items);
  if ((int)blockIdx.x >= grid) return;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < FH_STAGES; ++s) {
      hg::mbar_init(&sm.full[s], 1 + (GATHER ? 128 : 0));
      hg::mbar_init(&sm.empty[s], FH_CONSUMERS);
    }
    hg::mbar_fence_init();
  }
  __syncthreads();
  const FfnWalk walk(items, N, FH_COLS / NB);

  if (wg == FH_CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    ffn_produce<NB, GATHER>(sm, &ta, &tb0, &tb1, work, walk, grid, N, K, x,
                            src_tok, tid);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  ffn_consume<MODE, GATHER>(smem, &tout, work, walk, grid, N, K, bias, out,
                            act, wg, tid);
}

template <int MODE, bool GATHER>
int ffn_hopper_pass(int grid, const CUtensorMap& ta, const CUtensorMap& tb0,
                    const CUtensorMap& tb1, const CUtensorMap& tout,
                    const int4* work, const int* n_work, const float* bias,
                    void* out, const void* x, const int* src_tok, int N,
                    int K, int act, cudaStream_t stream) {
  const size_t smem = hg::smem_bytes<FhSmem>();
  cudaError_t err = cudaFuncSetAttribute(
      ffn_hopper<MODE, GATHER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffn_hopper<MODE, GATHER><<<grid, FH_THREADS, smem, stream>>>(
      ta, tb0, tb1, tout, work, n_work, bias, (bf16*)out, (const bf16*)x,
      src_tok, N, K, act);
  return (int)cudaGetLastError();
}

// [rows, cols] bf16 row-major in boxes of 64 x 64
inline bool fh_map_2d(CUtensorMap* map, const void* p, int rows, int cols) {
  const cuuint64_t d[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t s[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t b[2] = {64, 64};
  return hg::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, 2, d, s, b);
}
// w [E, K, N] bf16 in boxes of 64 columns x 64 K-rows of one expert
inline bool fh_map_w(CUtensorMap* map, const void* p, int E, int K, int N) {
  const cuuint64_t d[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t s[2] = {(cuuint64_t)N * sizeof(bf16),
                           (cuuint64_t)K * N * sizeof(bf16)};
  const cuuint32_t b[3] = {64, hg::BK, 1};
  return hg::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, 3, d, s, b);
}

// The bf16 FFN: the work list, the up pass, the down pass.  plan: i32
// [4 * T / 64 + 1] scratch (the items, then their count).
template <bool GATHER>
int ffn_hopper_launch(int gated, int act, const void* x, const int* src_tok,
                      const int* tile_gid, int block_m, const int* num_rows,
                      const void* w_up, const void* w_gate,
                      const float* b_up, const void* w_down,
                      const float* b_down, void* hidden, void* out,
                      int* plan, int T, int H, int I, int E, int grid,
                      cudaStream_t stream) {
  if (T == 0) return 0;
  CUtensorMap tx, tup, tgate, th, tdown, tout;
  if (!fh_map_2d(&th, hidden, T, I) || !fh_map_2d(&tout, out, T, H) ||
      !fh_map_w(&tup, w_up, E, H, I) || !fh_map_w(&tdown, w_down, E, I, H) ||
      (gated && !fh_map_w(&tgate, w_gate, E, H, I)) ||
      (!GATHER && !fh_map_2d(&tx, x, T, H)))
    return (int)cudaErrorInvalidValue;
  if (!gated) tgate = tup;
  if (GATHER) tx = th;  // unused: the rows come by src_tok
  int4* work = reinterpret_cast<int4*>(plan);
  int* n_work = plan + 4 * (T / hg::WG_ROWS);
  int err = hg::gmm_plan_launch(tile_gid, block_m, num_rows, T, work, n_work,
                                stream);
  if (err) return err;
  err = gated ? ffn_hopper_pass<MODE_UP_GATED, GATHER>(
                    grid, tx, tup, tgate, th, work, n_work, b_up, hidden, x,
                    src_tok, I, H, act, stream)
              : ffn_hopper_pass<MODE_UP, GATHER>(
                    grid, tx, tup, tgate, th, work, n_work, b_up, hidden, x,
                    src_tok, I, H, act, stream);
  if (err) return err;
  return ffn_hopper_pass<MODE_DOWN, false>(grid, th, tdown, tdown, tout,
                                           work, n_work, b_down, out,
                                           nullptr, nullptr, H, I, act,
                                           stream);
}

// C [64, N] f32 = A [64, K] @ B [K, N], both bf16 row-major, by one
// consumer warpgroup on the MN-major mainloop (ffn_hopper's B path, one
// stage at a time): the check of the MN-major descriptors.
template <int BN> struct TileSmem {
  bf16 a[hg::A_TILE];
  bf16 b[BN * hg::BK];
  uint64_t full;
};

template <int BN>
__global__ void __launch_bounds__(128)
hopper_tile_mn(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb, float* __restrict__ c,
               int K) {
  extern __shared__ unsigned char tile_raw[];
  TileSmem<BN>& sm = hg::smem_at<TileSmem<BN>>(tile_raw);
  const int tid = threadIdx.x;
  if (tid == 0) {
    hg::mbar_init(&sm.full, 1);
    hg::mbar_fence_init();
  }
  __syncthreads();
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  uint32_t phase = 0;
  for (int kb = 0; kb < K / hg::BK; ++kb) {
    if (tid == 0) {
      hg::mbar_expect_tx(&sm.full, (hg::A_TILE + BN * hg::BK) * sizeof(bf16));
      hg::tma_load_2d(sm.a, &ta, &sm.full, kb * hg::BK, 0);
      for (int j = 0; j < BN / 64; ++j)
        hg::tma_load_2d(sm.b + 64 * j * hg::BK, &tb, &sm.full, 64 * j,
                        kb * hg::BK);
    }
    hg::mbar_wait(&sm.full, phase);
    phase ^= 1;
    hg::wgmma_fence();
    hg::wgmma_stage_mn<BN>(d, sm.a, sm.b);
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    __syncthreads();  // the stage is read before the next loads land
  }
  hg::fence_acc(d);
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + lane / 4 + 8 * h;
      const int col = 8 * j + 2 * (lane % 4);
      c[(size_t)row * BN + col] = d[4 * j + 2 * h];
      c[(size_t)row * BN + col + 1] = d[4 * j + 2 * h + 1];
    }
}

template <int BN>
int hopper_tile_mn_launch(const void* a, const void* b, float* c, int K,
                          cudaStream_t stream) {
  CUtensorMap ta, tb;
  if (!fh_map_2d(&ta, a, hg::WG_ROWS, K) || !fh_map_2d(&tb, b, K, BN))
    return (int)cudaErrorInvalidValue;
  const size_t smem = hg::smem_bytes<TileSmem<BN>>();
  cudaError_t err = cudaFuncSetAttribute(
      hopper_tile_mn<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  hopper_tile_mn<BN><<<1, 128, smem, stream>>>(ta, tb, c, K);
  return (int)cudaGetLastError();
}

template <typename T, bool RES, bool GATHER>
int grouped_ffn_launch(int gated, int act, const void* x, const int* src_tok,
                       const int* tile_gid, int block_m, const int* num_rows,
                       const void* w_up, const void* w_gate,
                       const float* b_up, const void* w_down,
                       const float* b_down, void* u, void* g, void* hidden,
                       void* out, int T_, int H, int I, cudaStream_t stream) {
  const dim3 g_up(T_ / FBM, I / FBN), g_down(T_ / FBM, H / FBN);
  if (gated)
    ffn_gemm<T, MODE_UP_GATED, RES, GATHER><<<g_up, FTHREADS, 0, stream>>>(
        (const T*)x, src_tok, tile_gid, block_m, num_rows, (const T*)w_up,
        (const T*)w_gate, b_up, (T*)hidden, (T*)u, (T*)g, H, I, act);
  else
    ffn_gemm<T, MODE_UP, RES, GATHER><<<g_up, FTHREADS, 0, stream>>>(
        (const T*)x, src_tok, tile_gid, block_m, num_rows, (const T*)w_up,
        nullptr, b_up, (T*)hidden, (T*)u, nullptr, H, I, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ffn_gemm<T, MODE_DOWN, false><<<g_down, FTHREADS, 0, stream>>>(
      (const T*)hidden, nullptr, tile_gid, block_m, num_rows,
      (const T*)w_down, nullptr, b_down, (T*)out, nullptr, nullptr, I, H,
      act);
  return (int)cudaGetLastError();
}

// B2 (GATHER false) and B3: bf16 on the Hopper FFN, f32 on the 64 x 64
// tile.
template <bool GATHER>
int ffn_entry(int is_bf16, int gated, int act, const void* x,
              const int* src_tok, const int* tile_gid, int block_m,
              const int* num_rows, const void* w_up, const void* w_gate,
              const float* b_up, const void* w_down, const float* b_down,
              void* hidden, void* out, int* plan, int T, int H, int I, int E,
              int grid, cudaStream_t stream) {
  if (is_bf16)
    return ffn_hopper_launch<GATHER>(gated, act, x, src_tok, tile_gid,
                                     block_m, num_rows, w_up, w_gate, b_up,
                                     w_down, b_down, hidden, out, plan, T, H,
                                     I, E, grid, stream);
  return grouped_ffn_launch<float, false, GATHER>(
      gated, act, x, src_tok, tile_gid, block_m, num_rows, w_up, w_gate,
      b_up, w_down, b_down, nullptr, nullptr, hidden, out, T, H, I, stream);
}

}  // namespace fm

// x [T, H], tile_gid i32 [T / block_m], num_rows i32 [1] or null (every
// row live), w_up / w_gate [E, H, I], b_up f32 [E, I], w_down [E, I, H],
// b_down f32 [E, H], hidden scratch [T, I], out [T, H].  bf16 also takes
// plan, i32 [4 * T / 64 + 1] scratch for the work list, and grid, the
// persistent blocks (one per SM); f32 ignores both.  Needs T, H, I and
// block_m to be multiples of 64.  bf16: three launches (the work list,
// the up pass, the down pass); f32: two.
extern "C" int fm_grouped_ffn(int is_bf16, int gated, int act,
                              const void* x, const int* tile_gid,
                              int block_m, const int* num_rows,
                              const void* w_up, const void* w_gate,
                              const float* b_up, const void* w_down,
                              const float* b_down, void* hidden, void* out,
                              int* plan, int T, int H, int I, int E, int grid,
                              cudaStream_t stream) {
  return fm::ffn_entry<false>(is_bf16, gated, act, x, nullptr, tile_gid,
                              block_m, num_rows, w_up, w_gate, b_up, w_down,
                              b_down, hidden, out, plan, T, H, I, E, grid,
                              stream);
}

// x [T, H], tile_gid, block_m, num_rows, the weights and biases as
// fm_grouped_ffn's, and u [T, I] and g [T, I] (null when not gated), both
// in x's dtype: two launches on the 64 x 64 tile.
extern "C" int fm_grouped_ffn_res(int is_bf16, int gated, int act,
                                  const void* x, const int* tile_gid,
                                  int block_m, const int* num_rows,
                                  const void* w_up, const void* w_gate,
                                  const float* b_up, const void* w_down,
                                  const float* b_down, void* u, void* g,
                                  void* hidden, void* out, int T, int H,
                                  int I, cudaStream_t stream) {
  if (is_bf16)
    return fm::grouped_ffn_launch<fm::bf16, true, false>(
        gated, act, x, nullptr, tile_gid, block_m, num_rows, w_up, w_gate,
        b_up, w_down, b_down, u, g, hidden, out, T, H, I, stream);
  return fm::grouped_ffn_launch<float, true, false>(
      gated, act, x, nullptr, tile_gid, block_m, num_rows, w_up, w_gate,
      b_up, w_down, b_down, u, g, hidden, out, T, H, I, stream);
}

// fm_grouped_ffn's arguments with x [S, H] in token order and src_tok i32
// [T], the token of each row of the grouped layout (each in [0, S)).
extern "C" int fm_grouped_ffn_tokens(int is_bf16, int gated, int act,
                                     const void* x, const int* src_tok,
                                     const int* tile_gid, int block_m,
                                     const int* num_rows, const void* w_up,
                                     const void* w_gate, const float* b_up,
                                     const void* w_down, const float* b_down,
                                     void* hidden, void* out, int* plan,
                                     int T, int H, int I, int E, int grid,
                                     cudaStream_t stream) {
  return fm::ffn_entry<true>(is_bf16, gated, act, x, src_tok, tile_gid,
                             block_m, num_rows, w_up, w_gate, b_up, w_down,
                             b_down, hidden, out, plan, T, H, I, E, grid,
                             stream);
}

// C [64, N] f32 = A [64, K] @ B [K, N], A and B bf16 row-major, N 128 or
// 256, K a multiple of 64: one block on the Hopper FFN's MN-major mainloop
// (a check of its descriptors).
extern "C" int fm_hopper_tile_mn(const void* a, const void* b, float* c,
                                 int K, int N, cudaStream_t stream) {
  if (N == 256) return fm::hopper_tile_mn_launch<256>(a, b, c, K, stream);
  if (N == 128) return fm::hopper_tile_mn_launch<128>(a, b, c, K, stream);
  return (int)cudaErrorInvalidValue;
}
