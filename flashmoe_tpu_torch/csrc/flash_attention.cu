// Causal blockwise (flash) attention forward.
//
// Replaces the TPU kernel flashmoe_tpu/ops/attention.py:_flash_kernel
// (launched by flash_attention).  Same function and numerics:
// softmax(q k^T * scale) v with the scores in f32, then scaled, masked to
// -1e30 where key > query or key >= T, an online softmax over key blocks
// (m, alpha and l updated as the TPU kernel does), the row sum taken over
// the unrounded probabilities, p rounded to v's dtype before P . V with f32
// accumulation, and the output acc / max(l, 1e-30) rounded once.  GQA is
// handled in the kernel: query head n reads kv head n / (N / NKV), so
// repeated kv heads are never materialised.
//
// What bounds it on an H100: at prefill sizes ([4, 32, 256, 128]) the
// bytes of q/k/v/o (21 MB, 6.3 us at 3.35 TB/s) bound the work, but what
// the kernel takes is the serial chain of each key block of a tile: S,
// its wait, the softmax, P V, its wait, about 2 us a key block with two
// warpgroups a SM (chip_ablate.py, group b9).  Design, for bf16
// (flash_hopper; f32 keeps the SIMT kernel below):
//   * GQA packing: a consumer warpgroup's 64-row wgmma tile holds P query
//     heads of one kv head (P the largest of 8, 4, 2, 1 dividing N / NKV)
//     by 64 / P queries, row j * 64 / P + i being head h0 + j and query
//     q0 + i.  Every row of the tile reads the same keys, so one K/V load
//     feeds P heads, and a causal tile ends its keys at 64 / P queries'
//     reach rather than 64's.
//   * A work item is two tiles on consecutive query ranges of one
//     (batch, kv head, head group), one for each of a block's two consumer
//     warpgroups; a producer thread TMA-loads both Q tiles (3-D maps
//     [B * heads, T, D], so rows past T are zero-filled and never taken
//     from the next head) into one of two Q buffers, then each key block's
//     K and V into a ring of FA_STAGES stages with a barrier each for K
//     and V, so S can start before V lands and the next key blocks load
//     while this one computes.
//   * Products on wgmma: S = Q K^T as m64n64k16 with both operands
//     K-major; the softmax runs in registers on the accumulator layout,
//     a row's max and sum over the quad of lanes that hold it, the mask
//     only on key blocks that reach past T or the tile's first query; P
//     goes back as the register A operand of O += P V (m64n{D}k16, V
//     MN-major, read in place).
//   * The grid is persistent, one block per SM: the items go longest
//     first (most key blocks) and each block walks them in a snake (b,
//     2 g - 1 - b, 2 g + b, ...), so the causal imbalance evens out and
//     the next item's Q and first key blocks load while this item's last
//     key blocks and stores run (a grid of one item a block pays each
//     load's and store's latency once a wave: cut b9_per_block).  A
//     warpgroup whose queries end a key block early waits out the item's
//     last stages without products.  The barrier waits trap without a
//     message (hopper_gemm.cuh: mbar_wait), so that ptxas does not
//     serialize the kernel's wgmma.
//   * The epilogue normalises, rounds to bf16 into the warpgroup's Q tile
//     (dead by then, 128-byte swizzled) and stores it by TMA, clipped at
//     T; the Q buffer is refilled once both warpgroups' stores have read
//     it.
#include "common.cuh"
#include "hopper_gemm.cuh"

namespace fm {

constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value

// ---- bf16: TMA + wgmma ---------------------------------------------------

constexpr int FA_ROWS = 64;      // packed (head, query) rows of a tile
constexpr int FA_BK = 64;        // keys of a stage
constexpr int FA_STAGES = 3;
constexpr int FA_CONSUMERS = 2;  // tiles of a block
constexpr int FA_THREADS = 128 * (FA_CONSUMERS + 1);
constexpr int FA_BOX = 64 * 64;  // bf16 elements of a 64-row x 64-column box

template <int D> struct FaSmem {
  static constexpr int NB = D / 64;  // 64-column boxes across D
  // two items' Q tiles, each tile's then its O, so that one item's loads
  // overlap the last one's products and stores
  bf16 q[2][FA_CONSUMERS][NB][FA_BOX];
  bf16 k[FA_STAGES][NB][FA_BOX];
  bf16 v[FA_STAGES][NB][FA_BOX];
  uint64_t qfull[2], qempty[2];
  uint64_t kfull[FA_STAGES];
  uint64_t vfull[FA_STAGES];
  uint64_t empty[FA_STAGES];
};

// Work item i: batch b, kv head kvh, first packed head h0, first query q0
// of its first tile.  Items go in order of decreasing q0, so the ones
// with the most key blocks come first.
struct FaItem {
  int b, kvh, h0, q0;
};
__device__ __forceinline__ FaItem fa_item(int i, int B, int NKV, int G,
                                          int P, int nqb) {
  const int sg = G / P, units = B * NKV * sg;
  const int qb = nqb - 1 - i / units, u = i % units;
  const int kvh = u / sg % NKV;
  return {u / (NKV * sg), kvh, kvh * G + u % sg * P,
          qb * FA_CONSUMERS * (FA_ROWS / P)};
}

// The j-th item of block b on a persistent grid of g blocks: a snake over
// the longest-first items (b, 2 g - 1 - b, 2 g + b, 4 g - 1 - b, ...), so
// that each block's key blocks add up to about the same.  Increasing in
// j.
__device__ __forceinline__ int fa_walk(int j, int b, int g) {
  return j & 1 ? (j + 1) * g - 1 - b : j * g + b;
}

// Key blocks that a tile of queries [qs, qs + rq) reads: none past T.
__device__ __forceinline__ int fa_key_blocks(int qs, int rq, int T,
                                             int causal) {
  if (qs >= T) return 0;
  const int all = (T + FA_BK - 1) / FA_BK;
  return causal ? min(all, (qs + rq - 1) / FA_BK + 1) : all;
}

// S = Q K^T of one key block on wgmma (m64n64k16, both operands K-major),
// issued and committed, not waited for: s is zeroed first.
template <int D>
__device__ __forceinline__ void fa_scores(float (&s)[32],
                                          const bf16 (*q)[FA_BOX],
                                          const bf16 (*k)[FA_BOX]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  hg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hg::wgmma_m64n64k16(s, hg::sw128_desc(q[kk / 4]) + 2 * (kk % 4),
                        hg::sw128_desc(k[kk / 4]) + 2 * (kk % 4));
  hg::wgmma_commit();
}

// The online softmax of key block kb on the score accumulator, in place:
// s[4 j + 2 h + i] (row r + 8 h, key kb * 64 + 8 j + 2 (lane % 4) + i)
// scaled, masked where the block reaches past T or past a row's query
// (edge), then p = exp(s - m_new); m_i and l_i are updated and alpha[h] =
// exp(m_old - m_new) is what the output rows must be scaled by.  p takes
// the special function unit's exponential (__expf: ex2.approx of x log2
// e, within a few ulp of expf, far below p's bf16 rounding), which
// shortens each key block's softmax (chip_ablate.py, cut
// b9_accurate_exp).
__device__ __forceinline__ void fa_softmax(float (&s)[32], float (&m_i)[2],
                                           float (&l_i)[2], float (&alpha)[2],
                                           int kb, bool edge,
                                           const int (&qrow)[2], int T,
                                           float scale, int causal,
                                           int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float x = s[4 * j + 2 * h + i] * scale;
        if (edge) {
          const int key = kb * FA_BK + 8 * j + 2 * (lane % 4) + i;
          if (key >= T || (causal && key > qrow[h])) x = NEG_INF;
        }
        s[4 * j + 2 * h + i] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i[h], mx);
    alpha[h] = expf(m_i[h] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p = __expf(s[4 * j + 2 * h + i] - m_new);
        s[4 * j + 2 * h + i] = p;
        sum += p;  // the row sum uses p before rounding, as on the TPU
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_i[h] = l_i[h] * alpha[h] + sum;
    m_i[h] = m_new;
  }
}

// p rounded to bf16 as the A fragments of four k16 steps: the accumulator
// layout, columns 16 kk.. of rows r and r + 8
__device__ __forceinline__ void fa_pack(const float (&s)[32],
                                        uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const __nv_bfloat162 v2 =
          __floats2bfloat162_rn(s[8 * kk + 2 * c], s[8 * kk + 2 * c + 1]);
      pa[kk][c] = *reinterpret_cast<const uint32_t*>(&v2);
    }
}

// O += P V on wgmma (P the register A operand, V MN-major), issued and
// committed, not waited for
template <int D>
__device__ __forceinline__ void fa_pv(float (&o)[D / 2],
                                      const uint32_t (&pa)[4][4],
                                      const bf16* v) {
  hg::wgmma_fence();
  const uint64_t dv = hg::sw128_desc_mn(v);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hg::wgmma_rs<D>(o, pa[kk], dv + (hg::MN_K16 >> 4) * kk);
  hg::wgmma_commit();
}

// A consumer warpgroup's tile over its nkb_w key blocks, the ring at pos:
// for each key block S, its softmax, the output rows rescaled, then P V,
// each product waited for before its result is read.  Each stage is
// released once its P V has read it.  (Issuing the next block's S ahead
// of this block's P V, to run the softmax under P V, made ptxas
// serialize every wgmma of the kernel, its info C7514, and ran slower.)
template <int D>
__device__ __forceinline__ void fa_tile(FaSmem<D>& sm,
                                        const bf16 (*q)[FA_BOX],
                                        hg::RingPos& pos, int nkb_w, int qs,
                                        float (&o)[D / 2], float (&l_i)[2],
                                        const int (&qrow)[2], int T,
                                        float scale, int causal, int tid) {
  const int lane = tid % 32;
  float m_i[2] = {NEG_INF, NEG_INF}, alpha[2], s[32];
  uint32_t pa[4][4];
  for (int kb = 0; kb < nkb_w; ++kb) {
    hg::mbar_wait<false>(&sm.kfull[pos.stage], pos.phase);
    fa_scores<D>(s, q, sm.k[pos.stage]);
    hg::wgmma_wait<0>();
    hg::fence_acc(s);
    // whether the block reaches past T or past the tile's first query
    const int last = kb * FA_BK + FA_BK - 1;
    fa_softmax(s, m_i, l_i, alpha, kb, last >= T || (causal && last > qs),
               qrow, T, scale, causal, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * h] *= alpha[h];
        o[4 * j + 2 * h + 1] *= alpha[h];
      }
    fa_pack(s, pa);
    hg::mbar_wait<false>(&sm.vfull[pos.stage], pos.phase);
    fa_pv<D>(o, pa, sm.v[pos.stage][0]);
    hg::wgmma_wait<0>();  // P V has read the stage
    hg::fence_acc(o);
    if (tid == 0) hg::mbar_arrive(&sm.empty[pos.stage]);
    pos.next<FA_STAGES>();
  }
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS, 1)
flash_hopper(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap to, int B, int N, int NKV,
             int T, int P, float scale, int causal) {
  constexpr int NB = FaSmem<D>::NB;
  extern __shared__ unsigned char fa_raw[];
  FaSmem<D>& sm = hg::smem_at<FaSmem<D>>(fa_raw);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int G = N / NKV, rq = FA_ROWS / P;
  const int nqb = (T + FA_CONSUMERS * rq - 1) / (FA_CONSUMERS * rq);
  const int items = nqb * B * NKV * (G / P);
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      hg::mbar_init(&sm.qfull[b], 1);
      hg::mbar_init(&sm.qempty[b], FA_CONSUMERS);
    }
    for (int s = 0; s < FA_STAGES; ++s) {
      hg::mbar_init(&sm.kfull[s], 1);
      hg::mbar_init(&sm.vfull[s], 1);
      hg::mbar_init(&sm.empty[s], FA_CONSUMERS);
    }
    hg::mbar_fence_init();
  }
  __syncthreads();
  hg::RingPos pos;

  if (wg == FA_CONSUMERS) {  // producer warpgroup: one thread issues TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 0) return;
    for (int j = 0;; ++j) {
      const int it = fa_walk(j, blockIdx.x, gridDim.x);
      if (it >= items) break;
      const FaItem w0 = fa_item(it, B, NKV, G, P, nqb);
      // the Q tiles of the consumers that hold a query (P boxes of rq
      // rows in each 64-column box), into the item's Q buffer once both
      // consumers have stored the item two back from it
      const int buf = j & 1;
      hg::mbar_wait<false>(&sm.qempty[buf], ((j >> 1) & 1) ^ 1);
      int tiles = 0, nkb = 0;
      for (int w = 0; w < FA_CONSUMERS; ++w) {
        tiles += w0.q0 + w * rq < T;
        nkb = max(nkb, fa_key_blocks(w0.q0 + w * rq, rq, T, causal));
      }
      hg::mbar_expect_tx(&sm.qfull[buf], tiles * NB * FA_BOX * sizeof(bf16));
      for (int w = 0; w < tiles; ++w)
        for (int c = 0; c < NB; ++c)
          for (int h = 0; h < P; ++h)
            hg::tma_load_3d(&sm.q[buf][w][c][h * rq * 64], &tq,
                            &sm.qfull[buf], 64 * c, w0.q0 + w * rq,
                            w0.b * N + w0.h0 + h);
      const int kvrow = w0.b * NKV + w0.kvh;
      constexpr uint32_t bytes = NB * FA_BOX * sizeof(bf16);
      for (int kb = 0; kb < nkb; ++kb) {
        hg::mbar_wait<false>(&sm.empty[pos.stage], pos.phase ^ 1);
        hg::mbar_expect_tx(&sm.kfull[pos.stage], bytes);
        for (int c = 0; c < NB; ++c)
          hg::tma_load_3d(sm.k[pos.stage][c], &tk, &sm.kfull[pos.stage],
                          64 * c, kb * FA_BK, kvrow);
        hg::mbar_expect_tx(&sm.vfull[pos.stage], bytes);
        for (int c = 0; c < NB; ++c)
          hg::tma_load_3d(sm.v[pos.stage][c], &tv, &sm.vfull[pos.stage],
                          64 * c, kb * FA_BK, kvrow);
        pos.next<FA_STAGES>();
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = tid / 32, lane = tid % 32;
  for (int j = 0;; ++j) {
    const int it = fa_walk(j, blockIdx.x, gridDim.x);
    if (it >= items) break;
    const FaItem w0 = fa_item(it, B, NKV, G, P, nqb);
    const int buf = j & 1;
    int nkb = 0;
    for (int w = 0; w < FA_CONSUMERS; ++w)
      nkb = max(nkb, fa_key_blocks(w0.q0 + w * rq, rq, T, causal));
    const int qs = w0.q0 + wg * rq;
    const int nkb_w = fa_key_blocks(qs, rq, T, causal);
    // the thread's rows r and r + 8 of the tile: queries qs + row % rq
    int qrow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      qrow[h] = qs + (warp * 16 + lane / 4 + 8 * h) % rq;
    float o[D / 2];  // the m64n{D} output accumulator
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float l_i[2] = {0.f, 0.f};
    if (nkb_w > 0) {
      hg::mbar_wait<false>(&sm.qfull[buf], (j >> 1) & 1);
      fa_tile<D>(sm, sm.q[buf][wg], pos, nkb_w, qs, o, l_i, qrow, T, scale,
                 causal, tid);
    }
    for (int kb = nkb_w; kb < nkb; ++kb) {
      // past the tile's last key block: wait out the stage, keeping the
      // ring in step, and let every thread see the phase before it is
      // released
      hg::mbar_wait<false>(&sm.kfull[pos.stage], pos.phase);
      hg::mbar_wait<false>(&sm.vfull[pos.stage], pos.phase);
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg));
      if (tid == 0) hg::mbar_arrive(&sm.empty[pos.stage]);
      pos.next<FA_STAGES>();
    }
    if (nkb_w > 0) {
      // O = acc / max(l, 1e-30) in bf16 into the tile's Q boxes (128-byte
      // swizzled rows), then one TMA store per head and 64-column box
      char* box = reinterpret_cast<char*>(sm.q[buf][wg]);
      float lmax[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) lmax[h] = fmaxf(l_i[h], 1e-30f);
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + lane / 4 + 8 * h;
          const int c = 8 * jj + 2 * (lane % 4);
          *reinterpret_cast<__nv_bfloat162*>(
              box + c / 64 * FA_BOX * 2 + hg::sw128_offset(r, 2 * (c % 64))) =
              __floats2bfloat162_rn(o[4 * jj + 2 * h] / lmax[h],
                                    o[4 * jj + 2 * h + 1] / lmax[h]);
        }
      hg::fence_async_smem();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg));
      if (tid == 0) {
        for (int c = 0; c < NB; ++c)
          for (int h = 0; h < P; ++h)
            hg::tma_store_3d(&to, box + c * FA_BOX * 2 + h * rq * 128, 64 * c,
                             qs, w0.b * N + w0.h0 + h);
        hg::bulk_commit();
        hg::bulk_wait_read<0>();  // the stores have read the buffer
      }
    }
    // the item's Q buffer may be refilled
    if (tid == 0) hg::mbar_arrive(&sm.qempty[buf]);
  }
}

// The pack factor: the largest of 8, 4, 2, 1 that divides N / NKV.
inline int flash_pack(int N, int NKV) {
  const int G = N / NKV;
  int P = 8;
  while (G % P) P /= 2;
  return P;
}

// SMs of the current device, read once a device
inline int flash_sms() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 132;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return sms[dev];
}

template <int D>
int flash_hopper_launch(const void* q, const void* k, const void* v, void* o,
                        int B, int N, int NKV, int T, float scale, int causal,
                        cudaStream_t stream) {
  const int P = flash_pack(N, NKV), rq = FA_ROWS / P;
  CUtensorMap tq, tk, tv, to;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t qd[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)B * N};
  const cuuint64_t kd[3] = {(cuuint64_t)D, (cuuint64_t)T,
                            (cuuint64_t)B * NKV};
  const cuuint64_t st[2] = {(cuuint64_t)D * sizeof(bf16),
                            (cuuint64_t)T * D * sizeof(bf16)};
  const cuuint32_t qb[3] = {64, (cuuint32_t)rq, 1};
  const cuuint32_t kb[3] = {64, FA_BK, 1};
  if (!hg::make_map(&tq, bf, q, 3, qd, st, qb) ||
      !hg::make_map(&tk, bf, k, 3, kd, st, kb) ||
      !hg::make_map(&tv, bf, v, 3, kd, st, kb) ||
      !hg::make_map(&to, bf, o, 3, qd, st, qb))
    return (int)cudaErrorInvalidValue;
  const size_t smem = hg::smem_bytes<FaSmem<D>>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_hopper<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nqb = (T + FA_CONSUMERS * rq - 1) / (FA_CONSUMERS * rq);
  const int items = nqb * B * NKV * (N / NKV / P);
  const int grid = min(items, flash_sms());
  flash_hopper<D><<<grid, FA_THREADS, smem, stream>>>(
      tq, tk, tv, to, B, N, NKV, T, P, scale, causal);
  return (int)cudaGetLastError();
}

// ---- f32: SIMT -------------------------------------------------------------
//
// One warp per query row, 8 rows a block, 32-key tiles in shared memory;
// lane j scores key j of the tile, lanes split D for P . V.
constexpr int F32_ROWS = 8, F32_KT = 32;

template <int D>
__global__ void __launch_bounds__(F32_ROWS * 32)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int N, int NKV,
          int T, float scale, int causal) {
  __shared__ float Qs[F32_ROWS][D];
  __shared__ float Ks[F32_KT][D + 1];
  __shared__ float Vs[F32_KT][D];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, b = bh / N, n = bh % N;
  const int kvh = n / (N / NKV);
  const int q0 = blockIdx.x * F32_ROWS, row = q0 + warp;
  const float* qb = q + (size_t)bh * T * D;
  const float* kb = k + (size_t)(b * NKV + kvh) * T * D;
  const float* vb = v + (size_t)(b * NKV + kvh) * T * D;
  for (int d = lane; d < D; d += 32)
    Qs[warp][d] = row < T ? qb[(size_t)row * D + d] : 0.f;

  constexpr int NPL = D / 32;
  float acc[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) acc[i] = 0.f;
  float m_i = NEG_INF, l_i = 0.f;
  const int kend = causal ? min(T, q0 + F32_ROWS) : T;
  for (int k0 = 0; k0 < kend; k0 += F32_KT) {
    __syncthreads();
    for (int i = threadIdx.x; i < F32_KT * D; i += F32_ROWS * 32) {
      const int kr = i / D, d = i % D, key = k0 + kr;
      Ks[kr][d] = key < T ? kb[(size_t)key * D + d] : 0.f;
      Vs[kr][d] = key < T ? vb[(size_t)key * D + d] : 0.f;
    }
    __syncthreads();
    const int key = k0 + lane;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(Qs[warp][d], Ks[lane][d], s);
    s *= scale;
    if (key >= T || (causal && key > row)) s = NEG_INF;
    const float m_new = fmaxf(m_i, warp_max(s));
    const float p = expf(s - m_new);
    const float alpha = expf(m_i - m_new);
    l_i = l_i * alpha + warp_sum(p);
    m_i = m_new;
#pragma unroll
    for (int i = 0; i < NPL; ++i) acc[i] *= alpha;
    for (int j = 0; j < F32_KT; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int i = 0; i < NPL; ++i) acc[i] = fmaf(pj, Vs[j][lane + 32 * i], acc[i]);
    }
  }
  if (row < T) {
    const float inv = 1.f / fmaxf(l_i, 1e-30f);
#pragma unroll
    for (int i = 0; i < NPL; ++i)
      o[(size_t)bh * T * D + (size_t)row * D + lane + 32 * i] = acc[i] * inv;
  }
}

template <int D>
int flash_launch(int is_bf16, const void* q, const void* k, const void* v,
                 void* o, int B, int N, int NKV, int T, float scale,
                 int causal, cudaStream_t stream) {
  if (is_bf16)
    return flash_hopper_launch<D>(q, k, v, o, B, N, NKV, T, scale, causal,
                                  stream);
  const dim3 grid((T + F32_ROWS - 1) / F32_ROWS, B * N);
  flash_f32<D><<<grid, F32_ROWS * 32, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, N, NKV, T,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace fm

// q/o [B, N, T, D], k/v [B, NKV, T, D] (NKV divides N), D in {64, 128}.
extern "C" int fm_flash_attention(int is_bf16, const void* q, const void* k,
                                  const void* v, void* o, int B, int N,
                                  int NKV, int T, int D, float scale,
                                  int causal, cudaStream_t stream) {
  if (D == 64)
    return fm::flash_launch<64>(is_bf16, q, k, v, o, B, N, NKV, T, scale,
                                causal, stream);
  if (D == 128)
    return fm::flash_launch<128>(is_bf16, q, k, v, o, B, N, NKV, T, scale,
                                 causal, stream);
  return (int)cudaErrorInvalidValue;
}
