// The pieces of the Hopper FFN that the grouped FFN (grouped_ffn.cu: B2,
// B3, B6) and the fused expert-parallel kernel (fused_ep.cu: B5, B5q)
// share, so that both compute every output value the same way: the same
// ring of TMA stages, K order, column tiles (m64n128k16 for the gated up
// pass, m64n256k16 otherwise), f32 bias, activation (common.cuh's act_f)
// and bf16 rounding.  B5's rows therefore equal B2's bit for bit.
//
// A block has one producer warpgroup and two consumer warpgroups; each
// consumer owns one 64-row tile of a work item and holds its f32
// accumulators in registers (two of 64 x 128 in the gated up pass, one of
// 64 x 256 otherwise).  The epilogue writes 64-column chunks, either
// through two swizzled staging boxes per consumer that TMA stores drain
// (ffn_epilogue), or straight from the accumulator fragments (each thread
// holds column pairs of rows r and r + 8: ffn_rows).
#pragma once

#include "hopper_gemm.cuh"

namespace fm {

enum { MODE_UP = 0, MODE_UP_GATED = 1, MODE_DOWN = 2 };

constexpr int FH_STAGES = 4;
constexpr int FH_CONSUMERS = 2;  // 64-row tiles of a work item
constexpr int FH_THREADS = 128 * (FH_CONSUMERS + 1);
// B columns of a stage, all operands: the output tile is 256 columns, or
// 128 in the gated up pass (its up and gate accumulators side by side)
constexpr int FH_COLS = 256;
constexpr int EPI_COLS = 64;     // bf16 columns of one TMA store box
template <int STAGES> using FhRingT = hg::Ring<STAGES, FH_CONSUMERS, FH_COLS>;
typedef FhRingT<FH_STAGES> FhRing;
// a consumer warpgroup's two bf16 staging boxes of 64 rows x 64 columns
// (128-byte swizzled rows)
typedef bf16 FhBox[hg::WG_ROWS * EPI_COLS];

// named barriers: 1 + wg for consumer warpgroup wg (0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg));
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
// The activation is common.cuh's act_f (accurate expf, IEEE division).
// The special function unit's __expf and __fdividef make the gated up
// pass faster (chip_ablate.py, cut fast_act), but their one-ulp
// differences flip routing near ties between the single-device and the
// fused expert-parallel forward, which chip_smoke.py holds to one another.
template <int MODE, int ACT>
__device__ __forceinline__ float ffn_epi(float d0, float d1, float b) {
  const float v = d0 + b;
  if (MODE == MODE_UP_GATED) return act_f(d1, ACT) * v;
  if (MODE == MODE_UP) return act_f(v, ACT);
  return v;
}

// Output O of the up pass's epilogue: 0 the hidden activations (or the
// down pass's output), 1 u = up + b_up, 2 g = the raw gate product (the
// residuals the training backward reads).
template <int MODE, int ACT, int O>
__device__ __forceinline__ float ffn_out(float d0, float d1, float b) {
  if (O == 1) return d0 + b;
  if (O == 2) return d1;
  return ffn_epi<MODE, ACT>(d0, d1, b);
}

// Chunk ch of output O as bf16 pairs: lo for row r, hi for row r + 8, at
// the chunk's columns 8 jj + 2 (lane % 4) + {0, 1}.  d[NB - 1] is the
// gate's accumulator when gated (else unused).
template <int MODE, int ACT, int O, int NB, int BN>
__device__ __forceinline__ void ffn_pair(const float (&d)[NB][BN / 2],
                                         const float2 (&bv)[EPI_COLS / 8],
                                         int ch, int jj, __nv_bfloat162& lo,
                                         __nv_bfloat162& hi) {
  const int j = ch * (EPI_COLS / 8) + jj;
  lo = __floats2bfloat162_rn(
      ffn_out<MODE, ACT, O>(d[0][4 * j], d[NB - 1][4 * j], bv[jj].x),
      ffn_out<MODE, ACT, O>(d[0][4 * j + 1], d[NB - 1][4 * j + 1],
                            bv[jj].y));
  hi = __floats2bfloat162_rn(
      ffn_out<MODE, ACT, O>(d[0][4 * j + 2], d[NB - 1][4 * j + 2], bv[jj].x),
      ffn_out<MODE, ACT, O>(d[0][4 * j + 3], d[NB - 1][4 * j + 3],
                            bv[jj].y));
}

// Chunk ch of output O through the warpgroup's next staging box and a TMA
// store at (n0 + 64 ch, row0) of tout.  A box is rewritten once the store
// two chunks back has read it.  With next, the following chunk's bias is
// loaded into bv between the box's writes and its store.
template <int MODE, int ACT, int O, int NB, int BN>
__device__ __forceinline__ void ffn_box(const float (&d)[NB][BN / 2],
                                        float2 (&bv)[EPI_COLS / 8],
                                        const float* next, int ch,
                                        FhBox* boxes,
                                        const CUtensorMap* tout, int& stored,
                                        int n0, int row0, int wg, int tid) {
  const int lane = tid % 32;
  const int r = tid / 32 * 16 + lane / 4;  // the thread's first row
  char* box = reinterpret_cast<char*>(boxes[stored++ & 1]);
  if (tid == 0) hg::bulk_wait_read<1>();
  wg_sync(wg);
#pragma unroll
  for (int jj = 0; jj < EPI_COLS / 8; ++jj) {
    const int c = 8 * jj + 2 * (lane % 4);  // column in the box
    __nv_bfloat162 lo, hi;
    ffn_pair<MODE, ACT, O, NB, BN>(d, bv, ch, jj, lo, hi);
    *reinterpret_cast<__nv_bfloat162*>(box + hg::sw128_offset(r, 2 * c)) =
        lo;
    *reinterpret_cast<__nv_bfloat162*>(
        box + hg::sw128_offset(r + 8, 2 * c)) = hi;
  }
  if (next != nullptr) ffn_bias(bv, next);
  hg::fence_async_smem();
  wg_sync(wg);
  if (tid == 0) {
    hg::tma_store_2d(tout, box, n0 + EPI_COLS * ch, row0);
    hg::bulk_commit();
  }
}

// Chunk ch of output O stored straight from the fragments: row r at p0,
// row r + 8 at p1 (each the row's element n0 + 64 ch, or null: not
// written).
template <int MODE, int ACT, int O, int NB, int BN>
__device__ __forceinline__ void ffn_direct(const float (&d)[NB][BN / 2],
                                           const float2 (&bv)[EPI_COLS / 8],
                                           int ch, bf16* p0, bf16* p1,
                                           int lane) {
#pragma unroll
  for (int jj = 0; jj < EPI_COLS / 8; ++jj) {
    const int c = 8 * jj + 2 * (lane % 4);
    __nv_bfloat162 lo, hi;
    ffn_pair<MODE, ACT, O, NB, BN>(d, bv, ch, jj, lo, hi);
    if (p0 != nullptr) *reinterpret_cast<__nv_bfloat162*>(p0 + c) = lo;
    if (p1 != nullptr) *reinterpret_cast<__nv_bfloat162*>(p1 + c) = hi;
  }
}

// The output maps and pointers of one pass: out [rows, N] through tout
// (the down pass also writes the zeros past *num_rows through out); with
// RES (the up pass of B6) u and g [rows, N] through tu / tg, their zeros
// at U / G.
struct FfnOut {
  const CUtensorMap* tout;
  const CUtensorMap* tu;
  const CUtensorMap* tg;
  bf16* out;
  bf16* U;
  bf16* G;
};

// The epilogue of a consumer warpgroup's 64 x BN tile at rows row0.. and
// columns n0.. of an [rows, N] output, 64-column chunks in turn, each
// through the staging boxes: output 0 to o.tout, and with RES (B6's up
// pass) u (output 1) and, gated, g (output 2) before it, to o.tu / o.tg.
// bv holds the first chunk's bias, be points at it (the thread's first
// column).
template <int MODE, int ACT, int NB, int BN, bool RES>
__device__ __forceinline__ void ffn_epilogue(const float (&d)[NB][BN / 2],
                                             float2 (&bv)[EPI_COLS / 8],
                                             const float* be, FhBox* boxes,
                                             const FfnOut& o, int& stored,
                                             int n0, int N, int row0, int wg,
                                             int tid) {
#pragma unroll
  for (int ch = 0; ch < BN / EPI_COLS; ++ch) {
    if (n0 + EPI_COLS * ch < N) {  // the same for the whole warpgroup
      const float* next =
          ch + 1 < BN / EPI_COLS && n0 + EPI_COLS * (ch + 1) < N
              ? be + EPI_COLS * (ch + 1)
              : nullptr;
      if constexpr (RES) {
        ffn_box<MODE, ACT, 1, NB, BN>(d, bv, nullptr, ch, boxes, o.tu, stored,
                                      n0, row0, wg, tid);
        if (MODE == MODE_UP_GATED)
          ffn_box<MODE, ACT, 2, NB, BN>(d, bv, nullptr, ch, boxes, o.tg,
                                        stored, n0, row0, wg, tid);
      }
      ffn_box<MODE, ACT, 0, NB, BN>(d, bv, next, ch, boxes, o.tout, stored,
                                    n0, row0, wg, tid);
    }
  }
}

// The epilogue of a consumer warpgroup's 64 x BN tile straight from the
// fragments, 64-column chunks of output 0 in turn: the thread's row r at
// p0, row r + 8 at p1 (each the row's element n0, or null: not written),
// N the output's width.  bv holds the first chunk's bias, be points at
// it.
template <int MODE, int ACT, int NB, int BN>
__device__ __forceinline__ void ffn_rows(const float (&d)[NB][BN / 2],
                                         float2 (&bv)[EPI_COLS / 8],
                                         const float* be, bf16* p0, bf16* p1,
                                         int n0, int N, int lane) {
#pragma unroll
  for (int ch = 0; ch < BN / EPI_COLS; ++ch) {
    if (n0 + EPI_COLS * ch < N) {
      const int off = EPI_COLS * ch;
      ffn_direct<MODE, ACT, 0, NB, BN>(d, bv, ch, p0 ? p0 + off : nullptr,
                                       p1 ? p1 + off : nullptr, lane);
      if (ch + 1 < BN / EPI_COLS && n0 + off + EPI_COLS < N)
        ffn_bias(bv, be + off + EPI_COLS);
    }
  }
}

// Zeros over a consumer's 64 rows at row0.. and columns [n0, min(n0 + BN,
// N)) of an [rows, N] bf16 output (a tile past *num_rows).
template <int BN>
__device__ __forceinline__ void ffn_zeros(bf16* out, int row0, int n0, int N,
                                          int tid) {
  for (int i = tid; i < hg::WG_ROWS * BN / 8; i += 128) {
    const int c = n0 + (i % (BN / 8)) * 8;
    if (c < N)
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + i / (BN / 8)) * N + c) =
          make_uint4(0, 0, 0, 0);
  }
}

// A consumer warpgroup whose item lacks its tile: wait out each of the
// item's nk stages and release it, keeping the ring in step.
template <int STAGES>
__device__ __forceinline__ void ffn_skip(FhRingT<STAGES>& sm,
                                         hg::RingPos& pos, int nk, int wg,
                                         int tid, uint64_t limit_ns) {
  for (int kb = 0; kb < nk; ++kb) {
    hg::mbar_wait(&sm.full[pos.stage], pos.phase, limit_ns);
    // every thread of the warpgroup has seen the phase before the stage
    // can be refilled
    wg_sync(wg);
    if (tid == 0) hg::mbar_arrive(&sm.empty[pos.stage]);
    pos.next<STAGES>();
  }
}

// A consumer warpgroup's products over an item's nk stages: its 64-row A
// tile against BN columns of NB operands, f32 accumulators d zeroed
// first; releases each stage one wgmma group behind (wgmma.wait_group
// completes the whole warpgroup's reads, so one arrival a warpgroup).
// GENERIC: some of a stage's operands were written by the generic proxy
// (cp.async rows, dequantized weights); a proxy fence after the full
// barrier's wait orders those writes, which the wait made visible to this
// thread, before wgmma reads them through the async proxy.  Returns the
// last stage, which ffn_drain releases once its products are done.
template <int STAGES, int NB, int BN, bool GENERIC>
__device__ __forceinline__ int ffn_products(FhRingT<STAGES>& sm,
                                            hg::RingPos& pos, int nk,
                                            int wg, int tid,
                                            float (&d)[NB][BN / 2],
                                            uint64_t limit_ns) {
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[m][i] = 0.f;
  int prev = -1;
  for (int kb = 0; kb < nk; ++kb) {
    hg::mbar_wait(&sm.full[pos.stage], pos.phase, limit_ns);
    if (GENERIC) hg::fence_async_smem();
    hg::wgmma_fence();
#pragma unroll
    for (int m = 0; m < NB; ++m)
      hg::wgmma_stage_mn<BN>(d[m], sm.a[pos.stage][wg],
                             sm.b[pos.stage] + m * BN * hg::BK);
    hg::wgmma_commit();
    hg::wgmma_wait<1>();  // the previous stage's products are done
    if (prev >= 0 && tid == 0) hg::mbar_arrive(&sm.empty[prev]);
    prev = pos.stage;
    pos.next<STAGES>();
  }
  return prev;
}

// After ffn_products: the first chunk's bias (be, the thread's first
// column) loaded into bv while the last products drain (the loads of a
// chunk go out together, ahead of its stores, which would otherwise wait
// them one by one), then the last stage released.  The caller computes be
// only now, so that no pointer of the epilogue stays live across the
// mainloop.
template <int STAGES, int NB, int BN>
__device__ __forceinline__ void ffn_drain(FhRingT<STAGES>& sm, int last,
                                          int tid, float (&d)[NB][BN / 2],
                                          const float* be,
                                          float2 (&bv)[EPI_COLS / 8]) {
  ffn_bias(bv, be);
  hg::wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < NB; ++m) hg::fence_acc(d[m]);
  if (tid == 0) hg::mbar_arrive(&sm.empty[last]);
}

// ---- host side -------------------------------------------------------

// [rows, cols] bf16 row-major in boxes of 64 x 64
inline bool fh_map_2d(CUtensorMap* map, const void* p, int rows, int cols) {
  const cuuint64_t d[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t s[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t b[2] = {64, 64};
  return hg::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, 2, d, s, b);
}
// w [E, K, N] in boxes of 64 columns x 64 K-rows of one expert: bf16 with
// 128-byte swizzle (the MN-major B box), or 1-byte payloads (bytes 1)
// unswizzled, 64-byte rows, for a dequantizing producer
inline bool fh_map_w(CUtensorMap* map, const void* p, int E, int K, int N,
                     int bytes = 2) {
  const cuuint64_t d[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t s[2] = {(cuuint64_t)N * bytes,
                           (cuuint64_t)K * N * bytes};
  const cuuint32_t b[3] = {64, hg::BK, 1};
  if (bytes == 1)
    return hg::make_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, p, 3, d, s, b,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  return hg::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, 3, d, s, b);
}

}  // namespace fm
