// Two-pass expert-tiled MoE gate, for E beyond the single-tile gate.
//
// fm_gate_pass1 replaces the TPU kernel
// flashmoe_tpu/ops/gate.py:_gate_pass1_kernel (launched by
// router_pallas_tiled).  Same function: per token, f32 logits x . gate_w
// taken one expert tile at a time, an online (max, sum of exp) with
// rescale, and a top-k by logit carried from tile to tile (on equal
// logits the lower expert id wins); the logits go to device memory only
// when the statistics pass will read them.  It writes m, se, the top-k ids
// and their probabilities exp(logit - m) / max(se, 1e-30) (the TPU code
// formed the last outside its kernel).
//
// fm_gate_pass2 replaces flashmoe_tpu/ops/gate.py:_gate_pass2_kernel: from
// the spilled logits and the final (m, se), per expert the sum over tokens
// of the probabilities and the selection count, and the sum over tokens of
// lse^2 (once per token).
//
// What bounds them on an H100: pass 1 at S 8192, H 2048, E 512 in bf16 is
// 17 GFLOP over 36 MB of inputs and 17 MB of spilled logits, so the tensor
// cores and the bytes take about as long (~17 us each); each 64-token
// tile also reads all of gate_w (2.1 MB) again from L2, about 270 MB a
// call.  Pass 2 reads the logits once and is bound by bytes.
//
// Pass 1, bf16 (gate_pass1_hopper, on hopper_gemm.cuh's TMA + wgmma
// pieces): a persistent grid walks 64-token tiles; a work item is one
// tile against all experts, so (m, se) and the carried top-k never leave
// the block, as on the TPU (expert tiles inner).  A producer warpgroup
// keeps a ring of stages filled by TMA: the tile's x box (64 rows x 64 of
// H, K-major, rows past S zero-filled) and the expert tile's gate_w boxes
// ([H, E] row-major read in place as wgmma's MN-major B, 64 columns a
// box, boxes wholly past E not loaded).  Two consumer warpgroups share
// the x box and split each 256-expert tile's columns, 128 each
// (m64n128k16), so one token tile fills one block and S 8192 about one
// wave of the card.  Each holds its 64 x 128 f32 logits in registers
// (hopper_gemm.cuh's accumulator layout: a row's columns lie in the four
// threads of a quad) and, per tile:
//   * spills them when asked, through two swizzled staging boxes and TMA
//     stores that drain under the next tile's products (store_f32), or,
//     when E % 4 != 0 (the map's 16-byte row stride), from the fragments;
//   * updates its running (m, se) per row: the tile's max and sum of
//     exp by quad shuffles (every thread of the quad gets the same bits),
//     the running sum rescaled as _gate_pass1_kernel does;
//   * carries its own top-k per row (values and ids in shared memory):
//     selection rounds across the quad, each taking the largest logit
//     ranked below the last one taken (value, then lower id) and above
//     the row's K-th entry, so that after the first tile most values are
//     pruned; a round whose quads all find nothing ends the tile.  Rows
//     past S take no part.  A warpgroup's columns only grow from tile to
//     tile, so an entry is inserted past every equal one already kept.
// After the last tile the two warpgroups' (m, se) merge in a fixed order
// (warpgroup 0, then 1) and their lists merge by (value, lower id); one
// thread a row writes m, se, top_p and top_i.  The K order (wgmma over H
// in steps of 64, in order), the expert tiles and the column split follow
// H and E alone, so a token's outputs are the same bits in any batch.
// Every barrier wait is mbar_wait<false> (a trap, no message): a printf
// anywhere in the kernel makes ptxas serialize every wgmma (C7510).  On
// an H100 at S 8192, E 512, K 10 the selection rounds take about 40 % of
// pass 1 and the spill 15 % (chip_ablate.py, cuts b4_notopk,
// b4_nospill); the other column split, 256 columns of 512-expert tiles a
// warpgroup with 2 stages of 72 KB, ran 1.5x slower (cut b4_wide), and
// the spill from the fragments 1.1x slower than through TMA (cut
// b4_spill_direct).
//
// An armed logit bias (bias_e >= 0, the skewed_routing chaos point; B1
// takes the same operand, gate.cu) is added to column bias_e of the f32
// logits before the spill, the online (m, se) and the selection rounds, so
// pass 2 reads the biased logits.  An armed launch also keeps the router's
// rule for subnormal probabilities (router_plain, gate.cu): a selected
// probability below the smallest normal f32 is 0, and those zeros go to
// the lowest expert ids among the ones whose probability is below it.
// The list holds every expert of normal probability when it has fewer
// than K of them, and the lowest ids below it lie among experts 0..K-1,
// so the launch keeps the first K logits of each token ([S, K] in
// `head`) and reads them back once (m, se) are final.  Unarmed, neither
// step runs and the outputs are the same bits as without the operand.
//
// Pass 1, f32: one block of 128 threads per 64-token tile on
// gemm_tile.cuh's SIMT tile (TF32 would miss the f32 tolerance), looping
// over 64-wide expert tiles; the carried top-k in shared memory, where
// one thread a row inserts the tile's logits in expert order.
//
// Pass 2 (gate_pass2): blocks of [64 tokens x 128 experts] panels of the
// logits, read with 16-byte loads where E % 4 == 0; each forms
// exp(l - m) / max(se, 1e-30) with its tokens' pass-1 (m, se), adds its
// rows in a fixed order and writes its panel's partial sums; the counts
// come from the ids by an integer histogram in shared memory; the
// token-panel blocks of the first expert chunk also write the panel's
// sum of lse^2.  The last block of an expert chunk to finish (a ticket)
// adds the chunk's partials in a fixed order (each half of the panels in
// panel order, then the two halves; the z terms lane-strided, then a
// fixed shuffle tree), so the final reduction is spread over the chunks'
// blocks: no float atomics, repeated calls equal bit for bit, counts
// exact.
#include <cfloat>
#include <climits>
#include <cmath>

#include "gemm_tile.cuh"
#include "hopper_gemm.cuh"

namespace fm {

constexpr int TILED_KMAX = 64;  // the merge of 2K candidates, 2K <= 128

// ---- pass 1, f32: the SIMT tile ---------------------------------------

constexpr int P1_ROWS = FBM;   // tokens per pass-1 block

// An armed launch's zeros: from entry kk of a token's list on, the lowest
// expert ids whose probability exp(l - m) / den lies below the smallest
// normal f32, from the token's first K logits hd, each with probability
// 0.  Entries 0..kk-1 hold every expert of normal probability, so K - kk
// such ids lie among experts 0..K-1.
__device__ __forceinline__ void g1_zeros(const float* hd, float m, float den,
                                         int K, int kk, float* p, int* ids) {
  for (int j = 0; j < K && kk < K; ++j)
    if (expf(hd[j] - m) / den < FLT_MIN) {
      p[kk] = 0.f;
      ids[kk++] = j;
    }
}

__global__ void __launch_bounds__(FTHREADS)
gate_pass1_simt(const float* __restrict__ x, const float* __restrict__ w,
                int S, int H, int E, int PX, int K, int bias_e, float bias,
                float* __restrict__ head, float* __restrict__ logits,
                float* __restrict__ m_out, float* __restrict__ se_out,
                float* __restrict__ top_p, int* __restrict__ top_i) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Cs = reinterpret_cast<float*>(smem);  // GEMM operands, then logits
  float* tv = reinterpret_cast<float*>(smem + FFN_SMEM);  // [64][K]
  int* ti = reinterpret_cast<int*>(tv + P1_ROWS * K);     // [64][K]
  constexpr int LDC = FfnTile<float>::LDC;

  const int tid = threadIdx.x;
  const int r = tid >> 1, half = tid & 1;  // two threads a token row
  const int s0 = blockIdx.x * P1_ROWS;
  float* v = tv + r * K;
  int* id = ti + r * K;
  float m_run = -1e30f, se_run = 0.f;  // the TPU kernel's initial values
  int n = 0;  // filled entries of the row's top-k (thread half == 0)

  for (int e0 = 0; e0 < E; e0 += FBN) {
    const float* B[1] = {w + e0};
    ffn_mainloop<1, false>(x + (size_t)s0 * H, H, B, PX, Cs);
    __syncthreads();
    const int ne = min(FBN, E - e0);  // columns past E are padding
    if (bias_e >= e0 && bias_e < e0 + ne) {  // the same in the whole block
      if (tid < P1_ROWS) Cs[tid * LDC + bias_e - e0] += bias;
      __syncthreads();
    }
    if (logits != nullptr)
      for (int i = tid; i < P1_ROWS * FBN; i += FTHREADS) {
        const int rr = i / FBN, c = i % FBN;
        if (c < ne && s0 + rr < S)
          logits[(size_t)(s0 + rr) * E + e0 + c] = Cs[rr * LDC + c];
      }
    const float* row = Cs + r * LDC;
    if (head != nullptr && e0 == 0 && half == 0 && s0 + r < S)
      for (int c = 0; c < K; ++c) head[(size_t)(s0 + r) * K + c] = row[c];
    const int c0 = half * (FBN / 2), c1 = min(c0 + FBN / 2, ne);
    float mt = -1e30f;
    for (int c = c0; c < c1; ++c) mt = fmaxf(mt, row[c]);
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    const float m_new = fmaxf(m_run, mt);
    float part = 0.f;
    for (int c = c0; c < c1; ++c) part += expf(row[c] - m_new);
    part += __shfl_xor_sync(0xffffffffu, part, 1);  // a + b == b + a
    se_run = se_run * expf(m_run - m_new) + part;
    m_run = m_new;
    if (half == 0) {
      for (int c = 0; c < ne; ++c) {
        const float val = row[c];
        if (n == K && !(val > v[K - 1])) continue;
        int j = (n < K) ? n++ : K - 1;
        for (; j > 0 && val > v[j - 1]; --j) {
          v[j] = v[j - 1];
          id[j] = id[j - 1];
        }
        v[j] = val;
        id[j] = e0 + c;
      }
    }
    __syncthreads();  // the next tile's operands overwrite Cs
  }
  const int s = s0 + r;
  if (half == 0 && s < S) {
    m_out[s] = m_run;
    se_out[s] = se_run;
    const float den = fmaxf(se_run, 1e-30f);
    int kk = 0;
    for (; kk < K; ++kk) {
      const float p = expf(v[kk] - m_run) / den;
      if (head != nullptr && p < FLT_MIN) break;
      top_p[(size_t)s * K + kk] = p;
      top_i[(size_t)s * K + kk] = id[kk];
    }
    if (kk < K) g1_zeros(head + (size_t)s * K, m_run, den, K, kk,
                         top_p + (size_t)s * K, top_i + (size_t)s * K);
  }
}

int pass1_simt_launch(const void* x, const void* w, int S, int H, int E,
                      int PX, int K, int bias_e, float bias, float* head,
                      float* logits, float* m, float* se, float* top_p,
                      int* top_i, cudaStream_t stream) {
  const int bytes = FFN_SMEM + 2 * P1_ROWS * K * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gate_pass1_simt, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int nb = (S + P1_ROWS - 1) / P1_ROWS;
  gate_pass1_simt<<<nb, FTHREADS, bytes, stream>>>(
      (const float*)x, (const float*)w, S, H, E, PX, K, bias_e, bias, head,
      logits, m, se, top_p, top_i);
  return (int)cudaGetLastError();
}

// ---- pass 1, bf16: TMA + wgmma ----------------------------------------

constexpr int G1_ET = 256;                 // experts of one expert tile
constexpr int G1_CONSUMERS = 2;            // warpgroups splitting its columns
constexpr int G1_COLS = G1_ET / G1_CONSUMERS;  // a warpgroup's columns
constexpr int G1_THREADS = 128 * (G1_CONSUMERS + 1);
constexpr int G1_ROWS = hg::WG_ROWS;       // tokens of a work item
constexpr int G1_BAR = 1 + G1_CONSUMERS;   // named barrier of both consumers
constexpr uint64_t G1_LIMIT = 5000000000ull;

// The block's shared memory: the ring, the staging boxes of the spill,
// the two warpgroups' final (m, se) and list lengths; the lists, [2][64][K]
// values then [2][64][K] ids, follow it.
template <int STAGES> struct G1Smem {
  bf16 a[STAGES][hg::A_TILE];          // x: 64 rows x 64 of H
  bf16 b[STAGES][G1_ET * hg::BK];      // gate_w: G1_ET / 64 boxes
  float out[G1_CONSUMERS][2][hg::WG_ROWS * hg::F32_BOX];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
  float m[G1_CONSUMERS][G1_ROWS];
  float se[G1_CONSUMERS][G1_ROWS];
  int n[G1_CONSUMERS][G1_ROWS];
};

template <int STAGES> constexpr size_t g1_smem(int K) {
  return hg::smem_bytes<G1Smem<STAGES>>() +
         (size_t)2 * G1_CONSUMERS * G1_ROWS * K * 4;
}

// (v, i) ranks above (bv, bi): the larger logit, then the lower id
__device__ __forceinline__ bool g1_above(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The producer: thread 0 loads each stage of each item's expert tiles,
// the x box and the tile's gate_w boxes that hold a column below E.
template <int STAGES>
__device__ __forceinline__ void g1_produce(G1Smem<STAGES>& sm,
                                           const CUtensorMap* tx,
                                           const CUtensorMap* tw, int tiles,
                                           int H, int E) {
  const int nk = (H + hg::BK - 1) / hg::BK;
  hg::RingPos pos;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    for (int e0 = 0; e0 < E; e0 += G1_ET) {
      const int boxes = (min(G1_ET, E - e0) + 63) / 64;
      const uint32_t bytes =
          (uint32_t)(hg::A_TILE + boxes * 64 * hg::BK) * sizeof(bf16);
      for (int kb = 0; kb < nk; ++kb) {
        hg::mbar_wait<false>(&sm.empty[pos.stage], pos.phase ^ 1);
        uint64_t* full = &sm.full[pos.stage];
        hg::mbar_expect_tx(full, bytes);
        hg::tma_load_2d(sm.a[pos.stage], tx, full, kb * hg::BK,
                        t * G1_ROWS);
        for (int j = 0; j < boxes; ++j)
          hg::tma_load_2d(sm.b[pos.stage] + 64 * j * hg::BK, tw, full,
                          e0 + 64 * j, kb * hg::BK);
        pos.next<STAGES>();
      }
    }
}

// A consumer warpgroup's products over one expert tile: its 64 x 128
// logits in d (zeroed first); each stage released one wgmma group behind.
template <int STAGES>
__device__ __forceinline__ void g1_products(G1Smem<STAGES>& sm,
                                            hg::RingPos& pos, int nk, int wg,
                                            int tid, float (&d)[G1_COLS / 2]) {
#pragma unroll
  for (int i = 0; i < G1_COLS / 2; ++i) d[i] = 0.f;
  int prev = -1;
  for (int kb = 0; kb < nk; ++kb) {
    hg::mbar_wait<false>(&sm.full[pos.stage], pos.phase, G1_LIMIT);
    hg::wgmma_fence();
    hg::wgmma_stage_mn<G1_COLS>(d, sm.a[pos.stage],
                                sm.b[pos.stage] + wg * G1_COLS * hg::BK);
    hg::wgmma_commit();
    hg::wgmma_wait<1>();
    if (prev >= 0 && tid == 0) hg::mbar_arrive(&sm.empty[prev]);
    prev = pos.stage;
    pos.next<STAGES>();
  }
  hg::wgmma_wait<0>();
  hg::fence_acc(d);
  if (tid == 0) hg::mbar_arrive(&sm.empty[prev]);
}

// A warpgroup whose columns of an expert tile all lie past E: wait out
// each stage and release it, keeping the ring in step.
template <int STAGES>
__device__ __forceinline__ void g1_skip(G1Smem<STAGES>& sm, hg::RingPos& pos,
                                        int nk, int wg, int tid) {
  for (int kb = 0; kb < nk; ++kb) {
    hg::mbar_wait<false>(&sm.full[pos.stage], pos.phase, G1_LIMIT);
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg));
    if (tid == 0) hg::mbar_arrive(&sm.empty[pos.stage]);
    pos.next<STAGES>();
  }
}

// a selection round scans a thread's 32 logits of a row in this many
// independent chains: a round's latency, not its instructions, bounds it
constexpr int G1_SCAN = 4;

// One expert tile's epilogue for the thread's two rows (h 0: row r, h 1:
// row r + 8 of the tile): the running (m, se), then the selection rounds
// into the warpgroup's lists lv / li (the rows' K entries, n filled, thr
// the K-th, -inf while the list fills, +inf for a row past S, which so
// takes no entry).  c0 is the thread's first column (the tile's column 2
// (lane % 4)); its columns are c0 + 8 j + {0, 1}.  FULL: every column
// lies below E.  Every shuffle runs in all lanes: rows of one warp differ
// in n and thr.
template <bool FULL>
__device__ __forceinline__ void g1_tile(const float (&d)[G1_COLS / 2],
                                        int c0, int E, int K,
                                        float (&m_run)[2], float (&se_run)[2],
                                        int (&n)[2], float (&thr)[2],
                                        float* lv0, int* li0, float* lv1,
                                        int* li1, int lane) {
  auto ok = [&](int h, int j, int i) {
    return FULL || c0 + 8 * j + i < E;
  };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < G1_COLS / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (ok(h, j, i)) mt = fmaxf(mt, d[4 * j + 2 * h + i]);
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m_run[h], mt);
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < G1_COLS / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (ok(h, j, i)) part += expf(d[4 * j + 2 * h + i] - m_new);
    part += __shfl_xor_sync(0xffffffffu, part, 1);  // a + b == b + a
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    se_run[h] = se_run[h] * expf(m_run[h] - m_new) + part;
    m_run[h] = m_new;
  }
  // selection rounds: the quad's largest logit ranked below the last one
  // taken (pv, pi) and above the row's K-th entry thr
  float pv[2] = {INFINITY, INFINITY};
  int pi[2] = {-1, -1};
  for (;;) {
    float bv[2];
    int bi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // G1_SCAN independent chains (columns j % G1_SCAN), then merged
      float sv[G1_SCAN];
      int si[G1_SCAN];
#pragma unroll
      for (int a = 0; a < G1_SCAN; ++a) {
        sv[a] = -INFINITY;
        si[a] = INT_MAX;
      }
#pragma unroll
      for (int j = 0; j < G1_COLS / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float v = d[4 * j + 2 * h + i];
          const int c = c0 + 8 * j + i;
          const int a = j % G1_SCAN;
          // a chain's columns grow: an equal later value never wins
          if (ok(h, j, i) && v > thr[h] && v > sv[a] &&
              (v < pv[h] || (v == pv[h] && c > pi[h]))) {
            sv[a] = v;
            si[a] = c;
          }
        }
#pragma unroll
      for (int w = 1; w < G1_SCAN; w <<= 1)
#pragma unroll
        for (int a = 0; a + w < G1_SCAN; a += 2 * w)
          if (g1_above(sv[a + w], si[a + w], sv[a], si[a])) {
            sv[a] = sv[a + w];
            si[a] = si[a + w];
          }
      bv[h] = sv[0];
      bi[h] = si[0];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv[h], off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi[h], off);
        if (g1_above(ov, oi, bv[h], bi[h])) {
          bv[h] = ov;
          bi[h] = oi;
        }
      }
    }
    if (!__any_sync(0xffffffffu, bi[0] != INT_MAX || bi[1] != INT_MAX))
      break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (bi[h] == INT_MAX) continue;
      float* lv = h ? lv1 : lv0;
      int* li = h ? li1 : li0;
      if (lane % 4 == 0) {  // the quad's first thread inserts
        int j = n[h] < K ? n[h] : K - 1;
        for (; j > 0 && g1_above(bv[h], bi[h], lv[j - 1], li[j - 1]); --j) {
          lv[j] = lv[j - 1];
          li[j] = li[j - 1];
        }
        lv[j] = bv[h];
        li[j] = bi[h];
      }
      n[h] = min(n[h] + 1, K);
      pv[h] = bv[h];
      pi[h] = bi[h];
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (n[h] == K) thr[h] = (h ? lv1 : lv0)[K - 1];
    __syncwarp();
  }
}

// The two warpgroups' results of one item merged, one thread a row: m and
// se in a fixed order, the lists by (value, lower id); then m, se, top_p
// and top_i of the rows below S.
template <int STAGES>
__device__ __forceinline__ void g1_merge(const G1Smem<STAGES>& sm,
                                         const float* lv, const int* li,
                                         int row, int s, int K,
                                         const float* head,
                                         float* __restrict__ m_out,
                                         float* __restrict__ se_out,
                                         float* __restrict__ top_p,
                                         int* __restrict__ top_i) {
  const float m0 = sm.m[0][row], m1 = sm.m[1][row];
  const float m = fmaxf(m0, m1);
  const float se =
      sm.se[0][row] * expf(m0 - m) + sm.se[1][row] * expf(m1 - m);
  m_out[s] = m;
  se_out[s] = se;
  const float den = fmaxf(se, 1e-30f);
  const float* v0 = lv + (size_t)row * K;
  const float* v1 = lv + (size_t)(G1_ROWS + row) * K;
  const int* i0 = li + (size_t)row * K;
  const int* i1 = li + (size_t)(G1_ROWS + row) * K;
  const int n0 = sm.n[0][row], n1 = sm.n[1][row];
  int a = 0, b = 0, kk = 0;
  for (; kk < K; ++kk) {
    const bool first = b >= n1 || (a < n0 && g1_above(v0[a], i0[a], v1[b],
                                                       i1[b]));
    const float v = first ? v0[a] : v1[b];
    const float p = expf(v - m) / den;
    if (head != nullptr && p < FLT_MIN) break;  // the rest are below too
    const int id = first ? i0[a++] : i1[b++];
    top_p[(size_t)s * K + kk] = p;
    top_i[(size_t)s * K + kk] = id;
  }
  if (kk < K) g1_zeros(head + (size_t)s * K, m, den, K, kk,
                       top_p + (size_t)s * K, top_i + (size_t)s * K);
}

template <int STAGES>
__global__ void __launch_bounds__(G1_THREADS, 1)
gate_pass1_hopper(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap tl, int S, int H,
                  int E, int K, int bias_e, float bias,
                  float* __restrict__ head, float* __restrict__ logits,
                  int spill_tma,
                  float* __restrict__ m_out, float* __restrict__ se_out,
                  float* __restrict__ top_p, int* __restrict__ top_i) {
  extern __shared__ unsigned char g1_raw[];
  G1Smem<STAGES>& sm = hg::smem_at<G1Smem<STAGES>>(g1_raw);
  float* lv = reinterpret_cast<float*>(&sm + 1);  // [2][64][K]
  int* li = reinterpret_cast<int*>(lv + G1_CONSUMERS * G1_ROWS * K);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int tiles = (S + G1_ROWS - 1) / G1_ROWS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hg::mbar_init(&sm.full[s], 1);
      hg::mbar_init(&sm.empty[s], G1_CONSUMERS);
    }
    hg::mbar_fence_init();
  }
  __syncthreads();

  if (wg == G1_CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) g1_produce<STAGES>(sm, &tx, &tw, tiles, H, E);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int nk = (H + hg::BK - 1) / hg::BK;
  const int lane = tid % 32;
  const int r = tid / 32 * 16 + lane / 4;  // the thread's first row
  float* lv0 = lv + (size_t)(wg * G1_ROWS + r) * K;
  int* li0 = li + (size_t)(wg * G1_ROWS + r) * K;
  float* lv1 = lv0 + (size_t)8 * K;
  int* li1 = li0 + (size_t)8 * K;
  hg::RingPos pos;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * G1_ROWS;
    float m_run[2] = {-1e30f, -1e30f}, se_run[2] = {0.f, 0.f};
    float thr[2] = {row0 + r < S ? -INFINITY : INFINITY,
                    row0 + r + 8 < S ? -INFINITY : INFINITY};
    int n[2] = {0, 0};
    for (int e0 = 0; e0 < E; e0 += G1_ET) {
      const int n0 = e0 + wg * G1_COLS;  // the warpgroup's first column
      if (n0 >= E) {
        g1_skip<STAGES>(sm, pos, nk, wg, tid);
        continue;
      }
      float d[G1_COLS / 2];
      g1_products<STAGES>(sm, pos, nk, wg, tid, d);
      // the armed bias on column bias_e, held by the threads whose
      // fragments map to it (d[4 j + 2 h + i]: row r + 8 h, column n0 + 8 j
      // + 2 (lane % 4) + i, the map the spill's staging boxes use)
      if (bias_e >= n0 && bias_e < n0 + G1_COLS) {
#pragma unroll
        for (int j = 0; j < G1_COLS / 8; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (n0 + 8 * j + 2 * (lane % 4) + q % 2 == bias_e)
              d[4 * j + q] += bias;
      }
      // an armed launch keeps each token's first K logits (K <= 64: all in
      // warpgroup 0's columns of the first expert tile)
      if (head != nullptr && n0 == 0) {
#pragma unroll
        for (int j = 0; j < G1_COLS / 8; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = 8 * j + 2 * (lane % 4) + q % 2;
            const int s = row0 + r + 8 * (q / 2);
            if (c < K && s < S) head[(size_t)s * K + c] = d[4 * j + q];
          }
      }
      if (logits != nullptr) {
        if (spill_tma) {
          hg::store_f32<G1_COLS>(d, sm.out[wg][0], sm.out[wg][1], &tl, row0,
                                 n0, E, wg, tid);
        } else {  // E % 4 != 0: no TMA map of the logits
#pragma unroll
          for (int j = 0; j < G1_COLS / 8; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int c = n0 + 8 * j + 2 * (lane % 4) + q % 2;
              const int s = row0 + r + 8 * (q / 2);
              if (c < E && s < S) logits[(size_t)s * E + c] = d[4 * j + q];
            }
        }
      }
      const int c0 = n0 + 2 * (lane % 4);
      if (n0 + G1_COLS <= E)
        g1_tile<true>(d, c0, E, K, m_run, se_run, n, thr, lv0, li0, lv1,
                      li1, lane);
      else
        g1_tile<false>(d, c0, E, K, m_run, se_run, n, thr, lv0, li0, lv1,
                       li1, lane);
    }
    if (lane % 4 == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sm.m[wg][r + 8 * h] = m_run[h];
        sm.se[wg][r + 8 * h] = se_run[h];
        sm.n[wg][r + 8 * h] = n[h];
      }
    asm volatile("bar.sync %0, %1;\n" ::"r"(G1_BAR), "n"(128 * G1_CONSUMERS));
    const int ct = wg * 128 + tid;  // one thread a row
    if (ct < G1_ROWS && row0 + ct < S)
      g1_merge<STAGES>(sm, lv, li, ct, row0 + ct, K, head, m_out, se_out,
                       top_p, top_i);
    // the lists are read before the next item writes them
    asm volatile("bar.sync %0, %1;\n" ::"r"(G1_BAR), "n"(128 * G1_CONSUMERS));
  }
  if (tid == 0) hg::bulk_wait<0>();  // the spill has left shared memory
}

template <int STAGES>
int pass1_hopper_launch(const void* x, const void* w, int S, int H, int E,
                        int PX, int K, int bias_e, float bias, float* head,
                        float* logits, float* m, float* se, float* top_p,
                        int* top_i, cudaStream_t stream) {
  CUtensorMap tx, tw, tl;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t xd[2] = {(cuuint64_t)H, (cuuint64_t)S};
  const cuuint64_t xs[1] = {(cuuint64_t)H * sizeof(bf16)};
  const cuuint64_t wd[2] = {(cuuint64_t)PX, (cuuint64_t)H};
  const cuuint64_t ws[1] = {(cuuint64_t)PX * sizeof(bf16)};
  const cuuint32_t box[2] = {64, 64};
  if (!hg::make_map(&tx, bf, x, 2, xd, xs, box) ||
      !hg::make_map(&tw, bf, w, 2, wd, ws, box))
    return (int)cudaErrorInvalidValue;
  // the spilled logits [S, E] f32 by TMA where rows are 16-byte multiples
  const int spill_tma = logits != nullptr && E % 4 == 0;
  if (spill_tma) {
    const cuuint64_t ld[2] = {(cuuint64_t)E, (cuuint64_t)S};
    const cuuint64_t ls[1] = {(cuuint64_t)E * sizeof(float)};
    const cuuint32_t lb[2] = {hg::F32_BOX, hg::WG_ROWS};
    if (!hg::make_map(&tl, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, logits, 2, ld,
                      ls, lb))
      return (int)cudaErrorInvalidValue;
  } else {
    tl = tx;  // unused
  }
  const size_t smem = g1_smem<STAGES>(K);
  cudaError_t err = cudaFuncSetAttribute(
      gate_pass1_hopper<STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (S + G1_ROWS - 1) / G1_ROWS;
  gate_pass1_hopper<STAGES><<<min(tiles, sms), G1_THREADS, smem, stream>>>(
      tx, tw, tl, S, H, E, K, bias_e, bias, head, logits, spill_tma, m, se,
      top_p, top_i);
  return (int)cudaGetLastError();
}

// ---- pass 2 -------------------------------------------------------------

constexpr int P2_ROWS = 64;     // tokens of a panel
constexpr int P2_COLS = 128;    // experts of a chunk
constexpr int P2_THREADS = 256;
constexpr int P2_WARPS = P2_THREADS / 32;

template <bool VEC>
__global__ void __launch_bounds__(P2_THREADS)
gate_pass2(const float* __restrict__ logits, const float* __restrict__ m,
           const float* __restrict__ se, const int* __restrict__ top_i,
           int S, int E, int K, float* __restrict__ part_probs,
           int* __restrict__ part_cnt, float* __restrict__ part_z,
           unsigned* __restrict__ tickets, float* __restrict__ probs_sum,
           int* __restrict__ counts, float* __restrict__ zsum) {
  __shared__ float ms[P2_ROWS], den[P2_ROWS];
  __shared__ float red[P2_WARPS][P2_COLS];
  __shared__ int hist[P2_COLS];
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int chunk = blockIdx.x, panel = blockIdx.y;
  const int panels = gridDim.y;
  const int c0 = chunk * P2_COLS, s0 = panel * P2_ROWS;
  const int nvalid = min(P2_ROWS, S - s0);
  for (int i = tid; i < P2_ROWS; i += P2_THREADS) {
    ms[i] = i < nvalid ? m[s0 + i] : 0.f;
    den[i] = i < nvalid ? fmaxf(se[s0 + i], 1e-30f) : 1.f;
  }
  for (int i = tid; i < P2_COLS; i += P2_THREADS) hist[i] = 0;
  __syncthreads();

  // the thread's four columns: 4 lane.. (VEC) or lane + 32 q
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int rr = warp; rr < nvalid; rr += P2_WARPS) {
    const float* row = logits + (size_t)(s0 + rr) * E + c0;
    float v[4];
    if (VEC) {
      if (c0 + 4 * lane < E) {  // E % 4 == 0: all four or none
        const float4 q = __ldg(reinterpret_cast<const float4*>(row) + lane);
        v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4)
          acc[q4] += expf(v[q4] - ms[rr]) / den[rr];
      }
    } else {
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4)
        if (c0 + lane + 32 * q4 < E)
          acc[q4] += expf(__ldg(row + lane + 32 * q4) - ms[rr]) / den[rr];
    }
  }
#pragma unroll
  for (int q4 = 0; q4 < 4; ++q4)
    red[warp][VEC ? 4 * lane + q4 : lane + 32 * q4] = acc[q4];
  // the selection counts of the panel's tokens in this chunk
  for (int i = tid; i < nvalid * K; i += P2_THREADS) {
    const int e = __ldg(top_i + (size_t)s0 * K + i) - c0;
    if (e >= 0 && e < P2_COLS) atomicAdd(&hist[e], 1);
  }
  __syncthreads();
  if (tid < P2_COLS && c0 + tid < E) {
    float p = 0.f;
    for (int q = 0; q < P2_WARPS; ++q) p += red[q][tid];  // warp order
    part_probs[(size_t)panel * E + c0 + tid] = p;
    part_cnt[(size_t)panel * E + c0 + tid] = hist[tid];
  }
  if (chunk == 0 && warp == P2_WARPS - 1) {  // the z-loss term once a token
    float z = 0.f;
    for (int i = lane; i < nvalid; i += 32) {
      const float lse = ms[i] + logf(den[i]);
      z += lse * lse;
    }
    z = warp_sum(z);  // every lane gets the same bits
    if (lane == 0) part_z[panel] = z;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(&tickets[chunk], 1u) == (unsigned)(panels - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid == 0) tickets[chunk] = 0;

  // the chunk's last block: the panels' partials added in panel order
  // (two threads a column, the halves of the panels, then lo + hi)
  const int col = tid % P2_COLS, half = tid / P2_COLS;
  const int b0 = half ? panels / 2 : 0, b1 = half ? panels : panels / 2;
  float p = 0.f;
  int c = 0;
  if (c0 + col < E)
    for (int b = b0; b < b1; ++b) {
      p += __ldcg(part_probs + (size_t)b * E + c0 + col);
      c += __ldcg(part_cnt + (size_t)b * E + c0 + col);
    }
  float* lo = red[0];
  int* clo = hist;
  __syncthreads();  // red and hist are free
  if (half == 0) {
    lo[col] = p;
    clo[col] = c;
  }
  __syncthreads();
  if (half == 1 && c0 + col < E) {
    probs_sum[c0 + col] = lo[col] + p;
    counts[c0 + col] = clo[col] + c;
  }
  if (chunk == 0 && warp == 0) {
    float z = 0.f;
    for (int b = lane; b < panels; b += 32) z += __ldcg(part_z + b);
    z = warp_sum(z);
    if (lane == 0) *zsum = z;
  }
}

}  // namespace fm

// x [S, H]; w [H, PX].  bf16: PX >= E with PX % 8 == 0 (the map's
// 16-byte row stride; columns past E are ignored), x read in place; f32:
// x [ceil(S / 64) * 64, H] (rows past S are read, never reported) and PX a
// multiple of 64.  H % 64 == 0, 1 <= K <= min(E, 64).  bias_e: the expert
// whose logit gets `bias` (-1: none); an armed launch (bias_e >= 0) takes
// head, f32 scratch [S, K], and keeps the router's rule for subnormal
// probabilities.  Outputs: logits f32 [S, E] (null: not written), m and se
// f32 [S], top_p f32 [S, K], top_i i32 [S, K].
extern "C" int fm_gate_pass1(int is_bf16, const void* x, const void* w,
                             int S, int H, int E, int PX, int K, int bias_e,
                             float bias, float* head, float* logits,
                             float* m, float* se, float* top_p, int* top_i,
                             cudaStream_t stream) {
  if (K < 1 || K > fm::TILED_KMAX || K > E || bias_e >= E ||
      (bias_e >= 0) != (head != nullptr))
    return (int)cudaErrorInvalidValue;
  if (!is_bf16)
    return fm::pass1_simt_launch(x, w, S, H, E, PX, K, bias_e, bias, head,
                                 logits, m, se, top_p, top_i, stream);
  if (PX < E || PX % 8) return (int)cudaErrorInvalidValue;
  // a ring of 4 stages leaves room for lists of K <= 32, 3 for K <= 64
  if (K <= 32)
    return fm::pass1_hopper_launch<4>(x, w, S, H, E, PX, K, bias_e, bias,
                                      head, logits, m, se, top_p, top_i,
                                      stream);
  return fm::pass1_hopper_launch<3>(x, w, S, H, E, PX, K, bias_e, bias, head,
                                    logits, m, se, top_p, top_i, stream);
}

// logits f32 [S, E], m and se f32 [S], top_i i32 [S, K] (K <= 64).
// Scratch: part_probs f32 [nb, E], part_cnt i32 [nb, E], part_z f32 [nb]
// with nb = ceil(S / 64); tickets u32 [ceil(E / 128)], zero on entry and
// left zero (launches that share them run in stream order).  Outputs:
// probs_sum f32 [E], counts i32 [E], zsum f32 [].
extern "C" int fm_gate_pass2(const float* logits, const float* m,
                             const float* se, const int* top_i, int S, int E,
                             int K, float* part_probs, int* part_cnt,
                             float* part_z, unsigned* tickets,
                             float* probs_sum, int* counts, float* zsum,
                             cudaStream_t stream) {
  if (K < 1 || K > fm::TILED_KMAX || S < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((E + fm::P2_COLS - 1) / fm::P2_COLS,
                  (S + fm::P2_ROWS - 1) / fm::P2_ROWS);
  if (E % 4 == 0)
    fm::gate_pass2<true><<<grid, fm::P2_THREADS, 0, stream>>>(
        logits, m, se, top_i, S, E, K, part_probs, part_cnt, part_z, tickets,
        probs_sum, counts, zsum);
  else
    fm::gate_pass2<false><<<grid, fm::P2_THREADS, 0, stream>>>(
        logits, m, se, top_i, S, E, K, part_probs, part_cnt, part_z, tickets,
        probs_sum, counts, zsum);
  return (int)cudaGetLastError();
}
