// The fused expert-parallel MoE layer: dispatch -> expert FFN -> return in
// one persistent kernel, for every rank of an ep world.
//
// fm_fused_ep replaces the TPU kernel flashmoe_tpu/parallel/fused.py:115
// (_fused_kernel, launched by _fused_shard at :1674), FlashDMoE's single
// kernel.  Same function, for each rank r of D:
//   phase 0  a barrier: r signals every peer, then waits for D-1 signals;
//   phase 1  every occupied 64-row tile of x_send[r][dst][e] (the first
//            send_cnt rows) is stored into peer dst's x_recv[r][e], then a
//            flag of (r, e, tile) is raised in dst's heap; the own slab is
//            the same store into r's own heap;
//   phase 2  B2's FFN on every arrived tile (up GEMM, gate GEMM when
//            gated, f32 bias and activation, the hidden rounded to the
//            input dtype, down GEMM with f32 accumulation, f32 down bias,
//            rounded), as tasks in the order the host built from
//            src_order and the schedule.  A task is an item of up to two
//            64-row tiles of one local expert (from one source or two)
//            against one column tile: FH_COLS / NB hidden columns for an
//            up task (128 gated, 256 otherwise), 256 output columns for a
//            down task.  An up task waits for its tiles' dispatch flags,
//            writes their hidden columns to the rank's scratch and raises
//            one up flag per (tile, column tile); a down task waits for
//            every up flag of its tiles, stores its columns of each tile's
//            populated rows into the tile's source, at y_back[r][e]
//            (combine off) or at their token-sorted rows
//            recv_pos[r][src][e][slot] of its return buffer (combine on),
//            then raises the source's return flag of (r, e, tile, column
//            tile);
//   phase 3  wait for every return of a tile r sent; with the combine,
//            out[r][t] = sum_j w[t*k+j] * y_sorted[t*k+j] in f32 over the
//            nonzero weights.
// Rows past a count are never sent; in the outputs they are unspecified.
//
// Quantized expert stores (B5q, the int8/e4m3 arm of the rowwin schedule,
// _fused_kernel's dequantization at flashmoe_tpu/parallel/fused.py:638-653):
// with Q = int8_t or __nv_fp8_e4m3 the weights are 1-byte payloads and
// s_up / s_gate [D * nlx][I], s_down [D * nlx][H] their f32 scales per
// output channel.  Every weight tile is dequantized on its way into shared
// memory ((payload.f32 * scale) rounded once to the input dtype), so the
// FFN computes exactly as on weights dequantized beforehand, while each
// weight element streams 1 byte from HBM.  The flags, the task list and
// every phase stay as they are.
// Counts are clamped to the slabs' capacity; rank r receives from source s
// the rows s sends it, send_cnt[s][r][e], so the two sides cannot disagree.
//
// Transport.  Each rank owns an identically laid-out symmetric heap of four
// regions: x_recv [D][nlx][ch][H], the return buffer (y_back
// [D][nlx][ch][H] or y_sorted [rows_pad][H]), its hidden scratch
// [D][nlx][ch][I] and its flag words (barrier counter, work counter,
// dispatch, up and return flags).  The kernel reaches rank p's regions
// through the peer table only (peers[region][p]), and its TMA loads
// through tensor maps the host encodes from the same table's addresses
// into a device buffer, [3 + 2 D] maps for any D (the kernel's parameters
// would hold a dozen ranks' maps at most).
// Here the regions are slices of allocations on one card (virtual ranks):
// the data regions are allocated for each call, the flag words persist
// across calls.  Peer heaps mapped from other GPUs over CUDA IPC would
// serve the same kernel body.  A flag is a release store (after
// __threadfence()) of the call's sequence number, read by an acquire load
// in a __nanosleep spin loop, at system scope so that it holds across GPUs
// too; flags are never reset, so a flag left by an earlier call never
// satisfies a wait (the wrapper advances the sequence number only for a
// launch that was accepted).  A wait that spins past timeout_ns prints
// what it waited for and traps: a protocol fault fails loudly instead of
// hanging.  Data written by other blocks is read from L2 only (TMA,
// cp.async.cg, __ldcg).
//
// Co-residency.  Every block may wait on others, so all D * G blocks
// (block b serves rank b / G) must be resident at once: the kernel is
// launched cooperatively, which refuses a grid that could not be, and the
// wrapper sizes G from the occupancy calculator (with the kernel's
// dynamic shared memory).  Phase 2 hands out tasks through the rank's work
// counter; each block stops at its first grab past the end, so a call adds
// exactly n_total + G to it and the wrapper passes the running base.  The
// host lists each unit's up tasks before its down tasks, so a down task is
// handed out only after every up task it waits for, and a block issues
// every load of its current task before it waits on the next one's flags:
// each task a block has taken completes whatever the later ones do (no
// deadlock).
//
// What bounds it on an H100: at the FlashMoE reference layer (E 64, ep 8,
// capacity 32) the bytes (weights once, the slabs moved four times); at
// Mixtral widths (ep 8, one 352 MB expert per rank, capacity 1024) the
// tensor-core operations; a quantized store halves the weight bytes of a
// bf16 one.  Two designs, chosen by dtype (a dispatch, not a fallback):
//
// * fused_ep_hopper, bf16 (B5 and B5q): phase 2 on the Hopper FFN's
//   mainloop (ffn_hopper.cuh, B2's ring, products and epilogue values).
//   Blocks of 384 threads, one per SM, with the ring in dynamic shared
//   memory: a producer warpgroup whose thread 0 takes tasks from the
//   counter, waits for their flags (the warpgroup's 128 threads share the
//   waits), hands each task to the consumers through a small task ring of
//   its own mbarriers, and issues every stage's TMA loads (A rows from
//   x_recv for an up task, from the hidden scratch for a down task; the
//   weight strip read in place as MN-major B); two consumer warpgroups,
//   one per tile of the item, on wgmma.  The host pairs the tiles of a
//   unit across its sources (tile t of every source in turn), so that at
//   the ep path's shapes (about 32 live rows a slab) both warpgroups work.
//   The epilogues store straight from the accumulator fragments: the up
//   pass's hidden rows to the scratch, the down pass's populated rows to
//   the source's return buffer.  With a quantized store the producer
//   loads each stage's 1-byte payload boxes by TMA into a 2-slot staging
//   ring beside the 4-stage ring, and the consumer
//   warpgroups write (payload.f32 * scale[column]) rounded once to bf16
//   into the swizzled MN-major B tile, each warpgroup half the boxes of
//   the stage two ahead of its products, while its wgmma runs (int8
//   decoded by a byte permute under 2^23, e4m3 by the f16 conversion;
//   the scales of a box's columns through L1); each fences its writes
//   (fence.proxy.async.shared::cta), meets at its named barrier, and one
//   thread arrives on the stage's full barrier (which also counts the A
//   boxes' bytes) and on the payload slot's empty one: wgmma reads bf16
//   tiles, so B5q equals B5 on dequantized weights bit for bit.  (In the
//   producer warpgroup alone the conversion was issue-bound: 2.1 ms of
//   6.6 at the ep path's shapes, chip_ablate.py.)  Phases 0 and 1 run on
//   all 384 threads; phase 3 on the two consumer warpgroups, after the
//   producer has left (named barriers).  Memory order across proxies: a
//   TMA load
//   of rows another block wrote (generic stores) follows the flag's
//   acquire and a fence.proxy.async.global; the writer fences
//   (__threadfence or __threadfence_system) before the release.  The
//   consumers' mbarrier waits trap after twice timeout_ns and a second,
//   so that a protocol fault's flag message comes out first.
// * fused_ep_kernel, f32: one 64 x 64 output tile at a time per block of
//   4 warps (gemm_tile.cuh, SIMT FMA; QuantB dequantizes the payloads),
//   the same tasks, flags and phases.
#include <cstdint>
#include <cstdio>
#include <type_traits>
#include <vector>

#include "ffn_hopper.cuh"
#include "gemm_tile.cuh"

namespace fm {

struct EpArgs {
  int D, nlx, cap, ch, H, I, k, combine, act, rows_pad, G, n_tiles,
      n_total, n_up, n_down;
  unsigned seq;
  unsigned long long work_base;
  long long timeout_ns;
  const void* x_send;    // [D][D][nlx][cap][H]
  const int* send_cnt;   // [D][D][nlx]: rows rank r sends (dst, e)
  const int4* order;     // [D][n_total] tasks: the item's tiles (tile code
                         // (src*nlx + e)*n_tiles + t, the second -1 when
                         // the item has one), kind << 16 | column tile
                         // (kind 1 down), 0
  const int* recv_pos;   // [D][D][nlx][cap] sorted return rows (combine)
  const float* w_sorted; // [D][rows_pad] (combine)
  const void* w_up;      // [D * nlx][H][I]
  const void* w_gate;    // [D * nlx][H][I] or null
  const float* b_up;     // [D * nlx][I]
  const void* w_down;    // [D * nlx][I][H]
  const float* b_down;   // [D * nlx][H]
  const float* s_up;     // [D * nlx][I] f32 scales of a quantized w_up
  const float* s_gate;   // [D * nlx][I] (gated, quantized)
  const float* s_down;   // [D * nlx][H]
  const unsigned long long* peers;  // [4][D]: each rank's x_recv, return
                                    // buffer, hidden scratch, flag words
  // bf16: [3 + 2 D] TMA maps in device memory, 64-byte aligned: the
  // weights (w_up, w_gate, w_down: bf16 [E, K, N] in MN-major B boxes, or
  // 1-byte payloads in unswizzled boxes), then each rank's x_recv
  // [D * nlx * ch, H], then each rank's hidden scratch [D * nlx * ch, I],
  // in 64 x 64 A boxes
  const CUtensorMap* maps;
  float* out;            // [D][rows_pad / k][H] (combine)
};

enum { WAIT_BARRIER = 0, WAIT_DISPATCH = 1, WAIT_UP = 2, WAIT_RETURN = 3 };

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// a barrier of n threads (id 0 with every thread of the block:
// __syncthreads)
__device__ __forceinline__ void ep_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// spin until *f reaches target (the barrier counts up; a flag equals it)
__device__ void wait_for(const EpArgs& a, const unsigned* f,
                         unsigned target, int what, int rank, int src,
                         int e, int t) {
  if (ld_acquire(f) >= target) return;
  const unsigned long long t0 = now_ns();
  unsigned ns = 32;
  while (ld_acquire(f) < target) {
    __nanosleep(ns);
    if (ns < 1024) ns <<= 1;
    if ((long long)(now_ns() - t0) > a.timeout_ns) {
      printf("fm_fused_ep: rank %d timed out waiting for %s (source %d, "
             "expert %d, tile %d): word %u, want %u\n",
             rank,
             what == WAIT_BARRIER    ? "the barrier"
             : what == WAIT_DISPATCH ? "a dispatch flag"
             : what == WAIT_UP       ? "an up flag"
                                     : "a return flag",
             src, e, t, *f, target);
      __trap();
    }
  }
}

enum { REGION_X_RECV = 0, REGION_RET, REGION_HIDDEN, REGION_FLAGS };

template <typename T> struct Heap {
  const EpArgs* a;
  int rank;
  __device__ Heap(const EpArgs& args, int r) : a(&args), rank(r) {}
  __device__ char* region(int which) const {
    return (char*)a->peers[which * a->D + rank];
  }
  // the first row of tile (src, e, t) in x_recv and the hidden scratch
  __device__ int tile_row(int src, int e, int t) const {
    return (src * a->nlx + e) * a->ch + t * FBM;
  }
  __device__ T* x_recv(int src, int e, int t) const {
    return (T*)region(REGION_X_RECV) + (size_t)tile_row(src, e, t) * a->H;
  }
  __device__ T* ret() const { return (T*)region(REGION_RET); }
  __device__ T* hidden(int src, int e, int t) const {
    return (T*)region(REGION_HIDDEN) + (size_t)tile_row(src, e, t) * a->I;
  }
  __device__ unsigned* barrier() const {
    return (unsigned*)region(REGION_FLAGS);
  }
  __device__ unsigned long long* work() const {
    return (unsigned long long*)(region(REGION_FLAGS) + 8);
  }
  // dispatch flags [D][nlx][n_tiles], up flags [D][nlx][n_tiles][n_up],
  // return flags [D][nlx][n_tiles][n_down]
  __device__ unsigned* disp_flag(int r, int e, int t) const {
    return (unsigned*)(region(REGION_FLAGS) + 16) +
           (r * a->nlx + e) * a->n_tiles + t;
  }
  __device__ unsigned* up_flag(int r, int e, int t, int j) const {
    const int n = a->D * a->nlx * a->n_tiles;
    return (unsigned*)(region(REGION_FLAGS) + 16) + n +
           ((r * a->nlx + e) * a->n_tiles + t) * a->n_up + j;
  }
  __device__ unsigned* ret_flag(int r, int e, int t, int j) const {
    const int n = a->D * a->nlx * a->n_tiles;
    return (unsigned*)(region(REGION_FLAGS) + 16) + n * (1 + a->n_up) +
           ((r * a->nlx + e) * a->n_tiles + t) * a->n_down + j;
  }
};

// rows source src sends rank dst's local expert e, clamped to the capacity
__device__ __forceinline__ int sent_rows(const EpArgs& a, int src, int dst,
                                         int e) {
  return min(a.send_cnt[(src * a.D + dst) * a.nlx + e], a.cap);
}

// One tile of a task at rank `rank`: its source, local expert, row tile
// and live rows (<= 0: nothing arrived, the tile is skipped).
struct EpTile {
  int src, e, t, rows;
};
__device__ __forceinline__ EpTile ep_tile(const EpArgs& a, int rank,
                                          int code) {
  EpTile x;
  x.src = code / (a.nlx * a.n_tiles);
  x.e = (code / a.n_tiles) % a.nlx;
  x.t = code % a.n_tiles;
  x.rows = min(FBM, sent_rows(a, x.src, rank, x.e) - x.t * FBM);
  return x;
}

// output columns of an up (gated or not) and a down task
template <bool GATED> __host__ __device__ constexpr int up_cols() {
  return FH_COLS / (GATED ? 2 : 1);
}
constexpr int DOWN_COLS = FH_COLS;

// ---- phases 0, 1 and 3: every thread of the block (nthreads) ----------

template <typename T>
__device__ void ep_barrier(const EpArgs& a, int rank, int g, int tid) {
  if (a.D == 1) return;
  if (g == 0 && tid < a.D && tid != rank) {
    __threadfence_system();
    atomicAdd_system(Heap<T>(a, tid).barrier(), 1u);
  }
  if (tid == 0)
    wait_for(a, Heap<T>(a, rank).barrier(), a.seq * (unsigned)(a.D - 1),
             WAIT_BARRIER, rank, -1, -1, -1);
  __syncthreads();
}

// send every occupied tile, own slab first
template <typename T>
__device__ void ep_send(const EpArgs& a, int rank, int g, int tid,
                        int nthreads) {
  const int D = a.D, nlx = a.nlx, nt = a.n_tiles, H = a.H;
  const int per_dst = nlx * nt;
  for (int idx = g; idx < D * per_dst; idx += a.G) {
    const int dst = (rank + idx / per_dst) % D;
    const int e = (idx % per_dst) / nt, t = idx % nt;
    const int rows = min(FBM, sent_rows(a, rank, dst, e) - t * FBM);
    if (rows <= 0) continue;
    const Heap<T> peer(a, dst);
    const uint4* from =
        (const uint4*)((const T*)a.x_send +
                       ((size_t)((rank * D + dst) * nlx + e) * a.cap +
                        t * FBM) * H);
    uint4* to = (uint4*)peer.x_recv(rank, e, t);
    const int n16 = rows * H * (int)sizeof(T) / 16;
    for (int i = tid; i < n16; i += nthreads) to[i] = from[i];
    __syncthreads();
    if (tid == 0) {
      __threadfence_system();
      st_release(peer.disp_flag(rank, e, t), a.seq);
    }
  }
}

// drain every return, then the k-row combine; bar_id / nthreads: the
// barrier of the threads that run it
template <typename T>
__device__ void ep_drain(const EpArgs& a, int rank, int g, int tid,
                         int nthreads, int bar_id) {
  const int D = a.D, nlx = a.nlx, nt = a.n_tiles, H = a.H;
  const int per_dst = nlx * nt;
  const Heap<T> own(a, rank);
  for (int i = tid; i < D * per_dst * a.n_down; i += nthreads) {
    const int tile = i / a.n_down, j = i % a.n_down;
    const int dst = tile / per_dst, e = (tile % per_dst) / nt,
              t = tile % nt;
    if (t * FBM < sent_rows(a, rank, dst, e))
      wait_for(a, own.ret_flag(dst, e, t, j), a.seq, WAIT_RETURN, rank,
               dst, e, t);
  }
  ep_sync(bar_id, nthreads);
  if (!a.combine) return;
  const int s_out = a.rows_pad / a.k;
  const T* ys = own.ret();
  const float* ws = a.w_sorted + (size_t)rank * a.rows_pad;
  float* o = a.out + (size_t)rank * s_out * H;
  for (int tok = g; tok < s_out; tok += a.G)
    for (int h = tid; h < H; h += nthreads) {
      float acc = 0.f;
      for (int j = 0; j < a.k; ++j) {
        const float w = ws[tok * a.k + j];
        if (w != 0.f)
          acc = __fadd_rn(
              acc, __fmul_rn(to_f(__ldcg(ys + (size_t)(tok * a.k + j) * H +
                                         h)),
                             w));
      }
      o[(size_t)tok * H + h] = acc;
    }
}

// ---- f32: the 64 x 64 tile --------------------------------------------

// One 64 x 64 tile of A @ W[:, n0:n0+64] for the weights w0 (and w1 when
// NB is 2) at element offset off (Q = void: weights in T; else 1-byte
// payloads with scales s0 (s1) at column offset soff)
template <typename T, typename Q, int NB>
__device__ __forceinline__ void weight_tile(const T* A, int K,
                                            const void* w0, const void* w1,
                                            const float* s0, const float* s1,
                                            size_t off, size_t soff, int N,
                                            float* Cs) {
  if constexpr (std::is_void<Q>::value) {
    const T* B[NB];
    B[0] = (const T*)w0 + off;
    if (NB == 2) B[NB - 1] = (const T*)w1 + off;
    ffn_mainloop<NB, false>(A, K, B, N, Cs);
  } else {
    const Q* B[NB];
    const float* S[NB];
    B[0] = (const Q*)w0 + off;
    S[0] = s0 + soff;
    if (NB == 2) {
      B[NB - 1] = (const Q*)w1 + off;
      S[NB - 1] = s1 + soff;
    }
    ffn_mainloop_q<NB>(A, K, B, S, N, Cs);
  }
}

template <typename T, bool GATED, typename Q>
__global__ void __launch_bounds__(FTHREADS) fused_ep_kernel(EpArgs a) {
  constexpr int NB = GATED ? 2 : 1;
  constexpr int LDC = FfnTile<T>::LDC;
  static_assert(sizeof(FfnSmem<T, NB, false>) <= FFN_SMEM, "shared memory");
  static_assert(sizeof(typename QuantB<T, int8_t, NB>::Smem) <= FFN_SMEM,
                "shared memory of the quantized arm");
  __shared__ __align__(128) float Cs[FFN_SMEM / 4];
  __shared__ unsigned long long s_idx;

  const int tid = threadIdx.x;
  const int rank = blockIdx.x / a.G, g = blockIdx.x % a.G;
  const int nlx = a.nlx, H = a.H, I = a.I;
  const Heap<T> own(a, rank);

  ep_barrier<T>(a, rank, g, tid);
  ep_send<T>(a, rank, g, tid, FTHREADS);

  // ---- phase 2: tasks in the host's order, handed out by the counter ----
  for (;;) {
    if (tid == 0) s_idx = atomicAdd(own.work(), 1ull) - a.work_base;
    __syncthreads();
    const unsigned long long idx = s_idx;
    __syncthreads();
    if (idx >= (unsigned long long)a.n_total) break;
    const int4 task = a.order[(size_t)rank * a.n_total + idx];
    const bool down = task.z >> 16;
    const int j = task.z & 0xffff;
    for (int c = 0; c < 2; ++c) {
      const int code = c ? task.y : task.x;
      if (code < 0) continue;
      const EpTile x = ep_tile(a, rank, code);
      if (x.rows <= 0) continue;
      const int src = x.src, e = x.e, t = x.t;
      const size_t ge = (size_t)rank * nlx + e;  // global expert
      T* hid = own.hidden(src, e, t);
      if (!down) {
        if (tid == 0)
          wait_for(a, own.disp_flag(src, e, t), a.seq, WAIT_DISPATCH, rank,
                   src, e, t);
        __syncthreads();
        const T* xt = own.x_recv(src, e, t);
        const int c_end = min((j + 1) * up_cols<GATED>(), I);
        for (int n0 = j * up_cols<GATED>(); n0 < c_end; n0 += FBN) {
          weight_tile<T, Q, NB>(xt, H, a.w_up, a.w_gate, a.s_up, a.s_gate,
                                ge * H * I + n0, ge * I + n0, I, Cs);
          __syncthreads();
          const float* bias = a.b_up + ge * I + n0;
          for (int i = tid; i < FBM * FBN; i += FTHREADS) {
            const int r = i / FBN, cc = i % FBN;
            float v = Cs[r * LDC + cc] + bias[cc];
            if (GATED)
              v = act_f(Cs[FBM * LDC + r * LDC + cc], a.act) * v;
            else
              v = act_f(v, a.act);
            hid[(size_t)r * I + n0 + cc] = from_f<T>(v);
          }
          __syncthreads();
        }
        if (tid == 0) {
          __threadfence();
          st_release(own.up_flag(src, e, t, j), a.seq);
        }
        continue;
      }
      for (int i = tid; i < a.n_up; i += FTHREADS)
        wait_for(a, own.up_flag(src, e, t, i), a.seq, WAIT_UP, rank, src,
                 e, t);
      __syncthreads();
      const Heap<T> back(a, src);
      const int* pos =
          a.combine ? a.recv_pos + ((size_t)(rank * a.D + src) * nlx + e) *
                                       a.cap + t * FBM
                    : nullptr;
      const int c_end = min((j + 1) * DOWN_COLS, H);
      for (int n0 = j * DOWN_COLS; n0 < c_end; n0 += FBN) {
        weight_tile<T, Q, 1>(hid, I, a.w_down, nullptr, a.s_down, nullptr,
                             ge * I * H + n0, ge * H + n0, H, Cs);
        __syncthreads();
        const float* bias = a.b_down + ge * H + n0;
        for (int i = tid; i < x.rows * FBN; i += FTHREADS) {
          const int r = i / FBN, cc = i % FBN;
          const size_t row =
              a.combine ? (size_t)pos[r]
                        : (size_t)own.tile_row(rank, e, t) + r;
          back.ret()[row * H + n0 + cc] =
              from_f<T>(Cs[r * LDC + cc] + bias[cc]);
        }
        __syncthreads();
      }
      if (tid == 0) {
        __threadfence_system();
        st_release(back.ret_flag(rank, e, t, j), a.seq);
      }
    }
  }

  ep_drain<T>(a, rank, g, tid, FTHREADS, 0);
}

// ---- bf16: the Hopper FFN -----------------------------------------------

enum { EP_UP = 0, EP_DOWN = 1, EP_END = 2 };
constexpr int EP_TASKS = 4;       // slots of the task ring
constexpr int EP_PRODUCER_BAR = 3;  // named barrier of the producer
constexpr int EP_CONSUMER_BAR = 4;  // of both consumer warpgroups

// A task as the consumers see it: the live tiles first.
struct EpTask {
  int kind, j, e, tiles;
  int src[FH_CONSUMERS], t[FH_CONSUMERS], rows[FH_CONSUMERS];
};

// B5q: the payload staging ring, EP_PAY slots of a stage's 1-byte
// payload boxes ([box][K-row][64 columns]), each with a barrier for their
// arrival (the producer's TMA) and one for their conversion (an arrival
// per consumer warpgroup).  Beside the 4-stage ring two slots are what
// shared memory holds.
constexpr int EP_PAY = 2;
struct EpPay {
  alignas(128) unsigned char b[EP_PAY][FH_COLS / 64][hg::BK * 64];
  uint64_t full[EP_PAY];
  uint64_t empty[EP_PAY];
};
struct EpNone {};

template <int STAGES, bool QUANT> struct EpSmem {
  FhRingT<STAGES> ring;
  EpTask task[EP_TASKS];
  uint64_t tfull[EP_TASKS];
  uint64_t tempty[EP_TASKS];
  unsigned long long grab;
  std::conditional_t<QUANT, EpPay, EpNone> q;
};

// B5q: 8 payload bytes -> 8 exact f32 values.  int8: the byte x ^ 0x80
// (x + 128, unsigned) under 0x4B000000 is the f32 2^23 + x + 128, so one
// byte permute and one subtraction give x exactly.
__device__ __forceinline__ void decode8(const int8_t*, uint2 raw,
                                        float (&v)[8]) {
  const unsigned w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = __int_as_float(
               (int)__byte_perm(w[i / 4], 0x4B000000u, 0x7540 + i % 4)) -
           8388736.f;
}
// e4m3 -> f16 is exact (NaN stays NaN; e4m3fn has no infinities)
__device__ __forceinline__ void decode8(const __nv_fp8_e4m3*, uint2 raw,
                                        float (&v)[8]) {
  const unsigned w[2] = {raw.x, raw.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __half2 h(__nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(w[i / 2] >> (16 * (i % 2))), __NV_E4M3));
    const float2 f = __half22float2(h);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ unsigned bf16x2_bits(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// B5q: 8 payload bytes (raw) of a staging box's K-row k, columns 8 c8..,
// into the same place of the swizzled MN-major bf16 box (one 16-byte
// unit): (payload.f32 * scale) rounded once to bf16, the value
// quant.dequantize_channelwise gives.  s0, s1: the 8 columns' scales.
template <typename Q>
__device__ __forceinline__ void ep_dequant8(uint2 raw, char* box, float4 s0,
                                            float4 s1, int k, int c8) {
  float v[8];
  decode8((const Q*)nullptr, raw, v);
  uint4 o;
  o.x = bf16x2_bits(__fmul_rn(v[0], s0.x), __fmul_rn(v[1], s0.y));
  o.y = bf16x2_bits(__fmul_rn(v[2], s0.z), __fmul_rn(v[3], s0.w));
  o.z = bf16x2_bits(__fmul_rn(v[4], s1.x), __fmul_rn(v[5], s1.y));
  o.w = bf16x2_bits(__fmul_rn(v[6], s1.z), __fmul_rn(v[7], s1.w));
  *reinterpret_cast<uint4*>(box + hg::sw128_offset(k, 16 * c8)) = o;
}

// The producer warpgroup: take tasks, wait for their flags (the 128
// threads share the waits), hand them to the consumers, and thread 0
// issues their TMA loads: with Q the weight boxes go to the payload
// staging ring, for the consumers to convert.  Thread 0 first acquires the
// five maps the rank uses (a.maps: the three weights', its x_recv's, its
// hidden scratch's) for the tensormap proxy and prefetches them.
template <bool GATED, typename Q, int STAGES>
__device__ void ep_produce(const EpArgs& a,
                           EpSmem<STAGES, !std::is_void<Q>::value>& sm,
                           int rank, int tid, uint64_t limit) {
  constexpr bool QUANT = !std::is_void<Q>::value;
  const Heap<bf16> own(a, rank);
  FhRingT<STAGES>& ring = sm.ring;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hg::tensormap_acquire(a.maps + i);
    hg::tensormap_acquire(a.maps + 3 + rank);
    hg::tensormap_acquire(a.maps + 3 + a.D + rank);
  }
  int q = 0;
  uint32_t qph = 0;
  unsigned n = 0;  // stages issued: stage n % STAGES, lap (n / STAGES) & 1
  for (;;) {
    if (tid == 0) sm.grab = atomicAdd(own.work(), 1ull) - a.work_base;
    ep_sync(EP_PRODUCER_BAR, 128);
    const unsigned long long idx = sm.grab;
    EpTask tk;
    tk.kind = EP_END;
    tk.tiles = 0;
    if (idx < (unsigned long long)a.n_total) {
      const int4 code = a.order[(size_t)rank * a.n_total + idx];
      tk.kind = code.z >> 16;
      tk.j = code.z & 0xffff;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int cd = c ? code.y : code.x;
        if (cd < 0) continue;
        const EpTile x = ep_tile(a, rank, cd);
        tk.e = x.e;
        if (x.rows > 0) {
          tk.src[tk.tiles] = x.src;
          tk.t[tk.tiles] = x.t;
          tk.rows[tk.tiles] = x.rows;
          ++tk.tiles;
        }
      }
      if (tk.tiles == 0) {  // nothing arrived: the next task
        ep_sync(EP_PRODUCER_BAR, 128);  // every thread has read sm.grab
        continue;
      }
      if (tk.kind == EP_UP) {
        if (tid < tk.tiles)
          wait_for(a, own.disp_flag(tk.src[tid], tk.e, tk.t[tid]), a.seq,
                   WAIT_DISPATCH, rank, tk.src[tid], tk.e, tk.t[tid]);
      } else {
        for (int i = tid; i < tk.tiles * a.n_up; i += 128) {
          const int c = i / a.n_up;
          wait_for(a, own.up_flag(tk.src[c], tk.e, tk.t[c], i % a.n_up),
                   a.seq, WAIT_UP, rank, tk.src[c], tk.e, tk.t[c]);
        }
      }
    }
    // the flags acquired by the warpgroup are the block's; every thread
    // has read sm.grab
    ep_sync(EP_PRODUCER_BAR, 128);
    if (tid == 0) {
      hg::mbar_wait(&sm.tempty[q], qph ^ 1, limit);
      sm.task[q] = tk;
      hg::mbar_arrive(&sm.tfull[q]);
      // rows other blocks stored (generic proxy) before their flags,
      // ordered before this thread's TMA loads (async proxy)
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
    }
    if (++q == EP_TASKS) {
      q = 0;
      qph ^= 1;
    }
    if (tk.kind == EP_END) return;

    const bool down = tk.kind == EP_DOWN;
    const int nb = down || !GATED ? 1 : 2;
    const int BN = FH_COLS / nb;
    const int N = down ? a.H : a.I, K = down ? a.I : a.H;
    const int n0 = tk.j * BN, boxes = min(BN, N - n0) / 64;
    const int nk = K / hg::BK;
    const int ge = rank * a.nlx + tk.e;
    // the A rows: the rank's hidden scratch or x_recv; the weights
    const CUtensorMap* ta = a.maps + 3 + (down ? a.D : 0) + rank;
    const CUtensorMap* tb[2] = {a.maps + (down ? 2 : 0), a.maps + 1};
    int arow[FH_CONSUMERS];
#pragma unroll
    for (int c = 0; c < FH_CONSUMERS; ++c)
      arow[c] = c < tk.tiles ? own.tile_row(tk.src[c], tk.e, tk.t[c]) : 0;
    const uint32_t a_bytes = tk.tiles * hg::A_TILE * sizeof(bf16);

    if (tid != 0) continue;
    if constexpr (!QUANT) {
      const uint32_t bytes = a_bytes + nb * boxes * 64 * 64 * sizeof(bf16);
      for (int kb = 0; kb < nk; ++kb, ++n) {
        const int s = n % STAGES;
        hg::mbar_wait(&ring.empty[s], ((n / STAGES) & 1) ^ 1, limit);
        uint64_t* full = &ring.full[s];
        hg::mbar_expect_tx(full, bytes);
        for (int c = 0; c < tk.tiles; ++c)
          hg::tma_load_2d(ring.a[s][c], ta, full, kb * hg::BK, arow[c]);
        for (int m = 0; m < nb; ++m)
          for (int j = 0; j < boxes; ++j)
            hg::tma_load_3d(ring.b[s] + (m * BN + 64 * j) * hg::BK, tb[m],
                            full, n0 + 64 * j, kb * hg::BK, ge);
      }
    } else {
      // the A boxes onto each stage's full barrier; the payload boxes of
      // stage m into staging slot m % EP_PAY once the consumers have
      // converted the slot's last payload (they write the B tile,
      // ep_convert)
      EpPay& P = sm.q;
      const uint32_t p_bytes = nb * boxes * 64 * 64;
      auto load_payload = [&](int kb, unsigned m) {  // K-step kb, stage m
        const int ps = m % EP_PAY;
        hg::mbar_wait(&P.empty[ps], ((m / EP_PAY) & 1) ^ 1, limit);
        hg::mbar_expect_tx(&P.full[ps], p_bytes);
        for (int o = 0; o < nb; ++o)
          for (int j = 0; j < boxes; ++j)
            hg::tma_load_3d(P.b[ps][o * (BN / 64) + j], tb[o], &P.full[ps],
                            n0 + 64 * j, kb * hg::BK, ge);
      };
      for (int kb = 0; kb < min(EP_PAY, nk); ++kb) load_payload(kb, n + kb);
      for (int kb = 0; kb < nk; ++kb, ++n) {
        const int s = n % STAGES;
        hg::mbar_wait(&ring.empty[s], ((n / STAGES) & 1) ^ 1, limit);
        hg::mbar_expect_tx(&ring.full[s], a_bytes);
        for (int c = 0; c < tk.tiles; ++c)
          hg::tma_load_2d(ring.a[s][c], ta, &ring.full[s], kb * hg::BK,
                          arow[c]);
        if (kb + EP_PAY < nk) load_payload(kb + EP_PAY, n + EP_PAY);
      }
    }
  }
}

// the limit of the consumers' mbarrier waits: past the flags' timeout
__device__ __forceinline__ uint64_t ep_limit(const EpArgs& a) {
  return 2 * (uint64_t)a.timeout_ns + 1000000000ull;
}

// B5q: how many stages ahead of its products a consumer warpgroup
// converts: the stage's B slot is free once both warpgroups have
// released the stage STAGES back (with 4 stages, two before the ones in
// flight), and its payload slot has had EP_PAY stages to arrive.
constexpr int EP_AHEAD = 2;

// B5q: consumer warpgroup wg's half of the B tile of global stage m
// (boxes 2 wg and 2 wg + 1 of the stage's up to four): wait for the
// payload and for the slot's last products, convert (the thread's 8
// columns 8 c8.. of each box, rows k0 + 16 i, a box's payload bytes
// loaded before its first store, which the loads could otherwise not
// pass), fence the generic-proxy writes for wgmma's async-proxy reads,
// and one arrival for the warpgroup on the stage's full barrier and the
// payload slot's empty one.  sc: the f32 scales of each of the two
// boxes' columns (null: the box lies past the weight's columns), read
// through L1 a box at a time: the warpgroup holds its 128 accumulators
// meanwhile (scales kept in registers, or two boxes converted together,
// spilled).
template <typename Q, int STAGES>
__device__ __forceinline__ void ep_convert(EpSmem<STAGES, true>& sm,
                                           unsigned m,
                                           const float* const (&sc)[2],
                                           int wg, int tid, uint64_t limit) {
  const int s = m % STAGES, ps = m % EP_PAY;
  hg::mbar_wait(&sm.q.full[ps], (m / EP_PAY) & 1, limit);
  hg::mbar_wait(&sm.ring.empty[s], ((m / STAGES) & 1) ^ 1, limit);
  const int c8 = tid % 8, k0 = tid / 8;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    if (sc[h] == nullptr) continue;
    const int b = 2 * wg + h;
    uint2 raw[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      raw[i] = *reinterpret_cast<const uint2*>(sm.q.b[ps][b] +
                                               (k0 + 16 * i) * 64 + 8 * c8);
    const float4* p = reinterpret_cast<const float4*>(sc[h] + 8 * c8);
    const float4 s0 = __ldg(p), s1 = __ldg(p + 1);
    char* box = reinterpret_cast<char*>(sm.ring.b[s] + 64 * b * hg::BK);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ep_dequant8<Q>(raw[i], box, s0, s1, k0 + 16 * i, c8);
  }
  hg::fence_async_smem();
  wg_sync(wg);
  if (tid == 0) {
    hg::mbar_arrive(&sm.ring.full[s]);
    hg::mbar_arrive(&sm.q.empty[ps]);
  }
}

// B5q: a consumer warpgroup's stages of one task, global stages n.. n +
// nk - 1: the first EP_AHEAD stages' halves converted up front, then at
// each stage its products (active, as ffn_products; else the stage is
// released at once) while the half of the stage EP_AHEAD on is
// converted.  Returns the last stage an active warpgroup holds (-1 for
// an inactive one); n advances past the task.
template <typename Q, int STAGES, int NB, int BN>
__device__ __forceinline__ int ep_products_q(
    EpSmem<STAGES, true>& sm, unsigned& n, int nk, bool active,
    const float* const (&sc)[2], int wg, int tid, float (&d)[NB][BN / 2],
    uint64_t limit) {
  for (int c = 0; c < min(EP_AHEAD, nk); ++c)
    ep_convert<Q>(sm, n + c, sc, wg, tid, limit);
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[m][i] = 0.f;
  int prev = -1;
  for (int kb = 0; kb < nk; ++kb, ++n) {
    const int s = n % STAGES;
    hg::mbar_wait(&sm.ring.full[s], (n / STAGES) & 1, limit);
    hg::fence_async_smem();  // the other warpgroup's converted half
    if (active) {
      hg::wgmma_fence();
#pragma unroll
      for (int m = 0; m < NB; ++m)
        hg::wgmma_stage_mn<BN>(d[m], sm.ring.a[s][wg],
                               sm.ring.b[s] + m * BN * hg::BK);
      hg::wgmma_commit();
      hg::wgmma_wait<1>();  // the previous stage's products are done
      if (prev >= 0 && tid == 0) hg::mbar_arrive(&sm.ring.empty[prev]);
      prev = s;
    } else {
      wg_sync(wg);  // every thread has seen the phase
      if (tid == 0) hg::mbar_arrive(&sm.ring.empty[s]);
    }
    if (kb + EP_AHEAD < nk)
      ep_convert<Q>(sm, n + EP_AHEAD, sc, wg, tid, limit);
  }
  return prev;
}

// One task of a consumer warpgroup: its tile's products, the epilogue
// straight from the fragments, the flag.  tk is the task's slot in the
// task ring, held until the task ends: what the epilogue needs is read
// from it only after the mainloop.  Q (B5q): the warpgroup also converts
// its half of each stage's weight boxes (ep_products_q); n counts the
// ring's stages.
template <int MODE, int ACT, int STAGES, typename Q>
__device__ __forceinline__ void ep_task(
    const EpArgs& a,
    EpSmem<STAGES, !std::is_void<Q>::value>& sm, hg::RingPos& pos,
    unsigned& n, const EpTask& tk, int rank, int wg, int tid) {
  constexpr int NB = MODE == MODE_UP_GATED ? 2 : 1;
  constexpr int BN = FH_COLS / NB;
  const bool down = MODE == MODE_DOWN;
  const int nk = (down ? a.I : a.H) / hg::BK;
  const int N = down ? a.H : a.I;
  float d[NB][BN / 2];
  int last;
  if constexpr (std::is_void<Q>::value) {
    if (wg >= tk.tiles) {  // the item has one tile: keep the ring in step
      ffn_skip<STAGES>(sm.ring, pos, nk, wg, tid, ep_limit(a));
      return;
    }
    last = ffn_products<STAGES, NB, BN, false>(sm.ring, pos, nk, wg, tid, d,
                                               ep_limit(a));
  } else {
    // the scales of the warpgroup's two boxes (box b: operand b / per_op,
    // columns 64 (b % per_op)..), null past the weight's columns
    const int per_op = BN / 64, n0 = tk.j * BN;
    const size_t ge = (size_t)rank * a.nlx + tk.e;
    const float* sc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = 2 * wg + h, o = b / per_op;
      const int c = n0 + 64 * (b % per_op);
      const float* S = down ? a.s_down : o ? a.s_gate : a.s_up;
      sc[h] = o < NB && c < N ? S + ge * N + c : nullptr;
    }
    const bool active = wg < tk.tiles;
    last = ep_products_q<Q, STAGES, NB, BN>(sm, n, nk, active, sc, wg, tid,
                                             d, ep_limit(a));
    if (!active) return;
  }
  const int lane = tid % 32;
  const int r = tid / 32 * 16 + lane / 4;  // the thread's rows r, r + 8
  const int src = tk.src[wg], e = tk.e, t = tk.t[wg], j = tk.j;
  const int n0 = j * BN;
  const size_t ge = (size_t)rank * a.nlx + e;
  float2 bv[EPI_COLS / 8];
  const float* be =
      (down ? a.b_down : a.b_up) + ge * N + n0 + 2 * (lane % 4);
  ffn_drain<STAGES, NB, BN>(sm.ring, last, tid, d, be, bv);
  const Heap<bf16> own(a, rank);
  if (!down) {
    // every row of the tile to the scratch: a row past the count computes
    // whatever x_recv holds there, and only its own hidden row
    bf16* hid = own.hidden(src, e, t) + n0;
    ffn_rows<MODE, ACT, NB, BN>(d, bv, be, hid + (size_t)r * N,
                                hid + (size_t)(r + 8) * N, n0, N, lane);
    __threadfence();
    wg_sync(wg);
    if (tid == 0) st_release(own.up_flag(src, e, t, j), a.seq);
    return;
  }
  // the populated rows, to the source's return buffer
  const int rows = tk.rows[wg];
  const Heap<bf16> back(a, src);
  bf16* p[2] = {nullptr, nullptr};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if (row < rows) {
      const size_t at =
          a.combine ? (size_t)a.recv_pos[((size_t)(rank * a.D + src) *
                                              a.nlx + e) * a.cap +
                                         t * FBM + row]
                    : (size_t)own.tile_row(rank, e, t) + row;
      p[h] = back.ret() + at * N + n0;
    }
  }
  ffn_rows<MODE, ACT, NB, BN>(d, bv, be, p[0], p[1], n0, N, lane);
  __threadfence_system();
  wg_sync(wg);
  if (tid == 0) st_release(back.ret_flag(rank, e, t, j), a.seq);
}

// A consumer warpgroup: tasks from the task ring until the end.  A slot
// is released once both warpgroups have finished its task.
template <bool GATED, int STAGES, typename Q>
__device__ void ep_consume(const EpArgs& a,
                           EpSmem<STAGES, !std::is_void<Q>::value>& sm,
                           int rank, int wg, int tid) {
  hg::RingPos pos;
  unsigned n = 0;
  int q = 0;
  uint32_t qph = 0;
  for (;;) {
    hg::mbar_wait(&sm.tfull[q], qph, ep_limit(a));
    const EpTask& tk = sm.task[q];
    const int kind = tk.kind;
    if (kind == EP_END) return;
    // the activation as a constant, as in B2's epilogue
#define FM_EP_TASK(M, A) \
  ep_task<M, A, STAGES, Q>(a, sm, pos, n, tk, rank, wg, tid)
    if (kind == EP_DOWN)
      FM_EP_TASK(MODE_DOWN, ACT_RELU);
    else if (a.act == ACT_RELU)
      FM_EP_TASK(GATED ? MODE_UP_GATED : MODE_UP, ACT_RELU);
    else if (a.act == ACT_GELU)
      FM_EP_TASK(GATED ? MODE_UP_GATED : MODE_UP, ACT_GELU);
    else
      FM_EP_TASK(GATED ? MODE_UP_GATED : MODE_UP, ACT_SILU);
#undef FM_EP_TASK
    hg::mbar_arrive(&sm.tempty[q]);
    if (++q == EP_TASKS) {
      q = 0;
      qph ^= 1;
    }
  }
}

template <bool GATED, typename Q> struct EpHopper {
  static constexpr bool QUANT = !std::is_void<Q>::value;
  static constexpr int STAGES = FH_STAGES;
  typedef EpSmem<STAGES, QUANT> Smem;
  static_assert(sizeof(Smem) + 1024 <= 232448, "shared memory");
};

template <bool GATED, typename Q>
__global__ void __launch_bounds__(FH_THREADS, 1)
fused_ep_hopper(const __grid_constant__ EpArgs a) {
  typedef EpHopper<GATED, Q> H;
  extern __shared__ unsigned char ep_raw[];
  typename H::Smem& sm = hg::smem_at<typename H::Smem>(ep_raw);
  const int rank = blockIdx.x / a.G, g = blockIdx.x % a.G;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < H::STAGES; ++s) {
      // B5q: the A boxes' bytes and one arrival per consumer warpgroup's
      // converted half of the B tile
      hg::mbar_init(&sm.ring.full[s], 1 + (H::QUANT ? FH_CONSUMERS : 0));
      hg::mbar_init(&sm.ring.empty[s], FH_CONSUMERS);
    }
    if constexpr (H::QUANT)
      for (int s = 0; s < EP_PAY; ++s) {
        hg::mbar_init(&sm.q.full[s], 1);
        hg::mbar_init(&sm.q.empty[s], FH_CONSUMERS);
      }
    for (int i = 0; i < EP_TASKS; ++i) {
      hg::mbar_init(&sm.tfull[i], 1);
      hg::mbar_init(&sm.tempty[i], 128 * FH_CONSUMERS);
    }
    hg::mbar_fence_init();
  }
  __syncthreads();
  ep_barrier<bf16>(a, rank, g, threadIdx.x);
  ep_send<bf16>(a, rank, g, threadIdx.x, FH_THREADS);

  // the block holds 168 x 384 registers (__launch_bounds__): the
  // producer's and the consumers' budgets must add up to no more
  static_assert(40 * 128 + 232 * 256 <= 168 * FH_THREADS,
                "register budgets");
  if (wg == FH_CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    ep_produce<GATED, Q, H::STAGES>(a, sm, rank, tid, ep_limit(a));
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  ep_consume<GATED, H::STAGES, Q>(a, sm, rank, wg, tid);
  ep_drain<bf16>(a, rank, g, threadIdx.x, 128 * FH_CONSUMERS,
                 EP_CONSUMER_BAR);
}

// ---- host side -----------------------------------------------------------

template <typename T, bool GATED, typename Q> struct Arm {
  static const void* kernel() {
    return (const void*)fused_ep_kernel<T, GATED, Q>;
  }
  static constexpr int threads = FTHREADS;
  static size_t smem() { return 0; }
};
template <bool GATED, typename Q> struct Arm<bf16, GATED, Q> {
  static const void* kernel() {
    return (const void*)fused_ep_hopper<GATED, Q>;
  }
  static constexpr int threads = FH_THREADS;
  static size_t smem() {
    return hg::smem_bytes<typename EpHopper<GATED, Q>::Smem>();
  }
};

template <typename T, bool GATED, typename Q> int prepare() {
  typedef Arm<T, GATED, Q> A;
  if (A::smem() == 0) return 0;
  return (int)cudaFuncSetAttribute(A::kernel(),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)A::smem());
}

// The Hopper arm's maps (EpArgs::maps), encoded on the host from the
// peer table's addresses (host_peers) and copied into a.maps on the
// stream, ahead of the launch (the copy leaves the host buffer before it
// returns).
template <typename Q>
int ep_maps(const EpArgs& a, const unsigned long long* host_peers,
            cudaStream_t stream) {
  if (a.maps == nullptr || (uintptr_t)a.maps % 64)
    return (int)cudaErrorInvalidValue;
  const int E = a.D * a.nlx, rows = a.D * a.nlx * a.ch;
  const int wb = std::is_void<Q>::value ? 2 : 1;
  std::vector<CUtensorMap> m(3 + 2 * a.D);
  bool ok = fh_map_w(&m[0], a.w_up, E, a.H, a.I, wb) &&
            fh_map_w(&m[2], a.w_down, E, a.I, a.H, wb);
  if (a.w_gate != nullptr)
    ok = ok && fh_map_w(&m[1], a.w_gate, E, a.H, a.I, wb);
  else
    m[1] = m[0];
  for (int r = 0; r < a.D && ok; ++r)
    ok = fh_map_2d(&m[3 + r],
                   (const void*)host_peers[REGION_X_RECV * a.D + r], rows,
                   a.H) &&
         fh_map_2d(&m[3 + a.D + r],
                   (const void*)host_peers[REGION_HIDDEN * a.D + r], rows,
                   a.I);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyAsync((void*)a.maps, m.data(),
                              m.size() * sizeof(CUtensorMap),
                              cudaMemcpyHostToDevice, stream);
}

template <typename T, bool GATED, typename Q>
int launch(const EpArgs& a, const unsigned long long* host_peers,
           cudaStream_t stream) {
  typedef Arm<T, GATED, Q> A;
  int err = prepare<T, GATED, Q>();
  if (!err && std::is_same<T, bf16>::value)
    err = ep_maps<Q>(a, host_peers, stream);
  if (err) return err;
  EpArgs args = a;
  void* params[] = {&args};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      A::kernel(), dim3(a.D * a.G), dim3(A::threads), params, A::smem(),
      stream);
  // a refused launch ran nothing: clear it so that it does not surface at
  // the next, unrelated launch check
  if (e != cudaSuccess) (void)cudaGetLastError();
  return (int)e;
}

// occupancy is taken per instantiation: the arms differ in registers and
// shared memory
template <typename T, bool GATED, typename Q> int max_blocks(int* out) {
  typedef Arm<T, GATED, Q> A;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = (cudaError_t)prepare<T, GATED, Q>();
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, A::kernel(), A::threads, A::smem());
  *out = per_sm * sms;
  return (int)err;
}

// weight codes of the C entries: full precision, int8, e4m3
enum { W_FULL = 0, W_INT8 = 1, W_E4M3 = 2 };

// F(T, GATED, Q) for the runtime (is_bf16, gated, wq)
template <template <typename, bool, typename> class F, typename... Args>
int dispatch(int is_bf16, int gated, int wq, Args... args) {
  if (wq < W_FULL || wq > W_E4M3) return (int)cudaErrorInvalidValue;
#define FM_EP_CASE(T, G)                                            \
  if (wq == W_FULL) return F<T, G, void>::run(args...);             \
  if (wq == W_INT8) return F<T, G, int8_t>::run(args...);           \
  return F<T, G, __nv_fp8_e4m3>::run(args...);
  if (is_bf16) {
    if (gated) { FM_EP_CASE(bf16, true) }
    FM_EP_CASE(bf16, false)
  }
  if (gated) { FM_EP_CASE(float, true) }
  FM_EP_CASE(float, false)
#undef FM_EP_CASE
}

template <typename T, bool GATED, typename Q> struct Launch {
  static int run(const EpArgs& a, const unsigned long long* host_peers,
                 cudaStream_t s) {
    return launch<T, GATED, Q>(a, host_peers, s);
  }
};
template <typename T, bool GATED, typename Q> struct MaxBlocks {
  static int run(int* out) { return max_blocks<T, GATED, Q>(out); }
};

}  // namespace fm

// The most blocks of fm_fused_ep (bf16 or f32, gated or not, weights of
// code wq: 0 full precision, 1 int8, 2 e4m3) that can be resident at once
// on the current device: occupancy times the SM count (bf16: one block of
// 384 threads per SM).
extern "C" int fm_fused_ep_max_blocks(int is_bf16, int gated, int wq,
                                      int* out) {
  return fm::dispatch<fm::MaxBlocks>(is_bf16, gated, wq, out);
}

// One fused EP layer for D ranks, D * G blocks (see EpArgs for the
// layouts; order holds n_total int4 tasks a rank).  wq: the weights' code
// (0 in the input dtype; 1 int8, 2 e4m3 with f32 scales s_up, s_gate,
// s_down).  peers: the [4][D] peer table on the device; host_peers: the
// same addresses on the host; maps: bf16's device buffer of [3 + 2 D] TMA
// maps (128 bytes each, 64-byte aligned; null for f32), which the call
// encodes from host_peers and fills on the stream.  H and I must be
// multiples of 64, ch a multiple of 64 holding cap rows, the heap regions
// and weights 16-byte aligned.  Returns the launch's error; a refused
// launch runs nothing.
extern "C" int fm_fused_ep(
    int is_bf16, int gated, int wq, int act, int D, int nlx, int cap, int ch,
    int H, int I, int k, int combine, int rows_pad, int G, int n_total,
    unsigned seq, unsigned long long work_base, long long timeout_ns,
    const void* x_send, const int* send_cnt, const int* order,
    const int* recv_pos, const float* w_sorted, const void* w_up,
    const void* w_gate, const float* b_up, const void* w_down,
    const float* b_down, const float* s_up, const float* s_gate,
    const float* s_down, const unsigned long long* peers,
    const unsigned long long* host_peers, void* maps, float* out,
    cudaStream_t stream) {
  fm::EpArgs a;
  a.D = D; a.nlx = nlx; a.cap = cap; a.ch = ch; a.H = H; a.I = I; a.k = k;
  a.combine = combine; a.act = act; a.rows_pad = rows_pad; a.G = G;
  a.n_tiles = ch / fm::FBM;
  a.n_up = (I + fm::FH_COLS / (gated ? 2 : 1) - 1) / (fm::FH_COLS /
                                                       (gated ? 2 : 1));
  a.n_down = (H + fm::DOWN_COLS - 1) / fm::DOWN_COLS;
  a.n_total = n_total;
  a.seq = seq; a.work_base = work_base; a.timeout_ns = timeout_ns;
  a.x_send = x_send; a.send_cnt = send_cnt;
  a.order = (const int4*)order; a.recv_pos = recv_pos; a.w_sorted = w_sorted;
  a.w_up = w_up; a.w_gate = w_gate; a.b_up = b_up; a.w_down = w_down;
  a.b_down = b_down; a.s_up = s_up; a.s_gate = s_gate; a.s_down = s_down;
  a.peers = peers; a.maps = (const CUtensorMap*)maps; a.out = out;
  return fm::dispatch<fm::Launch>(is_bf16, gated, wq, a, host_peers, stream);
}
