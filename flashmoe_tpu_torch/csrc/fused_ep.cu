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
//            src_order and the schedule.  An up task (source, local
//            expert, row tile, group of 256 hidden columns) waits for the
//            tile's dispatch flag, writes its hidden columns to the rank's
//            scratch and raises its own up flag; a down task (..., group
//            of 256 output columns) waits for all up flags of its tile,
//            stores its columns of the populated rows into the source's
//            y_back[r][e] (combine off) or at their token-sorted rows
//            recv_pos[r][src][e][slot] of its return buffer (combine on),
//            then raises the source's return flag of (r, e, tile, group);
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
// memory (gemm_tile.cuh QuantB: (payload.f32 * scale) rounded once to the
// input dtype), so the FFN computes exactly as on weights dequantized
// beforehand, while each weight element streams 1 byte from HBM.  The
// flags, the task list and every phase stay as they are.
// Counts are clamped to the slabs' capacity; rank r receives from source s
// the rows s sends it, send_cnt[s][r][e], so the two sides cannot disagree.
//
// Transport.  Each rank owns an identically laid-out symmetric heap of four
// regions: x_recv [D][nlx][ch][H], the return buffer (y_back
// [D][nlx][ch][H] or y_sorted [rows_pad][H]), its hidden scratch
// [D][nlx][ch][I] and its flag words (barrier counter, work counter,
// dispatch, up and return flags).  The kernel reaches rank p's regions
// through the peer table only (peers[region][p]).  Here they are slices of
// allocations on one card (virtual ranks): the data regions are allocated
// for each call, the flag words persist across calls.  Peer heaps mapped
// from other GPUs over CUDA IPC would serve the same kernel body.  A flag
// is a release store (after __threadfence()) of the call's sequence number,
// read by an acquire load in a __nanosleep spin loop, at system scope so
// that it holds across GPUs too; flags are never reset, so a flag left by
// an earlier call never satisfies a wait (the wrapper advances the
// sequence number only for a launch that was accepted).  A wait that
// spins past timeout_ns prints what it waited for and traps: a protocol
// fault fails loudly instead of hanging.  Data written by other blocks is
// read from L2 only (cp.async.cg, __ldcg).
//
// Co-residency.  Every block may wait on others, so all D * G blocks
// (block b serves rank b / G) must be resident at once: the kernel is
// launched cooperatively, which refuses a grid that could not be, and the
// wrapper sizes G from the occupancy calculator.  Phase 2 hands out tasks
// through the rank's work counter; each block stops at its first grab past
// the end, so a call adds exactly n_total + G to it and the wrapper passes
// the running base.
//
// What bounds it on an H100: at the FlashMoE reference layer (E 64, ep 8,
// capacity 32) the bytes (weights once, the slabs moved four times); at
// Mixtral widths (ep 8, one 352 MB expert per rank, capacity 1024) the
// tensor-core operations; a quantized store halves the weight bytes of a
// bf16 one.  Design: a task is a 64 x 256 strip of one
// tile's hidden (up) or output (down), four of gemm_tile.cuh's 64 x 64
// tiles, so that a few tiles still fill the card; the host lists each
// unit's up tasks before its down tasks, weight-column group by group
// across the unit's tiles, so the blocks running together share the
// weight columns in L2, and a down task is handed out only after every up
// task it waits for (no deadlock).  A capacity below 64 rows computes a
// full tile: rows are independent, and the rows past the count are never
// returned.
#include <cstdio>
#include <type_traits>

#include "gemm_tile.cuh"

namespace fm {

struct EpArgs {
  int D, nlx, cap, ch, H, I, k, combine, act, rows_pad, G, n_tiles,
      n_total, grp, n_up, n_down;
  unsigned seq;
  unsigned long long work_base;
  long long timeout_ns;
  const void* x_send;    // [D][D][nlx][cap][H]
  const int* send_cnt;   // [D][D][nlx]: rows rank r sends (dst, e)
  const int2* order;     // [D][n_total] tasks: ((src*nlx + e)*n_tiles +
                         // tile, kind << 16 | column group), kind 1 down
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
  __device__ T* x_recv(int src, int e, int t) const {
    return (T*)region(REGION_X_RECV) +
           ((size_t)(src * a->nlx + e) * a->ch + t * FBM) * a->H;
  }
  __device__ T* ret() const { return (T*)region(REGION_RET); }
  __device__ T* hidden(int src, int e, int t) const {
    return (T*)region(REGION_HIDDEN) +
           ((size_t)(src * a->nlx + e) * a->ch + t * FBM) * a->I;
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
  const int D = a.D, nlx = a.nlx, nt = a.n_tiles, H = a.H, I = a.I;
  const Heap<T> own(a, rank);

  // ---- phase 0: barrier ----
  if (D > 1) {
    if (g == 0 && tid < D && tid != rank) {
      __threadfence_system();
      atomicAdd_system(Heap<T>(a, tid).barrier(), 1u);
    }
    if (tid == 0)
      wait_for(a, own.barrier(), a.seq * (unsigned)(D - 1), WAIT_BARRIER,
               rank, -1, -1, -1);
    __syncthreads();
  }

  // ---- phase 1: send every occupied tile, own slab first ----
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
    for (int i = tid; i < n16; i += FTHREADS) to[i] = from[i];
    __syncthreads();
    if (tid == 0) {
      __threadfence_system();
      st_release(peer.disp_flag(rank, e, t), a.seq);
    }
  }

  // ---- phase 2: tasks in the host's order, handed out by the counter ----
  for (;;) {
    if (tid == 0) s_idx = atomicAdd(own.work(), 1ull) - a.work_base;
    __syncthreads();
    const unsigned long long idx = s_idx;
    __syncthreads();
    if (idx >= (unsigned long long)a.n_total) break;
    const int2 task = a.order[(size_t)rank * a.n_total + idx];
    const int src = task.x / per_dst, e = (task.x / nt) % nlx,
              t = task.x % nt;
    const bool down = task.y >> 16;
    const int j = task.y & 0xffff;
    const int rows = min(FBM, sent_rows(a, src, rank, e) - t * FBM);
    if (rows <= 0) continue;
    const size_t ge = (size_t)rank * nlx + e;  // global expert
    T* hid = own.hidden(src, e, t);
    if (!down) {
      if (tid == 0)
        wait_for(a, own.disp_flag(src, e, t), a.seq, WAIT_DISPATCH, rank,
                 src, e, t);
      __syncthreads();
      const T* xt = own.x_recv(src, e, t);
      const int c_end = min((j + 1) * a.grp, I / FBN);
      for (int n0 = j * a.grp * FBN; n0 < c_end * FBN; n0 += FBN) {
        weight_tile<T, Q, NB>(xt, H, a.w_up, a.w_gate, a.s_up, a.s_gate,
                              ge * H * I + n0, ge * I + n0, I, Cs);
        __syncthreads();
        const float* bias = a.b_up + ge * I + n0;
        for (int i = tid; i < FBM * FBN; i += FTHREADS) {
          const int r = i / FBN, c = i % FBN;
          float v = Cs[r * LDC + c] + bias[c];
          if (GATED)
            v = act_f(Cs[FBM * LDC + r * LDC + c], a.act) * v;
          else
            v = act_f(v, a.act);
          hid[(size_t)r * I + n0 + c] = from_f<T>(v);
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
      wait_for(a, own.up_flag(src, e, t, i), a.seq, WAIT_UP, rank, src, e,
               t);
    __syncthreads();
    const Heap<T> back(a, src);
    const int* pos =
        a.combine ? a.recv_pos + ((size_t)(rank * D + src) * nlx + e) *
                                     a.cap + t * FBM
                  : nullptr;
    const int c_end = min((j + 1) * a.grp, H / FBN);
    for (int n0 = j * a.grp * FBN; n0 < c_end * FBN; n0 += FBN) {
      weight_tile<T, Q, 1>(hid, I, a.w_down, nullptr, a.s_down, nullptr,
                           ge * I * H + n0, ge * H + n0, H, Cs);
      __syncthreads();
      const float* bias = a.b_down + ge * H + n0;
      for (int i = tid; i < rows * FBN; i += FTHREADS) {
        const int r = i / FBN, c = i % FBN;
        const size_t row =
            a.combine ? (size_t)pos[r]
                      : (size_t)(rank * nlx + e) * a.ch + t * FBM + r;
        back.ret()[row * H + n0 + c] = from_f<T>(Cs[r * LDC + c] + bias[c]);
      }
      __syncthreads();
    }
    if (tid == 0) {
      __threadfence_system();
      st_release(back.ret_flag(rank, e, t, j), a.seq);
    }
  }

  // ---- phase 3: drain every return, then the k-row combine ----
  for (int i = tid; i < D * per_dst * a.n_down; i += FTHREADS) {
    const int tile = i / a.n_down, j = i % a.n_down;
    const int dst = tile / per_dst, e = (tile % per_dst) / nt,
              t = tile % nt;
    if (t * FBM < sent_rows(a, rank, dst, e))
      wait_for(a, own.ret_flag(dst, e, t, j), a.seq, WAIT_RETURN, rank,
               dst, e, t);
  }
  __syncthreads();
  if (!a.combine) return;
  const int s_out = a.rows_pad / a.k;
  const T* ys = own.ret();
  const float* ws = a.w_sorted + (size_t)rank * a.rows_pad;
  float* o = a.out + (size_t)rank * s_out * H;
  for (int tok = g; tok < s_out; tok += a.G)
    for (int h = tid; h < H; h += FTHREADS) {
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

template <typename T, bool GATED, typename Q>
int launch(const EpArgs& a, cudaStream_t stream) {
  EpArgs args = a;
  void* params[] = {&args};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)fused_ep_kernel<T, GATED, Q>, dim3(a.D * a.G),
      dim3(FTHREADS), params, 0, stream);
  // a refused launch ran nothing: clear it so that it does not surface at
  // the next, unrelated launch check
  if (err != cudaSuccess) (void)cudaGetLastError();
  return (int)err;
}

// occupancy is taken per instantiation: the arms differ in registers
template <typename T, bool GATED, typename Q> int max_blocks(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_ep_kernel<T, GATED, Q>, FTHREADS, 0);
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
  static int run(const EpArgs& a, cudaStream_t s) {
    return launch<T, GATED, Q>(a, s);
  }
};
template <typename T, bool GATED, typename Q> struct MaxBlocks {
  static int run(int* out) { return max_blocks<T, GATED, Q>(out); }
};

}  // namespace fm

// The most blocks of fm_fused_ep (bf16 or f32, gated or not, weights of
// code wq: 0 full precision, 1 int8, 2 e4m3) that can be resident at once
// on the current device: occupancy times the SM count.
extern "C" int fm_fused_ep_max_blocks(int is_bf16, int gated, int wq,
                                      int* out) {
  return fm::dispatch<fm::MaxBlocks>(is_bf16, gated, wq, out);
}

// One fused EP layer for D ranks, D * G blocks, tasks of grp 64-column
// chunks (see EpArgs for the layouts).  wq: the weights' code (0 in the
// input dtype; 1 int8, 2 e4m3 with f32 scales s_up, s_gate, s_down).  H
// and I must be multiples of 64, ch a multiple of 64 holding cap rows, the
// heap regions and weights 16-byte aligned, order 8-byte aligned.  Returns
// the launch's error; a refused launch runs nothing.
extern "C" int fm_fused_ep(
    int is_bf16, int gated, int wq, int act, int D, int nlx, int cap, int ch,
    int H, int I, int k, int combine, int rows_pad, int G, int grp,
    unsigned seq, unsigned long long work_base, long long timeout_ns,
    const void* x_send, const int* send_cnt, const int* order,
    const int* recv_pos, const float* w_sorted, const void* w_up,
    const void* w_gate, const float* b_up, const void* w_down,
    const float* b_down, const float* s_up, const float* s_gate,
    const float* s_down, const unsigned long long* peers, float* out,
    cudaStream_t stream) {
  fm::EpArgs a;
  a.D = D; a.nlx = nlx; a.cap = cap; a.ch = ch; a.H = H; a.I = I; a.k = k;
  a.combine = combine; a.act = act; a.rows_pad = rows_pad; a.G = G;
  a.n_tiles = ch / fm::FBM;
  a.grp = grp;
  a.n_up = (I / fm::FBN + grp - 1) / grp;
  a.n_down = (H / fm::FBN + grp - 1) / grp;
  a.n_total = D * nlx * a.n_tiles * (a.n_up + a.n_down);
  a.seq = seq; a.work_base = work_base; a.timeout_ns = timeout_ns;
  a.x_send = x_send; a.send_cnt = send_cnt;
  a.order = (const int2*)order; a.recv_pos = recv_pos; a.w_sorted = w_sorted;
  a.w_up = w_up; a.w_gate = w_gate; a.b_up = b_up; a.w_down = w_down;
  a.b_down = b_down; a.s_up = s_up; a.s_gate = s_gate; a.s_down = s_down;
  a.peers = peers; a.out = out;
  return fm::dispatch<fm::Launch>(is_bf16, gated, wq, a, stream);
}
