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
// cores and the bytes take about as long (~17 us each); pass 2 reads the
// logits once and is bound by bytes.
// Design: pass 1 is one block of 128 threads per 64-token tile, looping
// over 64-wide expert tiles; each tile's logits come from the grouped
// GEMM tile of gemm_tile.cuh into shared memory (WMMA with f32
// accumulators for bf16; f32 FMAs for f32, where TF32 would miss the f32
// tolerance).  The TPU kept (m, se) and the top-k in VMEM scratch across
// its sequential grid; here the expert loop runs inside the block, so
// (m, se) stay in the registers of the two threads that own a token row,
// and the carried top-k (K <= 64) stays in shared memory, where one thread
// a row inserts the tile's logits in expert order.  A logit enters a full
// list only when strictly above its K-th entry, and moves up only past
// strictly smaller ones, so of two equal logits the lower id ranks first.
// Pass 2 writes per-token-tile partial sums, and gate.cu's one-block
// reduction adds them in tile order, as the single-tile gate does: no
// atomics, a fixed order of summation, exact integer counts.
#include "gemm_tile.cuh"

namespace fm {

// gate.cu: adds per-block partials in block order
int gate_reduce_launch(const float* part_probs, const int* part_cnt,
                       const float* part_z, int nb, int E, float* probs_sum,
                       int* counts, float* zsum, cudaStream_t stream);

constexpr int P1_ROWS = FBM;   // tokens per pass-1 block
constexpr int P2_ROWS = 32;    // tokens per pass-2 block
constexpr int P2_THREADS = 256;
constexpr int TILED_KMAX = 64;  // the merge of 2K candidates, 2K <= 128

template <typename T>
__global__ void __launch_bounds__(FTHREADS)
gate_pass1(const T* __restrict__ x, const T* __restrict__ w, int S, int H,
           int E, int PX, int K, float* __restrict__ logits,
           float* __restrict__ m_out, float* __restrict__ se_out,
           float* __restrict__ top_p, int* __restrict__ top_i) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Cs = reinterpret_cast<float*>(smem);  // GEMM operands, then logits
  float* tv = reinterpret_cast<float*>(smem + FFN_SMEM);  // [64][K]
  int* ti = reinterpret_cast<int*>(tv + P1_ROWS * K);     // [64][K]
  constexpr int LDC = FfnTile<T>::LDC;

  const int tid = threadIdx.x;
  const int r = tid >> 1, half = tid & 1;  // two threads a token row
  const int s0 = blockIdx.x * P1_ROWS;
  float* v = tv + r * K;
  int* id = ti + r * K;
  float m_run = -1e30f, se_run = 0.f;  // the TPU kernel's initial values
  int n = 0;  // filled entries of the row's top-k (thread half == 0)

  for (int e0 = 0; e0 < E; e0 += FBN) {
    const T* B[1] = {w + e0};
    ffn_mainloop<1, false>(x + (size_t)s0 * H, H, B, PX, Cs);
    __syncthreads();
    const int ne = min(FBN, E - e0);  // columns past E are padding
    if (logits != nullptr)
      for (int i = tid; i < P1_ROWS * FBN; i += FTHREADS) {
        const int rr = i / FBN, c = i % FBN;
        if (c < ne && s0 + rr < S)
          logits[(size_t)(s0 + rr) * E + e0 + c] = Cs[rr * LDC + c];
      }
    const float* row = Cs + r * LDC;
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
    for (int kk = 0; kk < K; ++kk) {
      top_p[(size_t)s * K + kk] = expf(v[kk] - m_run) / den;
      top_i[(size_t)s * K + kk] = id[kk];
    }
  }
}

__global__ void __launch_bounds__(P2_THREADS)
gate_pass2(const float* __restrict__ logits, const float* __restrict__ m,
           const float* __restrict__ se, const int* __restrict__ top_i,
           int S, int E, int K, float* __restrict__ part_probs,
           int* __restrict__ part_cnt, float* __restrict__ part_z) {
  __shared__ float ms[P2_ROWS], den[P2_ROWS];
  __shared__ int ids[P2_ROWS * TILED_KMAX];
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * P2_ROWS, nvalid = min(P2_ROWS, S - s0);
  for (int i = tid; i < nvalid; i += P2_THREADS) {
    ms[i] = m[s0 + i];
    den[i] = fmaxf(se[s0 + i], 1e-30f);
  }
  for (int i = tid; i < nvalid * K; i += P2_THREADS)
    ids[i] = top_i[(size_t)s0 * K + i];
  __syncthreads();
  const float* L = logits + (size_t)s0 * E;
  for (int e = tid; e < E; e += P2_THREADS) {
    float p = 0.f;
    int c = 0;
#pragma unroll 8
    for (int rr = 0; rr < nvalid; ++rr)
      p += expf(L[(size_t)rr * E + e] - ms[rr]) / den[rr];
    for (int i = 0; i < nvalid * K; ++i) c += (ids[i] == e);
    part_probs[(size_t)blockIdx.x * E + e] = p;
    part_cnt[(size_t)blockIdx.x * E + e] = c;
  }
  if (tid == 0) {  // the z-loss term once per token
    float z = 0.f;
    for (int rr = 0; rr < nvalid; ++rr) {
      const float lse = ms[rr] + logf(den[rr]);
      z += lse * lse;
    }
    part_z[blockIdx.x] = z;
  }
}

template <typename T>
int pass1_launch(const void* x, const void* w, int S, int H, int E, int PX,
                 int K, float* logits, float* m, float* se, float* top_p,
                 int* top_i, cudaStream_t stream) {
  const int bytes = FFN_SMEM + 2 * P1_ROWS * K * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gate_pass1<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int nb = (S + P1_ROWS - 1) / P1_ROWS;
  gate_pass1<T><<<nb, FTHREADS, bytes, stream>>>(
      (const T*)x, (const T*)w, S, H, E, PX, K, logits, m, se, top_p, top_i);
  return (int)cudaGetLastError();
}

}  // namespace fm

// x [ceil(S / 64) * 64, H] (rows past S are read, never reported), w
// [H, PX] with PX a multiple of 64 >= E (columns past E are ignored);
// H % 64 == 0, 1 <= K <= min(E, 64).  Outputs: logits f32 [S, E] (null:
// not written), m and se f32 [S], top_p f32 [S, K], top_i i32 [S, K].
extern "C" int fm_gate_pass1(int is_bf16, const void* x, const void* w,
                             int S, int H, int E, int PX, int K,
                             float* logits, float* m, float* se,
                             float* top_p, int* top_i, cudaStream_t stream) {
  if (K < 1 || K > fm::TILED_KMAX || K > E) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return fm::pass1_launch<fm::bf16>(x, w, S, H, E, PX, K, logits, m, se,
                                      top_p, top_i, stream);
  return fm::pass1_launch<float>(x, w, S, H, E, PX, K, logits, m, se, top_p,
                                 top_i, stream);
}

// logits f32 [S, E], m and se f32 [S], top_i i32 [S, K] (K <= 64).
// Scratch: part_probs f32 [nb, E], part_cnt i32 [nb, E], part_z f32 [nb]
// with nb = ceil(S / 32).  Outputs: probs_sum f32 [E], counts i32 [E],
// zsum f32 [].
extern "C" int fm_gate_pass2(const float* logits, const float* m,
                             const float* se, const int* top_i, int S, int E,
                             int K, float* part_probs, int* part_cnt,
                             float* part_z, float* probs_sum, int* counts,
                             float* zsum, cudaStream_t stream) {
  if (K < 1 || K > fm::TILED_KMAX) return (int)cudaErrorInvalidValue;
  const int nb = (S + fm::P2_ROWS - 1) / fm::P2_ROWS;
  fm::gate_pass2<<<nb, fm::P2_THREADS, 0, stream>>>(
      logits, m, se, top_i, S, E, K, part_probs, part_cnt, part_z);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return fm::gate_reduce_launch(part_probs, part_cnt, part_z, nb, E,
                                probs_sum, counts, zsum, stream);
}
