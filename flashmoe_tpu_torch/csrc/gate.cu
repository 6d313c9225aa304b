// Fused MoE gate: logits GEMM + softmax + top-k + routing statistics.
//
// Replaces the TPU kernel flashmoe_tpu/ops/gate.py:_gate_kernel (launched
// by router_pallas).  Same function: f32 logits x . gate_w, softmax over
// the E experts, iterative top-k in which the lowest index wins ties, and
// the three statistics the losses need: per-expert sums of softmax
// probabilities, per-expert selection counts and the sum of squared
// log-sum-exps (z-loss).
//
// What bounds it on an H100: the bytes of x ([S, H] read once); at E <= 256
// the f32 FMAs (2*S*H*E) stay below the card's SIMT rate for that traffic.
// Design: one block of 256 threads routes GT = 16 tokens.  gate_w streams
// through shared memory in GHC-row chunks shared by the block's tokens;
// each thread keeps up to 16 logits of one token in registers.  Softmax
// and top-k run one warp per token.  On the TPU the statistics were a sum
// carried from one grid step to the next; blocks here run in no order, so
// each block writes its partial sums and a second one-block launch adds
// them in block order: the sums do not depend on scheduling, and the
// integer counts are exact.
#include "common.cuh"

namespace fm {

constexpr int GT = 16;       // tokens per block
constexpr int GHC = 32;      // rows of gate_w per shared-memory chunk
constexpr int GEMAX = 256;   // most experts one pass handles
constexpr int GKMAX = 32;    // most experts a token selects
constexpr int GTHREADS = 256;

template <typename T>
__global__ void __launch_bounds__(GTHREADS)
gate_main(const T* __restrict__ x, const T* __restrict__ w, int S, int H,
          int E, int K, float* __restrict__ top_p, int* __restrict__ top_i,
          float* __restrict__ part_probs, int* __restrict__ part_cnt,
          float* __restrict__ part_z) {
  __shared__ float xs[GT][GHC + 1];
  __shared__ float ws[GHC * GEMAX];  // gate_w chunk, later logits/probs
  __shared__ int tsel[GT][GKMAX];
  __shared__ float zrow[GT];

  const int tid = threadIdx.x;
  const int t = tid / 16, l16 = tid % 16;
  const int s0 = blockIdx.x * GT;

  float acc[GEMAX / 16];
#pragma unroll
  for (int j = 0; j < GEMAX / 16; ++j) acc[j] = 0.f;

  for (int h0 = 0; h0 < H; h0 += GHC) {
    for (int i = tid; i < GT * GHC; i += GTHREADS) {
      const int r = i / GHC, c = i % GHC, s = s0 + r;
      xs[r][c] = (s < S) ? to_f(x[(size_t)s * H + h0 + c]) : 0.f;
    }
    for (int i = tid; i < GHC * E; i += GTHREADS)
      ws[i] = to_f(w[(size_t)h0 * E + i]);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < GEMAX / 16; ++j) {
      const int e = l16 + 16 * j;
      if (e < E) {
        float a = acc[j];
#pragma unroll 8
        for (int c = 0; c < GHC; ++c) a = fmaf(xs[t][c], ws[c * E + e], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

  float* lg = ws;  // [GT][E] logits, then probabilities
#pragma unroll
  for (int j = 0; j < GEMAX / 16; ++j) {
    const int e = l16 + 16 * j;
    if (e < E) lg[t * E + e] = acc[j];
  }
  __syncthreads();

  const int wid = tid / 32, lane = tid % 32;
  for (int tt = wid; tt < GT; tt += GTHREADS / 32) {
    const int s = s0 + tt;
    float* row = lg + tt * E;
    float m = -INFINITY;
    for (int e = lane; e < E; e += 32) m = fmaxf(m, row[e]);
    m = warp_max(m);
    float se = 0.f;
    for (int e = lane; e < E; e += 32) {
      const float ex = expf(row[e] - m);
      row[e] = ex;
      se += ex;
    }
    se = warp_sum(se);
    for (int e = lane; e < E; e += 32) row[e] = row[e] / se;
    __syncwarp();
    for (int kk = 0; kk < K; ++kk) {
      float bv = -1.f;  // probabilities are >= 0
      int bi = E;
      for (int e = lane; e < E; e += 32) {
        bool taken = false;
        for (int q = 0; q < kk; ++q) taken |= (tsel[tt][q] == e);
        const float v = row[e];
        if (!taken && v > bv) {  // e rises, so the lowest index stays
          bv = v;
          bi = e;
        }
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        tsel[tt][kk] = bi;
        if (s < S) {
          top_p[(size_t)s * K + kk] = bv;
          top_i[(size_t)s * K + kk] = bi;
        }
      }
      __syncwarp();
    }
    if (lane == 0) {
      const float lse = m + logf(se);
      zrow[tt] = (s < S) ? lse * lse : 0.f;
    }
  }
  __syncthreads();

  const int nvalid = min(GT, S - s0);
  for (int e = tid; e < E; e += GTHREADS) {
    float p = 0.f;
    int c = 0;
    for (int tt = 0; tt < nvalid; ++tt) {
      p += lg[tt * E + e];
      for (int kk = 0; kk < K; ++kk) c += (tsel[tt][kk] == e);
    }
    part_probs[(size_t)blockIdx.x * E + e] = p;
    part_cnt[(size_t)blockIdx.x * E + e] = c;
  }
  if (tid == 0) {
    float z = 0.f;
    for (int tt = 0; tt < nvalid; ++tt) z += zrow[tt];
    part_z[blockIdx.x] = z;
  }
}

// Adds the per-block partials in block order (deterministic); the
// two-pass gate's pass 2 (gate_tiled.cu) reduces its partials here too.
__global__ void gate_reduce(const float* __restrict__ part_probs,
                            const int* __restrict__ part_cnt,
                            const float* __restrict__ part_z, int nb, int E,
                            float* __restrict__ probs_sum,
                            int* __restrict__ counts,
                            float* __restrict__ zsum) {
  for (int e = threadIdx.x; e <= E; e += blockDim.x) {
    if (e < E) {
      float p = 0.f;
      int c = 0;
      for (int b = 0; b < nb; ++b) {
        p += part_probs[(size_t)b * E + e];
        c += part_cnt[(size_t)b * E + e];
      }
      probs_sum[e] = p;
      counts[e] = c;
    } else {
      float z = 0.f;
      for (int b = 0; b < nb; ++b) z += part_z[b];
      *zsum = z;
    }
  }
}

int gate_reduce_launch(const float* part_probs, const int* part_cnt,
                       const float* part_z, int nb, int E, float* probs_sum,
                       int* counts, float* zsum, cudaStream_t stream) {
  gate_reduce<<<1, 256, 0, stream>>>(part_probs, part_cnt, part_z, nb, E,
                                     probs_sum, counts, zsum);
  return (int)cudaGetLastError();
}

}  // namespace fm

// Scratch: part_probs f32 [nb, E], part_counts i32 [nb, E], part_z f32
// [nb] with nb = ceil(S / 16).  Needs S >= 1, H % 32 == 0, E <= 256,
// K <= min(E, 32).
extern "C" int fm_gate(int is_bf16, const void* x, const void* w, int S,
                       int H, int E, int K, float* top_p, int* top_i,
                       float* part_probs, int* part_cnt, float* part_z,
                       float* probs_sum, int* counts, float* zsum,
                       cudaStream_t stream) {
  const int nb = (S + fm::GT - 1) / fm::GT;
  if (is_bf16)
    fm::gate_main<fm::bf16><<<nb, fm::GTHREADS, 0, stream>>>(
        (const fm::bf16*)x, (const fm::bf16*)w, S, H, E, K, top_p, top_i,
        part_probs, part_cnt, part_z);
  else
    fm::gate_main<float><<<nb, fm::GTHREADS, 0, stream>>>(
        (const float*)x, (const float*)w, S, H, E, K, top_p, top_i,
        part_probs, part_cnt, part_z);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return fm::gate_reduce_launch(part_probs, part_cnt, part_z, nb, E,
                                probs_sum, counts, zsum, stream);
}
