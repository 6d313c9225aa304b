// Causal blockwise (flash) attention forward.
//
// Replaces the TPU kernel flashmoe_tpu/ops/attention.py:_flash_kernel
// (launched by flash_attention).  Same function: softmax(q k^T * scale)
// v with a causal mask, an online softmax in f32 over key blocks, and the
// probabilities rounded to v's dtype before P . V (accumulated in f32).
//
// What bounds it on an H100: at prefill sizes ([4, 32, 256, 128]) the
// bytes of q/k/v/o and the launch, not the operations.  Design: one block
// of 4 warps per (batch*head, 64-query block) loops over 64-key blocks up
// to the diagonal only.  bf16 takes tensor cores: each warp owns 16
// query rows, keeps its Q fragments and its [16, D] f32 output
// accumulators in registers, computes S = Q K^T with WMMA, runs the row
// softmax on S in shared memory (two lanes a row), and rescales the
// output accumulators by multiplying them element-wise with a fragment
// of the per-row factors (accumulator fragments of one shape share their
// element layout).  f32 takes the SIMT cores, one warp per query row.
// GQA is handled in the kernel: query head n reads kv head n / (N / NKV),
// so repeated kv heads are never materialised.  Key rows at or past T are
// zero-filled and masked, so T need not be a multiple of the block.
#include <mma.h>

#include "common.cuh"

namespace fm {

constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value
constexpr int ABQ = 64, ABK = 64, AWARPS = 4;
constexpr int SLD = ABK + 4;  // f32 row stride of the score tile
constexpr int PLD = ABK + 8;  // bf16 row stride of the probability tile

template <int D> struct FlashSmem {
  static constexpr int LD = D + 8;  // bf16 row stride of Q/K/V tiles
  static constexpr int BYTES =
      3 * ABQ * LD * 2 + AWARPS * 16 * SLD * 4 + AWARPS * 16 * PLD * 2 +
      AWARPS * 16 * 16 * 4;
};

// rows [row0, row0 + 64) of a [T, D] bf16 matrix into a [64][LD] tile,
// zero past T (16-byte copies)
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int T) {
  constexpr int LD = D + 8, CPR = D / 8;
  for (int c = threadIdx.x; c < ABQ * CPR; c += AWARPS * 32) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    if (row0 + r < T)
      cp_async16(dst + r * LD + cc, src + (size_t)(row0 + r) * D + cc);
    else
      *reinterpret_cast<uint4*>(dst + r * LD + cc) = make_uint4(0, 0, 0, 0);
  }
  cp_async_commit();
}

template <int D>
__global__ void __launch_bounds__(AWARPS * 32)
flash_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o, int N, int NKV,
           int T, float scale, int causal) {
  using namespace nvcuda;
  constexpr int LD = D + 8, ND = D / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + ABQ * LD;
  bf16* Vs = Ks + ABK * LD;
  float* Ss = reinterpret_cast<float*>(Vs + ABK * LD);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + AWARPS * 16 * SLD);
  float* Fs = reinterpret_cast<float*>(Ps + AWARPS * 16 * PLD);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, b = bh / N, n = bh % N;
  const int kvh = n / (N / NKV);
  const int q0 = blockIdx.x * ABQ;
  const bf16* qb = q + (size_t)bh * T * D;
  const bf16* kb = k + (size_t)(b * NKV + kvh) * T * D;
  const bf16* vb = v + (size_t)(b * NKV + kvh) * T * D;
  float* Sw = Ss + warp * 16 * SLD;
  bf16* Pw = Ps + warp * 16 * PLD;
  float* Fw = Fs + warp * 16 * 16;

  load_rows<D>(Qs, qb, q0, T);
  cp_async_wait<0>();
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d)
    wmma::load_matrix_sync(qf[d], Qs + warp * 16 * LD + d * 16, LD);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) wmma::fill_fragment(of[d], 0.f);

  // lanes 2r and 2r+1 own row r of the warp's 16 rows, 32 columns each
  const int r = lane >> 1, half = lane & 1;
  const int qrow = q0 + warp * 16 + r;
  float m_i = NEG_INF, l_i = 0.f;

  const int nkb_all = (T + ABK - 1) / ABK;
  const int nkb = causal ? min(nkb_all, (q0 + ABQ - 1) / ABK + 1) : nkb_all;
  for (int kbi = 0; kbi < nkb; ++kbi) {
    const int k0 = kbi * ABK;
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_rows<D>(Ks, kb, k0, T);
    load_rows<D>(Vs, vb, k0, T);
    cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int j = 0; j < ABK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + j * 16 * LD + d * 16, LD);
        wmma::mma_sync(sf, qf[d], kf, sf);
      }
      wmma::store_matrix_sync(Sw + j * 16, sf, SLD, wmma::mem_row_major);
    }
    __syncwarp();

    float mx = NEG_INF;
    for (int c = half * 32; c < half * 32 + 32; ++c) {
      const int key = k0 + c;
      float s = Sw[r * SLD + c] * scale;
      if (key >= T || (causal && key > qrow)) s = NEG_INF;
      Sw[r * SLD + c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float sum = 0.f;
    for (int c = half * 32; c < half * 32 + 32; ++c) {
      const float p = expf(Sw[r * SLD + c] - m_new);
      sum += p;  // the row sum uses p before rounding, as on the TPU
      Pw[r * PLD + c] = __float2bfloat16_rn(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = l_i * alpha + sum;
    m_i = m_new;
#pragma unroll
    for (int c = 0; c < 8; ++c) Fw[r * 16 + half * 8 + c] = alpha;
    __syncwarp();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> af;
    wmma::load_matrix_sync(af, Fw, 16, wmma::mem_row_major);
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf[ABK / 16];
#pragma unroll
    for (int kk = 0; kk < ABK / 16; ++kk)
      wmma::load_matrix_sync(pf[kk], Pw + kk * 16, PLD);
#pragma unroll
    for (int d = 0; d < ND; ++d) {
#pragma unroll
      for (int t = 0; t < of[d].num_elements; ++t) of[d].x[t] *= af.x[t];
#pragma unroll
      for (int kk = 0; kk < ABK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, Vs + kk * 16 * LD + d * 16, LD);
        wmma::mma_sync(of[d], pf[kk], vf, of[d]);
      }
    }
    __syncwarp();
  }

  const float inv = 1.f / fmaxf(l_i, 1e-30f);
#pragma unroll
  for (int c = 0; c < 8; ++c) Fw[r * 16 + half * 8 + c] = inv;
  __syncwarp();
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> af;
  wmma::load_matrix_sync(af, Fw, 16, wmma::mem_row_major);
  bf16* ob = o + (size_t)bh * T * D;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
#pragma unroll
    for (int t = 0; t < of[d].num_elements; ++t) of[d].x[t] *= af.x[t];
    wmma::store_matrix_sync(Sw, of[d], SLD, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const int rr = i / 16, cc = i % 16, row = q0 + warp * 16 + rr;
      if (row < T)
        ob[(size_t)row * D + d * 16 + cc] = __float2bfloat16_rn(Sw[rr * SLD + cc]);
    }
    __syncwarp();
  }
}

// f32: one warp per query row, 8 rows a block, 32-key tiles in shared
// memory; lane j scores key j of the tile, lanes split D for P . V.
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
  if (is_bf16) {
    const int bytes = FlashSmem<D>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((T + ABQ - 1) / ABQ, B * N);
    flash_bf16<D><<<grid, AWARPS * 32, bytes, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, N, NKV, T,
        scale, causal);
  } else {
    const dim3 grid((T + F32_ROWS - 1) / F32_ROWS, B * N);
    flash_f32<D><<<grid, F32_ROWS * 32, 0, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, N, NKV,
        T, scale, causal);
  }
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
