// Grouped expert FFN over expert-sorted rows.
//
// Replaces the TPU kernel flashmoe_tpu/ops/expert.py:_ffn_kernel
// (launched by grouped_ffn).  Same function: each row tile t of x [T, H]
// belongs to expert tile_gid[t]; its rows go through that expert's
// up GEMM (and gate GEMM when gated), an f32 bias and activation
// (act(g) * (up + b_up) when gated), the hidden activations rounded to
// x's dtype, the down GEMM accumulated in f32, + b_down, rounded to x's
// dtype.
//
// What bounds it on an H100: the expert weights.  Every row tile streams
// its expert's w_up/w_gate/w_down once, so at decode and prefill sizes the
// bytes of the weights (2.8 GB a Mixtral layer) bound it, not the
// tensor-core operations.  Design: the TPU kernel held a whole [bm, H]
// f32 accumulator in VMEM across I-chunks; a [bm, 4096] f32 tile does not
// fit one block's registers or shared memory here, so the FFN is two
// grouped GEMM launches that read tile_gid per row tile:
//   1. hidden[T, I] = act(x @ w_gate[e]) * (x @ w_up[e] + b_up[e]), written
//      in x's dtype (exactly the TPU kernel's rounding point),
//   2. out[T, H] = hidden @ w_down[e] + b_down[e].
// Each launch tiles its output in 64 x 64 blocks of 4 warps; bf16 tiles go
// through tensor cores (WMMA 16x16x16, f32 accumulators), f32 tiles
// through FMA on the SIMT cores.  Operand tiles arrive by 16-byte cp.async
// copies, two stages deep.  Row tiles are the fastest grid axis, so the
// row tiles of one expert run side by side and share each weight tile in
// L2.  Row tiles at or past *num_rows (the ragged plan's padded tail) skip
// their GEMMs and write zeros.
#include <mma.h>
#include <type_traits>

#include "common.cuh"

namespace fm {

constexpr int FBM = 64, FBN = 64, FTHREADS = 128;
enum { MODE_UP = 0, MODE_UP_GATED = 1, MODE_DOWN = 2 };

template <typename T> struct FfnTile {
  static constexpr int BK = 64 / (int)sizeof(T);  // 64 bytes of a row
  static constexpr int PAD = 16 / (int)sizeof(T);
  static constexpr int LDA = BK + PAD;
  static constexpr int LDB = FBN + PAD;
  static constexpr int LDC = FBN + 4;
};

constexpr int FFN_SMEM = 2 * FBM * (FBN + 4) * 4;  // Cs for two outputs

template <typename T, int NB>
struct FfnSmem {
  T As[2][FBM][FfnTile<T>::LDA];
  T Bs[2][NB][FfnTile<T>::BK][FfnTile<T>::LDB];
};

template <typename T, int NB>
__device__ __forceinline__ void ffn_load(FfnSmem<T, NB>& sm, int st,
                                         const T* A, int K,
                                         const T* const* B, int N, int k0) {
  using TL = FfnTile<T>;
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int ACPR = TL::BK / EPC;
  constexpr int BCPR = FBN / EPC;
  const int tid = threadIdx.x;
  for (int c = tid; c < FBM * ACPR; c += FTHREADS) {
    const int r = c / ACPR, cc = (c % ACPR) * EPC;
    cp_async16(&sm.As[st][r][cc], A + (size_t)r * K + k0 + cc);
  }
#pragma unroll
  for (int m = 0; m < NB; ++m)
    for (int c = tid; c < TL::BK * BCPR; c += FTHREADS) {
      const int r = c / BCPR, cc = (c % BCPR) * EPC;
      cp_async16(&sm.Bs[st][m][r][cc], B[m] + (size_t)(k0 + r) * N + cc);
    }
  cp_async_commit();
}

// bf16: tensor cores.  Warp w owns the 32 x 32 output quadrant
// (w / 2, w % 2) as 2 x 2 WMMA accumulators per output matrix.
template <int NB>
__device__ void ffn_mainloop(const bf16* A, int K, const bf16* const* B,
                             int N, float* Cs) {
  using namespace nvcuda;
  using TL = FfnTile<bf16>;
  FfnSmem<bf16, NB>& sm = *reinterpret_cast<FfnSmem<bf16, NB>*>(Cs);
  const int warp = threadIdx.x / 32, wm = warp >> 1, wn = warp & 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NB][2][2];
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[m][i][j], 0.f);

  const int nk = K / TL::BK;
  ffn_load<bf16, NB>(sm, 0, A, K, B, N, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      ffn_load<bf16, NB>(sm, (kt + 1) & 1, A, K, B, N, (kt + 1) * TL::BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int kk = 0; kk < TL::BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &sm.As[st][wm * 32 + i * 16][kk],
                               TL::LDA);
#pragma unroll
      for (int m = 0; m < NB; ++m)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, &sm.Bs[st][m][kk][wn * 32 + j * 16],
                                 TL::LDB);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::mma_sync(acc[m][i][j], a[i], b, acc[m][i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            Cs + (size_t)m * FBM * TL::LDC +
                (wm * 32 + i * 16) * TL::LDC + wn * 32 + j * 16,
            acc[m][i][j], TL::LDC, wmma::mem_row_major);
}

// f32: SIMT FMA.  Thread (ty, tx) owns rows 4*ty..+3, columns 8*tx..+7.
template <int NB>
__device__ void ffn_mainloop(const float* A, int K, const float* const* B,
                             int N, float* Cs) {
  using TL = FfnTile<float>;
  FfnSmem<float, NB>& sm = *reinterpret_cast<FfnSmem<float, NB>*>(Cs);
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  float acc[NB][4][8];
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[m][r][c] = 0.f;

  const int nk = K / TL::BK;
  ffn_load<float, NB>(sm, 0, A, K, B, N, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      ffn_load<float, NB>(sm, (kt + 1) & 1, A, K, B, N, (kt + 1) * TL::BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int k = 0; k < TL::BK; ++k) {
      float a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = sm.As[st][ty * 4 + r][k];
#pragma unroll
      for (int m = 0; m < NB; ++m)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float b = sm.Bs[st][m][k][tx * 8 + c];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[m][r][c] = fmaf(a[r], b, acc[m][r][c]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        Cs[(size_t)m * FBM * TL::LDC + (ty * 4 + r) * TL::LDC + tx * 8 + c] =
            acc[m][r][c];
}

// One grouped GEMM launch.  MODE_UP / MODE_UP_GATED: A = x [T, K=H],
// B0 = w_up [E, H, N=I], B1 = w_gate, bias = b_up [E, I], C = hidden.
// MODE_DOWN: A = hidden [T, K=I], B0 = w_down [E, I, N=H], bias = b_down,
// C = out.
template <typename T, int MODE>
__global__ void __launch_bounds__(FTHREADS)
ffn_gemm(const T* __restrict__ A, const int* __restrict__ tile_gid,
         int block_m, const int* __restrict__ num_rows,
         const T* __restrict__ B0, const T* __restrict__ B1,
         const float* __restrict__ bias, T* __restrict__ C, int K, int N,
         int act) {
  constexpr int NB = (MODE == MODE_UP_GATED) ? 2 : 1;
  constexpr int LDC = FfnTile<T>::LDC;
  static_assert(sizeof(FfnSmem<T, NB>) <= FFN_SMEM, "shared memory");
  __shared__ __align__(128) float Cs[FFN_SMEM / 4];

  const int row0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN;
  if (num_rows != nullptr && row0 >= *num_rows) {
    if (MODE == MODE_DOWN)
      for (int i = threadIdx.x; i < FBM * FBN; i += FTHREADS)
        C[(size_t)(row0 + i / FBN) * N + n0 + i % FBN] = from_f<T>(0.f);
    return;
  }
  const int e = tile_gid[row0 / block_m];
  const T* Bs[NB];
  Bs[0] = B0 + (size_t)e * K * N + n0;
  if (NB == 2) Bs[NB - 1] = B1 + (size_t)e * K * N + n0;
  ffn_mainloop<NB>(A + (size_t)row0 * K, K, Bs, N, Cs);
  __syncthreads();

  const float* bias_e = bias + (size_t)e * N + n0;
  for (int i = threadIdx.x; i < FBM * FBN; i += FTHREADS) {
    const int r = i / FBN, c = i % FBN;
    float v = Cs[r * LDC + c] + bias_e[c];
    if (MODE == MODE_UP_GATED)
      v = act_f(Cs[FBM * LDC + r * LDC + c], act) * v;
    else if (MODE == MODE_UP)
      v = act_f(v, act);
    C[(size_t)(row0 + r) * N + n0 + c] = from_f<T>(v);
  }
}

template <typename T>
int grouped_ffn_launch(int gated, int act, const void* x,
                       const int* tile_gid, int block_m, const int* num_rows,
                       const void* w_up, const void* w_gate,
                       const float* b_up, const void* w_down,
                       const float* b_down, void* hidden, void* out, int T_,
                       int H, int I, cudaStream_t stream) {
  const dim3 g_up(T_ / FBM, I / FBN), g_down(T_ / FBM, H / FBN);
  if (gated)
    ffn_gemm<T, MODE_UP_GATED><<<g_up, FTHREADS, 0, stream>>>(
        (const T*)x, tile_gid, block_m, num_rows, (const T*)w_up,
        (const T*)w_gate, b_up, (T*)hidden, H, I, act);
  else
    ffn_gemm<T, MODE_UP><<<g_up, FTHREADS, 0, stream>>>(
        (const T*)x, tile_gid, block_m, num_rows, (const T*)w_up, nullptr,
        b_up, (T*)hidden, H, I, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ffn_gemm<T, MODE_DOWN><<<g_down, FTHREADS, 0, stream>>>(
      (const T*)hidden, tile_gid, block_m, num_rows, (const T*)w_down,
      nullptr, b_down, (T*)out, I, H, act);
  return (int)cudaGetLastError();
}

}  // namespace fm

// x [T, H], tile_gid i32 [T / block_m], num_rows i32 [1] or null (every
// row live), w_up / w_gate [E, H, I], b_up f32 [E, I], w_down [E, I, H],
// b_down f32 [E, H], hidden scratch [T, I], out [T, H].  Needs T, H, I and
// block_m to be multiples of 64.
extern "C" int fm_grouped_ffn(int is_bf16, int gated, int act,
                              const void* x, const int* tile_gid,
                              int block_m, const int* num_rows,
                              const void* w_up, const void* w_gate,
                              const float* b_up, const void* w_down,
                              const float* b_down, void* hidden, void* out,
                              int T, int H, int I, cudaStream_t stream) {
  if (is_bf16)
    return fm::grouped_ffn_launch<fm::bf16>(
        gated, act, x, tile_gid, block_m, num_rows, w_up, w_gate, b_up,
        w_down, b_down, hidden, out, T, H, I, stream);
  return fm::grouped_ffn_launch<float>(gated, act, x, tile_gid, block_m,
                                       num_rows, w_up, w_gate, b_up, w_down,
                                       b_down, hidden, out, T, H, I, stream);
}
