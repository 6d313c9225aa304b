// Transposed grouped matmul, the weight gradient:
// dW[e, K, N] = sum over the rows r of expert e of x[r, :]^T dy[r, :], f32.
//
// Replaces the TPU kernel flashmoe_tpu/ops/expert.py:_tgmm_kernel
// (launched by tgmm).  Same function: the rows are expert-major (a
// nondecreasing tile_gid), and an expert that owns no row gets exactly 0.
//
// What bounds it on an H100: the bytes of its f32 output.  At the Mixtral
// training step one call writes [8, 4096, 14336] f32 (1.88 GB, 0.56 ms at
// 3.35 TB/s) from inputs of a few tens of MB, while its 2*T*K*N operations
// take about 0.3 ms at the bf16 tensor-core peak.  Design: on the TPU the
// grid ran in order and one expert's row tiles summed into the same VMEM
// output block on consecutive grid steps; blocks here run in no order, so
// each block owns one (expert, 64-wide K tile, 64-wide N tile) of dW and
// loops over that expert's rows [row_start[e], row_end[e]) itself (the
// wrapper finds the range with a searchsorted over tile_gid).  The sum
// needs no atomics, its order is fixed, and every output element is
// written exactly once: an expert with an empty range writes zeros, so no
// select over uninitialised memory is needed.  The x^T and dy row chunks
// arrive by 16-byte cp.async copies, two stages deep; bf16 runs on tensor
// cores (WMMA, x^T read as a column-major fragment of the row-major x
// chunk), f32 on SIMT FMA.  N tiles are the fastest grid axis, so blocks
// that share an x chunk run side by side and share it in L2.
#include "common.cuh"

#include <mma.h>

namespace fm {

constexpr int TBK = 64, TBN = 64, TTHREADS = 128;

template <typename T> struct TgmmTile {
  static constexpr int BR = 64 / (int)sizeof(T);  // rows per stage
  static constexpr int LD = 64 + 16 / (int)sizeof(T);
};

template <typename T> struct TgmmSmem {
  T Xs[2][TgmmTile<T>::BR][TgmmTile<T>::LD];  // x[r, k0 : k0 + 64]
  T Ds[2][TgmmTile<T>::BR][TgmmTile<T>::LD];  // dy[r, n0 : n0 + 64]
};

template <typename T>
__device__ __forceinline__ void tgmm_load(TgmmSmem<T>& sm, int st,
                                          const T* x, const T* dy, int K,
                                          int N, int r) {
  constexpr int EPC = 16 / (int)sizeof(T);
  constexpr int CPR = 64 / EPC;
  for (int c = threadIdx.x; c < TgmmTile<T>::BR * CPR; c += TTHREADS) {
    const int rr = c / CPR, cc = (c % CPR) * EPC;
    cp_async16(&sm.Xs[st][rr][cc], x + (size_t)(r + rr) * K + cc);
    cp_async16(&sm.Ds[st][rr][cc], dy + (size_t)(r + rr) * N + cc);
  }
  cp_async_commit();
}

// bf16: warp w owns the 32 x 32 quadrant (w / 2, w % 2) of the 64 x 64
// (k, n) tile as 2 x 2 WMMA accumulators, stored straight to dW.
__device__ void tgmm_tile(const bf16* x, const bf16* dy, int K, int N,
                          int r0, int r1, float* dw) {
  using namespace nvcuda;
  using TL = TgmmTile<bf16>;
  // raw bytes: a __shared__ object of bf16 may not be default-constructed
  __shared__ __align__(128) unsigned char raw[sizeof(TgmmSmem<bf16>)];
  TgmmSmem<bf16>& sm = *reinterpret_cast<TgmmSmem<bf16>*>(raw);
  const int warp = threadIdx.x / 32, wm = warp >> 1, wn = warp & 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  if (r0 < r1) tgmm_load<bf16>(sm, 0, x, dy, K, N, r0);
  for (int r = r0, st = 0; r < r1; r += TL::BR, st ^= 1) {
    if (r + TL::BR < r1) {
      tgmm_load<bf16>(sm, st ^ 1, x, dy, K, N, r + TL::BR);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < TL::BR; rr += 16) {
      // A = x^T (k x r): A(k, r) = Xs[r][k], a column-major view
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &sm.Xs[st][rr][wm * 32 + i * 16],
                               TL::LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, &sm.Ds[st][rr][wn * 32 + j * 16], TL::LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          dw + (size_t)(wm * 32 + i * 16) * N + wn * 32 + j * 16, acc[i][j],
          N, wmma::mem_row_major);
}

// f32: thread (ty, tx) owns k rows 4*ty..+3 and n columns 8*tx..+7.
__device__ void tgmm_tile(const float* x, const float* dy, int K, int N,
                          int r0, int r1, float* dw) {
  using TL = TgmmTile<float>;
  __shared__ __align__(128) unsigned char raw[sizeof(TgmmSmem<float>)];
  TgmmSmem<float>& sm = *reinterpret_cast<TgmmSmem<float>*>(raw);
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  if (r0 < r1) tgmm_load<float>(sm, 0, x, dy, K, N, r0);
  for (int r = r0, st = 0; r < r1; r += TL::BR, st ^= 1) {
    if (r + TL::BR < r1) {
      tgmm_load<float>(sm, st ^ 1, x, dy, K, N, r + TL::BR);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < TL::BR; ++rr) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.Xs[st][rr][ty * 4 + i];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float b = sm.Ds[st][rr][tx * 8 + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(a[i], b, acc[i][c]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      dw[(size_t)(ty * 4 + i) * N + tx * 8 + c] = acc[i][c];
}

template <typename T>
__global__ void __launch_bounds__(TTHREADS)
tgmm_kernel(const T* __restrict__ x, const T* __restrict__ dy,
            const int* __restrict__ row_start,
            const int* __restrict__ row_end, float* __restrict__ dw, int K,
            int N) {
  const int n0 = blockIdx.x * TBN, k0 = blockIdx.y * TBK, e = blockIdx.z;
  tgmm_tile(x + k0, dy + n0, K, N, row_start[e], row_end[e],
            dw + ((size_t)e * K + k0) * N + n0);
}

}  // namespace fm

// x [T, K], dy [T, N] (one dtype); row_start / row_end i32 [E], expert e's
// rows [row_start[e], row_end[e]) (multiples of 64 / sizeof(dtype) rows);
// dw f32 [E, K, N].  Needs K and N to be multiples of 64.
extern "C" int fm_tgmm(int is_bf16, const void* x, const void* dy,
                       const int* row_start, const int* row_end, void* dw,
                       int E, int K, int N, cudaStream_t stream) {
  const dim3 grid(N / fm::TBN, K / fm::TBK, E);
  if (is_bf16)
    fm::tgmm_kernel<fm::bf16><<<grid, fm::TTHREADS, 0, stream>>>(
        (const fm::bf16*)x, (const fm::bf16*)dy, row_start, row_end,
        (float*)dw, K, N);
  else
    fm::tgmm_kernel<float><<<grid, fm::TTHREADS, 0, stream>>>(
        (const float*)x, (const float*)dy, row_start, row_end, (float*)dw, K,
        N);
  return (int)cudaGetLastError();
}
