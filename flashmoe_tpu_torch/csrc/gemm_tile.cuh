// One 64 x 64 output tile of a GEMM C = A @ B for the grouped kernels
// (grouped_ffn.cu, grouped_matmul.cu): A [rows, K] row-major, B either
// [K, N] row-major or, with TRANS, [N, K] contracted on its last dim (the
// weight read in its forward layout, never transposed in memory).  With
// GATHER, row r of the A tile is row arow[r] of A (the gather-fused FFN
// reads token rows by their source index); otherwise row r.
//
// A block of 4 warps (FTHREADS) owns the tile.  Operand tiles arrive by
// 16-byte cp.async copies, two stages deep.  bf16 goes through tensor
// cores (WMMA 16x16x16, f32 accumulators; warp w owns the 32 x 32
// quadrant (w / 2, w % 2) as 2 x 2 fragments per output), f32 through FMA
// on the SIMT cores (thread (ty, tx) owns rows 4*ty..+3, columns
// 8*tx..+7).  The accumulators land in the f32 shared tile Cs (row stride
// LDC), one FBM x LDC block per output, for the caller's epilogue.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace fm {

constexpr int FBM = 64, FBN = 64, FTHREADS = 128;

template <typename T> struct FfnTile {
  static constexpr int BK = 64 / (int)sizeof(T);  // 64 bytes of a row
  static constexpr int PAD = 16 / (int)sizeof(T);
  static constexpr int LDA = BK + PAD;  // A tile, and B's tile with TRANS
  static constexpr int LDB = FBN + PAD;
  static constexpr int LDC = FBN + 4;
};

constexpr int FFN_SMEM = 2 * FBM * (FBN + 4) * 4;  // Cs for two outputs

// one stage of one B operand: [BK][LDB] from a [K, N] weight, or
// [FBN][LDA] from an [N, K] weight (TRANS)
template <typename T, bool TRANS> struct BTile {
  T v[FfnTile<T>::BK][FfnTile<T>::LDB];
};
template <typename T> struct BTile<T, true> {
  T v[FBN][FfnTile<T>::LDA];
};

template <typename T, int NB, bool TRANS>
struct FfnSmem {
  T As[2][FBM][FfnTile<T>::LDA];
  BTile<T, TRANS> Bs[2][NB];
};

// B[m] points at the tile's first output column: w_e + n0 for a [K, N]
// weight, w_e + n0 * K for an [N, K] one.
template <typename T, int NB, bool TRANS, bool GATHER>
__device__ __forceinline__ void ffn_load(FfnSmem<T, NB, TRANS>& sm, int st,
                                         const T* A, const int* arow, int K,
                                         const T* const* B, int N, int k0) {
  using TL = FfnTile<T>;
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int ACPR = TL::BK / EPC;
  constexpr int BCPR = FBN / EPC;
  const int tid = threadIdx.x;
  for (int c = tid; c < FBM * ACPR; c += FTHREADS) {
    const int r = c / ACPR, cc = (c % ACPR) * EPC;
    const size_t ra = GATHER ? (size_t)arow[r] : (size_t)r;
    cp_async16(&sm.As[st][r][cc], A + ra * K + k0 + cc);
  }
#pragma unroll
  for (int m = 0; m < NB; ++m) {
    if constexpr (TRANS) {
      for (int c = tid; c < FBN * ACPR; c += FTHREADS) {
        const int r = c / ACPR, cc = (c % ACPR) * EPC;
        cp_async16(&sm.Bs[st][m].v[r][cc], B[m] + (size_t)r * K + k0 + cc);
      }
    } else {
      for (int c = tid; c < TL::BK * BCPR; c += FTHREADS) {
        const int r = c / BCPR, cc = (c % BCPR) * EPC;
        cp_async16(&sm.Bs[st][m].v[r][cc], B[m] + (size_t)(k0 + r) * N + cc);
      }
    }
  }
  cp_async_commit();
}

// bf16: tensor cores.
template <int NB, bool TRANS, bool GATHER = false>
__device__ void ffn_mainloop(const bf16* A, int K, const bf16* const* B,
                             int N, float* Cs, const int* arow = nullptr) {
  using namespace nvcuda;
  using TL = FfnTile<bf16>;
  FfnSmem<bf16, NB, TRANS>& sm =
      *reinterpret_cast<FfnSmem<bf16, NB, TRANS>*>(Cs);
  const int warp = threadIdx.x / 32, wm = warp >> 1, wn = warp & 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NB][2][2];
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[m][i][j], 0.f);

  const int nk = K / TL::BK;
  ffn_load<bf16, NB, TRANS, GATHER>(sm, 0, A, arow, K, B, N, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      ffn_load<bf16, NB, TRANS, GATHER>(sm, (kt + 1) & 1, A, arow, K, B,
                                        N, (kt + 1) * TL::BK);
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
          if constexpr (TRANS) {
            // B(k, n) = Bt[n][k]: a column-major view of the [N, K] tile
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
                b;
            wmma::load_matrix_sync(b, &sm.Bs[st][m].v[wn * 32 + j * 16][kk],
                                   TL::LDA);
#pragma unroll
            for (int i = 0; i < 2; ++i)
              wmma::mma_sync(acc[m][i][j], a[i], b, acc[m][i][j]);
          } else {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
                b;
            wmma::load_matrix_sync(b, &sm.Bs[st][m].v[kk][wn * 32 + j * 16],
                                   TL::LDB);
#pragma unroll
            for (int i = 0; i < 2; ++i)
              wmma::mma_sync(acc[m][i][j], a[i], b, acc[m][i][j]);
          }
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

// f32: SIMT FMA.
template <int NB, bool TRANS, bool GATHER = false>
__device__ void ffn_mainloop(const float* A, int K, const float* const* B,
                             int N, float* Cs, const int* arow = nullptr) {
  using TL = FfnTile<float>;
  FfnSmem<float, NB, TRANS>& sm =
      *reinterpret_cast<FfnSmem<float, NB, TRANS>*>(Cs);
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  float acc[NB][4][8];
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[m][r][c] = 0.f;

  const int nk = K / TL::BK;
  ffn_load<float, NB, TRANS, GATHER>(sm, 0, A, arow, K, B, N, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      ffn_load<float, NB, TRANS, GATHER>(sm, (kt + 1) & 1, A, arow, K, B,
                                         N, (kt + 1) * TL::BK);
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
          float b;
          if constexpr (TRANS)
            b = sm.Bs[st][m].v[tx * 8 + c][k];
          else
            b = sm.Bs[st][m].v[k][tx * 8 + c];
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

}  // namespace fm
