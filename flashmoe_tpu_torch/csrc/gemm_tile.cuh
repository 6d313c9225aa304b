// One 64 x 64 output tile of a GEMM C = A @ B for the f32 kernels
// (grouped_ffn.cu, grouped_matmul.cu, fused_ep.cu, gate_tiled.cu): A
// [rows, K] row-major, B either [K, N] row-major or, with TRANS, [N, K]
// contracted on its last dim (the weight read in its forward layout,
// never transposed in memory).  With GATHER, row r of the A tile is row
// arow[r] of A (the gather-fused FFN reads token rows by their source
// index); otherwise row r.
//
// A block of 4 warps (FTHREADS) owns the tile.  Operand tiles arrive by
// 16-byte cp.async copies, two stages deep.  The tile is f32 only (every
// bf16 kernel runs on hopper_gemm.cuh's TMA + wgmma mainloop): FMA on the
// SIMT cores, thread (ty, tx) owning rows 4*ty..+3, columns 8*tx..+7 (TF32
// tensor cores would miss the f32 tolerance).  The accumulators land in
// the f32 shared tile Cs (row stride LDC), one FBM x LDC block per
// output, for the caller's epilogue.
//
// The B operands reach shared memory through a loader policy: CpAsyncB
// copies weights in A's dtype; QuantB (ffn_mainloop_q, the f32 fused
// kernel's quantized arm) reads [K, N] weights stored as 1-byte int8 or
// e4m3 payloads with f32 per-column scales, and writes each element as
// payload.f32 * scale, so the mainloop computes exactly as on weights
// dequantized beforehand.  Its global loads for the next stage are issued
// before the current stage's products and stored after them.
#pragma once

#include <cuda_fp8.h>

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

// A's stage: the 64 x BK tile, row r taken from row arow[r] with GATHER
template <typename T, int NB, bool TRANS, bool GATHER>
__device__ __forceinline__ void ffn_load_a(FfnSmem<T, NB, TRANS>& sm, int st,
                                           const T* A, const int* arow,
                                           int K, int k0) {
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int ACPR = FfnTile<T>::BK / EPC;
  for (int c = threadIdx.x; c < FBM * ACPR; c += FTHREADS) {
    const int r = c / ACPR, cc = (c % ACPR) * EPC;
    const size_t ra = GATHER ? (size_t)arow[r] : (size_t)r;
    cp_async16(&sm.As[st][r][cc], A + ra * K + k0 + cc);
  }
}

// B operands in A's dtype, by cp.async.  B[m] points at the tile's first
// output column: w_e + n0 for a [K, N] weight, w_e + n0 * K for an [N, K]
// one.
template <typename T, int NB, bool TRANS> struct CpAsyncB {
  using Smem = FfnSmem<T, NB, TRANS>;
  const T* const* B;
  int K, N;
  __device__ __forceinline__ void prologue(Smem&) {}
  __device__ __forceinline__ void issue(Smem& sm, int st, int k0) {
    using TL = FfnTile<T>;
    constexpr int EPC = 16 / (int)sizeof(T);
    constexpr int ACPR = TL::BK / EPC;
    constexpr int BCPR = FBN / EPC;
    const int tid = threadIdx.x;
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
          cp_async16(&sm.Bs[st][m].v[r][cc],
                     B[m] + (size_t)(k0 + r) * N + cc);
        }
      }
    }
  }
  __device__ __forceinline__ void finish(Smem&, int) {}
};

// 16 payload bytes -> 16 exact f32 values
__device__ __forceinline__ void decode16(const int8_t*, uint4 raw,
                                         float (&v)[16]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    v[i] = (float)(int)(signed char)((w[i >> 2] >> (8 * (i & 3))) & 0xffu);
}
// e4m3 -> f16 is exact (NaN stays NaN; e4m3fn has no infinities)
__device__ __forceinline__ void decode16(const __nv_fp8_e4m3*, uint4 raw,
                                         float (&v)[16]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const __half2 h(__nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(w[i >> 1] >> (16 * (i & 1))), __NV_E4M3));
    const float2 f = __half22float2(h);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store16(float* dst, const float (&v)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    reinterpret_cast<float4*>(dst)[j] =
        make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
}

// [K, N] B operands stored as 1-byte payloads Q (int8_t or __nv_fp8_e4m3)
// with f32 scales per output column: B[m] and S[m] point at the tile's
// first column.  Each of the first BK * FBN / 16 threads owns one 16-byte
// payload chunk of a stage (row c / 4, columns (c % 4) * 16 ..+15) and
// keeps it in a register between issue and finish.  The tile's scales sit
// in shared memory beside the operands.
template <typename T, typename Q, int NB> struct QuantB {
  struct Smem : FfnSmem<T, NB, false> {
    float Sc[NB][FBN];
  };
  static constexpr int CHUNKS = FfnTile<T>::BK * FBN / 16;
  static_assert(CHUNKS <= FTHREADS, "one payload chunk a thread");
  const Q* const* B;
  const float* const* S;
  int N;
  uint4 raw[NB];
  __device__ __forceinline__ void prologue(Smem& sm) {
    for (int i = threadIdx.x; i < NB * FBN; i += FTHREADS)
      sm.Sc[i / FBN][i % FBN] = S[i / FBN][i % FBN];
    __syncthreads();
  }
  __device__ __forceinline__ void issue(Smem&, int, int k0) {
    const int c = threadIdx.x;
    if (c >= CHUNKS) return;
    const int r = c / (FBN / 16), cc = (c % (FBN / 16)) * 16;
#pragma unroll
    for (int m = 0; m < NB; ++m)
      raw[m] = __ldg(reinterpret_cast<const uint4*>(
          B[m] + (size_t)(k0 + r) * N + cc));
  }
  __device__ __forceinline__ void finish(Smem& sm, int st) {
    const int c = threadIdx.x;
    if (c >= CHUNKS) return;
    const int r = c / (FBN / 16), cc = (c % (FBN / 16)) * 16;
#pragma unroll
    for (int m = 0; m < NB; ++m) {
      float v[16];
      decode16((const Q*)nullptr, raw[m], v);
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = __fmul_rn(v[i], sm.Sc[m][cc + i]);
      store16(&sm.Bs[st][m].v[r][cc], v);
    }
  }
};

template <int NB, bool TRANS, bool GATHER, typename BL>
__device__ void ffn_mainloop_bl(const float* A, int K, BL bl, float* Cs,
                                const int* arow) {
  using TL = FfnTile<float>;
  typename BL::Smem& sm = *reinterpret_cast<typename BL::Smem*>(Cs);
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  float acc[NB][4][8];
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[m][r][c] = 0.f;

  const int nk = K / TL::BK;
  bl.prologue(sm);
  ffn_load_a<float, NB, TRANS, GATHER>(sm, 0, A, arow, K, 0);
  bl.issue(sm, 0, 0);
  cp_async_commit();
  bl.finish(sm, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      ffn_load_a<float, NB, TRANS, GATHER>(sm, (kt + 1) & 1, A, arow, K,
                                           (kt + 1) * TL::BK);
      bl.issue(sm, (kt + 1) & 1, (kt + 1) * TL::BK);
      cp_async_commit();
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
    if (kt + 1 < nk) bl.finish(sm, (kt + 1) & 1);
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

// C = A @ B with B in A's dtype (see the top of this file)
template <int NB, bool TRANS, bool GATHER = false, typename T>
__device__ __forceinline__ void ffn_mainloop(const T* A, int K,
                                             const T* const* B, int N,
                                             float* Cs,
                                             const int* arow = nullptr) {
  ffn_mainloop_bl<NB, TRANS, GATHER>(
      A, K, CpAsyncB<T, NB, TRANS>{B, K, N}, Cs, arow);
}

// C = A @ dequant(B): B [K, N] 1-byte payloads of type Q with f32
// per-column scales S (both at the tile's first column)
template <int NB, typename Q, typename T>
__device__ __forceinline__ void ffn_mainloop_q(const T* A, int K,
                                               const Q* const* B,
                                               const float* const* S, int N,
                                               float* Cs) {
  QuantB<T, Q, NB> bl;
  bl.B = B;
  bl.S = S;
  bl.N = N;
  ffn_mainloop_bl<NB, false, false>(A, K, bl, Cs, nullptr);
}

}  // namespace fm
