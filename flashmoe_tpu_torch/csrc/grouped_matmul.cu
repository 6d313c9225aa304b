// Grouped matmul: out[T, N] = x[T, K] @ w[tile_gid[t]], one expert per row
// tile, accumulated in f32.
//
// Replaces the TPU kernel flashmoe_tpu/ops/expert.py:_gmm_kernel
// (launched by grouped_matmul).  Same function: w is [E, K, N], or with
// transpose_w [E, N, K] and contracted on its last dim, so the backward's
// dHidden = dy @ w_down[e]^T and dX = d_up @ w_up[e]^T (+ d_gate @
// w_gate[e]^T) read the weights in their forward layout and no transposed
// copy is ever made.  The output is f32 or x's dtype.
//
// What bounds it on an H100: the bytes.  At the Mixtral training step
// (2560 rows, K and N of 4096 and 14336, 8 experts) one call reads the
// expert's weights (940 MB bf16) and writes an f32 [T, N] output; its
// 2*T*K*N operations take about as long at the tensor-core peak, so the
// two bounds sit within 10 % of each other.  Design: the TPU kernel swept
// K-chunks of one row tile through a VMEM accumulator; here each block of
// 4 warps owns one 64 x 64 output tile, runs the whole K loop in registers
// (gemm_tile.cuh: WMMA for bf16, with the transposed weight tile read as a
// column-major fragment, SIMT FMA for f32), and writes the tile once.  Row
// tiles are the fastest grid axis, so the row tiles of one expert share
// each weight tile in L2.  Row tiles at or past *num_rows (the ragged
// plan's padded tail) skip the GEMM and write zeros.
#include "gemm_tile.cuh"

namespace fm {

template <typename T, bool TRANS, typename OutT>
__global__ void __launch_bounds__(FTHREADS)
gmm_kernel(const T* __restrict__ x, const int* __restrict__ tile_gid,
           int block_m, const int* __restrict__ num_rows,
           const T* __restrict__ w, OutT* __restrict__ out, int K, int N) {
  constexpr int LDC = FfnTile<T>::LDC;
  static_assert(sizeof(FfnSmem<T, 1, TRANS>) <= FFN_SMEM, "shared memory");
  __shared__ __align__(128) float Cs[FFN_SMEM / 4];

  const int row0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN;
  if (num_rows != nullptr && row0 >= *num_rows) {
    for (int i = threadIdx.x; i < FBM * FBN; i += FTHREADS)
      out[(size_t)(row0 + i / FBN) * N + n0 + i % FBN] = from_f<OutT>(0.f);
    return;
  }
  const int e = tile_gid[row0 / block_m];
  const T* B[1] = {w + (size_t)e * K * N + (size_t)n0 * (TRANS ? K : 1)};
  ffn_mainloop<1, TRANS>(x + (size_t)row0 * K, K, B, N, Cs);
  __syncthreads();
  for (int i = threadIdx.x; i < FBM * FBN; i += FTHREADS) {
    const int r = i / FBN, c = i % FBN;
    out[(size_t)(row0 + r) * N + n0 + c] = from_f<OutT>(Cs[r * LDC + c]);
  }
}

template <typename T, bool TRANS>
int gmm_launch(int out_f32, const void* x, const int* tile_gid, int block_m,
               const int* num_rows, const void* w, void* out, int T_, int K,
               int N, cudaStream_t stream) {
  const dim3 grid(T_ / FBM, N / FBN);
  if (out_f32)
    gmm_kernel<T, TRANS, float><<<grid, FTHREADS, 0, stream>>>(
        (const T*)x, tile_gid, block_m, num_rows, (const T*)w, (float*)out,
        K, N);
  else
    gmm_kernel<T, TRANS, T><<<grid, FTHREADS, 0, stream>>>(
        (const T*)x, tile_gid, block_m, num_rows, (const T*)w, (T*)out, K,
        N);
  return (int)cudaGetLastError();
}

}  // namespace fm

// x [T, K]; tile_gid i32 [T / block_m]; num_rows i32 [1] or null (every
// row live); w [E, K, N], or [E, N, K] with transpose_w; out [T, N] in f32
// (out_f32) or x's dtype.  Needs T, K, N and block_m to be multiples of
// 64.
extern "C" int fm_grouped_matmul(int is_bf16, int transpose_w, int out_f32,
                                 const void* x, const int* tile_gid,
                                 int block_m, const int* num_rows,
                                 const void* w, void* out, int T, int K,
                                 int N, cudaStream_t stream) {
  if (is_bf16)
    return transpose_w
               ? fm::gmm_launch<fm::bf16, true>(out_f32, x, tile_gid, block_m,
                                                num_rows, w, out, T, K, N,
                                                stream)
               : fm::gmm_launch<fm::bf16, false>(out_f32, x, tile_gid,
                                                 block_m, num_rows, w, out, T,
                                                 K, N, stream);
  return transpose_w
             ? fm::gmm_launch<float, true>(out_f32, x, tile_gid, block_m,
                                           num_rows, w, out, T, K, N, stream)
             : fm::gmm_launch<float, false>(out_f32, x, tile_gid, block_m,
                                            num_rows, w, out, T, K, N, stream);
}
