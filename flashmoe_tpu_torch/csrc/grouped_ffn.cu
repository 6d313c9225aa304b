// Grouped expert FFN over expert-sorted rows, and its residual-saving
// training forward.
//
// fm_grouped_ffn replaces the TPU kernel
// flashmoe_tpu/ops/expert.py:_ffn_kernel (launched by grouped_ffn).  Same
// function: each row tile t of x [T, H] belongs to expert tile_gid[t]; its
// rows go through that expert's up GEMM (and gate GEMM when gated), an f32
// bias and activation (act(g) * (up + b_up) when gated), the hidden
// activations rounded to x's dtype, the down GEMM accumulated in f32,
// + b_down, rounded to x's dtype.
//
// fm_grouped_ffn_tokens replaces flashmoe_tpu/ops/expert.py:_ffn_gather_kernel
// (launched by grouped_ffn_tokens, the gather-fused inference FFN): the
// same FFN over rows that are never gathered into a buffer.  Row r of the
// grouped layout is token src_tok[r] of x [S, H]: the up pass (template
// flag GATHER) loads each A-tile row by a 16-byte cp.async from that
// token's row, in the two-stage pipeline that double-buffers every
// operand tile (the TPU kernel's per-row DMAs into two VMEM slabs).  The
// down pass is fm_grouped_ffn's.  Rows are independent and the tile code
// is shared, so at every row the output is fm_grouped_ffn's on the
// gathered buffer, bit for bit; an unpopulated slot computes its src_tok
// (token 0) and the combine never reads it.  Only the [T, H] grouped
// input buffer disappears; the [T, I] hidden buffer stays.
//
// fm_grouped_ffn_res replaces flashmoe_tpu/ops/expert.py:_ffn_res_kernel
// (launched by _grouped_ffn_res, the forward of grouped_ffn_ad): the same
// FFN, and the up pass's epilogue also writes the pre-activations the
// backward needs, u = x @ w_up[e] + b_up[e] and, when gated,
// g = x @ w_gate[e], both rounded to x's dtype.  It is the up pass of
// fm_grouped_ffn with the template flag RES set; the down pass is shared.
//
// What bounds them on an H100: the expert weights.  Every row tile streams
// its expert's w_up/w_gate/w_down once, so at decode and prefill sizes the
// bytes of the weights (2.8 GB a Mixtral layer) bound them, not the
// tensor-core operations; the residual-saving forward adds the bytes of u
// and g ([T, I] each, 73 MB each at 2560 rows).  Design: the TPU kernel
// held a whole [bm, H] f32 accumulator in VMEM across I-chunks; a
// [bm, 4096] f32 tile does not fit one block's registers or shared memory
// here, so the FFN is two grouped GEMM launches (gemm_tile.cuh) that read
// tile_gid per row tile:
//   1. hidden[T, I] = act(x @ w_gate[e]) * (x @ w_up[e] + b_up[e]), written
//      in x's dtype (exactly the TPU kernel's rounding point), and with RES
//      u and g beside it,
//   2. out[T, H] = hidden @ w_down[e] + b_down[e].
// Row tiles are the fastest grid axis, so the row tiles of one expert run
// side by side and share each weight tile in L2.  Row tiles at or past
// *num_rows (the ragged plan's padded tail) skip their GEMMs and write
// zeros: to out, and with RES to u and g, so that the backward never reads
// uninitialised memory there.
#include "gemm_tile.cuh"

namespace fm {

enum { MODE_UP = 0, MODE_UP_GATED = 1, MODE_DOWN = 2 };

// One grouped GEMM launch.  MODE_UP / MODE_UP_GATED: A = x [T, K=H] (with
// GATHER: x [S, K=H], row r of the layout at A[src_tok[r]]), B0 = w_up
// [E, H, N=I], B1 = w_gate, bias = b_up [E, I], C = hidden, and with RES
// U = u and G = g [T, I].  MODE_DOWN: A = hidden [T, K=I], B0 = w_down
// [E, I, N=H], bias = b_down, C = out.
template <typename T, int MODE, bool RES, bool GATHER = false>
__global__ void __launch_bounds__(FTHREADS)
ffn_gemm(const T* __restrict__ A, const int* __restrict__ src_tok,
         const int* __restrict__ tile_gid, int block_m,
         const int* __restrict__ num_rows,
         const T* __restrict__ B0, const T* __restrict__ B1,
         const float* __restrict__ bias, T* __restrict__ C,
         T* __restrict__ U, T* __restrict__ G, int K, int N, int act) {
  constexpr int NB = (MODE == MODE_UP_GATED) ? 2 : 1;
  constexpr int LDC = FfnTile<T>::LDC;
  static_assert(sizeof(FfnSmem<T, NB, false>) <= FFN_SMEM, "shared memory");
  __shared__ __align__(128) float Cs[FFN_SMEM / 4];

  const int row0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN;
  if (num_rows != nullptr && row0 >= *num_rows) {
    for (int i = threadIdx.x; i < FBM * FBN; i += FTHREADS) {
      const size_t at = (size_t)(row0 + i / FBN) * N + n0 + i % FBN;
      if (MODE == MODE_DOWN) C[at] = from_f<T>(0.f);
      if (RES) U[at] = from_f<T>(0.f);
      if (RES && MODE == MODE_UP_GATED) G[at] = from_f<T>(0.f);
    }
    return;
  }
  const int e = tile_gid[row0 / block_m];
  const T* Bs[NB];
  Bs[0] = B0 + (size_t)e * K * N + n0;
  if (NB == 2) Bs[NB - 1] = B1 + (size_t)e * K * N + n0;
  if constexpr (GATHER)
    ffn_mainloop<NB, false, true>(A, K, Bs, N, Cs, src_tok + row0);
  else
    ffn_mainloop<NB, false>(A + (size_t)row0 * K, K, Bs, N, Cs);
  __syncthreads();

  const float* bias_e = bias + (size_t)e * N + n0;
  for (int i = threadIdx.x; i < FBM * FBN; i += FTHREADS) {
    const int r = i / FBN, c = i % FBN;
    const size_t at = (size_t)(row0 + r) * N + n0 + c;
    float v = Cs[r * LDC + c] + bias_e[c];
    if (MODE == MODE_UP_GATED) {
      const float g = Cs[FBM * LDC + r * LDC + c];
      if (RES) {
        U[at] = from_f<T>(v);
        G[at] = from_f<T>(g);
      }
      v = act_f(g, act) * v;
    } else if (MODE == MODE_UP) {
      if (RES) U[at] = from_f<T>(v);
      v = act_f(v, act);
    }
    C[at] = from_f<T>(v);
  }
}

template <typename T, bool RES, bool GATHER>
int grouped_ffn_launch(int gated, int act, const void* x, const int* src_tok,
                       const int* tile_gid, int block_m, const int* num_rows,
                       const void* w_up, const void* w_gate,
                       const float* b_up, const void* w_down,
                       const float* b_down, void* u, void* g, void* hidden,
                       void* out, int T_, int H, int I, cudaStream_t stream) {
  const dim3 g_up(T_ / FBM, I / FBN), g_down(T_ / FBM, H / FBN);
  if (gated)
    ffn_gemm<T, MODE_UP_GATED, RES, GATHER><<<g_up, FTHREADS, 0, stream>>>(
        (const T*)x, src_tok, tile_gid, block_m, num_rows, (const T*)w_up,
        (const T*)w_gate, b_up, (T*)hidden, (T*)u, (T*)g, H, I, act);
  else
    ffn_gemm<T, MODE_UP, RES, GATHER><<<g_up, FTHREADS, 0, stream>>>(
        (const T*)x, src_tok, tile_gid, block_m, num_rows, (const T*)w_up,
        nullptr, b_up, (T*)hidden, (T*)u, nullptr, H, I, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ffn_gemm<T, MODE_DOWN, false><<<g_down, FTHREADS, 0, stream>>>(
      (const T*)hidden, nullptr, tile_gid, block_m, num_rows,
      (const T*)w_down, nullptr, b_down, (T*)out, nullptr, nullptr, I, H,
      act);
  return (int)cudaGetLastError();
}

template <bool RES, bool GATHER>
int grouped_ffn_entry(int is_bf16, int gated, int act, const void* x,
                      const int* src_tok, const int* tile_gid, int block_m,
                      const int* num_rows, const void* w_up,
                      const void* w_gate, const float* b_up,
                      const void* w_down, const float* b_down, void* u,
                      void* g, void* hidden, void* out, int T, int H, int I,
                      cudaStream_t stream) {
  if (is_bf16)
    return grouped_ffn_launch<bf16, RES, GATHER>(
        gated, act, x, src_tok, tile_gid, block_m, num_rows, w_up, w_gate,
        b_up, w_down, b_down, u, g, hidden, out, T, H, I, stream);
  return grouped_ffn_launch<float, RES, GATHER>(
      gated, act, x, src_tok, tile_gid, block_m, num_rows, w_up, w_gate,
      b_up, w_down, b_down, u, g, hidden, out, T, H, I, stream);
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
  return fm::grouped_ffn_entry<false, false>(
      is_bf16, gated, act, x, nullptr, tile_gid, block_m, num_rows, w_up,
      w_gate, b_up, w_down, b_down, nullptr, nullptr, hidden, out, T, H, I,
      stream);
}

// fm_grouped_ffn's arguments, and u [T, I] and g [T, I] (null when not
// gated), both in x's dtype.
extern "C" int fm_grouped_ffn_res(int is_bf16, int gated, int act,
                                  const void* x, const int* tile_gid,
                                  int block_m, const int* num_rows,
                                  const void* w_up, const void* w_gate,
                                  const float* b_up, const void* w_down,
                                  const float* b_down, void* u, void* g,
                                  void* hidden, void* out, int T, int H,
                                  int I, cudaStream_t stream) {
  return fm::grouped_ffn_entry<true, false>(
      is_bf16, gated, act, x, nullptr, tile_gid, block_m, num_rows, w_up,
      w_gate, b_up, w_down, b_down, u, g, hidden, out, T, H, I, stream);
}

// fm_grouped_ffn's arguments with x [S, H] in token order and src_tok i32
// [T], the token of each row of the grouped layout (each in [0, S)).
extern "C" int fm_grouped_ffn_tokens(int is_bf16, int gated, int act,
                                     const void* x, const int* src_tok,
                                     const int* tile_gid, int block_m,
                                     const int* num_rows, const void* w_up,
                                     const void* w_gate, const float* b_up,
                                     const void* w_down, const float* b_down,
                                     void* hidden, void* out, int T, int H,
                                     int I, cudaStream_t stream) {
  return fm::grouped_ffn_entry<false, true>(
      is_bf16, gated, act, x, src_tok, tile_gid, block_m, num_rows, w_up,
      w_gate, b_up, w_down, b_down, nullptr, nullptr, hidden, out, T, H, I,
      stream);
}
