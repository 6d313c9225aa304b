// One-block checks of the wgmma operand forms that the transposed grouped
// matmul (tgmm.cu) and flash attention (flash_attention.cu) add to
// hopper_gemm.cuh, each held alone against torch.matmul on the card before
// the kernels that run on them.  No TPU kernel: a test harness.  One
// consumer warpgroup walks K in stages of 64, thread 0 issuing the TMA
// loads; the f32 result leaves from the accumulator fragments.
//
//   form 0: C [64, 256] = A^T B, A [K, 64] and B [K, 256] both MN-major
//           (wgmma_stage_tn: imm-trans-a = 1, imm-trans-b = 1);
//   form 1: C [64, 64] = A B^T, A [64, K] and B [64, K] both K-major
//           (wgmma_m64n64k16: flash attention's S = Q K^T);
//   form 2: C [64, N] = A B, A [64, K] in registers (the accumulator
//           layout as bf16 pairs), B [K, N] MN-major, N 64 or 128
//           (wgmma_rs: flash attention's O += P V).
#include "common.cuh"
#include "hopper_gemm.cuh"

namespace fm {

struct CheckSmem {
  bf16 a[64 * 64];
  bf16 b[256 * 64];
  uint64_t full;
};

// thread tid's accumulator fragment d[BN / 2] into C [64, BN]
template <int BN>
__device__ __forceinline__ void check_store(const float (&d)[BN / 2],
                                            float* c, int tid) {
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + lane / 4 + 8 * h;
      const int col = 8 * j + 2 * (lane % 4);
      c[(size_t)row * BN + col] = d[4 * j + 2 * h];
      c[(size_t)row * BN + col + 1] = d[4 * j + 2 * h + 1];
    }
}

template <int FORM, int BN>
__global__ void __launch_bounds__(128)
hopper_check(const __grid_constant__ CUtensorMap ta,
             const __grid_constant__ CUtensorMap tb,
             const bf16* __restrict__ a, float* __restrict__ c, int K) {
  extern __shared__ unsigned char check_raw[];
  CheckSmem& sm = hg::smem_at<CheckSmem>(check_raw);
  const int tid = threadIdx.x, lane = tid % 32;
  const int r = tid / 32 * 16 + lane / 4;  // the thread's first row
  if (tid == 0) {
    hg::mbar_init(&sm.full, 1);
    hg::mbar_fence_init();
  }
  __syncthreads();
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  uint32_t phase = 0;
  for (int kb = 0; kb < K / hg::BK; ++kb) {
    if (tid == 0) {
      const int a_boxes = FORM == 2 ? 0 : 1;
      hg::mbar_expect_tx(&sm.full,
                         (a_boxes + BN / 64) * 64 * 64 * sizeof(bf16));
      if (FORM == 0) hg::tma_load_2d(sm.a, &ta, &sm.full, 0, kb * hg::BK);
      if (FORM == 1) hg::tma_load_2d(sm.a, &ta, &sm.full, kb * hg::BK, 0);
      for (int j = 0; j < BN / 64; ++j) {
        if (FORM == 1)
          hg::tma_load_2d(sm.b, &tb, &sm.full, kb * hg::BK, 0);
        else
          hg::tma_load_2d(sm.b + 64 * 64 * j, &tb, &sm.full, 64 * j,
                          kb * hg::BK);
      }
    }
    hg::mbar_wait(&sm.full, phase);
    phase ^= 1;
    if constexpr (FORM == 0) {
      hg::wgmma_fence();
      hg::wgmma_stage_tn(d, sm.a, sm.b);
    } else if constexpr (FORM == 1) {
      hg::wgmma_fence();
      const uint64_t da = hg::sw128_desc(sm.a), db = hg::sw128_desc(sm.b);
#pragma unroll
      for (int k = 0; k < hg::BK / 16; ++k)
        hg::wgmma_m64n64k16(d, da + 2 * k, db + 2 * k);
    } else {
      // A's fragments of the stage's four k16 steps, from global memory
      uint32_t af[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = r + 8 * (q & 1);
          const int col = kb * hg::BK + 16 * k + 8 * (q >> 1) + 2 * (lane % 4);
          af[k][q] = *reinterpret_cast<const uint32_t*>(a + (size_t)row * K +
                                                        col);
        }
      hg::wgmma_fence();
      const uint64_t db = hg::sw128_desc_mn(sm.b);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        hg::wgmma_rs<BN>(d, af[k], db + (hg::MN_K16 >> 4) * k);
    }
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    __syncthreads();  // the stage is read before the next loads land
  }
  hg::fence_acc(d);
  check_store<BN>(d, c, tid);
}

template <int FORM, int BN>
int hopper_check_launch(const void* a, const void* b, float* c, int K,
                        cudaStream_t stream) {
  CUtensorMap ta, tb;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint32_t box[2] = {64, 64};
  // form 0: A [K, 64]; form 1: A [64, K]; form 2 reads A itself
  const cuuint64_t ad[2] = {FORM == 0 ? 64u : (cuuint64_t)K,
                            FORM == 0 ? (cuuint64_t)K : 64u};
  const cuuint64_t as[1] = {ad[0] * sizeof(bf16)};
  // form 1: B [64, K]; else B [K, BN]
  const cuuint64_t bd[2] = {FORM == 1 ? (cuuint64_t)K : (cuuint64_t)BN,
                            FORM == 1 ? 64u : (cuuint64_t)K};
  const cuuint64_t bs[1] = {bd[0] * sizeof(bf16)};
  if (!hg::make_map(&ta, bf, a, 2, ad, as, box) ||
      !hg::make_map(&tb, bf, b, 2, bd, bs, box))
    return (int)cudaErrorInvalidValue;
  const size_t smem = hg::smem_bytes<CheckSmem>();
  cudaError_t err = cudaFuncSetAttribute(
      hopper_check<FORM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  hopper_check<FORM, BN><<<1, 128, smem, stream>>>(ta, tb, (const bf16*)a,
                                                   c, K);
  return (int)cudaGetLastError();
}

}  // namespace fm

// The forms above on bf16 a and b, c f32 [64, N]; K a multiple of 64; N
// 256 (form 0), 64 (form 1), 64 or 128 (form 2).
extern "C" int fm_hopper_check(int form, const void* a, const void* b,
                               float* c, int K, int N, cudaStream_t stream) {
  if (form == 0 && N == 256)
    return fm::hopper_check_launch<0, 256>(a, b, c, K, stream);
  if (form == 1 && N == 64)
    return fm::hopper_check_launch<1, 64>(a, b, c, K, stream);
  if (form == 2 && N == 64)
    return fm::hopper_check_launch<2, 64>(a, b, c, K, stream);
  if (form == 2 && N == 128)
    return fm::hopper_check_launch<2, 128>(a, b, c, K, stream);
  return (int)cudaErrorInvalidValue;
}
