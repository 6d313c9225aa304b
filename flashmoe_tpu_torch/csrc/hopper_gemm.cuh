// Hopper GEMM mainloop: TMA loads into a ring of shared-memory stages,
// one producer warp, consumer warpgroups on wgmma with f32 accumulators
// in registers.  A is K-major ([rows, K]); B is K-major ([cols, K], both
// contracted on their last dim, wgmma's native layout: the grouped matmul)
// or MN-major ([K, cols] row-major: the forward FFN's weights).
//
// Pieces, all sm_90a:
//   * host: tensor maps for cp.async.bulk.tensor, encoded per call with
//     cuTensorMapEncodeTiled reached through cudaGetDriverEntryPoint (no
//     -lcuda); a box is 64 bf16 (128 bytes) of K by up to 256 rows, with
//     128-byte swizzle and out-of-bounds rows filled with zeros;
//   * mbarriers: a "full" barrier per stage (the producer's expect_tx,
//     completed by the TMA bytes) and an "empty" one (one arrival per
//     consumer warpgroup once it no longer reads the stage); the phase
//     parity flips at each lap of the ring;
//   * wgmma.mma_async m64n256k16 bf16 -> f32 on shared-memory descriptors
//     in the canonical K-major 128-byte-swizzle layout: 8-row groups 1024
//     bytes apart (SBO), K advanced by 32 bytes (two 16-byte units of the
//     start address) per k16 step.  A stage's tiles are 1024-byte aligned,
//     as the swizzle pattern is taken from the address bits.
//   * the accumulator layout of m64nN (thread t of the warpgroup, warp w =
//     t / 32, lane l): d[4j + 2h + i] is row 16w + l / 4 + 8h, column 8j +
//     2 (l % 4) + i;
//   * TMA stores from a swizzled shared-memory box (bulk groups), so an
//     epilogue can hand its tile to the copy engine and go on;
//   * MN-major B ([K, N] row-major weights, boxes of 64 columns by BK
//     K-rows; wgmma with imm-trans-b = 1) for the forward FFN
//     (grouped_ffn.cu), in m64n256k16 and m64n128k16.
#pragma once

#include <cuda.h>
#include <stdio.h>

#include "common.cuh"

namespace fm {
namespace hg {

constexpr int BK = 64;          // K per stage: 128 bytes of bf16, one swizzle row
constexpr int WG_ROWS = 64;     // rows of one consumer warpgroup (wgmma M)
constexpr int A_TILE = WG_ROWS * BK;  // bf16 elements of one A box

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed.  A ring out of
// step (a protocol fault) would spin forever: trap after limit_ns (5 s by
// default) instead, so the launch fails with an error rather than holding
// the card.  A kernel whose producer itself waits on flags with a timeout
// of its own (fused_ep.cu) passes a longer limit, so that the flag's
// message comes out first.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity,
                                          uint64_t limit_ns = 5000000000ull) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > limit_ns) {
      printf("hopper_gemm: mbarrier wait timed out (block %d thread %d)\n",
             blockIdx.x, threadIdx.x);
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A tensor map in global memory that the host wrote before the launch:
// acquired for the tensormap proxy at system scope (a descriptor that
// proxy cached from earlier contents of the same address is not used),
// then prefetched.  Maps passed as __grid_constant__ parameters need
// neither.
__device__ __forceinline__ void tensormap_acquire(const CUtensorMap* map) {
  asm volatile(
      "fence.proxy.tensormap::generic.acquire.sys [%0], 128;\n" ::"l"(
          (uint64_t)map)
      : "memory");
  asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)map) : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// shared -> global by TMA, completing in the issuing thread's bulk group
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"((uint64_t)map),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// at most N of the thread's bulk groups still read shared memory
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// at most N of the thread's bulk groups still pending
template <int N> __device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory, made visible to the async proxy
// (TMA stores, wgmma's operand reads)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// an arrival on bar once the thread's cp.async copies issued so far have
// landed, counted against the arrivals the barrier was initialised with
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// Byte offset of byte `b` of row `r` in a box of 128-byte rows stored with
// 128-byte swizzle (the 16-byte unit index XOR the row mod 8).
__device__ __forceinline__ int sw128_offset(int r, int b) {
  return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle
__device__ __forceinline__ uint64_t sw128_desc(const void* smem) {
  const uint64_t addr = smem_u32(smem);
  return ((addr & 0x3FFFF) >> 4)          // start address, 16-byte units
         | (uint64_t)1 << 16              // leading offset: unused here
         | (uint64_t)(1024 >> 4) << 32    // stride offset: 8 rows x 128 B
         | (uint64_t)1 << 62;             // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from touching accumulators across a wgmma wait
template <int R> __device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] += A[64 x 16] * B[16 x 256]: A K-major, B K-major (TB 0,
// B stored [256, 16]) or MN-major (TB 1, B stored [16, 256]), both in
// shared memory
template <int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "
      "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, %131;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

// d[64 x 128] += A[64 x 16] * B[16 x 128]: A K-major, B K-major (TB 0)
// or MN-major (TB 1), both in shared memory
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

// One stage's worth of wgmma: the 64 x BK slice of A against the 256 x BK
// slice of B, as four k16 steps (32 bytes each along the swizzled row).
__device__ __forceinline__ void wgmma_stage(float (&d)[128], const bf16* a,
                                            const bf16* b) {
  const uint64_t da = sw128_desc(a), db = sw128_desc(b);
#pragma unroll
  for (int k = 0; k < BK / 16; ++k)
    wgmma_m64n256k16<0>(d, da + 2 * k, db + 2 * k);
}

// ---- MN-major B: [K, N] row-major weights, read in place ----------
//
// A [K, N] weight (w_up / w_gate [E, H, I], w_down [E, I, H]) reaches
// shared memory as TMA boxes of 64 columns (128 bytes) by BK K-rows with
// 128-byte swizzle: K-row k of a box at byte 128 k, its 16-byte units
// XOR-ed with k mod 8.  A B tile of BN columns is BN / 64 such boxes, each
// MN_BOX bytes, side by side.  In wgmma's canonical MN-major layout with
// 128-byte swizzle the leading byte offset steps from one 64-column box to
// the next (MN_BOX) and the stride byte offset from one group of 8 K-rows
// to the next (8 x 128 bytes); a k16 step moves the start address down 16
// K-rows (2048 bytes).  wgmma reads B transposed (imm-trans-b = 1).
constexpr int MN_BOX = BK * 128;         // bytes of one 64-column box
constexpr int MN_K16 = 16 * 128;         // bytes of 16 K-rows

__device__ __forceinline__ uint64_t sw128_desc_mn(const void* smem) {
  const uint64_t addr = smem_u32(smem);
  return ((addr & 0x3FFFF) >> 4)            // start address, 16-byte units
         | (uint64_t)(MN_BOX >> 4) << 16    // leading offset: next 64 columns
         | (uint64_t)(1024 >> 4) << 32      // stride offset: next 8 K-rows
         | (uint64_t)1 << 62;               // 128-byte swizzle
}

// one k16 step of an m64nBN product with B MN-major (BN 256 or 128)
template <int BN>
__device__ __forceinline__ void wgmma_k16_mn(float (&d)[BN / 2], uint64_t da,
                                             uint64_t db) {
  if constexpr (BN == 256)
    wgmma_m64n256k16<1>(d, da, db);
  else
    wgmma_m64n128k16<1>(d, da, db);
}

// One stage with B MN-major: the 64 x BK K-major box of A against BN / 64
// boxes of B (BK x 64 each), as four k16 steps: A advances 32 bytes along
// its swizzled rows, B 16 K-rows.
template <int BN>
__device__ __forceinline__ void wgmma_stage_mn(float (&d)[BN / 2],
                                               const bf16* a, const bf16* b) {
  const uint64_t da = sw128_desc(a), db = sw128_desc_mn(b);
#pragma unroll
  for (int k = 0; k < BK / 16; ++k)
    wgmma_k16_mn<BN>(d, da + 2 * k, db + (MN_K16 >> 4) * k);
}

// A persistent grid walking `items` work items in turn: the largest
// count <= gridDim.x coprime to `items`, so that a block striding over
// the tiles by it meets every item residue rather than a fixed few.
__device__ __forceinline__ int stride_grid(int items) {
  auto coprime = [](int a, int b) {
    while (b) {
      const int r = a % b;
      a = b;
      b = r;
    }
    return a == 1;
  };
  int grid = gridDim.x;
  while (grid > 1 && !coprime(grid, items)) --grid;
  return grid;
}

// The ring: STAGES x (CONSUMERS A boxes + one B box of BN rows) and the
// two barriers of each stage.  Its boxes must sit 1024-byte aligned.
template <int STAGES, int CONSUMERS, int BN> struct Ring {
  static constexpr int B_TILE = BN * BK;  // bf16 elements of one B box
  bf16 a[STAGES][CONSUMERS][A_TILE];
  bf16 b[STAGES][B_TILE];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

// A block's dynamic shared memory as an S placed 1024-byte aligned;
// smem_bytes<S>() is the size to launch with.
template <typename S> constexpr size_t smem_bytes() {
  return sizeof(S) + 1024;  // + alignment slack
}
template <typename S> __device__ __forceinline__ S& smem_at(void* raw) {
  const uint32_t s = smem_u32(raw);
  const uint32_t pad = (1024 - (s & 1023)) & 1023;
  return *reinterpret_cast<S*>((char*)raw + pad);
}

// Position in the ring, advanced by both sides in the same order.
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  template <int STAGES> __device__ __forceinline__ void next() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// ---- host side -------------------------------------------------------

// The work list of the Hopper grouped kernels (grouped_matmul.cu:gmm_plan),
// built on the device by one block: work[j] = (first 64-row tile, tiles
// (1 or 2), expert or -1 past *num_rows, 0) for j < *n_work.  work holds
// T / 64 entries.
int gmm_plan_launch(const int* tile_gid, int block_m, const int* num_rows,
                    int T, int4* work, int* n_work, cudaStream_t stream);

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A tensor of `rank` dims of `type` (dims innermost first, strides in
// bytes of dims 1..rank-1) cut in boxes of `box` (128 bytes of the
// innermost dim at most), 128-byte swizzle unless `swizzle` says
// otherwise, zero fill out of bounds on loads, out-of-bounds elements
// dropped on stores.  Returns false when the encoding is refused.
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type,
                     const void* base, int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box,
                     CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, type, (cuuint32_t)rank,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hg
}  // namespace fm
