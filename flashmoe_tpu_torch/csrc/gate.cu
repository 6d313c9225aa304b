// Fused MoE gate: logits GEMM + softmax + top-k + routing statistics.
//
// Replaces the TPU kernel flashmoe_tpu/ops/gate.py:_gate_kernel (launched
// by router_pallas).  Same function: f32 logits x . gate_w, softmax over
// the E experts, iterative top-k in which the lowest index wins ties, and
// the three statistics the losses need: per-expert sums of softmax
// probabilities, per-expert selection counts and the sum of squared
// log-sum-exps (z-loss).
//
// What bounds it on an H100: the bytes of x ([S, H] read once); the
// 2*S*H*E operations are far below the card's rate for that traffic.  The
// design fills the card at every S, prefill and decode alike:
//
// * A block of 4 warps routes GT = 16 tokens over one of `split` slices of
//   H (ops/gate.py:gate_split: up to 32 slices, so a decode step of 4
//   Mixtral tokens still runs 32 blocks and a prefill of 1024 runs 2048;
//   fewer where E is wide; never a function of S, so a token's logits are
//   summed in one order in any batch).  Within
//   a block the warps split E's 8-wide column tiles when E is wide and the
//   H slice when E is narrow (GateWarps), so every thread has work at E 8.
// * x streams in chunks of 64 bytes of each token row: a lane loads 16
//   bytes of each of its two rows with one vector load, the next chunk's
//   loads issued before the current chunk's products.  gate_w's chunk
//   rows (a contiguous block of it) arrive by 16-byte cp.async in a
//   warp-private double buffer.
// * bf16 logits run on the tensor cores (mma.sync m16n8k16 bf16 -> f32):
//   the 16 bytes a lane loads are 8 consecutive h of its row, so within a
//   chunk h is permuted the same way for x and gate_w; the products are
//   exact in f32, only the summation order moves.  f32 runs on SIMT FMA
//   (no TF32) with the same register layout.
// * Merge: each block writes its partial logits [16, E] to scratch; the
//   last block of a token tile to finish (a ticket taken after
//   __threadfence) adds the partials in slice order and runs softmax,
//   top-k and the tile's statistics; the last tile to finish adds the
//   tiles' statistics and forms RouterOutput's fields as ops/gate.py's
//   _finish does (normalised weights, i64 ids and counts, mean
//   probabilities, aux and z losses), so a route is one launch.  Each
//   last block resets its ticket, so the tickets stay zero between
//   launches on a stream with no memset.  Every sum runs in a fixed order
//   (where threads share a sum, each adds a fixed stride of terms in
//   order and a fixed shuffle tree adds the threads): the results are the
//   same bit for bit on every run, whatever the blocks' schedule.
#include "common.cuh"

namespace fm {

constexpr int GT = 16;       // tokens per block: one mma row tile
constexpr int GWARPS = 4;
constexpr int GTHREADS = 32 * GWARPS;
constexpr int GKMAX = 32;    // most experts a token selects

// NT = E padded to a power of two >= 8, in 8-wide column tiles.  WN warps
// split the column tiles (NTW each), WK = 4 / WN split the H slice.
template <int NT> struct GateWarps {
  static constexpr int WN = NT >= GWARPS ? GWARPS : NT;
  static constexpr int WK = GWARPS / WN;
  static constexpr int NTW = NT / WN;
  static constexpr int NW = NTW * 8;  // columns of one warp
};

// a chunk is 64 bytes of a row, 16 bytes a lane
template <typename T> struct GateChunk {
  static constexpr int CH = 64 / (int)sizeof(T);   // h per chunk
  static constexpr int VEC = 16 / (int)sizeof(T);  // elements in 16 bytes
};

// Dynamic shared memory: per warp two stages of gate_w [CH][RS]; per
// warp the x tile [GT][CH + 1] (f32 only); the [WK][GT][8 NT] f32
// reduction area (later the tile's logits); the top-k ids and values; the
// squared lse's; the statistics' sums and the aux terms; the ticket flag.
template <typename T, int NT> struct GateSmem {
  using WP = GateWarps<NT>;
  using C = GateChunk<T>;
  static constexpr int RS = WP::NW + C::VEC;  // row stride: 16-byte pad
  static constexpr int W_ELEMS = GWARPS * 2 * C::CH * RS;
  static constexpr int X_FLOATS =
      sizeof(T) == 4 ? GWARPS * GT * (C::CH + 1) : 0;
  static constexpr int RED_FLOATS = WP::WK * GT * NT * 8;
  static constexpr size_t x_off = sizeof(T) * W_ELEMS;
  static constexpr size_t red_off = x_off + 4 * X_FLOATS;
  static constexpr size_t sel_off = red_off + 4 * RED_FLOATS;
  static constexpr size_t val_off = sel_off + 4 * GT * GKMAX;
  static constexpr size_t z_off = val_off + 4 * GT * GKMAX;
  static constexpr size_t fin_off = z_off + 4 * GT;  // [3][256] + 1
  static constexpr size_t flag_off = fin_off + 4 * (3 * 256 + 4);
  static constexpr size_t bytes = flag_off + 16;
};

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One chunk of one warp.  acc[j] is the m16n8 C fragment of the warp's
// column tile j: lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8,
// columns 2t and 2t + 1.  xa, xb: the lane's 16 bytes of rows g and g + 8
// (chunk h VEC*t .. VEC*t + VEC - 1); wst: the warp's stage [CH][RS].
template <int NTW>
__device__ __forceinline__ void gate_chunk(float (&acc)[NTW][4], uint4 xa,
                                           uint4 xb, const bf16* wst,
                                           float*, int lane) {
  constexpr int RS = NTW * 8 + 8;
  const int g = lane / 4, t = lane % 4;
  const uint32_t ax[4] = {xa.x, xa.y, xa.z, xa.w};
  const uint32_t bx[4] = {xb.x, xb.y, xb.z, xb.w};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    // mma k (2t, 2t + 1) is chunk h 8t + 4s + (0, 1), and mma k (2t + 8,
    // 2t + 9) is 8t + 4s + (2, 3): the same permutation for both operands
    const bf16* w0 = wst + (8 * t + 4 * s) * RS + g;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const bf16* wc = w0 + 8 * j;
      mma_bf16(acc[j], ax[2 * s], bx[2 * s], ax[2 * s + 1], bx[2 * s + 1],
               pack_bf16(wc[0], wc[RS]), pack_bf16(wc[2 * RS], wc[3 * RS]));
    }
  }
}

template <int NTW>
__device__ __forceinline__ void gate_chunk(float (&acc)[NTW][4], uint4 xa,
                                           uint4 xb, const float* wst,
                                           float* xs, int lane) {
  constexpr int RS = NTW * 8 + 4, CH = 16, XS = CH + 1;
  const int g = lane / 4, t = lane % 4;
  const float fa[4] = {__uint_as_float(xa.x), __uint_as_float(xa.y),
                       __uint_as_float(xa.z), __uint_as_float(xa.w)};
  const float fb[4] = {__uint_as_float(xb.x), __uint_as_float(xb.y),
                       __uint_as_float(xb.z), __uint_as_float(xb.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    xs[g * XS + 4 * t + i] = fa[i];
    xs[(g + 8) * XS + 4 * t + i] = fb[i];
  }
  __syncwarp();
#pragma unroll 4
  for (int h = 0; h < CH; ++h) {
    const float lo = xs[g * XS + h], hi = xs[(g + 8) * XS + h];
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const float2 b =
          *reinterpret_cast<const float2*>(&wst[h * RS + 8 * j + 2 * t]);
      acc[j][0] = fmaf(lo, b.x, acc[j][0]);
      acc[j][1] = fmaf(lo, b.y, acc[j][1]);
      acc[j][2] = fmaf(hi, b.x, acc[j][2]);
      acc[j][3] = fmaf(hi, b.y, acc[j][3]);
    }
  }
}

// Outputs of the gate, RouterOutput's fields (ops/gate.py): the combine
// weights (top-k probabilities over their sum), the ids, the counts, the
// mean probabilities and the two losses.
struct GateOut {
  float* combine;       // [S, K]
  long long* idx;       // [S, K]
  long long* counts;    // [E]
  float* probs_mean;    // [E]
  float* aux;           // []
  float* z;             // []
};

// Partial logits of block (tile, slice) -> part [split, S, E]; the merge
// by the last block of each tile; the statistics by the last tile.
// tickets: [ntiles + 1] zeros, left zero.
template <typename T, int NT>
__global__ void __launch_bounds__(GTHREADS)
gate_main(const T* __restrict__ x, const T* __restrict__ w, int S, int H,
          int E, int K, int split, float z_coef, float* __restrict__ part,
          unsigned* __restrict__ tickets, float* __restrict__ tile_probs,
          int* __restrict__ tile_cnt, float* __restrict__ tile_z,
          GateOut out) {
  using WP = GateWarps<NT>;
  using C = GateChunk<T>;
  using SM = GateSmem<T, NT>;
  constexpr int CH = C::CH, VEC = C::VEC, RS = SM::RS, NW = WP::NW;
  constexpr int EPD = NT * 8;
  extern __shared__ __align__(16) unsigned char gsm[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wn = warp % WP::WN, wk = warp / WP::WN;
  const int tile = blockIdx.x, sp = blockIdx.y, ntiles = gridDim.x;
  const int s0 = tile * GT;
  const int nch = H / CH;
  const int c_lo = (int)((long long)nch * sp / split);
  const int c_hi = (int)((long long)nch * (sp + 1) / split);
  const int e0 = wn * NW;
  T* ws = reinterpret_cast<T*>(gsm) + warp * 2 * CH * RS;
  float* xs = reinterpret_cast<float*>(gsm + SM::x_off) +
              warp * GT * (CH + 1);

  // columns past E stay zero in both stages
  for (int i = lane; i < 2 * CH * NW; i += 32)
    if (e0 + i % NW >= E) ws[(i / NW) * RS + i % NW] = from_f<T>(0.f);

  const int g = lane / 4, t = lane % 4;
  const bool va = s0 + g < S, vb = s0 + g + 8 < S;
  const T* xa_p = x + (size_t)(s0 + g) * H + VEC * t;
  const T* xb_p = x + (size_t)(s0 + g + 8) * H + VEC * t;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  const bool vec_w = E % VEC == 0;

  auto load_w = [&](int c, int st) {
    T* dst = ws + st * CH * RS;
    const T* src = w + (size_t)c * CH * E;
    if (vec_w) {
      constexpr int SEGS = NW / VEC;
      for (int i = lane; i < CH * SEGS; i += 32) {
        const int r = i / SEGS, cs = (i % SEGS) * VEC;
        if (e0 + cs < E)
          cp_async16(dst + r * RS + cs, src + (size_t)r * E + e0 + cs);
      }
    } else {
      for (int i = lane; i < CH * NW; i += 32) {
        const int r = i / NW, cc = i % NW;
        if (e0 + cc < E) dst[r * RS + cc] = src[(size_t)r * E + e0 + cc];
      }
    }
    cp_async_commit();
  };

  float acc[WP::NTW][4];
#pragma unroll
  for (int j = 0; j < WP::NTW; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  int c = c_lo + wk, st = 0;
  uint4 xa = zero4, xb = zero4;
  if (c < c_hi) {
    xa = va ? ldg16(xa_p + (size_t)c * CH) : zero4;
    xb = vb ? ldg16(xb_p + (size_t)c * CH) : zero4;
    load_w(c, 0);
  }
  for (; c < c_hi; c += WP::WK) {
    const int cn = c + WP::WK;
    uint4 na = zero4, nb = zero4;
    if (cn < c_hi) {
      na = va ? ldg16(xa_p + (size_t)cn * CH) : zero4;
      nb = vb ? ldg16(xb_p + (size_t)cn * CH) : zero4;
      load_w(cn, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    gate_chunk<WP::NTW>(acc, xa, xb, ws + st * CH * RS, xs, lane);
    __syncwarp();
    xa = na;
    xb = nb;
    st ^= 1;
  }

  // the block's partial: warps of one column range add in H-slice order
  float* red = reinterpret_cast<float*>(gsm + SM::red_off);
  {
    float* rw = red + wk * GT * EPD;
#pragma unroll
    for (int j = 0; j < WP::NTW; ++j) {
      const int col = e0 + 8 * j + 2 * t;
      rw[g * EPD + col] = acc[j][0];
      rw[g * EPD + col + 1] = acc[j][1];
      rw[(g + 8) * EPD + col] = acc[j][2];
      rw[(g + 8) * EPD + col + 1] = acc[j][3];
    }
  }
  __syncthreads();
  const int nvalid = min(GT, S - s0);
  for (int i = threadIdx.x; i < nvalid * E; i += GTHREADS) {
    const int r = i / E, e = i % E;
    float v = red[r * EPD + e];
    for (int q = 1; q < WP::WK; ++q) v += red[(q * GT + r) * EPD + e];
    part[((size_t)sp * S + s0 + r) * E + e] = v;
  }
  int* flag = reinterpret_cast<int*>(gsm + SM::flag_off);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *flag = atomicAdd(&tickets[tile], 1u) == (unsigned)(split - 1);
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  if (threadIdx.x == 0) tickets[tile] = 0;

  // merge: the tile's logits, slices added in order.  With many slices,
  // tpe threads share one element: each adds every tpe-th slice in order,
  // then a fixed shuffle tree adds their sums.  tpe follows the slice
  // count alone, so the order never depends on the batch.
  float* lg = red;  // [nvalid][E]
  const int nel = nvalid * E;
  int tpe = 1;
  while (tpe < 32 && tpe * 8 < split) tpe *= 2;
  const int groups = GTHREADS / tpe, sub = threadIdx.x % tpe;
  for (int i = threadIdx.x / tpe; i < (nel + groups - 1) / groups * groups;
       i += groups) {
    float v = 0.f;
    if (i < nel) {
      const int r = i / E, e = i % E;
      const float* p = part + (size_t)(s0 + r) * E + e;
#pragma unroll 8
      for (int q = sub; q < split; q += tpe)
        v += __ldcg(p + (size_t)q * S * E);
    }
    for (int off = tpe / 2; off; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (i < nel && sub == 0) lg[i] = v;
  }
  __syncthreads();

  int* tsel = reinterpret_cast<int*>(gsm + SM::sel_off);  // [GT][GKMAX]
  float* tval = reinterpret_cast<float*>(gsm + SM::val_off);
  float* zrow = reinterpret_cast<float*>(gsm + SM::z_off);
  float* fin_p = reinterpret_cast<float*>(gsm + SM::fin_off);  // [E]
  int* fin_c = reinterpret_cast<int*>(fin_p + 256);             // [E]
  float* fin_t = fin_p + 512;  // [E] aux terms, then [256] the z sum
  for (int r = warp; r < nvalid; r += GWARPS) {
    const int s = s0 + r;
    float* row = lg + r * E;
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
        for (int q = 0; q < kk; ++q) taken |= (tsel[r * GKMAX + q] == e);
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
        tsel[r * GKMAX + kk] = bi;
        tval[r * GKMAX + kk] = bv;
      }
      __syncwarp();
    }
    if (lane == 0) {
      float den = 0.f;
      for (int kk = 0; kk < K; ++kk) den += tval[r * GKMAX + kk];
      den = fmaxf(den, 1e-20f);
      for (int kk = 0; kk < K; ++kk) {
        out.combine[(size_t)s * K + kk] = tval[r * GKMAX + kk] / den;
        out.idx[(size_t)s * K + kk] = tsel[r * GKMAX + kk];
      }
      const float lse = m + logf(se);
      zrow[r] = lse * lse;
    }
  }
  __syncthreads();

  // the tile's statistics, tokens in order (with one tile, the sums)
  const bool one = ntiles == 1;
  for (int e = threadIdx.x; e < E; e += GTHREADS) {
    float p = 0.f;
    int cnt = 0;
    for (int r = 0; r < nvalid; ++r) {
      p += lg[r * E + e];
      for (int kk = 0; kk < K; ++kk) cnt += (tsel[r * GKMAX + kk] == e);
    }
    (one ? fin_p : tile_probs + (size_t)tile * E)[e] = p;
    (one ? fin_c : tile_cnt + (size_t)tile * E)[e] = cnt;
  }
  if (threadIdx.x == 0) {
    float z = 0.f;
    for (int r = 0; r < nvalid; ++r) z += zrow[r];
    *(one ? fin_t + 256 : tile_z + tile) = z;
  }
  if (!one) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      *flag = atomicAdd(&tickets[ntiles], 1u) == (unsigned)(ntiles - 1);
    __syncthreads();
    if (!*flag) return;
    __threadfence();
    if (threadIdx.x == 0) tickets[ntiles] = 0;

    // the last tile: statistics over the tiles.  Warp w takes outputs w,
    // w + 4, ... (output E is the z sum); lane l adds tiles l, l + 32, ...
    // in order, then a fixed shuffle tree adds the lanes.
    for (int o = warp; o <= E; o += GWARPS) {
      float p = 0.f;
      int cnt = 0;
      for (int tl = lane; tl < ntiles; tl += 32) {
        if (o < E) {
          p += __ldcg(tile_probs + (size_t)tl * E + o);
          cnt += __ldcg(tile_cnt + (size_t)tl * E + o);
        } else {
          p += __ldcg(tile_z + tl);
        }
      }
      p = warp_sum(p);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
      if (lane == 0) {
        if (o < E) {
          fin_p[o] = p;
          fin_c[o] = cnt;
        } else {
          fin_t[256] = p;
        }
      }
    }
  }
  __syncthreads();

  // RouterOutput's statistics and losses, as ops/gate.py:_finish forms
  // them: probs_mean = sums / S, aux = E * sum_e(counts_e / (S K) *
  // probs_mean_e) * K (the sum by a fixed shuffle tree), z = (zsum / S) *
  // coefficient
  for (int e = threadIdx.x; e < E; e += GTHREADS) {
    const float pm = fin_p[e] / (float)S;
    out.probs_mean[e] = pm;
    out.counts[e] = fin_c[e];
    fin_t[e] = (float)fin_c[e] / (float)(S * K) * pm;
  }
  __syncthreads();
  if (warp == 0) {
    float a = 0.f;
    for (int e = lane; e < E; e += 32) a += fin_t[e];
    a = warp_sum(a);
    if (lane == 0) {
      *out.aux = (float)E * a * (float)K;
      *out.z = fin_t[256] / (float)S * z_coef;
    }
  }
}

template <typename T, int NT>
int gate_launch(const void* x, const void* w, int S, int H, int E, int K,
                int split, float z_coef, float* scratch, unsigned* tickets,
                const GateOut& out, cudaStream_t stream) {
  constexpr size_t smem = GateSmem<T, NT>::bytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gate_main<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int ntiles = (S + GT - 1) / GT;
  float* part = scratch;
  float* tile_probs = part + (size_t)split * S * E;
  int* tile_cnt = reinterpret_cast<int*>(tile_probs + (size_t)ntiles * E);
  float* tile_z = reinterpret_cast<float*>(tile_cnt + (size_t)ntiles * E);
  gate_main<T, NT><<<dim3(ntiles, split), GTHREADS, smem, stream>>>(
      (const T*)x, (const T*)w, S, H, E, K, split, z_coef, part, tickets,
      tile_probs, tile_cnt, tile_z, out);
  return (int)cudaGetLastError();
}

template <typename T>
int gate_dispatch(const void* x, const void* w, int S, int H, int E, int K,
                  int split, float z_coef, float* scratch, unsigned* tickets,
                  const GateOut& out, cudaStream_t stream) {
#define FM_GATE(NT)                                                     \
  return gate_launch<T, NT>(x, w, S, H, E, K, split, z_coef, scratch,  \
                            tickets, out, stream)
  if (E <= 8) FM_GATE(1);
  if (E <= 16) FM_GATE(2);
  if (E <= 32) FM_GATE(4);
  if (E <= 64) FM_GATE(8);
  if (E <= 128) FM_GATE(16);
  FM_GATE(32);
#undef FM_GATE
}

}  // namespace fm

// One launch, RouterOutput's six fields out: combine f32 [S, K], idx i64
// [S, K], counts i64 [E], probs_mean f32 [E], aux f32 [], z f32 [].
// Scratch f32 [split * S * E + 2 * nt * E + nt] with nt = ceil(S / 16)
// (the partial logits, the tiles' probability sums, counts and z sums);
// tickets u32 [nt + 1], zero on entry and left zero (launches that share
// them run in stream order).  Needs S >= 1, H % 32 == 0, 1 <= split <= H /
// (64 / sizeof(dtype)), E <= 256, K <= min(E, 32).
extern "C" int fm_gate(int is_bf16, const void* x, const void* w, int S,
                       int H, int E, int K, int split, float z_coef,
                       float* scratch, unsigned* tickets, float* combine,
                       long long* idx, long long* counts, float* probs_mean,
                       float* aux, float* z, cudaStream_t stream) {
  const fm::GateOut out{combine, idx, counts, probs_mean, aux, z};
  if (is_bf16)
    return fm::gate_dispatch<fm::bf16>(x, w, S, H, E, K, split, z_coef,
                                       scratch, tickets, out, stream);
  return fm::gate_dispatch<float>(x, w, S, H, E, K, split, z_coef, scratch,
                                  tickets, out, stream);
}
