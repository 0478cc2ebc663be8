// Paged attention over a block-pooled KV cache, and quantize-on-scatter
// into it, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of
// pytorch_distributed_tpu/ops/paged_flash.py:
//   - the single sweep  (paged_flash_attention, pallas_call at :375;
//     kernel _paged_kernel :159, body _attend_block :108), and
//   - the flash-decoding split (pallas_call at :430; kernel
//     _paged_split_kernel :197) together with its fp32 log-sum-exp merge,
//     which the JAX package runs in jnp after its kernel (:444-459),
//     both with their in-kernel dequantization of int8/fp8 pools
//     (:119-130); and
//   - paged_quantize_scatter (pallas_call at :563, body :532): with bf16 q
//     written by the tensor-core sweep and split themselves, before they
//     read the rows (the append route, paged_tc_body), else by
//     quantize_scatter_kernel, further down this file.
//
// What it computes: each query head h = kv * G + g (GQA group G) at chunk
// index c attends to pools [n_blocks, block_len, H_kv, D] through block
// tables [B, W]. Key position j is visible to query (b, c) iff
// j <= qpos[b, c]; a padding row carries qpos = -1 and comes out 0. q is
// scaled in its own dtype, QK^T and the softmax statistics (m, l, acc) are
// fp32, p is rounded to V's dtype before PV, as _attend_block does.
//
// Pools are q's dtype, or quantized: int8 rows with an fp32 scale, or
// fp8 (e4m3 / e5m2) rows with an int8 exponent e, one per (block, slot,
// KV head) in scales [n_blocks, bl, H_kv]. The reference dequantizes a
// row to fp32, code * scale or code * 2^e (2^e built here exactly from its
// exponent bits), and keeps p in fp32 for PV there.
//
// What bounds it on the H100: the bytes of the attended K/V chain (on a
// quantized pool its one-byte codes plus a scale a row). Each pool
// element it reads feeds ~2 flops per query row (R = G * C rows share a
// KV head; R = 1 for an MHA decode tick), far below the ~295 flops/byte
// where the tensor cores would be the limit, so the least time is the
// visible chain's bytes over 3.35 TB/s.
//
// What the design does about it: the single sweep and the split with bf16
// q on bf16, int8, fp8 e4m3 and fp8 e5m2 pools are paged_sweep_tc_kernel
// and paged_split_tc_kernel, below (tensor cores, a TMA ring, 64-row
// tiles; on a quantized pool the codes land as they are, half a bf16
// stage's bytes, and the scales stay outside the products). fp32 q and
// fp32 pools, and the head dims and block lengths the TMA boxes do not
// take, run the CUDA-core walk:
//   - One thread block per (row tile, KV head, batch row[, split worker])
//     reads its own table entries; the TPU's sequential chain axis becomes
//     a loop. Its 4 warps take every 4th pool block of the range, each with
//     its own online softmax in registers, so no block-wide barrier sits in
//     the loop and four blocks' loads are in flight per thread block. The
//     warps' states merge once at the end, through shared memory.
//   - In a warp, lane (k, half) holds key k of a 16-key pass and half of
//     its D elements, loaded as 16-byte vectors straight from the pool: a
//     chain byte is read from HBM once per row tile, and the gathered
//     sequence never exists. For PV each lane owns D/32 output columns.
//   - The walk stops at the tile's frontier, so a ragged batch reads only
//     the blocks it attends.
//   - The split variant gives a long chain S thread blocks so a decode tick
//     of few, long requests fills the 132 SMs; the last of the S blocks to
//     finish (an atomic ticket) merges the S fp32 partials and writes the
//     output, so the merge costs no second launch.
// The walk dequantizes a quantized row to fp32 as it loads it. Its row
// tile is kRows = 8 rows, so a prefill chunk of R = 32 rows reads its
// chain four times.

#include <cuda_fp8.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;          // query rows per thread block (a row tile)
constexpr int kKeysPerPass = 16;  // keys per warp pass: 16 keys x 2 halves
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/attention.py

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_fp8_e5m2 x) { return static_cast<float>(x); }

// 2^e for an integer e in [-126, 127], from the exponent bits: exact
__device__ __forceinline__ float pow2(int e) { return __int_as_float((e + 127) << 23); }

// Scale kinds of a pool: none (float pool), an fp32 multiplier (int8
// pool) or an int8 exponent (fp8 pools).
constexpr int kNoScale = 0;
constexpr int kMultiplier = 1;
constexpr int kExponent = 2;

// Pool kinds, as the entry points' `pool` argument: pools in q's dtype, or
// int8 / fp8 e4m3 / fp8 e5m2 codes.
constexpr int kPoolFloat = 0;
constexpr int kPoolInt8 = 1;
constexpr int kPoolE4M3 = 2;
constexpr int kPoolE5M2 = 3;

// the dequantization factor of scales[i]
template <int kScale>
__device__ __forceinline__ float row_scale(const void* scales, int64_t i) {
  if constexpr (kScale == kMultiplier) return __ldg(static_cast<const float*>(scales) + i);
  if constexpr (kScale == kExponent)
    return pow2(__ldg(static_cast<const signed char*>(scales) + i));
  return 1.f;
}

// scales[i] as loaded, for the tensor-core producer's registers: the fp32
// multiplier, or the int8 exponent's sign-extended bits (the load feeds no
// instruction until scale_of, so the warp does not wait for it). A
// coherent load (kCoherent, through L2) sees a scale that this block wrote
// earlier in the launch, where the non-coherent one may not.
template <int kScale, bool kCoherent>
__device__ __forceinline__ float raw_scale(const void* scales, int64_t i) {
  if constexpr (kScale == kMultiplier) {
    const float* s = static_cast<const float*>(scales) + i;
    return kCoherent ? __ldcg(s) : __ldg(s);
  }
  const signed char* s = static_cast<const signed char*>(scales) + i;
  return __int_as_float(kCoherent ? __ldcg(s) : __ldg(s));
}

// the dequantization factor of a raw_scale
template <int kScale>
__device__ __forceinline__ float scale_of(float raw) {
  if constexpr (kScale == kMultiplier) return raw;
  return pow2(__float_as_int(raw));
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x as a T would hold it (round to nearest even), back in fp32.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// N contiguous elements of T at src into fp32 registers, in the widest
// aligned vectors the byte count allows (the host checks the alignment).
template <int N, typename T>
__device__ __forceinline__ void load_vec(float (&dst)[N], const T* src) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src) + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < kPer; ++k) dst[i * kPer + k] = to_float(e[k]);
    }
  } else if constexpr (kBytes % 8 == 0) {
    constexpr int kPer = 8 / sizeof(T);
#pragma unroll
    for (int i = 0; i < kBytes / 8; ++i) {
      const uint2 raw = __ldg(reinterpret_cast<const uint2*>(src) + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < kPer; ++k) dst[i * kPer + k] = to_float(e[k]);
    }
  } else if constexpr (kBytes % 4 == 0) {
    constexpr int kPer = 4 / sizeof(T);
#pragma unroll
    for (int i = 0; i < kBytes / 4; ++i) {
      const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(src) + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < kPer; ++k) dst[i * kPer + k] = to_float(e[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) dst[k] = to_float(src[k]);
  }
}

struct Params {
  const void* q;        // q[b, c, h, :] at q + b*q_sb + c*q_sc + h*q_sh
  int64_t q_sb, q_sc, q_sh;
  const void* k_pool;   // [n_blocks, bl, H_kv, D]
  const void* v_pool;
  const void* k_scale;  // [n_blocks, bl, H_kv] for quantized pools, else null
  const void* v_scale;
  const int* tables;    // [B, W]
  const int* qpos;      // [B, C]
  void* out;            // [B, C, H_kv * G, D]
  float* part_acc;      // split: [B, H_kv, S, R, D]
  float* part_m;        // split: [B, H_kv, S, R]
  float* part_l;
  int* tickets;         // split: [B, H_kv, n_row_tiles], zero on entry
  int H_kv, G, C, bl, W, S, wc;
  float scale;
};

// grid (n_row_tiles * S, H_kv, B); S == 1 for the single sweep. T is q's
// and the output's type, P the pools' element type, kScale its scale kind.
template <typename T, typename P, int kScale, int kDpl, bool kSplit>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(const Params p) {
  constexpr bool kQuant = kScale != kNoScale;
  constexpr int D = 32 * kDpl;
  constexpr int kHalf = D / 2;
  constexpr int kQStride = kHalf + 1;  // padded: the two halves sit on other banks
  __shared__ float q_s[kRows * 2 * kQStride];
  __shared__ float red_acc[kWarps * kRows * D];
  __shared__ float red_m[kWarps * kRows];
  __shared__ float red_l[kWarps * kRows];
  __shared__ int qp_s[kRows];
  __shared__ int is_last;

  const int R = p.G * p.C;
  const int n_rt = (R + kRows - 1) / kRows;
  const int rt = blockIdx.x % n_rt;
  const int s = blockIdx.x / n_rt;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = rt * kRows;
  const int nr = min(kRows, R - row0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int H = p.H_kv * p.G;

  // row r of the tile is query head h * G + g at chunk index c
  const T* q = static_cast<const T*>(p.q);
  const float scale_t = round_to<T>(p.scale);  // q * scale in q's dtype
  for (int i = tid; i < nr * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int g = (row0 + r) / p.C;
    const int c = (row0 + r) - g * p.C;
    const float x = to_float(q[b * p.q_sb + c * p.q_sc + (h * p.G + g) * p.q_sh + d]);
    q_s[(2 * r + d / kHalf) * kQStride + d % kHalf] = round_to<T>(x * scale_t);
  }
  if (tid < kRows) {
    const int c = (row0 + tid) % p.C;
    qp_s[tid] = tid < nr ? p.qpos[static_cast<int64_t>(b) * p.C + c] : -1;
  }
  __syncthreads();

  int qp[kRows];
  int frontier = -1;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    qp[r] = qp_s[r];
    frontier = max(frontier, qp[r]);
  }
  // this worker's range of the chain, cut at the tile's frontier: a block
  // whose first key lies past every row's position is all masked
  const int j_begin = kSplit ? s * p.wc : 0;
  const int j_end = kSplit ? min(p.W, j_begin + p.wc) : p.W;
  const int j_stop = frontier < 0 ? j_begin : min(j_end, frontier / p.bl + 1);

  float m[kRows], l[kRows], acc[kRows][kDpl];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int k = 0; k < kDpl; ++k) acc[r][k] = 0.f;
  }

  const P* k_pool = static_cast<const P*>(p.k_pool);
  const P* v_pool = static_cast<const P*>(p.v_pool);
  const int64_t row_stride = static_cast<int64_t>(p.H_kv) * D;
  const int kl = lane & (kKeysPerPass - 1);  // this lane's key in a pass
  const int half = lane >> 4;                // and its half of D
  const float* qh = q_s + half * kQStride;

  const int* table = p.tables + static_cast<int64_t>(b) * p.W;
  for (int j0 = j_begin + warp; j0 < j_stop; j0 += 32 * kWarps) {
    // lane i reads the table entry of the i-th block this warp walks from
    // j0, one load for up to 32 blocks; the walk takes them by shuffle
    const int jl = j0 + lane * kWarps;
    const int my_blk = jl < j_stop ? __ldg(table + jl) : 0;
    const int n_walk = min(32, (j_stop - j0 + kWarps - 1) / kWarps);
    for (int i = 0; i < n_walk; ++i) {
      const int j = j0 + i * kWarps;
      const int64_t blk = __shfl_sync(kFull, my_blk, i);
      const int64_t base = (blk * p.bl * p.H_kv + h) * D;  // element (blk, 0, h, 0)
      for (int t0 = 0; t0 < p.bl; t0 += kKeysPerPass) {
        const int t = t0 + kl;
        const bool t_in = t < p.bl;
        const int nk = min(kKeysPerPass, p.bl - t0);
        // every load of the pass is in flight before any use: one memory latency
        // per pass, not one per key. Rows past the block repeat its last
        // row; their p is 0.
        const int t_row = min(t, p.bl - 1);
        float kr[kHalf];
        load_vec<kHalf>(kr, k_pool + base + t_row * row_stride + half * kHalf);
        float v[kKeysPerPass][kDpl];
#pragma unroll
        for (int tt = 0; tt < kKeysPerPass; ++tt)
          load_vec<kDpl>(v[tt], v_pool + base + (t0 + min(tt, nk - 1)) * row_stride +
                                    lane * kDpl);
        if constexpr (kQuant) {
          // this lane's key's scales; key tt's V scale comes from lane tt
          const int64_t srow = (blk * p.bl + t_row) * p.H_kv + h;
          const float ks = row_scale<kScale>(p.k_scale, srow);
          const float vs = row_scale<kScale>(p.v_scale, srow);
#pragma unroll
          for (int d = 0; d < kHalf; ++d) kr[d] *= ks;
#pragma unroll
          for (int tt = 0; tt < kKeysPerPass; ++tt) {
            const float vst = __shfl_sync(kFull, vs, tt);
#pragma unroll
            for (int k = 0; k < kDpl; ++k) v[tt][k] *= vst;
          }
        }
        const int kpos = j * p.bl + t;
        float pr[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          pr[r] = 0.f;
          if (r < nr) {
            const float* qr = qh + 2 * r * kQStride;
            float sc = 0.f;
#pragma unroll
            for (int d = 0; d < kHalf; ++d) sc += qr[d] * kr[d];
            sc += __shfl_xor_sync(kFull, sc, 16);
            const bool vis = t_in && kpos <= qp[r];
            sc = vis ? sc : kNegInf;
            float mb = sc;
#pragma unroll
            for (int o = kKeysPerPass / 2; o > 0; o >>= 1)
              mb = fmaxf(mb, __shfl_xor_sync(kFull, mb, o));
            const float m_new = fmaxf(m[r], mb);
            const float pv = vis ? expf(sc - m_new) : 0.f;  // p * mask
            float ps = pv;
#pragma unroll
            for (int o = kKeysPerPass / 2; o > 0; o >>= 1)
              ps += __shfl_xor_sync(kFull, ps, o);
            const float corr = expf(m[r] - m_new);
            l[r] = l[r] * corr + ps;
            m[r] = m_new;
#pragma unroll
            for (int k = 0; k < kDpl; ++k) acc[r][k] *= corr;
            pr[r] = kQuant ? pv : round_to<T>(pv);  // p in V's dtype before PV
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < nr) {
#pragma unroll
            for (int tt = 0; tt < kKeysPerPass; ++tt) {
              const float pt = __shfl_sync(kFull, pr[r], tt);
#pragma unroll
              for (int k = 0; k < kDpl; ++k) acc[r][k] += pt * v[tt][k];
            }
          }
        }
      }
    }
  }

  // merge the warps' states: a warp that saw no visible key holds
  // (m = NEG_INF, l = 0, acc = 0) and drops out
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < nr) {
#pragma unroll
      for (int k = 0; k < kDpl; ++k)
        red_acc[(warp * kRows + r) * D + lane * kDpl + k] = acc[r][k];
      if (lane == 0) {
        red_m[warp * kRows + r] = m[r];
        red_l[warp * kRows + r] = l[r];
      }
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out);
  const int R_all = R;
  for (int i = tid; i < nr * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    float ms = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) ms = fmaxf(ms, red_m[w * kRows + r]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float al = expf(red_m[w * kRows + r] - ms);
      a += red_acc[(w * kRows + r) * D + d] * al;
      ls += red_l[w * kRows + r] * al;
    }
    if constexpr (kSplit) {
      const int64_t pr = ((static_cast<int64_t>(b) * p.H_kv + h) * p.S + s) * R_all + row0 + r;
      p.part_acc[pr * D + d] = a;
      if (d == 0) {
        p.part_m[pr] = ms;
        p.part_l[pr] = ls;
      }
    } else {
      const int g = (row0 + r) / p.C;
      const int c = (row0 + r) - g * p.C;
      // fully masked rows (l == 0) come out 0 through the epsilon
      out[((static_cast<int64_t>(b) * p.C + c) * H + h * p.G + g) * D + d] =
          from_float<T>(a / fmaxf(ls, 1e-37f));
    }
  }

  if constexpr (kSplit) {
    // the last worker of this (b, h, row tile) to finish merges all S
    __threadfence();
    __syncthreads();
    int* ticket = p.tickets + (static_cast<int64_t>(b) * p.H_kv + h) * n_rt + rt;
    if (tid == 0) is_last = atomicAdd(ticket, 1) == p.S - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    const int64_t pb = (static_cast<int64_t>(b) * p.H_kv + h) * p.S;
    for (int i = tid; i < nr * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      float ms = kNegInf;
      for (int w = 0; w < p.S; ++w)
        ms = fmaxf(ms, __ldcg(p.part_m + (pb + w) * R_all + row0 + r));
      float a = 0.f, ls = 0.f;
      for (int w = 0; w < p.S; ++w) {
        const int64_t pr = (pb + w) * R_all + row0 + r;
        const float al = expf(__ldcg(p.part_m + pr) - ms);
        a += __ldcg(p.part_acc + pr * D + d) * al;
        ls += __ldcg(p.part_l + pr) * al;
      }
      const int g = (row0 + r) / p.C;
      const int c = (row0 + r) - g * p.C;
      out[((static_cast<int64_t>(b) * p.C + c) * H + h * p.G + g) * D + d] =
          from_float<T>(a / fmaxf(ls, 1e-37f));
    }
    if (tid == 0) *ticket = 0;  // ready for reuse
  }
}

// ---------------------------------------------------------------------------
// The single sweep and the split with bf16 q on bf16, int8 and fp8 pools,
// on tensor cores, fed by TMA: one body, paged_tc_body, and two kernels,
// templated on the pool kind.
//
// One thread block per (row tile, KV head, batch row[, split worker]): the
// sweep's four consumer warps take tiles of up to 64 rows, so every R = G *
// C row of a KV head up to 64 shares one block and a chain byte is read
// from HBM once per (batch row, KV head); rows past a tile take further
// tiles (the split's two warps: 32 rows). One producer warp.
//   - Loads: the producer walks the chain up to the tile's frontier in
//     stages of 64 keys, a ring of kStages stages under full/empty
//     mbarriers. Each stage is whole TMA boxes of the pool viewed as
//     [n_blocks * bl, H_kv, D] (box (64, 1, min(bl, 64)), 128-byte
//     swizzle, D = 128 two boxes), one per pool block (bl <= 64) or per 64
//     rows of one (bl a multiple of 64), so several pool blocks of K and V
//     are in flight while the consumers compute. The producer's lanes hold
//     the pool rows of the next 32 boxes and of the 32 after them (one
//     table read per lane, a batch ahead); a box past the frontier is
//     asked for out of bounds and lands as zeros, reading no HBM.
//   - Products: QK^T and PV on mma.sync m16n8k16 (bf16 in, fp32 sums), a
//     warp owning 16 rows; K fragments by ldmatrix, V fragments by
//     ldmatrix.trans, both conflict-free on the swizzled boxes; p goes from
//     the S accumulators to the A operand in registers, rounded to bf16.
//     Not wgmma: a decode tick has R = G rows (1 for MHA), where wgmma's
//     64-row tile would waste 63 rows of each product, and the work is
//     bound by the chain's bytes at any R <= 64, far from the tensor cores'
//     rate, so mma.sync's 16-row tile serves every R.
//   - Warps: with kCW consumer warps and n16 = ceil(rows / 16) row groups,
//     the kCW / n16 key groups (the sweep's: 4 at R <= 16, 2 at R <= 32, 1
//     above) take every (kCW / n16)-th stage, each with its own fp32 online
//     softmax; at the end group 0 merges the others' states, passed through
//     shared memory, into its registers and writes the rows. The ring's
//     stage count is a multiple of kCW, so ring slot s belongs to key group
//     s % (kCW / n16) and a group meets its slots' phases in order: an
//     mbarrier parity wait cannot tell a phase from the one two ahead, so a
//     group running ahead must never wait on another group's slot.
// Semantics as the CUDA-core walk: q scaled in its dtype, S and (m, l, acc)
// fp32, p rounded to bf16 before PV, a padding row (qpos = -1) 0.
//
// Quantized pools (kPool int8, e4m3, e5m2): what bounds them is the chain's
// one-byte codes and a scale a row, about half a bf16 chain's bytes.
//   - The codes land by TMA as they are (box (D bytes, 1, min(bl, 64)),
//     the 64-byte swizzle at D = 64, the 128-byte one at 128), so a stage
//     holds 64 keys of K and V in half a bf16 stage's bytes. The producer
//     also loads the stage's 128 scales, four stages ahead into fixed
//     registers, from the pool rows it already holds for the boxes, so
//     their latency hides behind the ring (a load whose address waited on
//     a table load would stall the warp every stage), and writes them
//     beside the ring. The stage's full barrier takes its bytes before the
//     TMA copies go out and the producer's arrival after the scales are
//     written, which releases them: the copies never wait on the scales.
//   - Every int8, e4m3 and e5m2 value is exact in bf16, so the consumers
//     widen the codes exactly, straight into mma.sync B fragments (widen4:
//     integer and bf16 operations, none of the slower conversion pipe's):
//     no converted copy in shared memory, so the split keeps its six
//     blocks an SM, and no barrier beyond the ring's. The products work on
//     the codes themselves, and the scales stay outside them:
//       S[r, j]   = ks[j] * sum_d (q scale)[r, d] k_code[j, d]
//       acc[r, d] = sum_j (p[r, j] vs[j]) v_code[j, d]
//     with l summing the unscaled p. P' = p vs goes to the tensor cores as
//     two bf16 terms, hi = bf16(P') and lo = bf16(P' - hi), in two products
//     accumulated in fp32: ~16 bits of P' where the reference keeps fp32
//     (the walk's fp32 p), at ~2 flops a byte, far from the tensor cores'
//     rate. K's reduction index is permuted (lane t holds 16 contiguous
//     columns of a key row, one 16-byte read, paired as widen4 pairs its
//     codes), and so are the keys (lane t's four keys of a 16-key step are
//     contiguous, 4 t .. 4 t + 3, as PV's B fragment needs them) and V's
//     output columns (lane g holds columns g D/8 .. g D/8 + D/8 - 1): acc
//     and the split's partials keep that fragment order, and the rows are
//     written out through it.
//   - The scales cost 4 bytes (int8) or 1 byte (fp8) a row, read once. A
//     converted row costs ~2-3 instructions a code, once per warp that
//     reads it (a key group's warps each widen the whole stage).
//
// The append route (quantized pools, k_new set): the launch also writes the
// chunk's new K/V rows into the pools, kernel 9's work (paged_quantize_
// scatter, pallas_call at :563), so a layer's tick is one launch, not two.
// Kernel 9 costs its launch, not its bytes (under 25 KB a decode layer);
// what a fused write must not cost is the sweep's critical path.
//   - Who writes: every block whose keys [k_begin, k_stop) hold a new row's
//     position writes that row (for its KV head), before it reads it; blocks
//     that read the same keys (the row tiles of G > 1) write the same bytes.
//     Every row is written: its own row tile's frontier is at least its
//     position, so one of that tile's active workers holds it.
//   - The consumer warps write (append_rows) while the ring's first stages
//     land: they are idle until then. Each thread fences its stores for the
//     async proxy (fence.proxy.async.global) and arrives on `wrote`.
//   - The producer issues the stages before i_new, the first stage holding
//     a new row, at once, and waits on `wrote` (then fences) before stage
//     i_new's TMA copies. The new rows sit at the frontier, so i_new is
//     usually a span's last stage and the wait finds the writes done.
//   - Scales are read by plain loads, not TMA, kAhead stages early and by
//     the non-coherent path, which need not see this launch's writes: from
//     stage i_new on, each stage's scales are loaded through L2 as it goes
//     out (behind its TMA copies' own latency), never ahead. Each load site
//     takes one path, fixed at compile time: a load chosen between the two
//     at run time (a select of both) stalled the producer every stage (fp8
//     sweep at decode 40 -> 62 us of device time).
//
// The split (paged_split_tc_kernel): worker s of S reads chain blocks
// [s wc, min((s + 1) wc, W)), wc = ceil(W / S), cut at the tile's frontier,
// in stages of 64 keys from its first key; workers whose span starts past
// the frontier leave at once. A decode tick's longest chain (2,048 keys,
// 512 KB of K/V for one block in the sweep) becomes S spans of 256 keys,
// and its S x H_kv x B = 768 blocks are short-lived: their prologue and
// epilogue latencies, not their bytes, set the time when they run in
// rounds. So the split's blocks are small: two consumer warps (row tiles of
// 32 rows) and a two-stage ring, 32 KB at D = 64, so six blocks share an SM
// and all 768 are resident at once, 192 KB of K/V in flight an SM. Each
// active worker writes fp32 partials (acc unnormalized, m, l), takes a
// ticket, and the last of them merges the partials in worker order, so two
// launches give the same bits, and resets the ticket, so the caller zeroes
// the tickets once, not per launch.

constexpr int kStageKeys = 64;  // chain keys per ring stage
constexpr int kSplitWarps = 2;  // the split's consumer warps: row tiles of 32
constexpr int kSplitStages = 2;
constexpr int kBoxCols = 64;                   // 128 bytes: the swizzle's span
constexpr int kBoxBytes = kStageKeys * kBoxCols * 2;

// address of (key, column) in a stage's tile of 128-byte-swizzled boxes
// (1024-byte aligned): 16-byte chunk j of row r sits at j ^ (r % 8)
__device__ __forceinline__ uint32_t swizzled(uint32_t tile, int key, int col) {
  const uint32_t off = key * 128 + (col % kBoxCols) * 2;
  return tile + (col / kBoxCols) * kBoxBytes + (off ^ (((off >> 7) & 7) << 4));
}

// four 8x8 bf16 matrices; lane 8i + r gives row r of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&x)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&x)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(addr));
}

// C[16x8] += A[16x16] B[16x8]: lane 4g + t holds a = A[g][2t, 2t+1],
// A[g+8][..], A[g][2t+8, 2t+9], A[g+8][..]; b = B[2t, 2t+1][g],
// B[2t+8, 2t+9][g]; c = C[g][2t, 2t+1], C[g+8][2t, 2t+1]
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of (key, column byte) in a stage's tile of one-byte codes,
// kD bytes a key, as TMA lands it (1024-byte aligned): 16-byte chunk j of
// row r at j ^ (r / 2 % 4) with the 64-byte swizzle (kD 64), j ^ (r % 8)
// with the 128-byte one (kD 128)
template <int kD>
__device__ __forceinline__ int swizzled8(int key, int col) {
  const int off = key * kD + col;
  return off ^ ((off >> 3) & (kD == 64 ? 0x30 : 0x70));
}

// a * b on bf16x2 (+ -0, which changes no product)
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

// the four codes of w = [c0, c1, c2, c3] as two bf16x2, exactly (every
// int8, e4m3 and e5m2 value is a bf16 value): lo = (c0, c2), hi = (c1, c3),
// in integer and fp32/bf16 pipes alone (the conversion pipe is the slow one).
//   - fp8: each code's sign, exponent and mantissa bits moved into a bf16's
//     fields read as the value times 2^-(127 - bias) (subnormals too), and
//     one exact bf16 multiply by 2^(127 - bias): 2^120 for e4m3, 2^112 e5m2;
//   - int8: float(2^23 + code + 128) - (2^23 + 128) is the code, exactly,
//     so its top 16 bits are its bf16.
template <int kPool>
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  if constexpr (kPool == kPoolInt8) {
    const uint32_t u = w ^ 0x80808080u;  // code + 128, in [0, 255]
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | i)) - 8388736.f;
    lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[2]), 0x7632);
    hi = __byte_perm(__float_as_uint(f[1]), __float_as_uint(f[3]), 0x7632);
  } else {
    constexpr int kShift = kPool == kPoolE4M3 ? 4 : 3;  // exponent bits 8 - 4 or 8 - 5
    constexpr uint32_t kBias = kPool == kPoolE4M3 ? 0x7B807B80u : 0x77807780u;  // 2^120, 2^112
    // the codes in bytes 1 and 3 into the two bf16 halves
    auto place = [](uint32_t x) { return (x & 0x80008000u) | ((x & 0x7F007F00u) >> kShift); };
    lo = mul_bf16x2(place(w << 8), kBias);
    hi = mul_bf16x2(place(w), kBias);
  }
}

// raises the barrier's expected transaction bytes, without arriving
__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// (a, b) as two bf16x2 terms: hi = bf16(a, b), lo = bf16(a - hi, b - hi);
// each pair rounds in one conversion instruction
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(a - __uint_as_float(hi << 16), b - __uint_as_float(hi & 0xffff0000u));
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

constexpr float kAmaxFloor = 1e-8f;
constexpr float kInt8Scale = static_cast<float>(1.0 / 127.0);  // jnp.float32(1/127)

// Kernel 9's arithmetic (serving.kv_pool.quantize_rows) on one row of a
// quantized pool kind, from the row's largest |x|: its step and stored
// scale, then each value's code. quantize_scatter_kernel and the append
// route share it, so their bytes agree. IEEE division, rint and exact
// powers of two make it bit-identical to the plain PyTorch version:
//   int8: s = amax * fp32(1/127); code = clip(rint(x / s), -127, 127)
//   fp8:  e = clip(ceil(log2(amax / fmax)), -126, 126), taken exactly from
//         frexp(amax) = (m, k): e = k - k_fmax + (m > 0.875), as fmax is
//         0.875 * 2^k_fmax; code = cvt_rn_satfinite(x * 2^-e)
// with amax floored at 1e-8.
template <int kPool>
struct RowQuant {
  float step;  // int8: the scale s; fp8: 2^-e
  int e;       // fp8: the exponent stored as the scale

  __device__ __forceinline__ explicit RowQuant(float amax) {
    amax = fmaxf(amax, kAmaxFloor);
    if constexpr (kPool == kPoolInt8) {
      step = amax * kInt8Scale;
      e = 0;
    } else {
      constexpr int kFmaxExp = kPool == kPoolE4M3 ? 9 : 16;  // 448, 57344 = 0.875 * 2^k
      int k;
      const float m = frexpf(amax, &k);
      e = min(max(k - kFmaxExp + (m > 0.875f ? 1 : 0), -126), 126);
      step = pow2(-e);
    }
  }

  __device__ __forceinline__ uint8_t code(float x) const {
    if constexpr (kPool == kPoolInt8) {
      return static_cast<uint8_t>(static_cast<int8_t>(fminf(fmaxf(rintf(x / step), -127.f), 127.f)));
    } else {
      constexpr __nv_fp8_interpretation_t kFmt = kPool == kPoolE4M3 ? __NV_E4M3 : __NV_E5M2;
      return __nv_cvt_float_to_fp8(x * step, __NV_SATFINITE, kFmt);
    }
  }

  // the row's scale at scales[row] (scales [n_blocks, bl, H_kv])
  __device__ __forceinline__ void store_scale(void* scales, int64_t row) const {
    if constexpr (kPool == kPoolInt8) {
      static_cast<float*>(scales)[row] = step;
    } else {
      static_cast<int8_t*>(scales)[row] = static_cast<int8_t>(e);
    }
  }
};

struct TcParams {
  const __nv_bfloat16* q;  // q[b, c, h, :] at q + b*q_sb + c*q_sc + h*q_sh
  int64_t q_sb, q_sc, q_sh;
  void* k_scale;  // quantized pools: [n_blocks, bl, H_kv], else null
  void* v_scale;
  const int* tables;  // [B, W]
  const int* qpos;    // [B, C]
  __nv_bfloat16* out;  // [B, C, H_kv * G, D]
  float* part_acc;     // split: [B, H_kv, S, R, D]
  float* part_m;       // split: [B, H_kv, S, R]
  float* part_l;
  int* tickets;        // split: [B, H_kv, ceil(R / 32)], zero on entry and on exit
  int H_kv, G, C, bl, W, box_rows, pool_rows, S, wc;  // the sweep: S = 1, wc = W
  float scale;
  // the append route (quantized pools; null k_new: none): the chunk's new
  // rows k_new[b, c, h, :] at k_new + b*k_sb + c*k_sc + h*k_sh (elements;
  // v_new likewise), bf16 or fp32 (new_f32), row (b, c) written into the
  // pools [n_blocks, bl, H_kv, D] at position qpos[b, c]
  const void* k_new;
  const void* v_new;
  int64_t k_sb, k_sc, k_sh, v_sb, v_sc, v_sh;
  int new_f32;
  unsigned char* k_pool;
  unsigned char* v_pool;
};

// the append route: the positions of a chunk's first rows sit in shared
// memory (a serve's prefill chunk is 32 or 64 rows), later ones are read
// from qpos
constexpr int kNewRowsCached = 64;

__device__ __forceinline__ int new_position(const TcParams& p, const int* pos_s, int b, int c) {
  return c < kNewRowsCached ? pos_s[c] : __ldg(p.qpos + static_cast<int64_t>(b) * p.C + c);
}

// The append route's writes, by the consumer warps before they read a
// stage: the new K and V rows of batch row b and KV head h whose positions
// lie in this block's keys [k_begin, k_stop), each quantized as kernel 9
// does (RowQuant) into pool block tables[b, pos / bl] at slot pos % bl, its
// scale beside it. A row with a negative position lies in no block's keys
// and is not written. An octet of lanes holds a row (D / 8 values a lane,
// one or two 16-byte loads; its amax in three shuffles), a pass of the kCW
// warps 4 kCW rows, and 256 / D passes' loads go out together: a position
// from shared memory, then the row and its table entry, one round trip for
// up to 64 rows.
template <int kPool, int D, int kCW>
__device__ __forceinline__ void append_rows(const TcParams& p, const int* pos_s, int b, int h,
                                            int k_begin, int k_stop, int warp, int lane) {
  constexpr int kV = D / 8;
  constexpr int kPass = 4 * kCW;
  constexpr int kRound = 256 / D;
  const int* table = p.tables + static_cast<int64_t>(b) * p.W;
  const int e = lane & 7;
  for (int t0 = 0; t0 < 2 * p.C; t0 += kRound * kPass) {
    float x[kRound][kV];
    int64_t row[kRound];  // the destination (block, slot, head) row, or -1
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const int task = t0 + u * kPass + 4 * warp + (lane >> 3);  // row task / 2, V if odd
      const int c = task >> 1;
      const int pos = task < 2 * p.C ? new_position(p, pos_s, b, c) : -1;
      row[u] = -1;
#pragma unroll
      for (int i = 0; i < kV; ++i) x[u][i] = 0.f;
      if (pos >= k_begin && pos < k_stop) {
        const int j = pos / p.bl;
        row[u] = (static_cast<int64_t>(__ldg(table + j)) * p.bl + pos - j * p.bl) * p.H_kv + h;
        const int64_t at = (task & 1) ? b * p.v_sb + c * p.v_sc + h * p.v_sh + e * kV
                                      : b * p.k_sb + c * p.k_sc + h * p.k_sh + e * kV;
        const void* src = (task & 1) ? p.v_new : p.k_new;
        if (p.new_f32) {
          load_vec<kV>(x[u], static_cast<const float*>(src) + at);
        } else {
          load_vec<kV>(x[u], static_cast<const __nv_bfloat16*>(src) + at);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < kV; ++i) amax = fmaxf(amax, fabsf(x[u][i]));
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, o));
      if (row[u] < 0) continue;
      const RowQuant<kPool> rq(amax);
      uint32_t w[kV / 4];
#pragma unroll
      for (int i = 0; i < kV / 4; ++i)
        w[i] = rq.code(x[u][4 * i]) | rq.code(x[u][4 * i + 1]) << 8 |
               rq.code(x[u][4 * i + 2]) << 16 | static_cast<uint32_t>(rq.code(x[u][4 * i + 3])) << 24;
      const bool is_v = (t0 + u * kPass + 4 * warp + (lane >> 3)) & 1;
      unsigned char* dst = (is_v ? p.v_pool : p.k_pool) + row[u] * D + e * kV;
      if constexpr (kV == 8) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
      if (e == 0) rq.store_scale(is_v ? p.v_scale : p.k_scale, row[u]);
    }
  }
}

// The body of both tensor-core kernels: kCW consumer warps and a producer
// warp, row tiles of kRowsT = 16 kCW rows; grid (ceil(G * C / kRowsT) * S,
// H_kv, B). kPool: bf16 pools (kPoolFloat) or int8 / e4m3 / e5m2 codes.
template <int kPool, int D, int kStages, int kCW, bool kSplit>
__device__ __forceinline__ void paged_tc_body(const CUtensorMap& map_k, const CUtensorMap& map_v,
                                              const TcParams& p) {
  constexpr bool kQuant = kPool != kPoolFloat;
  constexpr int kScale = kPool == kPoolInt8 ? kMultiplier : kExponent;
  constexpr int kRowsT = 16 * kCW;
  constexpr int kTileBytes = kStageKeys * D * (kQuant ? 1 : 2);  // 64 keys of K (or V)
  constexpr float kLog2e = 1.4426950408889634f;
  static_assert(kStages % kCW == 0, "each key group owns its own ring slots");
  static_assert((kCW - 1) * kRowsT * (D + 4) * 4 <= 2 * kStages * kTileBytes,
                "the ring holds the key groups' states at the end");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =  // stage s: K at 2 s tiles, V after it
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 2 * kStages * kTileBytes);
  uint64_t* empty = full + kStages;
  // quantized pools: stage s's K scales at ks_s[64 s ..], its V scales at vs_s
  float* ks_s = reinterpret_cast<float*>(empty + kStages);
  float* vs_s = ks_s + kStages * kStageKeys;
  __shared__ int qp_s[kRowsT];
  __shared__ float m_s[(kCW - 1) * kRowsT];  // key groups 1 .. kCW - 1 at the end
  __shared__ float l_s[(kCW - 1) * kRowsT];
  __shared__ int is_last;
  // the append route: the chunk's first positions, and the consumers'
  // arrivals once their rows are stored
  __shared__ int np_s[kQuant ? kNewRowsCached : 1];
  __shared__ uint64_t wrote;
  const bool append = kQuant && p.k_new != nullptr;

  const int R = p.G * p.C;
  const int n_rt = (R + kRowsT - 1) / kRowsT;
  const int rt = blockIdx.x % n_rt;
  const int sw = blockIdx.x / n_rt;  // the split worker (0 for the sweep)
  const int row0 = rt * kRowsT;
  const int nr = min(kRowsT, R - row0);
  const int n16 = (nr + 15) / 16;  // row groups of 16
  const int n_kg = kCW / n16;      // key groups
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const int span = p.wc * p.bl;    // keys of a worker's span of the chain
  const int k_begin = sw * span;
  const int k_end = min(p.W * p.bl, k_begin + span);
  const int* table = p.tables + static_cast<int64_t>(b) * p.W;
  // the pool row of the span's box 32 * batch + lane, or -1 past its end
  auto box_row = [&](int batch) {
    const int key0 = k_begin + (32 * batch + lane) * p.box_rows;
    if (key0 >= k_end) return -1;
    const int j = key0 / p.bl;
    return __ldg(table + j) * p.bl + (key0 - j * p.bl);
  };
  const int rg = warp % n16;  // a consumer's rows: 16 rg .. 16 rg + 15 of the tile
  const int kg = warp / n16;  // and its key group
  const int g = lane >> 2;
  const int t = lane & 3;

  // Loads that do not depend on the positions go out before the barrier,
  // together with the positions': the producer's first 64 table entries,
  // the consumers' q fragments (rows 16 rg + g and + 8; a row past nr reads
  // row 0 and is zeroed below). On quantized pools the reduction index is
  // permuted: lane t's columns of 16-column step kk are 64 (kk / 4) + 16 t
  // + 4 (kk % 4) + 0..3, as its K codes sit in a key row, and its two pairs
  // are columns (0, 2) and (1, 3) of those four, as widen4 pairs codes.
  int cur = -1, nxt = -1, nxt2 = -1;  // nxt2: quantized pools, for the scales
  uint32_t qa[D / 16][4];
  if (warp == kCW) {
    cur = box_row(0);
    nxt = box_row(1);
    if constexpr (kQuant) nxt2 = box_row(2);
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = 16 * rg + g + 8 * r;
      const int row = row0 + (rl < nr ? rl : 0);
      const int gq = row / p.C;
      const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
          p.q + b * p.q_sb + (row - gq * p.C) * p.q_sc + (h * p.G + gq) * p.q_sh);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          qa[kk][r + 2 * hf] = __ldg(qrow + (kQuant ? 32 * (kk / 4) + 8 * t + 2 * (kk % 4) + hf
                                                    : 8 * kk + 4 * hf + t));
    }
  }
  if (tid < kRowsT)
    qp_s[tid] = tid < nr ? p.qpos[static_cast<int64_t>(b) * p.C + (row0 + tid) % p.C] : -1;
  if (append && tid < min(p.C, kNewRowsCached))
    np_s[tid] = __ldg(p.qpos + static_cast<int64_t>(b) * p.C + tid);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, n16);  // lane 0 of each warp of the stage's key group
    }
    if constexpr (kQuant) mbar_init(&wrote, 32 * kCW);  // every consumer thread
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int frontier = -1;
  for (int r = 0; r < nr; ++r) frontier = max(frontier, qp_s[r]);
  // keys [0, n_keys) are visible to some row of the tile; worker sw reads
  // [k_begin, k_stop), its span cut at n_keys. Workers whose span starts
  // past n_keys have nothing to read and leave at once; the n_active others
  // (worker 0 always) write partials, and the last of them to finish merges
  // those (one active worker writes the output).
  const int n_keys = frontier < 0 ? 0 : min(p.W * p.bl, frontier + 1);
  const int n_active = max(1, (n_keys + span - 1) / span);
  if (sw >= n_active) return;
  const int k_stop = min(n_keys, k_end);
  const int n_st = (max(k_stop - k_begin, 0) + kStageKeys - 1) / kStageKeys;

  if (warp == kCW) {  // the producer
    const int n_copies = kStageKeys / p.box_rows;  // boxes per stage, a divisor of 32
    // box 32 * batch + lane past the frontier: -1 (asked for out of bounds)
    auto cut = [&](int row, int batch) {
      return k_begin + (32 * batch + lane) * p.box_rows < k_stop ? row : -1;
    };
    cur = cut(cur, 0);
    nxt = cut(nxt, 1);
    if constexpr (kQuant) nxt2 = cut(nxt2, 2);
    // quantized pools: the K and V scales of keys lane and lane + 32 of
    // stage i go into register slot i % kAhead, as loaded (raw_scale),
    // kAhead stages before the stage goes out, so their latency hides
    // behind the ring. Nothing may wait on them before then (a warp issues
    // in order: a load feeding an address or an instruction stalls it):
    // their addresses come from registers, stage i's boxes' pool rows being
    // lane c % 32 of `rows`, cur or nxt, whose table entries went out a
    // batch of 32 boxes before (nxt2 holds the batch after nxt), and they
    // become factors (scale_of) only as they are written. The loop is
    // unrolled kAhead times, so that a slot is a fixed register and reusing
    // it waits on no other slot's load. A key of a box past the frontier
    // (its codes zeros) gets a raw 0, a finite factor.
    constexpr int kAhead = kQuant ? 4 : 1;  // kAhead * n_copies <= 32
    float ksr[kAhead][2], vsr[kAhead][2];
    auto load_scales = [&](int i, int rows, float (&ks)[2], float (&vs)[2], bool coherent) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int k = lane + 32 * u;
        const int r0 = __shfl_sync(kFull, rows, (i * n_copies + k / p.box_rows) % 32);
        ks[u] = vs[u] = 0.f;
        if (r0 >= 0) {
          const int64_t at = static_cast<int64_t>(r0 + k % p.box_rows) * p.H_kv + h;
          if (coherent) {  // a branch, never a select of both loads
            ks[u] = raw_scale<kScale, true>(p.k_scale, at);
            vs[u] = raw_scale<kScale, true>(p.v_scale, at);
          } else {
            ks[u] = raw_scale<kScale, false>(p.k_scale, at);
            vs[u] = raw_scale<kScale, false>(p.v_scale, at);
          }
        }
      }
    };
    // The append route: stage i_new, the first to hold a new row of this
    // block's keys, goes out only after every consumer thread stored its
    // rows and fenced them for the TMA loads (the `wrote` barrier); the
    // stages before it go out at once, while the consumers write. The
    // scales of stages i_new and later are not loaded ahead: each is
    // loaded, through L2, as its stage goes out (the new rows sit at the
    // frontier, so that is a span's last stage or two).
    [[maybe_unused]] int i_new = n_st;
    if constexpr (kQuant) {
      if (append) {
        int lo = k_stop;
        for (int c = lane; c < p.C; c += 32) {
          const int pos = new_position(p, np_s, b, c);
          if (pos >= k_begin && pos < lo) lo = pos;
        }
        lo = __reduce_min_sync(kFull, lo);
        if (lo < k_stop) i_new = (lo - k_begin) / kStageKeys;
      }
#pragma unroll
      for (int a = 0; a < kAhead; ++a)  // stages 0 .. kAhead - 1: boxes of batch 0
        if (a < i_new) load_scales(a, cur, ksr[a], vsr[a], false);
    }
    // stage i's boxes go out: returns its ring slot
    auto issue = [&](int i) {
      const int s = i % kStages;
      const int c0 = i * n_copies;  // the stage's first box
      if (c0 > 0 && c0 % 32 == 0) {
        cur = nxt;
        if constexpr (kQuant) {
          nxt = nxt2;
          nxt2 = cut(box_row(c0 / 32 + 2), c0 / 32 + 2);
        } else {
          nxt = cut(box_row(c0 / 32 + 1), c0 / 32 + 1);
        }
      }
      const int src = __shfl_sync(kFull, cur, (c0 % 32) + min(lane, n_copies - 1));
      if (lane == 0) {
        if (i >= kStages) mbar_wait(empty + s, ((i / kStages) & 1) ^ 1);
        // quantized pools: the bytes now, the arrival with the scales
        if constexpr (kQuant) {
          mbar_expect_bytes(full + s, 2 * kTileBytes);
        } else {
          mbar_expect_tx(full + s, 2 * kTileBytes);
        }
      }
      __syncwarp();
      if (lane < n_copies) {
        const int row = src >= 0 ? src : p.pool_rows;  // out of bounds: zeros
        // box `lane`'s first key row: D bytes a row of codes, 128 bytes a
        // row of one 64-column bf16 box
        unsigned char* k_st = ring + 2 * s * kTileBytes + lane * p.box_rows * (kQuant ? D : 128);
        if constexpr (kQuant) {  // one box of D bytes a key row
          tma_load(k_st, &map_k, full + s, 0, h, row);
          tma_load(k_st + kTileBytes, &map_v, full + s, 0, h, row);
        } else {
#pragma unroll
          for (int x = 0; x < D / kBoxCols; ++x) {
            tma_load(k_st + x * kBoxBytes, &map_k, full + s, x * kBoxCols, h, row);
            tma_load(k_st + kTileBytes + x * kBoxBytes, &map_v, full + s, x * kBoxCols, h, row);
          }
        }
      }
      return s;
    };
    if constexpr (kQuant) {
      for (int i0 = 0; i0 < n_st; i0 += kAhead) {
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
          const int i = i0 + a;
          if (i >= n_st) break;
          if (i == i_new) {
            mbar_wait(&wrote, 0);
            fence_async_global();
          }
          const int s = issue(i);
          if (i >= i_new) load_scales(i, cur, ksr[a], vsr[a], true);
          // the stage's scales go into its slot (its consumers are done
          // with it: issue's empty wait); __syncwarp orders the lanes'
          // writes before lane 0's arrival, which completes the stage with
          // its codes and releases them. Then slot a takes stage i + kAhead.
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            ks_s[s * kStageKeys + lane + 32 * u] = scale_of<kScale>(ksr[a][u]);
            vs_s[s * kStageKeys + lane + 32 * u] = scale_of<kScale>(vsr[a][u]);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(full + s);
          const int ia = i + kAhead;
          if (ia < i_new)  // i_new <= n_st
            load_scales(ia, (ia * n_copies) / 32 == (i * n_copies) / 32 ? cur : nxt, ksr[a],
                        vsr[a], false);
        }
      }
    } else {
      for (int i = 0; i < n_st; ++i) issue(i);
    }
    return;
  }

  // the append route: this block's new rows, before the first stage is
  // read (the stages before the producer's i_new land meanwhile)
  if constexpr (kQuant) {
    if (append) {
      append_rows<kPool, D, kCW>(p, np_s, b, h, k_begin, k_stop, warp, lane);
      fence_async_global();
      mbar_arrive(&wrote);
    }
  }

  // q scaled in its dtype, as A fragments
  int qp[2];
  {
    const float sc = __bfloat162float(__float2bfloat16(p.scale));
#pragma unroll
    for (int r = 0; r < 2; ++r) qp[r] = qp_s[16 * rg + g + 8 * r];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kQuant && i < 2) {  // columns (0, 1), (2, 3) -> (0, 2), (1, 3)
          const uint32_t a = qa[kk][i], c = qa[kk][i + 2];
          qa[kk][i] = __byte_perm(a, c, 0x5410);
          qa[kk][i + 2] = __byte_perm(a, c, 0x7632);
        }
        __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&qa[kk][i]);
        const bool in = 16 * rg + g + 8 * (i & 1) < nr;
        qa[kk][i] = in ? pack2(__low2float(x) * sc, __high2float(x) * sc) : 0u;
      }
  }

  float m[2] = {-INFINITY, -INFINITY};  // row max of S so far
  float l[2] = {0.f, 0.f};              // this lane's share of the row sums
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int mi = lane >> 3;  // the ldmatrix matrix this lane addresses
  for (int i = (kg < n_kg ? kg : n_st); i < n_st; i += n_kg) {
    const int s = i % kStages;
    const unsigned char* k_tile = ring + 2 * s * kTileBytes;
    const unsigned char* v_tile = k_tile + kTileBytes;
    const uint32_t k_st = smem_u32(k_tile);
    const uint32_t v_st = k_st + kTileBytes;
    mbar_wait(full + s, (i / kStages) & 1);

    float sc[8][4];  // S: 16 rows x 64 keys, 8 tiles of 8 keys
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    if constexpr (kQuant) {
      // key tile j, column g holds key 16 (j / 2) + 4 (g / 2) + 2 (j % 2) +
      // g % 2: S's column pair 2t, 2t + 1 of tiles 2kk, 2kk + 1 are then
      // keys 16 kk + 4 t .. + 3, PV's B fragment rows
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = 16 * (j >> 1) + 4 * (g >> 1) + 2 * (j & 1) + (g & 1);
        uint4 c[D / 64];
        if constexpr (D == 64) {
          c[0] = *reinterpret_cast<const uint4*>(k_tile + swizzled8<D>(key, 16 * t));
        } else {
          // odd and even g read the row's halves in turns: the two rows of
          // a phase's lanes then meet other banks
          const int odd = g & 1;
          const uint4 x0 = *reinterpret_cast<const uint4*>(k_tile + swizzled8<D>(key, 16 * t + 64 * odd));
          const uint4 x1 =
              *reinterpret_cast<const uint4*>(k_tile + swizzled8<D>(key, 16 * t + 64 * (odd ^ 1)));
          c[0] = odd ? x1 : x0;
          c[1] = odd ? x0 : x1;
        }
#pragma unroll
        for (int y = 0; y < D / 64; ++y) {
          const uint32_t w[4] = {c[y].x, c[y].y, c[y].z, c[y].w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            uint32_t b0, b1;
            widen4<kPool>(w[kk], b0, b1);
            mma(sc[j], qa[4 * y + kk], b0, b1);
          }
        }
      }
      // S times each key's K scale
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 k4 = *reinterpret_cast<const float4*>(ks_s + s * kStageKeys + 16 * kk + 4 * t);
        sc[2 * kk][0] *= k4.x;
        sc[2 * kk][2] *= k4.x;
        sc[2 * kk][1] *= k4.y;
        sc[2 * kk][3] *= k4.y;
        sc[2 * kk + 1][0] *= k4.z;
        sc[2 * kk + 1][2] *= k4.z;
        sc[2 * kk + 1][1] *= k4.w;
        sc[2 * kk + 1][3] *= k4.w;
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          // matrix mi: keys 16 jp + 8 (mi / 2) .. + 7, columns 16 kk + 8 (mi % 2) .. + 7
          uint32_t kb[4];
          ldmatrix_x4(kb, swizzled(k_st, 16 * jp + 8 * (mi >> 1) + (lane & 7),
                                   16 * kk + 8 * (mi & 1)));
          mma(sc[2 * jp], qa[kk], kb[0], kb[1]);
          mma(sc[2 * jp + 1], qa[kk], kb[2], kb[3]);
        }
    }

    const int k0 = k_begin + i * kStageKeys;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kQuant ? 16 * (j >> 1) + 4 * t + 2 * (j & 1) + (e & 1)
                               : 8 * j + 2 * t + (e & 1);
        const int kpos = k0 + key;
        if (!(kpos <= qp[e >> 1] && kpos < k_stop)) sc[j][e] = -INFINITY;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float ms = (m_new == -INFINITY ? 0.f : m_new) * kLog2e;
      const float corr = ex2(m[r] * kLog2e - ms);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float pv = ex2(fmaf(sc[j][2 * r + c], kLog2e, -ms));  // p * mask
          sc[j][2 * r + c] = pv;
          ps += pv;
        }
      l[r] = l[r] * corr + ps;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    if constexpr (kQuant) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // keys 16 kk + 4 t .. + 3 of this lane
        // P' = p times each key's V scale, as hi + lo bf16 terms
        const float4 v4 = *reinterpret_cast<const float4*>(vs_s + s * kStageKeys + 16 * kk + 4 * t);
        uint32_t ph[4], pl[4];
        split2(sc[2 * kk][0] * v4.x, sc[2 * kk][1] * v4.y, ph[0], pl[0]);
        split2(sc[2 * kk][2] * v4.x, sc[2 * kk][3] * v4.y, ph[1], pl[1]);
        split2(sc[2 * kk + 1][0] * v4.z, sc[2 * kk + 1][1] * v4.w, ph[2], pl[2]);
        split2(sc[2 * kk + 1][2] * v4.z, sc[2 * kk + 1][3] * v4.w, ph[3], pl[3]);
        // V codes of those four keys at columns g D/8 .. + D/8 - 1: column
        // tile n's B fragment takes column g D/8 + n
        uint32_t v[4][D / 32];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const unsigned char* row = v_tile + swizzled8<D>(16 * kk + 4 * t + x, (D / 8) * g);
          if constexpr (D == 64) {
            const uint2 y = *reinterpret_cast<const uint2*>(row);
            v[x][0] = y.x;
            v[x][1] = y.y;
          } else {
            const uint4 y = *reinterpret_cast<const uint4*>(row);
            v[x][0] = y.x;
            v[x][1] = y.y;
            v[x][2] = y.z;
            v[x][3] = y.w;
          }
        }
#pragma unroll
        for (int wd = 0; wd < D / 32; ++wd) {
          // a 4 x 4 byte transpose: x[e] = the four keys' codes of column
          // tile 4 wd + e, as [k0, k2, k1, k3], so widen4 pairs (k0, k1), (k2, k3)
          const uint32_t ac_lo = __byte_perm(v[0][wd], v[2][wd], 0x5140);
          const uint32_t ac_hi = __byte_perm(v[0][wd], v[2][wd], 0x7362);
          const uint32_t bd_lo = __byte_perm(v[1][wd], v[3][wd], 0x5140);
          const uint32_t bd_hi = __byte_perm(v[1][wd], v[3][wd], 0x7362);
          const uint32_t x[4] = {__byte_perm(ac_lo, bd_lo, 0x5410), __byte_perm(ac_lo, bd_lo, 0x7632),
                                 __byte_perm(ac_hi, bd_hi, 0x5410), __byte_perm(ac_hi, bd_hi, 0x7632)};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint32_t b0, b1;
            widen4<kPool>(x[e], b0, b1);
            mma(acc[4 * wd + e], ph, b0, b1);
            mma(acc[4 * wd + e], pl, b0, b1);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // keys 16 kk .. 16 kk + 15
        const uint32_t pa[4] = {pack2(sc[2 * kk][0], sc[2 * kk][1]),
                                pack2(sc[2 * kk][2], sc[2 * kk][3]),
                                pack2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                pack2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          // matrix mi: keys 16 kk + 8 (mi % 2) .. + 7, columns 16 np + 8 (mi / 2) .. + 7
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, swizzled(v_st, 16 * kk + 8 * (mi & 1) + (lane & 7),
                                         16 * np + 8 * (mi >> 1)));
          mma(acc[2 * np], pa, vb[0], vb[1]);
          mma(acc[2 * np + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);  // this warp has read the stage
  }

  // every stage has landed and been read: key groups 1 .. n_kg - 1 hand
  // their states to group 0 through the ring (slot (kg - 1) * 64 + row, a
  // row padded by 4 floats against bank conflicts), and group 0 merges
  // them into its own in registers and writes its rows. acc's element
  // 8 n + 2 t (+ 1) is output column out_col(8 n + 2 t (+ 1)).
  constexpr int kAccLd = D + 4;
  auto out_col = [](int i) { return kQuant ? (i % 8) * (D / 8) + i / 8 : i; };
  sync_warps<32 * kCW>();
  float* acc_s = reinterpret_cast<float*>(ring);
  float lt[2];  // the row sums
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lt[r] = l[r];
    lt[r] += __shfl_xor_sync(kFull, lt[r], 1);
    lt[r] += __shfl_xor_sync(kFull, lt[r], 2);
  }
  if (kg > 0 && kg < n_kg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int slot = (kg - 1) * kRowsT + 16 * rg + g + 8 * r;
      if (t == 0) {
        m_s[slot] = m[r];
        l_s[slot] = lt[r];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(acc_s + slot * kAccLd + 8 * n + 2 * t) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
  sync_warps<32 * kCW>();
  const int H = p.H_kv * p.G;
  const bool partial = kSplit && n_active > 1;
  const int64_t pb = (static_cast<int64_t>(b) * p.H_kv + h) * p.S;  // worker 0's partials
  if (kg == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = 16 * rg + g + 8 * r;
      if (rl >= nr) continue;
      float ms = m[r];
#pragma unroll
      for (int k = 1; k < kCW; ++k)
        if (k < n_kg) ms = fmaxf(ms, m_s[(k - 1) * kRowsT + rl]);
      // a key group that saw no visible key (m = -inf) drops out
      const float a0 = m[r] == -INFINITY ? 0.f : ex2((m[r] - ms) * kLog2e);
      float al[kCW];
      float ls = lt[r] * a0;
#pragma unroll
      for (int k = 1; k < kCW; ++k) {
        al[k] = 0.f;
        if (k < n_kg) {
          const float mk = m_s[(k - 1) * kRowsT + rl];
          al[k] = mk == -INFINITY ? 0.f : ex2((mk - ms) * kLog2e);
          ls += l_s[(k - 1) * kRowsT + rl] * al[k];
        }
      }
      const float lc = fmaxf(ls, 1e-37f);  // fully masked rows (ls == 0) come out 0
      const int gq = (row0 + rl) / p.C;
      const int c = row0 + rl - gq * p.C;
      __nv_bfloat16* orow = p.out + ((static_cast<int64_t>(b) * p.C + c) * H + h * p.G + gq) * D;
      const int64_t pr = (pb + sw) * R + row0 + rl;  // this worker's partial row
      if (partial && t == 0) {
        p.part_m[pr] = ms;  // -inf where the row saw no visible key here
        p.part_l[pr] = ls;
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        float v0 = acc[n][2 * r] * a0;
        float v1 = acc[n][2 * r + 1] * a0;
#pragma unroll
        for (int k = 1; k < kCW; ++k)
          if (k < n_kg) {
            const float2 x = *reinterpret_cast<const float2*>(
                acc_s + ((k - 1) * kRowsT + rl) * kAccLd + 8 * n + 2 * t);
            v0 += x.x * al[k];
            v1 += x.y * al[k];
          }
        if (partial) {
          *reinterpret_cast<float2*>(p.part_acc + pr * D + 8 * n + 2 * t) = make_float2(v0, v1);
        } else if constexpr (kQuant) {
          orow[out_col(8 * n + 2 * t)] = __float2bfloat16(v0 / lc);
          orow[out_col(8 * n + 2 * t + 1)] = __float2bfloat16(v1 / lc);
        } else {
          reinterpret_cast<uint32_t*>(orow)[4 * n + t] = pack2(v0 / lc, v1 / lc);
        }
      }
    }
  }
  if (!partial) return;

  // the last active worker of this (b, h, row tile) to finish merges the
  // partials of workers 0 .. n_active - 1, in that order: the same bits
  // whichever worker is last. A thread takes a float4 of a row's acc; the
  // workers' loads go out together (each worker's max rescales the sums as
  // it comes), so an iteration costs one round trip to L2 (at R = 32, 64
  // threads take 8 iterations).
  __threadfence();
  sync_warps<32 * kCW>();
  int* ticket = p.tickets + (static_cast<int64_t>(b) * p.H_kv + h) * n_rt + rt;
  if (tid == 0) is_last = atomicAdd(ticket, 1) == n_active - 1;
  sync_warps<32 * kCW>();
  if (!is_last) return;
  __threadfence();
  for (int i = tid; i < nr * (D / 4); i += (32 * kCW)) {
    const int rl = i / (D / 4);
    const int d = 4 * (i - rl * (D / 4));
    float ms = -INFINITY, ls = 0.f;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int w = 0; w < n_active; ++w) {
      const int64_t pr = (pb + w) * R + row0 + rl;
      const float mw = __ldcg(p.part_m + pr);  // -inf: the worker saw no visible key
      const float lw = __ldcg(p.part_l + pr);
      const float4 x = __ldcg(reinterpret_cast<const float4*>(p.part_acc + pr * D + d));
      const float mn = fmaxf(ms, mw);
      const float corr = ms == -INFINITY ? 0.f : ex2((ms - mn) * kLog2e);
      const float al = mw == -INFINITY ? 0.f : ex2((mw - mn) * kLog2e);
      v.x = v.x * corr + x.x * al;
      v.y = v.y * corr + x.y * al;
      v.z = v.z * corr + x.z * al;
      v.w = v.w * corr + x.w * al;
      ls = ls * corr + lw * al;
      ms = mn;
    }
    const float lc = fmaxf(ls, 1e-37f);
    const int gq = (row0 + rl) / p.C;
    const int c = row0 + rl - gq * p.C;
    __nv_bfloat16* orow = p.out + ((static_cast<int64_t>(b) * p.C + c) * H + h * p.G + gq) * D;
    if constexpr (kQuant) {
      orow[out_col(d)] = __float2bfloat16(v.x / lc);
      orow[out_col(d + 1)] = __float2bfloat16(v.y / lc);
      orow[out_col(d + 2)] = __float2bfloat16(v.z / lc);
      orow[out_col(d + 3)] = __float2bfloat16(v.w / lc);
    } else {
      *reinterpret_cast<uint2*>(orow + d) = make_uint2(pack2(v.x / lc, v.y / lc),
                                                      pack2(v.z / lc, v.w / lc));
    }
  }
  if (tid == 0) *ticket = 0;  // zero again for the next launch on this stream
}

// The single sweep: grid (ceil(G * C / 64), H_kv, B), four consumer warps
// and one block an SM with a deep ring (a decode tick's few blocks each
// stream a whole chain).
template <int kPool, int D, int kStages>
__global__ void __launch_bounds__(32 * kWarps + 32, 1)
    paged_sweep_tc_kernel(__grid_constant__ const CUtensorMap map_k,
                          __grid_constant__ const CUtensorMap map_v, const TcParams p) {
  paged_tc_body<kPool, D, kStages, kWarps, false>(map_k, map_v, p);
}

// The split: grid (ceil(G * C / 32) * S, H_kv, B), two consumer warps and
// a two-stage ring, so kMinBlocks blocks share an SM: at D = 64 all 768
// blocks of a decode tick are resident at once.
template <int kPool, int D, int kMinBlocks>
__global__ void __launch_bounds__(32 * kSplitWarps + 32, kMinBlocks)
    paged_split_tc_kernel(__grid_constant__ const CUtensorMap map_k,
                          __grid_constant__ const CUtensorMap map_v, const TcParams p) {
  paged_tc_body<kPool, D, kSplitStages, kSplitWarps, true>(map_k, map_v, p);
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

// A pool's tensor map from ops/paged_flash.py's pool_tensor_map_geometry:
// dims (D, H_kv, n_blocks * bl), byte strides (H_kv, row), box (64, 1,
// rows) of bf16 with the 128-byte swizzle, or (D, 1, rows) of one-byte
// codes with the D-byte swizzle
int encode_pool(CUtensorMap* map, const void* pool, const int64_t* geo, bool codes) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(geo[0]), static_cast<cuuint64_t>(geo[1]),
                              static_cast<cuuint64_t>(geo[2])};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(geo[3]),
                                 static_cast<cuuint64_t>(geo[4])};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(geo[5]), static_cast<cuuint32_t>(geo[6]),
                             static_cast<cuuint32_t>(geo[7])};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r =
      fn(map, codes ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
         const_cast<void*>(pool), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         codes && geo[0] == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kInvalid;
}

// one launch of a tensor-core kernel with `warps` consumer warps (row
// tiles of 16 warps rows) and a ring of `stages` stages of 64 key rows of
// K and V, `row_bytes` a row (and 64 K and V scales a stage on quantized
// pools): grid (ceil(G * C / (16 warps)) * S, H_kv, B)
template <typename Kernel>
int launch_tc(Kernel kernel, int row_bytes, int stages, int warps, bool quant,
              const CUtensorMap& mk, const CUtensorMap& mv, const TcParams& p, int B,
              cudaStream_t st) {
  const size_t smem = 1024 + 2 * stages * kStageKeys * row_bytes + 2 * stages * 8 +
                      (quant ? 2 * stages * kStageKeys * sizeof(float) : 0);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = 16 * warps;
  const dim3 grid(((p.G * p.C + rows - 1) / rows) * p.S, p.H_kv, B);
  kernel<<<grid, 32 * warps + 32, smem, st>>>(mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

// The instances: per pool kind, D 64 and 128; the sweep's ring holds 8
// stages (4 of bf16 at D 128: the same 128 KB), the split's 2, with six
// blocks an SM at D 64 and three at 128.
template <int kPool, bool kSplit>
int launch_tc_d(int D, const CUtensorMap& mk, const CUtensorMap& mv, const TcParams& p, int B,
                cudaStream_t st) {
  constexpr int kElem = kPool == kPoolFloat ? 2 : 1;
  constexpr bool kQuant = kPool != kPoolFloat;
  if constexpr (kSplit) {
    return D == 64 ? launch_tc(paged_split_tc_kernel<kPool, 64, 6>, 64 * kElem, kSplitStages,
                               kSplitWarps, kQuant, mk, mv, p, B, st)
                   : launch_tc(paged_split_tc_kernel<kPool, 128, 3>, 128 * kElem, kSplitStages,
                               kSplitWarps, kQuant, mk, mv, p, B, st);
  } else {
    constexpr int kStages128 = kQuant ? 8 : 4;
    return D == 64 ? launch_tc(paged_sweep_tc_kernel<kPool, 64, 8>, 64 * kElem, 8, kWarps, kQuant,
                               mk, mv, p, B, st)
                   : launch_tc(paged_sweep_tc_kernel<kPool, 128, kStages128>, 128 * kElem,
                               kStages128, kWarps, kQuant, mk, mv, p, B, st);
  }
}

// Checks the tensor-core kernels' operands and encodes the pools' tensor
// maps; returns 0 or a cudaError_t. pool: kPoolFloat (bf16 pools, no
// scales) or a quantized kind with both scale tables.
int tc_prepare(CUtensorMap* mk, CUtensorMap* mv, const void* q, int64_t q_sb, int64_t q_sc,
               int64_t q_sh, const void* k_pool, const void* v_pool, const void* k_scale,
               const void* v_scale, int pool, const int64_t* geometry, int B, int C, int H_kv,
               int G, int bl, int W) {
  const int64_t D = geometry[0];
  const int64_t box = geometry[7];
  const bool quant = pool != kPoolFloat;
  const bool box_ok = bl < kStageKeys ? box == bl && box >= 8 && kStageKeys % bl == 0
                                      : box == kStageKeys && bl % kStageKeys == 0;
  if (B < 1 || B > 65535 || H_kv < 1 || H_kv > 65535 || G < 1 || C < 1 || W < 1 ||
      pool < kPoolFloat || pool > kPoolE5M2 || quant != (k_scale != nullptr) ||
      quant != (v_scale != nullptr) || reinterpret_cast<uintptr_t>(q) % 4 || q_sb % 2 ||
      q_sc % 2 || q_sh % 2 || (D != 64 && D != 128) || geometry[1] != H_kv ||
      geometry[2] % bl || geometry[2] > INT32_MAX || geometry[3] != D * (quant ? 1 : 2) ||
      geometry[5] != (quant ? D : kBoxCols) || geometry[6] != 1 || !box_ok)
    return kInvalid;
  const int err = encode_pool(mk, k_pool, geometry, quant);
  return err != 0 ? err : encode_pool(mv, v_pool, geometry, quant);
}

// The append route's operands into p (null k_new: no append): the new rows
// k_new, v_new [B, C, H_kv, D] in new_dtype (0 = float32, 1 = bfloat16)
// with strides in elements, written into the quantized pools. Each row is
// read in 16-byte vectors, so the pointers and the strides' bytes must be
// multiples of 16. Returns 0 or cudaErrorInvalidValue.
int tc_append(TcParams* p, int pool, void* k_pool, void* v_pool, const void* k_new,
              int64_t k_sb, int64_t k_sc, int64_t k_sh, const void* v_new, int64_t v_sb,
              int64_t v_sc, int64_t v_sh, int new_dtype) {
  if (k_new == nullptr) return v_new == nullptr ? 0 : kInvalid;
  const int64_t elem = new_dtype == 0 ? 4 : 2;
  bool ok = pool != kPoolFloat && v_new != nullptr && (new_dtype == 0 || new_dtype == 1) &&
            reinterpret_cast<uintptr_t>(k_new) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(v_new) % 16 == 0;
  const int64_t strides[6] = {k_sb, k_sc, k_sh, v_sb, v_sc, v_sh};
  for (int i = 0; i < 6; ++i) ok = ok && strides[i] * elem % 16 == 0;
  if (!ok) return kInvalid;
  p->k_new = k_new;
  p->v_new = v_new;
  p->k_sb = k_sb;
  p->k_sc = k_sc;
  p->k_sh = k_sh;
  p->v_sb = v_sb;
  p->v_sc = v_sc;
  p->v_sh = v_sh;
  p->new_f32 = new_dtype == 0;
  p->k_pool = static_cast<unsigned char*>(k_pool);
  p->v_pool = static_cast<unsigned char*>(v_pool);
  return 0;
}

template <bool kSplit>
int launch_tc_pool(int pool, int D, const CUtensorMap& mk, const CUtensorMap& mv,
                   const TcParams& p, int B, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (pool) {
    case kPoolFloat: return launch_tc_d<kPoolFloat, kSplit>(D, mk, mv, p, B, st);
    case kPoolInt8: return launch_tc_d<kPoolInt8, kSplit>(D, mk, mv, p, B, st);
    case kPoolE4M3: return launch_tc_d<kPoolE4M3, kSplit>(D, mk, mv, p, B, st);
    case kPoolE5M2: return launch_tc_d<kPoolE5M2, kSplit>(D, mk, mv, p, B, st);
    default: return kInvalid;
  }
}

template <typename T, typename P, int kScale, bool kSplit, int kDpl>
int launch_one(const Params& p, int B, cudaStream_t stream) {
  const int R = p.G * p.C;
  const dim3 grid(((R + kRows - 1) / kRows) * p.S, p.H_kv, B);
  paged_attention_kernel<T, P, kScale, kDpl, kSplit><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// quantized pools are built for D in {64, 128} only, float pools for all four
template <typename T, typename P, int kScale, bool kSplit>
int launch_d(const Params& p, int B, int D, cudaStream_t st) {
  if (D == 64) return launch_one<T, P, kScale, kSplit, 2>(p, B, st);
  if (D == 128) return launch_one<T, P, kScale, kSplit, 4>(p, B, st);
  if constexpr (kScale == kNoScale) {
    if (D == 32) return launch_one<T, P, kScale, kSplit, 1>(p, B, st);
    if (D == 96) return launch_one<T, P, kScale, kSplit, 3>(p, B, st);
  }
  return kInvalid;
}

template <typename T, bool kSplit>
int launch_pool(const Params& p, int pool, int B, int D, cudaStream_t st) {
  switch (pool) {
    case 0: return launch_d<T, T, kNoScale, kSplit>(p, B, D, st);
    case 1: return launch_d<T, int8_t, kMultiplier, kSplit>(p, B, D, st);
    case 2: return launch_d<T, __nv_fp8_e4m3, kExponent, kSplit>(p, B, D, st);
    case 3: return launch_d<T, __nv_fp8_e5m2, kExponent, kSplit>(p, B, D, st);
    default: return kInvalid;
  }
}

template <bool kSplit>
int launch(Params p, int dtype, int pool, int B, int D, void* stream) {
  if (B < 1 || p.H_kv < 1 || p.G < 1 || p.C < 1 || p.bl < 1 || p.W < 1 ||
      p.S < 1 || p.S > p.W || (pool != 0) != (p.k_scale != nullptr) ||
      (pool != 0) != (p.v_scale != nullptr)) {
    return kInvalid;
  }
  p.wc = (p.W + p.S - 1) / p.S;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_pool<float, kSplit>(p, pool, B, D, st);
  if (dtype == 1) return launch_pool<__nv_bfloat16, kSplit>(p, pool, B, D, st);
  return kInvalid;
}

// ---------------------------------------------------------------------------
// Quantize-on-scatter: replaces paged_quantize_scatter
// (pytorch_distributed_tpu/ops/paged_flash.py:462-577, pallas_call :563).
//
// What it computes: each written K/V row [D] of each KV head goes into the
// quantized pool at (blk, off) with its scale beside it, in place, with
// the arithmetic of serving.kv_pool.quantize_rows (RowQuant, above),
// bit-identical to the plain PyTorch version.
//
// What bounds it on the H100: neither bytes nor operations. A decode tick
// writes 8 rows x 12 heads x 2 of 64 values per layer, under 25 KB; the
// plain version costs ~15 launches per layer. The kernel is one launch, and
// that launch is its whole cost: with bf16 q the tensor-core sweep and
// split write the new rows themselves (the append route, paged_tc_body),
// so this kernel runs only for fp32 q and the walk's shapes.
//
// Design: one warp per (row, KV head, K or V): each lane holds D/32 values
// read through the strides of the fused qkv view, the row's amax is a warp
// max by shuffle, and lane 0 writes the scale. Duplicate destinations come
// only from inactive lanes writing the trash block.

struct QParams {
  const void* k;  // k[b, l, h, :] at k + b*k_sb + l*k_sl + h*k_sh
  int64_t k_sb, k_sl, k_sh;
  const void* v;
  int64_t v_sb, v_sl, v_sh;
  const int64_t* blk;  // [N] destination blocks, N = B * L
  const int64_t* off;  // [N] in-block offsets
  void* k_pool;        // [n_blocks, bl, H_kv, D]
  void* v_pool;
  void* k_scale;       // [n_blocks, bl, H_kv]
  void* v_scale;
  int N, L, H_kv, bl;
};

template <typename T, int kPool, int kDpl>
__global__ void __launch_bounds__(kThreads) quantize_scatter_kernel(const QParams p) {
  constexpr int D = 32 * kDpl;
  const int lane = threadIdx.x & 31;
  const int64_t task = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (task >= 2 * static_cast<int64_t>(p.N) * p.H_kv) return;
  const bool is_v = task & 1;
  const int h = static_cast<int>((task >> 1) % p.H_kv);
  const int64_t n = (task >> 1) / p.H_kv;
  const int64_t bi = n / p.L;
  const int64_t li = n - bi * p.L;
  const T* src = is_v ? static_cast<const T*>(p.v) + bi * p.v_sb + li * p.v_sl + h * p.v_sh
                      : static_cast<const T*>(p.k) + bi * p.k_sb + li * p.k_sl + h * p.k_sh;
  float x[kDpl];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kDpl; ++i) {
    x[i] = to_float(src[lane * kDpl + i]);
    amax = fmaxf(amax, fabsf(x[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, o));
  const RowQuant<kPool> rq(amax);
  const int64_t row = (p.blk[n] * p.bl + p.off[n]) * p.H_kv + h;
  uint8_t* dst = static_cast<uint8_t*>(is_v ? p.v_pool : p.k_pool) + row * D + lane * kDpl;
#pragma unroll
  for (int i = 0; i < kDpl; ++i) dst[i] = rq.code(x[i]);
  if (lane == 0) rq.store_scale(is_v ? p.v_scale : p.k_scale, row);
}

template <typename T, int kPool>
int launch_quantize_d(const QParams& p, int D, cudaStream_t st) {
  const int64_t tasks = 2 * static_cast<int64_t>(p.N) * p.H_kv;
  const unsigned grid = static_cast<unsigned>((tasks + kWarps - 1) / kWarps);
  if (D == 64) {
    quantize_scatter_kernel<T, kPool, 2><<<grid, kThreads, 0, st>>>(p);
  } else if (D == 128) {
    quantize_scatter_kernel<T, kPool, 4><<<grid, kThreads, 0, st>>>(p);
  } else {
    return kInvalid;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_quantize_pool(const QParams& p, int pool, int D, cudaStream_t st) {
  switch (pool) {
    case 1: return launch_quantize_d<T, 1>(p, D, st);
    case 2: return launch_quantize_d<T, 2>(p, D, st);
    case 3: return launch_quantize_d<T, 3>(p, D, st);
    default: return kInvalid;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and out). pool: 0 = pools in q's
// dtype (no scales), 1 = int8 with fp32 scales, 2 = fp8 e4m3 and 3 = fp8
// e5m2 with int8 exponents. D in {32, 64, 96, 128} (quantized: {64, 128}).
// Strides in elements. Returns the launch's cudaError_t (0 = launched).
extern "C" int pdt_paged_attention_sweep(
    const void* q, int64_t q_sb, int64_t q_sc, int64_t q_sh, const void* k_pool,
    const void* v_pool, const void* k_scale, const void* v_scale, const void* tables,
    const void* qpos, void* out, int dtype, int pool, int B, int C, int H_kv, int G,
    int D, int bl, int W, float scale, void* stream) {
  Params p{q, q_sb, q_sc, q_sh, k_pool, v_pool, k_scale, v_scale,
           static_cast<const int*>(tables), static_cast<const int*>(qpos), out,
           nullptr, nullptr, nullptr, nullptr, H_kv, G, C, bl, W, 1, W, scale};
  return launch<false>(p, dtype, pool, B, D, stream);
}

// tickets: B * H_kv * ceil(G * C / 8) int32, zero on entry (left zero).
extern "C" int pdt_paged_attention_split(
    const void* q, int64_t q_sb, int64_t q_sc, int64_t q_sh, const void* k_pool,
    const void* v_pool, const void* k_scale, const void* v_scale, const void* tables,
    const void* qpos, void* out, void* part_acc, void* part_m, void* part_l,
    void* tickets, int dtype, int pool, int B, int C, int H_kv, int G, int D, int bl,
    int W, int S, float scale, void* stream) {
  Params p{q, q_sb, q_sc, q_sh, k_pool, v_pool, k_scale, v_scale,
           static_cast<const int*>(tables), static_cast<const int*>(qpos), out,
           static_cast<float*>(part_acc), static_cast<float*>(part_m),
           static_cast<float*>(part_l), static_cast<int*>(tickets), H_kv, G, C, bl,
           W, S, 0, scale};
  return launch<true>(p, dtype, pool, B, D, stream);
}

// dtype: 0 = float32, 1 = bfloat16 (k and v, strides in elements); pool: 1
// = int8, 2 = fp8 e4m3, 3 = fp8 e5m2; blk and off int64 [N]; D in {64, 128}.
extern "C" int pdt_paged_quantize_scatter(
    const void* k, int64_t k_sb, int64_t k_sl, int64_t k_sh, const void* v,
    int64_t v_sb, int64_t v_sl, int64_t v_sh, const void* blk, const void* off,
    void* k_pool, void* v_pool, void* k_scale, void* v_scale, int dtype, int pool,
    int N, int L, int H_kv, int D, int bl, void* stream) {
  if (N < 1 || L < 1 || N % L || H_kv < 1 || bl < 1) return kInvalid;
  QParams p{k, k_sb, k_sl, k_sh, v, v_sb, v_sl, v_sh,
            static_cast<const int64_t*>(blk), static_cast<const int64_t*>(off),
            k_pool, v_pool, k_scale, v_scale, N, L, H_kv, bl};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_quantize_pool<float>(p, pool, D, st);
  if (dtype == 1) return launch_quantize_pool<__nv_bfloat16>(p, pool, D, st);
  return kInvalid;
}

// The single sweep on tensor cores: bf16 q [B, C, H, D] (4-byte aligned,
// even strides in elements) on pools of kind `pool` (0 = bf16 with null
// scales; 1 = int8 codes with fp32 scales, 2 = fp8 e4m3 and 3 = fp8 e5m2
// codes with int8 exponents, scales [n_blocks, bl, H_kv]), D in {64, 128};
// geometry: the pools' tensor map, 8 int64 values (ops/paged_flash.py:
// pool_tensor_map_geometry), whose box rows are bl (8, 16 or 32) or 64 (bl
// a multiple of 64). A pool kind or D with no instance returns
// cudaErrorInvalidValue. The append route (quantized pools): k_new, v_new
// [B, C, H_kv, D] (strides in elements; new_dtype 0 = float32, 1 =
// bfloat16; 16-byte aligned rows) are quantized as paged_quantize_scatter
// does and written into the pools and scales at position qpos[b, c]
// (tables[b, pos / bl], slot pos % bl; a negative position writes
// nothing) before the launch reads them; null k_new and v_new: none.
extern "C" int pdt_paged_attention_sweep_tc(
    const void* q, int64_t q_sb, int64_t q_sc, int64_t q_sh, void* k_pool, void* v_pool,
    void* k_scale, void* v_scale, const int64_t* geometry, const void* tables, const void* qpos,
    void* out, int pool, int B, int C, int H_kv, int G, int bl, int W, float scale,
    const void* k_new, int64_t k_sb, int64_t k_sc, int64_t k_sh, const void* v_new, int64_t v_sb,
    int64_t v_sc, int64_t v_sh, int new_dtype, void* stream) {
  CUtensorMap mk, mv;
  int err = tc_prepare(&mk, &mv, q, q_sb, q_sc, q_sh, k_pool, v_pool, k_scale, v_scale, pool,
                       geometry, B, C, H_kv, G, bl, W);
  if (err != 0) return err;
  TcParams p{static_cast<const __nv_bfloat16*>(q), q_sb, q_sc, q_sh, k_scale, v_scale,
             static_cast<const int*>(tables), static_cast<const int*>(qpos),
             static_cast<__nv_bfloat16*>(out), nullptr, nullptr, nullptr, nullptr, H_kv, G, C,
             bl, W, static_cast<int>(geometry[7]), static_cast<int>(geometry[2]), 1, W, scale};
  err = tc_append(&p, pool, k_pool, v_pool, k_new, k_sb, k_sc, k_sh, v_new, v_sb, v_sc, v_sh,
                  new_dtype);
  if (err != 0) return err;
  return launch_tc_pool<false>(pool, static_cast<int>(geometry[0]), mk, mv, p, B, stream);
}

// The split on tensor cores: operands (and the append route) as
// pdt_paged_attention_sweep_tc, S workers (1 <= S <= W); part_acc, part_m,
// part_l fp32 scratch [B, H_kv, S, G * C, D], [B, H_kv, S, G * C] twice;
// tickets B * H_kv * ceil(G * C / 32) int32, zero on entry (left zero).
extern "C" int pdt_paged_attention_split_tc(
    const void* q, int64_t q_sb, int64_t q_sc, int64_t q_sh, void* k_pool, void* v_pool,
    void* k_scale, void* v_scale, const int64_t* geometry, const void* tables, const void* qpos,
    void* out, void* part_acc, void* part_m, void* part_l, void* tickets, int pool, int B, int C,
    int H_kv, int G, int bl, int W, int S, float scale, const void* k_new, int64_t k_sb,
    int64_t k_sc, int64_t k_sh, const void* v_new, int64_t v_sb, int64_t v_sc, int64_t v_sh,
    int new_dtype, void* stream) {
  if (S < 1 || S > W) return kInvalid;
  CUtensorMap mk, mv;
  int err = tc_prepare(&mk, &mv, q, q_sb, q_sc, q_sh, k_pool, v_pool, k_scale, v_scale, pool,
                       geometry, B, C, H_kv, G, bl, W);
  if (err != 0) return err;
  TcParams p{static_cast<const __nv_bfloat16*>(q), q_sb, q_sc, q_sh, k_scale, v_scale,
             static_cast<const int*>(tables), static_cast<const int*>(qpos),
             static_cast<__nv_bfloat16*>(out), static_cast<float*>(part_acc),
             static_cast<float*>(part_m), static_cast<float*>(part_l), static_cast<int*>(tickets),
             H_kv, G, C, bl, W, static_cast<int>(geometry[7]), static_cast<int>(geometry[2]), S,
             (W + S - 1) / S, scale};
  err = tc_append(&p, pool, k_pool, v_pool, k_new, k_sb, k_sc, k_sh, v_new, v_sb, v_sc, v_sh,
                  new_dtype);
  if (err != 0) return err;
  return launch_tc_pool<true>(pool, static_cast<int>(geometry[0]), mk, mv, p, B, stream);
}

extern "C" int pdt_paged_attention_rows_per_tile() { return kRows; }

extern "C" const char* pdt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
