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
//   - paged_quantize_scatter (pallas_call at :563, body :532), further
//     down this file.
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
// KV head) in scales [n_blocks, bl, H_kv]. A quantized row is dequantized
// to fp32 as it is loaded, float(q) * scale or float(q) * 2^e, with 2^e
// built exactly from its exponent bits. V is then fp32, so p stays fp32
// for PV there.
//
// What bounds it on the H100: the bytes of the attended K/V chain. Each
// pool element it reads feeds ~2 flops per query row (R = G * C rows share
// a KV head; R = 1 for an MHA decode tick), far below the ~295 flops/byte
// where the tensor cores would be the limit, so the least time is the
// visible chain's bytes over 3.35 TB/s.
//
// What the design does about it:
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
// CUDA cores do the two small products; wgmma, TMA and a deeper load
// pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// the dequantization factor of scales[i]
template <int kScale>
__device__ __forceinline__ float row_scale(const void* scales, int64_t i) {
  if constexpr (kScale == kMultiplier) return __ldg(static_cast<const float*>(scales) + i);
  if constexpr (kScale == kExponent)
    return pow2(__ldg(static_cast<const signed char*>(scales) + i));
  return 1.f;
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

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

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
// the arithmetic of serving.kv_pool.quantize_rows:
//   int8: s = amax * fp32(1/127); q = clip(rint(x / s), -127, 127)
//   fp8:  e = clip(ceil(log2(amax / fmax)), -126, 126), taken exactly from
//         frexp(amax) = (m, k): e = k - k_fmax + (m > 0.875), as fmax is
//         0.875 * 2^k_fmax; q = cvt_rn_satfinite(x * 2^-e)
// with amax = max(max |x|, 1e-8). IEEE division, rint and exact powers of
// two make it bit-identical to the plain PyTorch version.
//
// What bounds it on the H100: neither bytes nor operations. A decode tick
// writes 8 rows x 12 heads x 2 of 64 values per layer, under 25 KB; the
// plain version costs ~15 launches per layer. The kernel is one launch.
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

constexpr float kAmaxFloor = 1e-8f;
constexpr float kInt8Scale = static_cast<float>(1.0 / 127.0);  // jnp.float32(1/127)
constexpr int kPoolInt8 = 1;
constexpr int kPoolE4M3 = 2;

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
  amax = fmaxf(amax, kAmaxFloor);
  const int64_t row = (p.blk[n] * p.bl + p.off[n]) * p.H_kv + h;
  uint8_t* dst = static_cast<uint8_t*>(is_v ? p.v_pool : p.k_pool) + row * D + lane * kDpl;
  void* scales = is_v ? p.v_scale : p.k_scale;
  if constexpr (kPool == kPoolInt8) {
    const float s = amax * kInt8Scale;
#pragma unroll
    for (int i = 0; i < kDpl; ++i)
      dst[i] = static_cast<uint8_t>(
          static_cast<int8_t>(fminf(fmaxf(rintf(x[i] / s), -127.f), 127.f)));
    if (lane == 0) static_cast<float*>(scales)[row] = s;
  } else {
    constexpr __nv_fp8_interpretation_t kFmt = kPool == kPoolE4M3 ? __NV_E4M3 : __NV_E5M2;
    constexpr int kFmaxExp = kPool == kPoolE4M3 ? 9 : 16;  // 448, 57344 = 0.875 * 2^k
    int k;
    const float m = frexpf(amax, &k);
    const int e = min(max(k - kFmaxExp + (m > 0.875f ? 1 : 0), -126), 126);
    const float inv = pow2(-e);
#pragma unroll
    for (int i = 0; i < kDpl; ++i)
      dst[i] = __nv_cvt_float_to_fp8(x[i] * inv, __NV_SATFINITE, kFmt);
    if (lane == 0) static_cast<int8_t*>(scales)[row] = static_cast<int8_t>(e);
  }
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

extern "C" int pdt_paged_attention_rows_per_tile() { return kRows; }

extern "C" const char* pdt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
