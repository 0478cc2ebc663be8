// FlashAttention forward, fused backward and split backward, for Hopper
// (sm_90a).
//
// Replaces three Pallas TPU kernels of pytorch_distributed_tpu/ops/flash_attention.py:
//   - the forward _flash_fwd (pallas_call at :138; kernel _fwd_kernel :55),
//     which returns O and the row log-sum-exp LSE;
//   - the fused single-pass backward _flash_bwd_fused (pallas_call at :375;
//     kernel _bwd_fused_kernel :280, block math _masked_p_ds :164), which
//     returns dK, dV and per-KV-block dQ partials that XLA sums (:397);
//   - the split backward _flash_bwd (pallas_calls at :434 for _bwd_dq_kernel
//     :195 and :451 for _bwd_dkv_kernel :232), the one ops/ring_flash.py runs
//     per ring visit with bwd_impl="split": flash_bwd_dq_kernel gives dQ with
//     one block per Q tile sweeping the K/V tiles, and flash_bwd_kernel
//     without its dQ part gives dK, dV with one block per K/V tile sweeping
//     the Q tiles. Each output is written once, with no atomics, so two
//     launches give bit-identical gradients. The split spends 7 products per
//     visible pair (S and dP twice) where the fused kernel spends 5.
//
// What it computes, for q [B, Lq, H, D] and k, v [B, Lk, H, D] read through
// their strides (the fused qkv projection's views need no copy): key j is
// visible to query i iff j < Lk and, when causal, j <= i + shift (shift =
// q_offset - k_offset; 0 in the model). As Pallas does: q is scaled in its
// own dtype, S = qK^T and the softmax statistics are fp32, p is rounded to
// V's dtype before PV, NEG_INF = -1e30 is finite, and a row with no visible
// key gives O = 0 and LSE = NEG_INF. LSE is [B, H, Lq] fp32 (the TPU's
// 128-lane broadcast is not kept). The backward recomputes
// P = where(mask, exp(S - LSE), 0), dP = dO V^T, dS = P (dP - Delta) scale with
// Delta = rowsum(dO * O) from the caller, and accumulates dV += P^T dO (P in
// dO's dtype), dK += dS^T Q and dQ += dS K (dS in q's dtype). dQ sums in
// fp32 across key tiles by atomics into a zeroed [B, Lq, H, D] buffer: the
// numerics of the JAX kernel's partials_f32=True. The split dQ sums the same
// fp32 products in registers and writes dQ once in the input dtype.
//
// What bounds it on the H100: the operations. At the training shape
// (B 8, L 2048, H 12, D 64, causal) the forward does 4 D flops per visible
// (q, k) pair, 52 GFLOP, over ~100 MB of q, k, v, O; the backward 10 D per
// pair, 129 GFLOP, over ~200 MB (the split backward 14 D per pair, 181
// GFLOP): hundreds of flops per byte, above the H100's ~295 flops/byte line,
// so the bf16 tensor cores set the least time.
//
// What the design does about it:
//   - bf16 products run on the tensor cores through mma.sync m16n8k16 with
//     fp32 accumulators; the softmax probabilities stay in registers and
//     feed the PV product as its A operand without a trip through memory
//     (the C fragment of S is laid out as the A fragment of P).
//   - One thread block per (64-row tile, batch x head): the forward and the
//     split dQ kernel loop over K/V tiles, the fused backward and the split
//     dK/dV kernel (one block per K/V tile) over Q tiles; causal tiles above
//     the diagonal are skipped, so the work is the visible pairs'. Causal
//     forward and dQ blocks start with the longest rows.
//   - No padding copies: rows past L are zero in shared memory and masked.
//   - fp32 inputs take the same code with the product run on CUDA cores
//     (lanes trade fragment values by shuffle), for exact fp32 numerics.
// Loads are synchronous 16-byte copies into padded shared-memory tiles;
// wgmma, TMA and a load pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;  // rows of a Q tile and of a K/V tile: 16 per warp
constexpr int kPad = 8;    // row padding of the shared-memory tiles
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/attention.py

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Fragments of one product C[16x8] += A[16x16] B[16x8], as mma.sync
// m16n8k16 holds them. Lane 4g + t holds
//   A: pair 0 = A[g][2t, 2t+1], 1 = A[g+8][2t, 2t+1],
//      pair 2 = A[g][2t+8, 2t+9], 3 = A[g+8][2t+8, 2t+9];
//   B: pair 0 = B[2t, 2t+1][g], 1 = B[2t+8, 2t+9][g];
//   C: c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1].
// bf16 packs a pair into one 32-bit register (first element in the low
// half); fp32 keeps both floats.
template <typename T>
struct FragA {
  float x[8];
};
template <>
struct FragA<bf16> {
  uint32_t x[4];
};
template <typename T>
struct FragB {
  float x[4];
};
template <>
struct FragB<bf16> {
  uint32_t x[2];
};

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// pair i of a fragment from p[0] and p[s]
__device__ __forceinline__ void set_pair(float* x, int i, const float* p, int s) {
  x[2 * i] = p[0];
  x[2 * i + 1] = p[s];
}
__device__ __forceinline__ void set_pair(uint32_t* x, int i, const bf16* p, int s) {
  x[i] = pack(p[0], p[s]);
}

// pair i from two fp32 values, rounded to the fragment's type
__device__ __forceinline__ void set_pair_f(float* x, int i, float a, float b) {
  x[2 * i] = a;
  x[2 * i + 1] = b;
}
__device__ __forceinline__ void set_pair_f(uint32_t* x, int i, float a, float b) {
  x[i] = pack(__float2bfloat16(a), __float2bfloat16(b));
}

// A[m][k] at base[m * rs + k * cs], a 16x16 block
template <typename T>
__device__ __forceinline__ void load_a(FragA<T>& f, const T* base, int rs, int cs,
                                       int g, int t) {
  set_pair(f.x, 0, base + g * rs + (2 * t) * cs, cs);
  set_pair(f.x, 1, base + (g + 8) * rs + (2 * t) * cs, cs);
  set_pair(f.x, 2, base + g * rs + (2 * t + 8) * cs, cs);
  set_pair(f.x, 3, base + (g + 8) * rs + (2 * t + 8) * cs, cs);
}

// B[k][n] at base[k * rs + n * cs], a 16x8 block
template <typename T>
__device__ __forceinline__ void load_b(FragB<T>& f, const T* base, int rs, int cs,
                                       int g, int t) {
  set_pair(f.x, 0, base + (2 * t) * rs + g * cs, rs);
  set_pair(f.x, 1, base + (2 * t + 8) * rs + g * cs, rs);
}

// A as the C fragments of two adjacent 16x8 tiles (columns 0-7 and 8-15)
template <typename T>
__device__ __forceinline__ void a_from_c(FragA<T>& f, const float (&lo)[4],
                                         const float (&hi)[4]) {
  set_pair_f(f.x, 0, lo[0], lo[1]);
  set_pair_f(f.x, 1, lo[2], lo[3]);
  set_pair_f(f.x, 2, hi[0], hi[1]);
  set_pair_f(f.x, 3, hi[2], hi[3]);
}

__device__ __forceinline__ void mma(float (&c)[4], const FragA<bf16>& a,
                                    const FragB<bf16>& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]), "r"(b.x[0]),
        "r"(b.x[1]));
}

// The same product in fp32 on CUDA cores. Lane (g, s) holds rows g and
// g+8 of A at k = 2s, 2s+1, 2s+8, 2s+9; lane (n, s) holds column n of B at
// the same k. Each lane gathers what its four C elements need by shuffle.
// The loop stays rolled: unrolled, the fp32 kernels took most of two
// minutes of nvcc, and they serve checks, not the bf16 training path.
__device__ __forceinline__ void mma(float (&c)[4], const FragA<float>& a,
                                    const FragB<float>& b) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll 1
  for (int s = 0; s < 4; ++s) {
    float ar[8], b0[4], b1[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) ar[i] = __shfl_sync(kFull, a.x[i], 4 * g + s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b0[i] = __shfl_sync(kFull, b.x[i], 8 * t + s);      // column 2t
      b1[i] = __shfl_sync(kFull, b.x[i], 8 * t + 4 + s);  // column 2t + 1
    }
    c[0] = fmaf(ar[0], b0[0], fmaf(ar[1], b0[1], fmaf(ar[4], b0[2], fmaf(ar[5], b0[3], c[0]))));
    c[1] = fmaf(ar[0], b1[0], fmaf(ar[1], b1[1], fmaf(ar[4], b1[2], fmaf(ar[5], b1[3], c[1]))));
    c[2] = fmaf(ar[2], b0[0], fmaf(ar[3], b0[1], fmaf(ar[6], b0[2], fmaf(ar[7], b0[3], c[2]))));
    c[3] = fmaf(ar[2], b1[0], fmaf(ar[3], b1[1], fmaf(ar[6], b1[2], fmaf(ar[7], b1[3], c[3]))));
  }
}

// Rows [row0, row0 + 64) of one (batch, head) slice into a padded tile,
// 16 bytes a thread at a time; rows at or past n_rows are zero. kScale:
// each element becomes round_T(x * scale_t), q scaled in its own dtype.
template <typename T, int D, bool kScale>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t s_row, int row0,
                                          int n_rows, float scale_t) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  constexpr int LD = D + kPad;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * kVec;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      raw = __ldg(reinterpret_cast<const uint4*>(src + (row0 + r) * s_row + c));
    if constexpr (kScale) {
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int k = 0; k < kVec; ++k) e[k] = from_float<T>(to_float(e[k]) * scale_t);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = raw;
  }
}

struct Params {
  const void* q;  // [B, Lq, H, D], element strides q_s* (unit stride in D)
  const void* k;  // [B, Lk, H, D]
  const void* v;
  const void* dout;  // backward: [B, Lq, H, D]
  int64_t q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, o_sb, o_sl, o_sh;
  void* out;           // forward: O, contiguous [B, Lq, H, D]
  float* lse;          // [B, H, Lq]
  const float* delta;  // backward: [B, H, Lq]
  float* dq;           // fused backward: fp32 [B, Lq, H, D], zero on entry
  void* dq_out;        // split backward: dQ in the input dtype, contiguous [B, Lq, H, D]
  void* dk;            // backward: contiguous [B, Lk, H, D]
  void* dv;
  int H, Lq, Lk, causal, shift;
  float scale;
};

// grid (ceil(Lq / 64), B * H); 4 warps, warp w owns rows 16w .. 16w + 15
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kTile * LD;
  T* Vs = Ks + kTile * LD;

  const int n_qt = (p.Lq + kTile - 1) / kTile;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  const int q0 = qt * kTile;
  load_tile<T, D, true>(Qs, q, p.q_sl, q0, p.Lq, round_to<T>(p.scale));
  __syncthreads();
  FragA<T> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    load_a(qf[kk], Qs + (warp * 16) * LD + kk * 16, LD, 1, g, t);

  const int qrow[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  float o[D / 8][4] = {};

  const int n_kt = (p.Lk + kTile - 1) / kTile;
  int kt_end = n_kt;
  if (p.causal) {
    const int last = q0 + kTile - 1 + p.shift;  // the tile's last visible key
    kt_end = last < 0 ? 0 : min(n_kt, last / kTile + 1);
  }
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D, false>(Ks, k, p.k_sl, k0, p.Lk, 1.f);
    load_tile<T, D, false>(Vs, v, p.v_sl, k0, p.Lk, 1.f);
    __syncthreads();

    float s[8][4] = {};  // 16 rows x 64 keys: 8 tiles of 8 keys
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        FragB<T> kb;  // B[d][key] = K[key][d]
        load_b(kb, Ks + (j * 8) * LD + kk * 16, 1, LD, g, t);
        mma(s[j], qf[kk], kb);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kpos = k0 + j * 8 + 2 * t + c;
          const bool vis = kpos < p.Lk && (!p.causal || kpos <= qrow[r] + p.shift);
          if (!vis) s[j][2 * r + c] = kNegInf;
          mx = fmaxf(mx, s[j][2 * r + c]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kpos = k0 + j * 8 + 2 * t + c;
          const bool vis = kpos < p.Lk && (!p.causal || kpos <= qrow[r] + p.shift);
          const float pv = vis ? expf(s[j][2 * r + c] - m_new) : 0.f;  // p * mask
          s[j][2 * r + c] = pv;
          ps += pv;
        }
      }
      l[r] = l[r] * corr + ps;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * r] *= corr;
        o[n][2 * r + 1] *= corr;
      }
    }

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      FragA<T> pa;  // p rounded to V's dtype
      a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        FragB<T> vb;  // B[key][d] = V[key][d]
        load_b(vb, Vs + (kk * 16) * LD + n * 8, LD, 1, g, t);
        mma(o[n], pa, vb);
      }
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(kFull, lt, 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    const float lc = fmaxf(lt, 1e-37f);  // fully masked rows: 0 / lc = 0
    if (qrow[r] < p.Lq) {
      T* orow = out + ((static_cast<int64_t>(b) * p.Lq + qrow[r]) * p.H + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        orow[n * 8 + 2 * t] = from_float<T>(o[n][2 * r] / lc);
        orow[n * 8 + 2 * t + 1] = from_float<T>(o[n][2 * r + 1] / lc);
      }
      if (t == 0)
        p.lse[static_cast<int64_t>(bh) * p.Lq + qrow[r]] =
            lt > 0.f ? m[r] + logf(lc) : kNegInf;
    }
  }
}

// grid (ceil(Lk / 64), B * H); warp w owns keys 16w .. 16w + 15 of the tile.
// kDq: the fused backward, which also adds each tile's dQ by atomics; without
// it, the split backward's dK/dV kernel.
template <typename T, int D, bool kDq>
__global__ void __launch_bounds__(kThreads) flash_bwd_kernel(const Params p) {
  constexpr int LD = D + kPad;
  constexpr int LDS = kTile + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kTile * LD;
  T* Qs = Vs + kTile * LD;   // q as given, for dK
  T* Qss = Qs + kTile * LD;  // q scaled in its dtype, for S
  T* dOs = Qss + kTile * LD;
  T* dSt = dOs + kTile * LD;  // dS^T [key][q] in q's dtype, for dQ (kDq only)
  float* lse_s = reinterpret_cast<float*>(dSt + (kDq ? kTile * LDS : 0));
  float* dl_s = lse_s + kTile;

  const int kt = blockIdx.x;  // causal: the first key tiles see the most rows
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* lse = p.lse + static_cast<int64_t>(bh) * p.Lq;
  const float* delta = p.delta + static_cast<int64_t>(bh) * p.Lq;
  const float scale_t = round_to<T>(p.scale);

  const int k0 = kt * kTile;
  load_tile<T, D, false>(Ks, k, p.k_sl, k0, p.Lk, 1.f);
  load_tile<T, D, false>(Vs, v, p.v_sl, k0, p.Lk, 1.f);
  const int krow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dk[D / 8][4] = {};
  float dv[D / 8][4] = {};

  const int n_qt = (p.Lq + kTile - 1) / kTile;
  int qt_begin = 0;
  if (p.causal) {
    // the first Q tile whose last row sees key k0: q0 + 63 + shift >= k0
    const int first = k0 - p.shift - (kTile - 1);
    qt_begin = first <= 0 ? 0 : (first + kTile - 1) / kTile;
  }
  for (int qt = qt_begin; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // every warp is done with the previous Q tile and dS
    load_tile<T, D, false>(Qs, q, p.q_sl, q0, p.Lq, 1.f);
    load_tile<T, D, true>(Qss, q, p.q_sl, q0, p.Lq, scale_t);
    load_tile<T, D, false>(dOs, dout, p.o_sl, q0, p.Lq, 1.f);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool in = q0 + i < p.Lq;
      lse_s[i] = in ? lse[q0 + i] : 0.f;
      dl_s[i] = in ? delta[q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T, 16 keys x 64 rows: 8 tiles of 8 rows
    float st[8][4] = {};
    float dpt[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA<T> ka, va;
      load_a(ka, Ks + (warp * 16) * LD + kk * 16, LD, 1, g, t);
      load_a(va, Vs + (warp * 16) * LD + kk * 16, LD, 1, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        FragB<T> qb, ob;  // B[d][row] = Q[row][d], dO[row][d]
        load_b(qb, Qss + (j * 8) * LD + kk * 16, 1, LD, g, t);
        mma(st[j], ka, qb);
        load_b(ob, dOs + (j * 8) * LD + kk * 16, 1, LD, g, t);
        mma(dpt[j], va, ob);
      }
    }

    // P^T = where(mask, exp(S^T - LSE), 0); dS^T = P^T (dP^T - Delta) scale
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + 2 * t + (e & 1);
        const int qpos = q0 + ql;
        const int kpos = krow[e >> 1];
        const bool vis = kpos < p.Lk && qpos < p.Lq &&
                         (!p.causal || kpos <= qpos + p.shift);
        const float pv = vis ? expf(st[j][e] - lse_s[ql]) : 0.f;
        dpt[j][e] = pv * (dpt[j][e] - dl_s[ql]) * p.scale;
        st[j][e] = pv;
      }
    }

    // dV += P^T dO (P in dO's dtype), dK += dS^T Q (dS in q's dtype)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      FragA<T> pa, da;
      a_from_c(pa, st[2 * kk], st[2 * kk + 1]);
      a_from_c(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        FragB<T> ob, qb;  // B[row][d]
        load_b(ob, dOs + (kk * 16) * LD + n * 8, LD, 1, g, t);
        mma(dv[n], pa, ob);
        load_b(qb, Qs + (kk * 16) * LD + n * 8, LD, 1, g, t);
        mma(dk[n], da, qb);
      }
    }

    if constexpr (kDq) {
      // dQ[rows of this tile] += dS K: dS^T goes through shared memory, and
      // warp w takes rows 16w .. 16w + 15 over all 64 keys of the tile
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dSt[(warp * 16 + g + 8 * (e >> 1)) * LDS + j * 8 + 2 * t + (e & 1)] =
              from_float<T>(dpt[j][e]);
      }
      __syncthreads();
      FragA<T> dsa[4];  // A[row][key] = dS^T[key][row]
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        load_a(dsa[kk], dSt + (kk * 16) * LDS + warp * 16, 1, LDS, g, t);
      const int qr[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        float acc[4] = {};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          FragB<T> kb;  // B[key][d] = K[key][d]
          load_b(kb, Ks + (kk * 16) * LD + n * 8, LD, 1, g, t);
          mma(acc, dsa[kk], kb);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (qr[r] < p.Lq) {
            float* row = p.dq + ((static_cast<int64_t>(b) * p.Lq + qr[r]) * p.H + h) * D;
            atomicAdd(row + n * 8 + 2 * t, acc[2 * r]);
            atomicAdd(row + n * 8 + 2 * t + 1, acc[2 * r + 1]);
          }
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] < p.Lk) {
      const int64_t off = ((static_cast<int64_t>(b) * p.Lk + krow[r]) * p.H + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          dk_out[off + n * 8 + 2 * t + c] = from_float<T>(dk[n][2 * r + c]);
          dv_out[off + n * 8 + 2 * t + c] = from_float<T>(dv[n][2 * r + c]);
        }
      }
    }
  }
}

// The split backward's dQ (the TPU's _bwd_dq_kernel): grid (ceil(Lq / 64),
// B * H); warp w owns rows 16w .. 16w + 15 of the Q tile and sweeps the K/V
// tiles, when causal up to the tile's last visible key. Per K/V tile:
// S = (q scale) K^T and dP = dO V^T (fp32), P = where(mask, exp(S - LSE), 0),
// dS = P (dP - Delta) scale, dQ += dS K with dS in q's dtype; the fp32 sum
// stays in registers and dQ is written once in the input dtype.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qss = reinterpret_cast<T*>(smem);  // q scaled in its dtype, for S
  T* dOs = Qss + kTile * LD;
  T* Ks = dOs + kTile * LD;
  T* Vs = Ks + kTile * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + kTile * LD);
  float* dl_s = lse_s + kTile;

  const int n_qt = (p.Lq + kTile - 1) / kTile;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* lse = p.lse + static_cast<int64_t>(bh) * p.Lq;
  const float* delta = p.delta + static_cast<int64_t>(bh) * p.Lq;

  const int q0 = qt * kTile;
  load_tile<T, D, true>(Qss, q, p.q_sl, q0, p.Lq, round_to<T>(p.scale));
  load_tile<T, D, false>(dOs, dout, p.o_sl, q0, p.Lq, 1.f);
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const bool in = q0 + i < p.Lq;
    lse_s[i] = in ? lse[q0 + i] : 0.f;
    dl_s[i] = in ? delta[q0 + i] : 0.f;
  }
  __syncthreads();
  const int qrow[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float lse_r[2] = {lse_s[warp * 16 + g], lse_s[warp * 16 + g + 8]};
  const float dl_r[2] = {dl_s[warp * 16 + g], dl_s[warp * 16 + g + 8]};
  float dq[D / 8][4] = {};

  const int n_kt = (p.Lk + kTile - 1) / kTile;
  int kt_end = n_kt;
  if (p.causal) {
    const int last = q0 + kTile - 1 + p.shift;  // the tile's last visible key
    kt_end = last < 0 ? 0 : min(n_kt, last / kTile + 1);
  }
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D, false>(Ks, k, p.k_sl, k0, p.Lk, 1.f);
    load_tile<T, D, false>(Vs, v, p.v_sl, k0, p.Lk, 1.f);
    __syncthreads();

    // S = Q K^T and dP = dO V^T, 16 rows x 64 keys: 8 tiles of 8 keys
    float s[8][4] = {};
    float dp[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA<T> qa, oa;
      load_a(qa, Qss + (warp * 16) * LD + kk * 16, LD, 1, g, t);
      load_a(oa, dOs + (warp * 16) * LD + kk * 16, LD, 1, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        FragB<T> kb, vb;  // B[d][key] = K[key][d], V[key][d]
        load_b(kb, Ks + (j * 8) * LD + kk * 16, 1, LD, g, t);
        mma(s[j], qa, kb);
        load_b(vb, Vs + (j * 8) * LD + kk * 16, 1, LD, g, t);
        mma(dp[j], oa, vb);
      }
    }

    // P = where(mask, exp(S - LSE), 0); dS = P (dP - Delta) scale
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        const bool vis = kpos < p.Lk && (!p.causal || kpos <= qrow[r] + p.shift);
        const float pv = vis ? expf(s[j][e] - lse_r[r]) : 0.f;
        dp[j][e] = pv * (dp[j][e] - dl_r[r]) * p.scale;
      }
    }

    // dQ += dS K, dS in q's dtype
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      FragA<T> da;
      a_from_c(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        FragB<T> kb;  // B[key][d] = K[key][d]
        load_b(kb, Ks + (kk * 16) * LD + n * 8, LD, 1, g, t);
        mma(dq[n], da, kb);
      }
    }
  }

  T* dq_out = static_cast<T*>(p.dq_out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] < p.Lq) {
      T* row = dq_out + ((static_cast<int64_t>(b) * p.Lq + qrow[r]) * p.H + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        row[n * 8 + 2 * t] = from_float<T>(dq[n][2 * r]);
        row[n * 8 + 2 * t + 1] = from_float<T>(dq[n][2 * r + 1]);
      }
    }
  }
}

enum Kind { kFwd, kBwdFused, kBwdDkv, kBwdDq };

template <typename T, int D, int K>
int launch_typed(const Params& p, int B, cudaStream_t stream) {
  constexpr int LD = D + kPad;
  constexpr size_t tile = kTile * LD * sizeof(T);
  constexpr size_t rows = 2 * kTile * sizeof(float);  // LSE and Delta of a Q tile
  size_t smem = 3 * tile;
  void (*kernel)(const Params) = flash_fwd_kernel<T, D>;
  int n_rows = p.Lq;
  if constexpr (K == kBwdFused) {
    smem = 5 * tile + kTile * (kTile + kPad) * sizeof(T) + rows;
    kernel = flash_bwd_kernel<T, D, true>;
    n_rows = p.Lk;
  } else if constexpr (K == kBwdDkv) {
    smem = 5 * tile + rows;
    kernel = flash_bwd_kernel<T, D, false>;
    n_rows = p.Lk;
  } else if constexpr (K == kBwdDq) {
    smem = 4 * tile + rows;
    kernel = flash_bwd_dq_kernel<T, D>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_rows + kTile - 1) / kTile, B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch(const Params& p, int dtype, int B, int D, void* stream) {
  if (B < 1 || p.H < 1 || p.Lq < 1 || p.Lk < 1 || B * p.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_typed<float, 64, K>(p, B, st);
  if (dtype == 0 && D == 128) return launch_typed<float, 128, K>(p, B, st);
  if (dtype == 1 && D == 64) return launch_typed<bf16, 64, K>(p, B, st);
  if (dtype == 1 && D == 128) return launch_typed<bf16, 128, K>(p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

Params backward_params(const void* q, int64_t q_sb, int64_t q_sl, int64_t q_sh,
                       const void* k, int64_t k_sb, int64_t k_sl, int64_t k_sh,
                       const void* v, int64_t v_sb, int64_t v_sl, int64_t v_sh,
                       const void* dout, int64_t o_sb, int64_t o_sl, int64_t o_sh,
                       const void* lse, const void* delta, void* dk, void* dv, int H,
                       int Lq, int Lk, int causal, int shift, float scale) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.q_sb = q_sb, p.q_sl = q_sl, p.q_sh = q_sh;
  p.k_sb = k_sb, p.k_sl = k_sl, p.k_sh = k_sh;
  p.v_sb = v_sb, p.v_sl = v_sl, p.v_sh = v_sh;
  p.o_sb = o_sb, p.o_sl = o_sl, p.o_sh = o_sh;
  p.lse = static_cast<float*>(const_cast<void*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  p.H = H, p.Lq = Lq, p.Lk = Lk, p.causal = causal, p.shift = shift;
  p.scale = scale;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO, O, dK, dV). D in {64, 128}.
// Strides in elements, unit stride in D, rows 16-byte aligned. Returns the
// launch's cudaError_t (0 = launched).
extern "C" int pdt_flash_fwd(const void* q, int64_t q_sb, int64_t q_sl, int64_t q_sh,
                             const void* k, int64_t k_sb, int64_t k_sl, int64_t k_sh,
                             const void* v, int64_t v_sb, int64_t v_sl, int64_t v_sh,
                             void* out, void* lse, int dtype, int B, int H, int Lq,
                             int Lk, int D, int causal, int shift, float scale,
                             void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_sb = q_sb, p.q_sl = q_sl, p.q_sh = q_sh;
  p.k_sb = k_sb, p.k_sl = k_sl, p.k_sh = k_sh;
  p.v_sb = v_sb, p.v_sl = v_sl, p.v_sh = v_sh;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.H = H, p.Lq = Lq, p.Lk = Lk, p.causal = causal, p.shift = shift;
  p.scale = scale;
  return launch<kFwd>(p, dtype, B, D, stream);
}

// dq: fp32 [B, Lq, H, D], zero on entry; dk, dv: contiguous [B, Lk, H, D];
// lse, delta: fp32 [B, H, Lq].
extern "C" int pdt_flash_bwd(const void* q, int64_t q_sb, int64_t q_sl, int64_t q_sh,
                             const void* k, int64_t k_sb, int64_t k_sl, int64_t k_sh,
                             const void* v, int64_t v_sb, int64_t v_sl, int64_t v_sh,
                             const void* dout, int64_t o_sb, int64_t o_sl, int64_t o_sh,
                             const void* lse, const void* delta, void* dq, void* dk,
                             void* dv, int dtype, int B, int H, int Lq, int Lk, int D,
                             int causal, int shift, float scale, void* stream) {
  Params p = backward_params(q, q_sb, q_sl, q_sh, k, k_sb, k_sl, k_sh, v, v_sb, v_sl, v_sh,
                             dout, o_sb, o_sl, o_sh, lse, delta, dk, dv, H, Lq, Lk, causal,
                             shift, scale);
  p.dq = static_cast<float*>(dq);
  return launch<kBwdFused>(p, dtype, B, D, stream);
}

// The split backward: the dK/dV kernel, then the dQ kernel, on one stream.
// dq: contiguous [B, Lq, H, D] in the input dtype, written once; the rest as
// pdt_flash_bwd.
extern "C" int pdt_flash_bwd_split(const void* q, int64_t q_sb, int64_t q_sl, int64_t q_sh,
                                   const void* k, int64_t k_sb, int64_t k_sl, int64_t k_sh,
                                   const void* v, int64_t v_sb, int64_t v_sl, int64_t v_sh,
                                   const void* dout, int64_t o_sb, int64_t o_sl,
                                   int64_t o_sh, const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv, int dtype, int B, int H,
                                   int Lq, int Lk, int D, int causal, int shift,
                                   float scale, void* stream) {
  Params p = backward_params(q, q_sb, q_sl, q_sh, k, k_sb, k_sl, k_sh, v, v_sb, v_sl, v_sh,
                             dout, o_sb, o_sl, o_sh, lse, delta, dk, dv, H, Lq, Lk, causal,
                             shift, scale);
  p.dq_out = dq;
  const int err = launch<kBwdDkv>(p, dtype, B, D, stream);
  if (err != 0) return err;
  return launch<kBwdDq>(p, dtype, B, D, stream);
}

extern "C" const char* pdt_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
