// FlashAttention forward, fused backward and split backward, for Hopper
// (sm_90a).
//
// Replaces three Pallas TPU kernels of pytorch_distributed_tpu/ops/flash_attention.py:
//   - the forward _flash_fwd (pallas_call at :138; kernel _fwd_kernel :55),
//     which returns O and the row log-sum-exp LSE;
//   - the fused single-pass backward _flash_bwd_fused (pallas_call at :375;
//     kernel _bwd_fused_kernel :280, block math _masked_p_ds :164), which
//     returns dK, dV and per-KV-block dQ partials that XLA sums in a fixed
//     order (:397);
//   - the split backward _flash_bwd (pallas_calls at :434 for _bwd_dq_kernel
//     :195 and :451 for _bwd_dkv_kernel :232), the one ops/ring_flash.py runs
//     per ring visit with bwd_impl="split": the fused backward's code without
//     its dQ pass gives dK, dV (one block per K/V tile), and the dQ
//     kernel gives dQ with one block per Q tile sweeping the K/V tiles.
//     The split spends 7 products per visible pair (S and dP twice) where
//     the fused kernel spends 5.
//
// What it computes, for q [B, Lq, H, D] and k, v [B, Lk, H, D] read through
// their strides (the fused qkv projection's views and the ring's zigzag
// chunk views need no copy): key j is visible to query i iff j < Lk and,
// when causal, j <= i + shift (shift = q_offset - k_offset; 0 in the
// model). As Pallas does: q is scaled in its own dtype, S = qK^T and the
// softmax statistics are fp32, p is rounded to V's dtype before PV, and a
// row with no visible key gives O = 0 and LSE = NEG_INF (-1e30). LSE is
// [B, H, Lq] fp32 (the TPU's 128-lane broadcast is not kept). The backward
// recomputes P = where(mask, exp(S - LSE), 0), dP = dO V^T, dS = P (dP -
// Delta) scale with Delta = rowsum(dO * O) from the caller, and accumulates
// dV += P^T dO (P in dO's dtype), dK += dS^T Q and dQ += dS K (dS in q's
// dtype), dQ summed in fp32: the numerics of the JAX kernel's
// partials_f32=True. Every output is the same bits from one launch to the
// next: the fused backward adds its per-key-tile dQ tiles in a fixed order
// (below), no sum anywhere depends on timing.
//
// What bounds it on the H100: the operations. At the training shape
// (B 8, L 2048, H 12, D 64, causal) the forward does 4 D flops per visible
// (q, k) pair, 52 GFLOP, over ~100 MB of q, k, v, O; the backward 10 D per
// pair, 129 GFLOP, over ~200 MB (the split backward 14 D per pair, 181
// GFLOP): hundreds of flops per byte, above the H100's ~295 flops/byte line,
// so the bf16 tensor cores set the least time.
//
// What the design does about it, for bf16 (the training path):
//   - Every product runs on wgmma, m64n64k16, the only way to the tensor
//     cores' full rate: S = Q K^T and the backward's S^T, dP^T from shared
//     memory; O += P V, dV += P^T dO and dK += dS^T Q with P, P^T and dS^T
//     straight from the previous product's accumulator registers as the A
//     operand; the fused backward's dQ = dS K from a swizzled shared tile
//     of dS^T, the split backward's dQ += dS K with dS from registers.
//   - Operand tiles arrive by TMA (a tensor map over the operand's own
//     strides, 128-byte swizzle, zero fill past L) into a ring of stages
//     with mbarriers, issued by one producer warp while the consumer
//     warpgroup computes on the tiles already landed. No thread spends an
//     instruction on an address or a copy.
//   - The softmax runs in log2 units with ex2 on registers; the mask is
//     applied only on the diagonal and ragged tiles.
//   - One block per (64-row Q tile, batch x head), longest causal rows
//     first, for the forward and the split's dQ; one per (K/V tile, batch x
//     head) for the dK/dV backward. Two to three blocks share an SM, so one
//     block's softmax overlaps another's products. Causal tiles above the
//     diagonal are skipped, so the work is the visible pairs'.
//   - The fused backward's dQ: each block adds its 64 x D fp32 tile to the
//     dQ workspace with one bulk reduce-add, in descending key-tile order
//     kept by a per-(batch x head, Q tile) counter in global memory
//     (flash_bwd_wgmma_kernel), so the sum's order never changes and no
//     per-key-block partials are kept.
// fp32 inputs take the CUDA-core kernels (the product on CUDA cores, lanes
// trading fragment values by shuffle) for exact fp32 numerics: they serve
// chip_smoke.py's fp32 checks, not the bf16 training path, and their fused
// backward is the split's two kernels, dQ written once in fp32.

#include <math.h>

#include "hopper.cuh"

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

// Fragments of one product C[16x8] += A[16x16] B[16x8] of the fp32
// CUDA-core kernels, laid out as mma.sync m16n8k16 holds them. Lane 4g + t
// holds
//   A: pair 0 = A[g][2t, 2t+1], 1 = A[g+8][2t, 2t+1],
//      pair 2 = A[g][2t+8, 2t+9], 3 = A[g+8][2t+8, 2t+9];
//   B: pair 0 = B[2t, 2t+1][g], 1 = B[2t+8, 2t+9][g];
//   C: c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1],
// each pair as two floats.
template <typename T>
struct FragA {
  float x[8];
};
template <typename T>
struct FragB {
  float x[4];
};

// pair i of a fragment from p[0] and p[s]
__device__ __forceinline__ void set_pair(float* x, int i, const float* p, int s) {
  x[2 * i] = p[0];
  x[2 * i + 1] = p[s];
}

// pair i from two fp32 values
__device__ __forceinline__ void set_pair_f(float* x, int i, float a, float b) {
  x[2 * i] = a;
  x[2 * i + 1] = b;
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

// The product on CUDA cores. Lane (g, s) holds rows g and
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
  float* lse;          // forward: [B, H, Lq]; backward: [B * H, rows_ld]
  const float* delta;  // backward: [B * H, rows_ld]
  int rows_ld;         // backward: row stride of lse and delta
  void* dq_out;        // dQ kernel: contiguous [B, Lq, H, D] in the input dtype
  void* dk;            // backward: contiguous [B, Lk, H, D]
  void* dv;
  int H, Lq, Lk, causal, shift;
  float scale;
};

// The forward of fp32 inputs: grid (ceil(Lq / 64), B * H); 4 warps, warp w
// owns rows 16w .. 16w + 15
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

// The dK/dV kernel of fp32 inputs (both backwards: kernel 6's dK/dV kernel,
// and kernel 5 with flash_bwd_dq_kernel for dQ): grid (ceil(Lk / 64),
// B * H); warp w owns keys 16w .. 16w + 15 of the tile.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_kernel(const Params p) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kTile * LD;
  T* Qs = Vs + kTile * LD;   // q as given, for dK
  T* Qss = Qs + kTile * LD;  // q scaled in its dtype, for S
  T* dOs = Qss + kTile * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + kTile * LD);
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
  const float* lse = p.lse + static_cast<int64_t>(bh) * p.rows_ld;
  const float* delta = p.delta + static_cast<int64_t>(bh) * p.rows_ld;
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
    __syncthreads();  // every warp is done with the previous Q tile
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

// The split backward's dQ of fp32 inputs (the TPU's _bwd_dq_kernel): grid
// (ceil(Lq / 64), B * H); warp w owns rows 16w .. 16w + 15 of the Q tile
// and sweeps the K/V tiles, when causal up to the tile's last visible key.
// Per K/V tile: S = (q scale) K^T and dP = dO V^T, P = where(mask, exp(S -
// LSE), 0), dS = P (dP - Delta) scale, dQ += dS K; the sum stays in
// registers and dQ is written once.
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
  const float* lse = p.lse + static_cast<int64_t>(bh) * p.rows_ld;
  const float* delta = p.delta + static_cast<int64_t>(bh) * p.rows_ld;

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


// ---------------------------------------------------------------------------
// The bf16 kernels on Hopper's own units: TMA copies, mbarriers, wgmma.
//
// A block is one consumer warpgroup (warps 0-3, 128 threads, one 64-row
// wgmma tile) and one producer warp (warp 4) whose first lane issues every
// copy. Operand tiles are [64 rows][64 columns] bf16 boxes of a 4-D tensor
// map (D, H, L, B) over the [B, L, H, D] tensor's own strides, landed with
// the 128-byte swizzle that the wgmma descriptors name; D = 128 takes two
// boxes per tile. Rows past L arrive as zeros (TMA's out-of-bounds fill).
// The producer runs ahead through a ring of stages, each guarded by a
// "full" mbarrier (the copy's bytes) and an "empty" one (the consumers'
// release).

constexpr int kConsumers = 128;                 // one warpgroup
constexpr int kThreadsW = kConsumers + 32;      // and one producer warp
constexpr int kBox = 64;                        // rows and columns of a box
constexpr int kBoxBytes = kBox * kBox * 2;      // 8 KB: 64 rows of 128 bytes
constexpr int kSliceBytes = 16 * 128;           // 16 rows of a box: one k16 step
constexpr float kLog2e = 1.4426950408889634f;

// `bytes` contiguous bytes (a multiple of 16, 16-byte aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` of fp32 from shared to global memory (16-byte aligned, a
// multiple of 16 bytes), stored or (kAdd) added at L2, as one bulk copy
template <bool kAdd>
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  if (kAdd)
    asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::
                     "l"(dst),
                 "r"(smem_u32(src)), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
                 "r"(smem_u32(src)), "r"(bytes)
                 : "memory");
}

// returns once this thread's bulk copies are complete, their writes made
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// wgmma_ss's product (hopper.cuh) with A from registers, in mma.sync's
// m16n8k16 A layout for the warp's 16 rows: a[0] = A[g][2t, 2t+1], a[1] =
// A[g+8][..], a[2] = A[g][2t+8, 2t+9], a[3] = A[g+8][..]; which is the
// accumulator layout of two adjacent 8-column chunks, so a product's result
// feeds the next one
template <int kTB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PDT_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : PDT_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTB));
}

// the A operand of k step kk (16 columns) from an accumulator
__device__ __forceinline__ void a_from_acc(uint32_t (&a)[4], const float (&d)[32], int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = pack2(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

struct FwdArgs {
  void* out;   // O, contiguous [B, Lq, H, D] bf16
  float* lse;  // [B, H, Lq]
  int H, Lq, Lk, causal, shift;
  float scale;
};

// The forward: grid (B * H, ceil(Lq / 64)), the longest causal rows first.
// Per K/V tile: S = (q scale) K^T by 4 (D / 16) wgmma on the swizzled Q
// and K boxes; the online softmax in registers, in log2 units, the mask
// only on diagonal and ragged tiles; O += P V with P from registers (the
// S accumulator rounded to bf16) and V read MN-major.
template <int kBoxes, int kStages, int kMinBlocks>
__global__ void __launch_bounds__(kThreadsW, kMinBlocks)
    flash_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap map_q,
                           __grid_constant__ const CUtensorMap map_k,
                           __grid_constant__ const CUtensorMap map_v, const FwdArgs a) {
  constexpr int kTileBytes = kBoxes * kBoxBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* q_s = smem;
  unsigned char* kv_s = smem + kTileBytes;  // stage s: K at 2 s tiles, V after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv_s + 2 * kStages * kTileBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBox;
  const int n_kt = (a.Lk + kBox - 1) / kBox;
  int kt_end = n_kt;
  if (a.causal) {
    const int last = q0 + kBox - 1 + a.shift;  // the tile's last visible key
    kt_end = last < 0 ? 0 : min(n_kt, last / kBox + 1);
  }

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(q_full, kTileBytes);
      for (int x = 0; x < kBoxes; ++x)
        tma_load(q_s + x * kBoxBytes, &map_q, q_full, x * kBox, h, q0, b);
      for (int i = 0; i < kt_end; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty + s, ((i / kStages) & 1) ^ 1);
        unsigned char* k_st = kv_s + 2 * s * kTileBytes;
        mbar_expect_tx(k_full + s, kTileBytes);
        for (int x = 0; x < kBoxes; ++x)
          tma_load(k_st + x * kBoxBytes, &map_k, k_full + s, x * kBox, h, i * kBox, b);
        mbar_expect_tx(v_full + s, kTileBytes);
        for (int x = 0; x < kBoxes; ++x)
          tma_load(k_st + kTileBytes + x * kBoxBytes, &map_v, v_full + s, x * kBox, h, i * kBox,
                   b);
      }
    }
    return;
  }

  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0 and row0 + 8
  mbar_wait(q_full, 0);
  {  // q scaled in its own dtype, once, in place (a swizzle moves no value)
    const float sc = round_to<bf16>(a.scale);
    uint4* v = reinterpret_cast<uint4*>(q_s);
    for (int i = tid; i < kTileBytes / 16; i += kConsumers) {
      uint4 x = v[i];
      bf16* e = reinterpret_cast<bf16*>(&x);
#pragma unroll
      for (int k = 0; k < 8; ++k) e[k] = __float2bfloat16(__bfloat162float(e[k]) * sc);
      v[i] = x;
    }
    fence_async_smem();
    sync_consumers();
  }

  float o[kBoxes][32];
#pragma unroll
  for (int x = 0; x < kBoxes; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[x][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // row max of S so far
  float l[2] = {0.f, 0.f};              // this thread's share of the row sums
  for (int i = 0; i < kt_end; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const unsigned char* k_st = kv_s + 2 * s * kTileBytes;
    const unsigned char* v_st = k_st + kTileBytes;
    float sacc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sacc[e] = 0.f;
    mbar_wait(k_full + s, phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * kBoxes; ++kk) {
      const int off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
      wgmma_ss<0, 0>(sacc, desc(q_s + off), desc(k_st + off), kk);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(sacc);

    const int k0 = i * kBox;
    if (k0 + kBox > a.Lk || (a.causal && k0 + kBox - 1 > q0 + a.shift)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int kpos = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
        const int qrow = row0 + 8 * ((e >> 1) & 1);
        if (!(kpos < a.Lk && (!a.causal || kpos <= qrow + a.shift))) sacc[e] = -INFINITY;
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sacc[4 * j + 2 * r], sacc[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float ms = (m_new == -INFINITY ? 0.f : m_new) * kLog2e;
      corr[r] = ex2(m[r] * kLog2e - ms);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = ex2(fmaf(sacc[4 * j + 2 * r + c], kLog2e, -ms));
          sacc[4 * j + 2 * r + c] = p;
          ps += p;
        }
      l[r] = l[r] * corr[r] + ps;
      m[r] = m_new;
    }
#pragma unroll
    for (int x = 0; x < kBoxes; ++x)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[x][e] *= corr[(e >> 1) & 1];
    uint32_t pa[4][4];  // P rounded to V's dtype, one A operand per 16 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_from_acc(pa[kk], sacc, kk);

    mbar_wait(v_full + s, phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
        wgmma_rs<1>(o[x], pa[kk], desc(v_st + x * kBoxBytes + kk * kSliceBytes), 1);
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) fence_regs(o[x]);
    mbar_arrive(empty + s);
  }

  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(kFull, lt, 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    const float lc = fmaxf(lt, 1e-37f);  // fully masked rows: 0 / lc = 0
    const int qrow = row0 + 8 * r;
    if (qrow < a.Lq) {
      bf16* orow = out + ((static_cast<int64_t>(b) * a.Lq + qrow) * a.H + h) * (kBoxes * kBox);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + x * kBox + 8 * j + 2 * t) =
              pack2(o[x][4 * j + 2 * r] / lc, o[x][4 * j + 2 * r + 1] / lc);
      if (t == 0)
        a.lse[static_cast<int64_t>(bh) * a.Lq + qrow] = lt > 0.f ? m[r] + logf(lc) : kNegInf;
    }
  }
}

struct BwdArgs {
  const float* rows;  // [2, B * H, ld]: LSE, then Delta; zero past Lq
  int ld;             // a multiple of 64
  float* dq;          // kDq: fp32 64 x D tiles [B * H, ceil(Lq / 64)] (dq_workspace)
  int* turns;         // kDq: [B * H, ceil(Lq / 64)] counters, zero on entry
  void* dk;           // contiguous [B, Lk, H, D] bf16
  void* dv;
  void* dq_out;       // the dQ kernel: contiguous [B, Lq, H, D] bf16
  int H, Lq, Lk, causal, shift;
  float scale;
};

// The backward: grid (ceil(Lk / 64), B * H); a block owns one K/V tile
// (blockIdx.x = 0 the last one) and sweeps the Q tiles that see it, two
// blocks an SM. Per Q tile: S^T = K (q scale)^T and dP^T = V dO^T by wgmma
// from shared memory; P^T = where(mask, exp(S^T - LSE), 0), dS^T = P^T
// (dP^T - Delta) scale in registers; dV += P^T dO and dK += dS^T Q with
// P^T and dS^T as register A operands (P in dO's dtype, dS in q's).
// kDq (the fused backward): dS^T also goes once to a swizzled shared tile,
// the A operand (MN-major) of dQ_tile = dS K, and the tile is added to the
// fp32 dQ in a fixed order: Q tile qt's key tiles add in descending order,
// each waiting until the counter turns[bh, qt] names its turn (the first
// stores the tile, the rest add it at L2, one bulk copy each), then bumping
// it with a release once the copy has landed (thread 0 does so while the
// next tile's S and dP run), as CUTLASS's serial split-K semaphore does. A
// causal Q tile's first adder is then the diagonal block's first iteration
// and each later one comes one iteration after its predecessor. A block
// waits only on blocks of higher key tiles, which have lower linear
// indices and so were started before it: no deadlock whatever the grid's
// size. dS goes to shared memory before dV and dK are computed, so the dV,
// dK and dQ products run as one batch. Without kDq this is kernel 6's
// dK/dV kernel, the same code, so the same dK and dV bits.
template <int kBoxes, int kStages, bool kDq, int kMinBlocks>
__global__ void __launch_bounds__(kThreadsW, kMinBlocks)
    flash_bwd_wgmma_kernel(__grid_constant__ const CUtensorMap map_q,
                           __grid_constant__ const CUtensorMap map_k,
                           __grid_constant__ const CUtensorMap map_v,
                           __grid_constant__ const CUtensorMap map_do, const BwdArgs a) {
  constexpr int kTileBytes = kBoxes * kBoxBytes;
  constexpr int kRowBytes = 2 * kBox * sizeof(float);  // LSE and Delta of a Q tile
  constexpr int kDqTileBytes = 2 * kTileBytes;          // 64 rows x D of fp32
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* k_s = smem;
  unsigned char* v_s = k_s + kTileBytes;
  unsigned char* st_s = v_s + kTileBytes;  // stage s: Q at 2 s tiles, dO after it
  unsigned char* ds_s = st_s + 2 * kStages * kTileBytes;  // kDq: dS^T [key][q], one box
  unsigned char* dqs_s = ds_s + (kDq ? kBoxBytes : 0);  // kDq: a 64 x D fp32 dQ tile
  float* rows_s = reinterpret_cast<float*>(dqs_s + (kDq ? kDqTileBytes : 0));  // per stage
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(rows_s + kStages * 2 * kBox);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int k0 = kt * kBox;
  const int n_qt = (a.Lq + kBox - 1) / kBox;
  int qt_begin = 0;
  if (a.causal) {
    // the first Q tile whose last row sees key k0: q0 + 63 + shift >= k0
    const int first = k0 - a.shift - (kBox - 1);
    qt_begin = first <= 0 ? 0 : (first + kBox - 1) / kBox;
  }
  const int n_iter = max(n_qt - qt_begin, 0);

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer
    if (lane == 0) {
      const float* lse_g = a.rows + static_cast<int64_t>(bh) * a.ld;
      const float* dl_g = a.rows + static_cast<int64_t>(gridDim.y + bh) * a.ld;
      mbar_expect_tx(kv_full, 2 * kTileBytes);
      for (int x = 0; x < kBoxes; ++x) {
        tma_load(k_s + x * kBoxBytes, &map_k, kv_full, x * kBox, h, k0, b);
        tma_load(v_s + x * kBoxBytes, &map_v, kv_full, x * kBox, h, k0, b);
      }
      for (int i = 0; i < n_iter; ++i) {
        const int s = i % kStages;
        const int q0 = (qt_begin + i) * kBox;
        if (i >= kStages) mbar_wait(empty + s, ((i / kStages) & 1) ^ 1);
        unsigned char* q_st = st_s + 2 * s * kTileBytes;
        float* r_st = rows_s + s * 2 * kBox;
        mbar_expect_tx(full + s, 2 * kTileBytes + kRowBytes);
        for (int x = 0; x < kBoxes; ++x) {
          tma_load(q_st + x * kBoxBytes, &map_q, full + s, x * kBox, h, q0, b);
          tma_load(q_st + kTileBytes + x * kBoxBytes, &map_do, full + s, x * kBox, h, q0, b);
        }
        bulk_load(r_st, lse_g + q0, kBox * sizeof(float), full + s);
        bulk_load(r_st + kBox, dl_g + q0, kBox * sizeof(float), full + s);
      }
    }
    return;
  }

  const int g = lane >> 2;
  const int t = lane & 3;
  const int krow0 = k0 + 16 * warp + g;  // this thread's keys: krow0 and krow0 + 8
  // S in log2 units: q scaled by the bf16-rounded scale, as q's own dtype
  // holds it (exact at D = 64, where the scale is a power of two)
  const float s2 = round_to<bf16>(a.scale) * kLog2e;
  float dk[kBoxes][32], dv[kBoxes][32];
#pragma unroll
  for (int x = 0; x < kBoxes; ++x)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[x][e] = dv[x][e] = 0.f;
  mbar_wait(kv_full, 0);
  int* added = nullptr;  // kDq, thread 0: the counter of the dQ tile in flight

  // kDq, thread 0: once the dQ tile in flight has landed, bump its counter
  auto release = [&]() {
    if (added != nullptr) {
      bulk_wait();
      fence_async_global();
      red_release_add(added, 1);
      added = nullptr;
    }
  };

  for (int i = 0; i < n_iter; ++i) {
    const int s = i % kStages;
    const int qt = qt_begin + i;
    const int q0 = qt * kBox;
    const unsigned char* q_st = st_s + 2 * s * kTileBytes;
    const unsigned char* do_st = q_st + kTileBytes;
    const float* lse_s = rows_s + s * 2 * kBox;
    const float* dl_s = lse_s + kBox;
    float st[32], dpt[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;
    mbar_wait(full + s, (i / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * kBoxes; ++kk) {
      const int off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
      wgmma_ss<0, 0>(st, desc(k_s + off), desc(q_st + off), kk);
    }
#pragma unroll
    for (int kk = 0; kk < 4 * kBoxes; ++kk) {
      const int off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
      wgmma_ss<0, 0>(dpt, desc(v_s + off), desc(do_st + off), kk);
    }
    wgmma_commit();
    if (kDq && tid == 0) release();  // the last tile's adds, while S and dP run
    wgmma_wait();
    fence_regs(st);
    fence_regs(dpt);

    const bool masked = q0 + kBox > a.Lq || k0 + kBox > a.Lk ||
                        (a.causal && k0 + kBox - 1 > q0 + a.shift);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int ql = 8 * (e >> 2) + 2 * t + (e & 1);
      float pv = ex2(fmaf(st[e], s2, -lse_s[ql] * kLog2e));
      if (masked) {
        const int qpos = q0 + ql;
        const int kpos = krow0 + 8 * ((e >> 1) & 1);
        if (!(kpos < a.Lk && qpos < a.Lq && (!a.causal || kpos <= qpos + a.shift))) pv = 0.f;
      }
      dpt[e] = pv * (dpt[e] - dl_s[ql]) * a.scale;
      st[e] = pv;
    }

    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a_from_acc(pa[kk], st, kk);
      a_from_acc(da[kk], dpt, kk);
    }
    float dq[kBoxes][32];
    if constexpr (kDq) {
      // dS^T [key][q] into the swizzled box (16-byte chunk j of row r at
      // j ^ (r % 8)), the A operand of dQ; the last tile's dQ product, its
      // reader, is done
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        unsigned char* row = ds_s + (16 * warp + g + 8 * r) * 128;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(row + ((j ^ g) << 4) + 4 * t) = da[j >> 1][2 * (j & 1) + r];
      }
      fence_async_smem();
      sync_consumers();  // the whole dS^T tile is in shared memory
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
#pragma unroll
        for (int e = 0; e < 32; ++e) dq[x][e] = 0.f;
    }
    // dV += P^T dO, dK += dS^T Q (16 Q rows a k step, dO and Q read
    // MN-major), and kDq: dQ_tile = dS K (16 keys a k step, dS and K read
    // MN-major), one batch
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
        wgmma_rs<1>(dv[x], pa[kk], desc(do_st + x * kBoxBytes + kk * kSliceBytes), 1);
        wgmma_rs<1>(dk[x], da[kk], desc(q_st + x * kBoxBytes + kk * kSliceBytes), 1);
        if constexpr (kDq)
          wgmma_ss<1, 1>(dq[x], desc(ds_s + kk * kSliceBytes),
                         desc(k_s + x * kBoxBytes + kk * kSliceBytes), kk);
      }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) {
      fence_regs(dk[x]);
      fence_regs(dv[x]);
      if constexpr (kDq) fence_regs(dq[x]);
    }
    mbar_arrive(empty + s);  // Q, dO, LSE and Delta of this stage are read

    if constexpr (kDq) {
      // the tile in thread order, conflict-free: float4 k = 8x + j of
      // thread tid at k * 128 + tid, holding dq[x][4j .. 4j + 3], which is
      // rows g, g, g + 8, g + 8 of the thread's warp, columns 64x + 8j + 2t,
      // + 1, + 0, + 1 (ops/flash_attention.py's dq_from_workspace reads the
      // order back). The last tile's adds have read the buffer (release,
      // then the barrier before dQ).
      float4* slot = reinterpret_cast<float4*>(dqs_s);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          slot[(8 * x + j) * kConsumers + tid] =
              make_float4(dq[x][4 * j], dq[x][4 * j + 1], dq[x][4 * j + 2], dq[x][4 * j + 3]);
      fence_async_smem();
      sync_consumers();
      if (tid == 0) {
        // this block's turn among the key tiles that Q tile qt sees, last
        // first; the first stores, the rest add at L2, one bulk copy each
        const int n_kt = (a.Lk + kBox - 1) / kBox;
        const int kt_end = a.causal ? min(n_kt, (q0 + kBox - 1 + a.shift) / kBox + 1) : n_kt;
        const int turn = kt_end - 1 - kt;
        added = a.turns + static_cast<int64_t>(bh) * n_qt + qt;
        while (ld_acquire(added) != turn) {
        }
        fence_async_global();
        float* dst = a.dq + (static_cast<int64_t>(bh) * n_qt + qt) * (kDqTileBytes / 4);
        if (turn == 0)
          bulk_store<false>(dst, dqs_s, kDqTileBytes);
        else
          bulk_store<true>(dst, dqs_s, kDqTileBytes);
        bulk_commit();
      }
    }
  }
  if (kDq && tid == 0) release();

  bf16* dk_out = static_cast<bf16*>(a.dk);
  bf16* dv_out = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int krow = krow0 + 8 * r;
    if (krow < a.Lk) {
      const int64_t off = ((static_cast<int64_t>(b) * a.Lk + krow) * a.H + h) * (kBoxes * kBox);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = x * kBox + 8 * j + 2 * t;
          *reinterpret_cast<uint32_t*>(dk_out + off + col) =
              pack2(dk[x][4 * j + 2 * r], dk[x][4 * j + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dv_out + off + col) =
              pack2(dv[x][4 * j + 2 * r], dv[x][4 * j + 2 * r + 1]);
        }
    }
  }
}

// Kernel 6's dQ (the TPU's _bwd_dq_kernel) for bf16: grid (ceil(Lq / 64),
// B * H), the longest causal rows first within each (batch, head); a block
// owns one 64-row Q tile. The producer lands q, dO and the tile's LSE and
// Delta once, then streams the K/V tiles the rows see (when causal, up to
// the tile's last visible key) through the ring. Per K/V tile: S = (q
// scale) K^T and dP = dO V^T by wgmma from shared memory, both operands
// K-major; P = where(mask, exp(S - LSE), 0) (masked only on diagonal and
// ragged tiles) while dP is still running, then dS = P (dP - Delta) scale
// in registers; dQ += dS K with dS rounded to bf16 as the register A
// operand and K read MN-major from the same stage. dQ stays in fp32
// registers and is written once, so two launches give the same bits.
template <int kBoxes, int kStages, int kMinBlocks>
__global__ void __launch_bounds__(kThreadsW, kMinBlocks)
    flash_bwd_dq_wgmma_kernel(__grid_constant__ const CUtensorMap map_q,
                              __grid_constant__ const CUtensorMap map_k,
                              __grid_constant__ const CUtensorMap map_v,
                              __grid_constant__ const CUtensorMap map_do, const BwdArgs a) {
  constexpr int kTileBytes = kBoxes * kBoxBytes;
  constexpr int kRowBytes = 2 * kBox * sizeof(float);  // LSE and Delta of the Q tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* q_s = smem;
  unsigned char* do_s = q_s + kTileBytes;
  unsigned char* kv_s = do_s + kTileBytes;  // stage s: K at 2 s tiles, V after it
  float* rows_s = reinterpret_cast<float*>(kv_s + 2 * kStages * kTileBytes);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(rows_s + 2 * kBox);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBox;
  const int n_kt = (a.Lk + kBox - 1) / kBox;
  int kt_end = n_kt;
  if (a.causal) {
    const int last = q0 + kBox - 1 + a.shift;  // the tile's last visible key
    kt_end = last < 0 ? 0 : min(n_kt, last / kBox + 1);
  }

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * kTileBytes + kRowBytes);
      for (int x = 0; x < kBoxes; ++x) {
        tma_load(q_s + x * kBoxBytes, &map_q, q_full, x * kBox, h, q0, b);
        tma_load(do_s + x * kBoxBytes, &map_do, q_full, x * kBox, h, q0, b);
      }
      bulk_load(rows_s, a.rows + static_cast<int64_t>(bh) * a.ld + q0, kBox * sizeof(float),
                q_full);
      bulk_load(rows_s + kBox, a.rows + static_cast<int64_t>(gridDim.y + bh) * a.ld + q0,
                kBox * sizeof(float), q_full);
      for (int i = 0; i < kt_end; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty + s, ((i / kStages) & 1) ^ 1);
        unsigned char* k_st = kv_s + 2 * s * kTileBytes;
        mbar_expect_tx(full + s, 2 * kTileBytes);
        for (int x = 0; x < kBoxes; ++x) {
          tma_load(k_st + x * kBoxBytes, &map_k, full + s, x * kBox, h, i * kBox, b);
          tma_load(k_st + kTileBytes + x * kBoxBytes, &map_v, full + s, x * kBox, h, i * kBox,
                   b);
        }
      }
    }
    return;
  }

  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0 and row0 + 8
  mbar_wait(q_full, 0);
  {  // q scaled in its own dtype, once, in place (a swizzle moves no value)
    const float sc = round_to<bf16>(a.scale);
    uint4* v = reinterpret_cast<uint4*>(q_s);
    for (int i = tid; i < kTileBytes / 16; i += kConsumers) {
      uint4 x = v[i];
      bf16* e = reinterpret_cast<bf16*>(&x);
#pragma unroll
      for (int k = 0; k < 8; ++k) e[k] = __float2bfloat16(__bfloat162float(e[k]) * sc);
      v[i] = x;
    }
    fence_async_smem();
    sync_consumers();
  }
  // LSE in log2 units and Delta of this thread's rows (zero past Lq, where
  // q and dO are zero too, so dS is 0 there)
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = rows_s[16 * warp + g + 8 * r] * kLog2e;
    dl[r] = rows_s[kBox + 16 * warp + g + 8 * r];
  }

  float dq[kBoxes][32];
#pragma unroll
  for (int x = 0; x < kBoxes; ++x)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[x][e] = 0.f;
  for (int i = 0; i < kt_end; ++i) {
    const int s = i % kStages;
    const unsigned char* k_st = kv_s + 2 * s * kTileBytes;
    const unsigned char* v_st = k_st + kTileBytes;
    float sacc[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sacc[e] = dp[e] = 0.f;
    mbar_wait(full + s, (i / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * kBoxes; ++kk) {
      const int off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
      wgmma_ss<0, 0>(sacc, desc(q_s + off), desc(k_st + off), kk);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4 * kBoxes; ++kk) {
      const int off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
      wgmma_ss<0, 0>(dp, desc(do_s + off), desc(v_st + off), kk);
    }
    wgmma_commit();
    wgmma_wait_1();  // S is done; dP runs on
    fence_regs(sacc);

    const int k0 = i * kBox;
    const bool masked = k0 + kBox > a.Lk || (a.causal && k0 + kBox - 1 > q0 + a.shift);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e >> 1) & 1;
      float pv = ex2(fmaf(sacc[e], kLog2e, -lse2[r]));
      if (masked) {
        const int kpos = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
        if (!(kpos < a.Lk && (!a.causal || kpos <= row0 + 8 * r + a.shift))) pv = 0.f;
      }
      sacc[e] = pv;
    }
    wgmma_wait();
    fence_regs(dp);
#pragma unroll
    for (int e = 0; e < 32; ++e) dp[e] = sacc[e] * (dp[e] - dl[(e >> 1) & 1]) * a.scale;
    uint32_t da[4][4];  // dS rounded to q's dtype, one A operand per 16 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_from_acc(da[kk], dp, kk);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
        wgmma_rs<1>(dq[x], da[kk], desc(k_st + x * kBoxBytes + kk * kSliceBytes), 1);
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) fence_regs(dq[x]);
    mbar_arrive(empty + s);  // K and V of this stage are read
  }

  bf16* out = static_cast<bf16*>(a.dq_out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qrow = row0 + 8 * r;
    if (qrow < a.Lq) {
      bf16* orow = out + ((static_cast<int64_t>(b) * a.Lq + qrow) * a.H + h) * (kBoxes * kBox);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + x * kBox + 8 * j + 2 * t) =
              pack2(dq[x][4 * j + 2 * r], dq[x][4 * j + 2 * r + 1]);
    }
  }
}

// ---- launches ----

// An operand's geometry, as ops/flash_attention.py's tensor_map_geometry
// gives it: dims (D, H, L, B), byte strides (H, L, B), box (64, 1, 64, 1).
struct Geometry {
  int64_t dims[4];
  int64_t strides[3];
  int64_t box[4];
};

int encode(CUtensorMap* map, const void* ptr, const Geometry& g) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (g.box[0] != kBox || g.box[1] != 1 || g.box[2] != kBox || g.box[3] != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dims[i] = static_cast<cuuint64_t>(g.dims[i]);
    box[i] = static_cast<cuuint32_t>(g.box[i]);
  }
  for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(g.strides[i]);
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The kernels' operands: q (and dO) [B, Lq, H, D], k, v [B, Lk, H, D].
struct Operands {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  Geometry gq, gk, gv, gdo;
  int B, H, Lq, Lk, D, elem;
};

bool same_bhd(const Geometry& a, const Geometry& b) {
  return a.dims[0] == b.dims[0] && a.dims[1] == b.dims[1] && a.dims[3] == b.dims[3];
}

void read(Geometry& g, const int64_t* p) {
  for (int i = 0; i < 4; ++i) g.dims[i] = p[i];
  for (int i = 0; i < 3; ++i) g.strides[i] = p[4 + i];
  for (int i = 0; i < 4; ++i) g.box[i] = p[7 + i];
}

int operands(Operands& o, const void* q, const int64_t* gq, const void* k, const int64_t* gk,
             const void* v, const int64_t* gv, const void* dout, const int64_t* gdo, int dtype) {
  o.q = q, o.k = k, o.v = v, o.dout = dout;
  read(o.gq, gq);
  read(o.gk, gk);
  read(o.gv, gv);
  read(o.gdo, dout != nullptr ? gdo : gq);
  o.D = static_cast<int>(o.gq.dims[0]);
  o.H = static_cast<int>(o.gq.dims[1]);
  o.Lq = static_cast<int>(o.gq.dims[2]);
  o.B = static_cast<int>(o.gq.dims[3]);
  o.Lk = static_cast<int>(o.gk.dims[2]);
  o.elem = dtype == 1 ? 2 : 4;
  const bool ok = (dtype == 0 || dtype == 1) && (o.D == 64 || o.D == 128) && o.B >= 1 &&
                  o.H >= 1 && o.Lq >= 1 && o.Lk >= 1 && o.B * o.H <= 65535 &&
                  same_bhd(o.gq, o.gk) && same_bhd(o.gq, o.gv) && same_bhd(o.gq, o.gdo) &&
                  o.gv.dims[2] == o.Lk && o.gdo.dims[2] == o.Lq;
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The CUDA-core kernels' parameters (fp32)
Params old_params(const Operands& o, int causal, int shift, float scale) {
  Params p{};
  p.q = o.q, p.k = o.k, p.v = o.v, p.dout = o.dout;
  p.q_sh = o.gq.strides[0] / o.elem, p.q_sl = o.gq.strides[1] / o.elem;
  p.q_sb = o.gq.strides[2] / o.elem;
  p.k_sh = o.gk.strides[0] / o.elem, p.k_sl = o.gk.strides[1] / o.elem;
  p.k_sb = o.gk.strides[2] / o.elem;
  p.v_sh = o.gv.strides[0] / o.elem, p.v_sl = o.gv.strides[1] / o.elem;
  p.v_sb = o.gv.strides[2] / o.elem;
  p.o_sh = o.gdo.strides[0] / o.elem, p.o_sl = o.gdo.strides[1] / o.elem;
  p.o_sb = o.gdo.strides[2] / o.elem;
  p.H = o.H, p.Lq = o.Lq, p.Lk = o.Lk, p.causal = causal, p.shift = shift;
  p.scale = scale;
  return p;
}

template <typename Kernel>
int launch_kernel(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                  const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fwd_fp32(const Params& p, int B, cudaStream_t st) {
  const size_t smem = 3 * kTile * (D + kPad) * sizeof(float);
  return launch_kernel(flash_fwd_kernel<float, D>, dim3((p.Lq + kTile - 1) / kTile, B * p.H),
                       kThreads, smem, st, p);
}

template <int D>
int launch_dkv_fp32(const Params& p, int B, cudaStream_t st) {
  const size_t smem = 5 * kTile * (D + kPad) * sizeof(float) + 2 * kTile * sizeof(float);
  return launch_kernel(flash_bwd_kernel<float, D>, dim3((p.Lk + kTile - 1) / kTile, B * p.H),
                       kThreads, smem, st, p);
}

template <int D>
int launch_dq_fp32(const Params& p, int B, cudaStream_t st) {
  const size_t smem = 4 * kTile * (D + kPad) * sizeof(float) + 2 * kTile * sizeof(float);
  return launch_kernel(flash_bwd_dq_kernel<float, D>, dim3((p.Lq + kTile - 1) / kTile, B * p.H),
                       kThreads, smem, st, p);
}

template <int kBoxes>
int launch_fwd_wgmma(const Operands& o, const FwdArgs& a, cudaStream_t st) {
  constexpr int kStages = kBoxes == 1 ? 3 : 2;
  constexpr int kMinBlocks = kBoxes == 1 ? 3 : 2;
  CUtensorMap mq, mk, mv;
  int err = encode(&mq, o.q, o.gq);
  if (err == 0) err = encode(&mk, o.k, o.gk);
  if (err == 0) err = encode(&mv, o.v, o.gv);
  if (err != 0) return err;
  auto kernel = flash_fwd_wgmma_kernel<kBoxes, kStages, kMinBlocks>;
  const size_t smem = 1024 + (1 + 2 * kStages) * kBoxes * kBoxBytes + (1 + 3 * kStages) * 8;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(o.B * o.H, (o.Lq + kBox - 1) / kBox);
  kernel<<<grid, kThreadsW, smem, st>>>(mq, mk, mv, a);
  return static_cast<int>(cudaGetLastError());
}

template <int kBoxes, bool kDq>
int launch_bwd_wgmma(const Operands& o, const BwdArgs& a, cudaStream_t st) {
  constexpr int kStages = 2;
  constexpr int kMinBlocks = kBoxes == 1 ? 2 : 1;
  CUtensorMap mq, mk, mv, mdo;
  int err = encode(&mq, o.q, o.gq);
  if (err == 0) err = encode(&mk, o.k, o.gk);
  if (err == 0) err = encode(&mv, o.v, o.gv);
  if (err == 0) err = encode(&mdo, o.dout, o.gdo);
  if (err != 0) return err;
  auto kernel = flash_bwd_wgmma_kernel<kBoxes, kStages, kDq, kMinBlocks>;
  const size_t smem = 1024 + (2 + 2 * kStages) * kBoxes * kBoxBytes +
                      (kDq ? kBoxBytes + kBox * kBoxes * kBox * sizeof(float) : 0) +
                      kStages * 2 * kBox * sizeof(float) + (1 + 2 * kStages) * 8;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((o.Lk + kBox - 1) / kBox, o.B * o.H);
  kernel<<<grid, kThreadsW, smem, st>>>(mq, mk, mv, mdo, a);
  return static_cast<int>(cudaGetLastError());
}

template <int kBoxes>
int launch_dq_wgmma(const Operands& o, const BwdArgs& a, cudaStream_t st) {
  constexpr int kStages = kBoxes == 1 ? 3 : 2;
  constexpr int kMinBlocks = 2;
  CUtensorMap mq, mk, mv, mdo;
  int err = encode(&mq, o.q, o.gq);
  if (err == 0) err = encode(&mk, o.k, o.gk);
  if (err == 0) err = encode(&mv, o.v, o.gv);
  if (err == 0) err = encode(&mdo, o.dout, o.gdo);
  if (err != 0) return err;
  auto kernel = flash_bwd_dq_wgmma_kernel<kBoxes, kStages, kMinBlocks>;
  const size_t smem = 1024 + (2 + 2 * kStages) * kBoxes * kBoxBytes + 2 * kBox * sizeof(float) +
                      (1 + 2 * kStages) * 8;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((o.Lq + kBox - 1) / kBox, o.B * o.H);
  kernel<<<grid, kThreadsW, smem, st>>>(mq, mk, mv, mdo, a);
  return static_cast<int>(cudaGetLastError());
}

BwdArgs bwd_args(const Operands& o, const void* rows, int rows_ld, void* dq, void* turns,
                 void* dk, void* dv, int causal, int shift, float scale) {
  BwdArgs a{};
  a.rows = static_cast<const float*>(rows);
  a.ld = rows_ld;
  a.dq = static_cast<float*>(dq);
  a.turns = static_cast<int*>(turns);
  a.dk = dk, a.dv = dv;
  a.H = o.H, a.Lq = o.Lq, a.Lk = o.Lk, a.causal = causal, a.shift = shift;
  a.scale = scale;
  return a;
}

// The fp32 backward through the CUDA-core kernels: dK/dV, then (dq not
// null) dQ written once in fp32.
int backward_fp32(const Operands& o, const void* rows, int rows_ld, void* dq, void* dk,
                  void* dv, int causal, int shift, float scale, cudaStream_t st) {
  Params p = old_params(o, causal, shift, scale);
  p.lse = static_cast<float*>(const_cast<void*>(rows));
  p.delta = p.lse + static_cast<int64_t>(o.B) * o.H * rows_ld;
  p.rows_ld = rows_ld;
  p.dk = dk, p.dv = dv, p.dq_out = dq;
  int err = o.D == 64 ? launch_dkv_fp32<64>(p, o.B, st) : launch_dkv_fp32<128>(p, o.B, st);
  if (err != 0 || dq == nullptr) return err;
  return o.D == 64 ? launch_dq_fp32<64>(p, o.B, st) : launch_dq_fp32<128>(p, o.B, st);
}

}  // namespace

// Each operand is a pointer and its geometry: 11 int64 values, dims (D, H,
// L, B) in elements, byte strides of H, L and B (unit stride in D, every
// stride a multiple of 16 bytes), the box (64, 1, 64, 1) of the bf16
// kernels' tensor maps (ops/flash_attention.py: tensor_map_geometry).
// dtype: 0 = float32 (the CUDA-core kernels), 1 = bfloat16 (the wgmma
// kernels). Each returns the launches' cudaError_t (0 = launched).

// out: contiguous [B, Lq, H, D] in the input dtype; lse: fp32 [B, H, Lq].
extern "C" int pdt_flash_fwd(const void* q, const int64_t* gq, const void* k, const int64_t* gk,
                             const void* v, const int64_t* gv, void* out, void* lse, int dtype,
                             int causal, int shift, float scale, void* stream) {
  Operands o;
  const int err = operands(o, q, gq, k, gk, v, gv, nullptr, nullptr, dtype);
  if (err != 0) return err;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Params p = old_params(o, causal, shift, scale);
    p.out = out;
    p.lse = static_cast<float*>(lse);
    return o.D == 64 ? launch_fwd_fp32<64>(p, o.B, st) : launch_fwd_fp32<128>(p, o.B, st);
  }
  FwdArgs a{};
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.H = o.H, a.Lq = o.Lq, a.Lk = o.Lk, a.causal = causal, a.shift = shift;
  a.scale = scale;
  return o.D == 64 ? launch_fwd_wgmma<1>(o, a, st) : launch_fwd_wgmma<2>(o, a, st);
}

// The fused backward. rows: fp32 [2, B * H, rows_ld], LSE then Delta, zero
// past Lq, rows_ld a multiple of 64; dk, dv: contiguous [B, Lk, H, D]. dq:
// bf16, fp32 64 x D tiles [B * H, ceil(Lq / 64)] in the kernel's thread
// order, added in a fixed order, with turns, int32 [B * H, ceil(Lq / 64)],
// zero (the wrapper's dq_workspace); fp32, [B, Lq, H, D] fp32, written
// once, and no turns.
extern "C" int pdt_flash_bwd(const void* q, const int64_t* gq, const void* k, const int64_t* gk,
                             const void* v, const int64_t* gv, const void* dout,
                             const int64_t* gdo, const void* rows, int rows_ld, void* dq,
                             void* turns, void* dk, void* dv, int dtype, int causal, int shift,
                             float scale, void* stream) {
  Operands o;
  const int err = operands(o, q, gq, k, gk, v, gv, dout, gdo, dtype);
  if (err != 0) return err;
  if (rows_ld % kBox || rows_ld < o.Lq) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return backward_fp32(o, rows, rows_ld, dq, dk, dv, causal, shift, scale, st);
  const BwdArgs a = bwd_args(o, rows, rows_ld, dq, turns, dk, dv, causal, shift, scale);
  return o.D == 64 ? launch_bwd_wgmma<1, true>(o, a, st) : launch_bwd_wgmma<2, true>(o, a, st);
}

// The split backward: the dK/dV kernel (the fused backward's code without
// its dQ pass), then the dQ kernel, on one stream. dq: contiguous [B, Lq,
// H, D] in the input dtype, written once; the rest as pdt_flash_bwd.
extern "C" int pdt_flash_bwd_split(const void* q, const int64_t* gq, const void* k,
                                   const int64_t* gk, const void* v, const int64_t* gv,
                                   const void* dout, const int64_t* gdo, const void* rows,
                                   int rows_ld, void* dq, void* dk, void* dv, int dtype,
                                   int causal, int shift, float scale, void* stream) {
  Operands o;
  int err = operands(o, q, gq, k, gk, v, gv, dout, gdo, dtype);
  if (err != 0) return err;
  if (rows_ld % kBox || rows_ld < o.Lq) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return backward_fp32(o, rows, rows_ld, dq, dk, dv, causal, shift, scale, st);
  BwdArgs a = bwd_args(o, rows, rows_ld, nullptr, nullptr, dk, dv, causal, shift, scale);
  err = o.D == 64 ? launch_bwd_wgmma<1, false>(o, a, st) : launch_bwd_wgmma<2, false>(o, a, st);
  if (err != 0) return err;
  a.dq_out = dq;
  return o.D == 64 ? launch_dq_wgmma<1>(o, a, st) : launch_dq_wgmma<2>(o, a, st);
}

extern "C" const char* pdt_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
