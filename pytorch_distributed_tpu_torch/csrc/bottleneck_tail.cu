// The fused bottleneck tail's three one-pass reductions, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of pytorch_distributed_tpu/ops/bottleneck_tail.py:
//   - moments (pallas_call at :69; kernel _moments_kernel :49): one read of
//     z [N, F] gives s = sum_n z[n] [F] and M2 = z^T z [F, F], both fp32;
//   - tail_bwd_reduce (pallas_call at :114; kernel _bwd_reduce_kernel :86):
//     one read of z [N, F], g and out [N, E] gives gp = g * [out > 0] in g's
//     dtype (written once), P = z^T gp [F, E] fp32 and sum_n gp [E] fp32;
//   - tail_bwd_dz (pallas_call at :160; kernel _bwd_dz_kernel :137):
//     dz = gp @ wa + z @ c + dmn [N, F] in z's dtype, one output write, with
//     wa [E, F] and c [F, F] stacked as w = [wa ; c] [E + F, F] in z's dtype
//     (the caller rounds them from fp32) and dmn [F] fp32.
// N = B*H*W rows of the NHWC activations, read through a row stride with
// unit stride along the channels.
//
// What bounds them on the H100: bytes. At ResNet-50's stage 1 (B 128, z
// [401408, 64], E 256) moments reads 51 MB for 3.3 GFLOP, tail_bwd_reduce
// moves 668 MB for 13 GFLOP and tail_bwd_dz 308 MB for 16 GFLOP: well under
// the card's ~295 flops per byte. At stage 4 (z [6272, 512], E 2048) the
// products are 3-16 GFLOP over 6-83 MB, near the line.
//
// What the design does about it:
//   - The Pallas kernels walk the batch in order and carry the sums in VMEM
//     from one grid step to the next. Here blocks run in parallel: a block
//     owns one 64x64 tile of the F x F (or F x E) output and one chunk of
//     rows, loops over the chunk 32 rows at a time, and writes its fp32
//     tile, and its column sums, to a partial buffer [chunks, F + 1, n_b]
//     (row F holds the column sums). A second small kernel, tail_sum_kernel,
//     adds the chunks in ascending order, so two launches give the same
//     bits: no atomics. There are enough chunks for about four blocks per SM
//     whatever the tile count; the caller sizes the chunks (chunk_rows in
//     ops/bottleneck_tail.py) and allocates the partial buffer.
//   - moments computes the upper triangle of tiles only; the sum kernel
//     writes each summed off-diagonal element at both places, so the two
//     halves are equal bit for bit; a diagonal block reads its rows once
//     for both operands.
//   - tail_bwd_reduce forms gp on the load (out compared in fp32, as the
//     Pallas body does), and only the blocks of the first F tile write it
//     and sum it, so gp is written once.
//   - tail_bwd_dz is one product of K = E + F: [gp | z] @ [wa ; c], plus
//     dmn in the fp32 epilogue before the one rounding to z's dtype. wa and c
//     come rounded to the operands' dtype for the tensor cores (bf16 for bf16
//     activations), where the Pallas kernel multiplies bf16 by fp32. On bf16
//     it is tail_dz_wgmma_kernel, further down: TMA and wgmma, a persistent
//     stream of (row tile, k step) stages.
//   - The reductions' bf16 products run on the tensor cores through mma.sync
//     m16n8k16 with fp32 accumulators; fp32 inputs take the same code with
//     the product on CUDA cores, for exact fp32 numerics, and fp32 dz the
//     CUDA-core tail_dz_kernel.
// The reductions' loads are synchronous 16-byte copies into padded
// shared-memory tiles, from which ldmatrix gathers the bf16 fragments;
// cp.async or TMA pipelines and wgmma for them are later work.

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // four warps, each a 32x32 quadrant of the tile
constexpr int kTile = 64;      // output tile edge
constexpr int kStep = 32;      // contraction rows per shared-memory step
constexpr int kPad = 8;        // row padding of the shared-memory tiles

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

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 b16 matrices from shared memory, lanes 8j..8j+7 giving the row
// addresses of matrix j; each lane receives (row l/4, columns 2(l%4), +1) of
// every matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// acc += A B over k in [0, kStep) for the warp's 32x32 quadrant at rows m0
// and columns n0 of the tile, from shared-memory tiles: B stored [k][n]
// (row stride ldb); A stored [k][m] when kAKMajor (the reductions' z^T),
// else [m][k] (row stride lda). acc[mi][ni] is the m16n8 C fragment of
// rows m0 + 16 mi and columns n0 + 8 ni: lane 4g + t holds C[g][2t, 2t+1]
// in elements 0, 1 and C[g+8][2t, 2t+1] in 2, 3 (mma.sync's layout).
// bf16 (the reductions, A k-major only): the fragments come from
// ldmatrix, transposed, the products from mma.sync m16n8k16.
template <bool kAKMajor>
__device__ __forceinline__ void warp_product(float (&acc)[2][4][4], const bf16* a, int lda,
                                             const bf16* b, int ldb, int m0, int n0) {
  static_assert(kAKMajor, "bf16 dz runs tail_dz_wgmma_kernel");
  const int lane = threadIdx.x & 31;
  const int j = lane >> 3;  // the matrix this lane addresses
  const int r = lane & 7;   // and its row
#pragma unroll
  for (int k0 = 0; k0 < kStep; k0 += 16) {
    uint32_t af[2][4], bfr[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int m = m0 + 16 * mi;
      // matrices: (m, k), (m + 8, k), (m, k + 8), (m + 8, k + 8)
      ldmatrix_x4_trans(af[mi], a + (k0 + r + ((j >> 1) << 3)) * lda + m + ((j & 1) << 3));
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      // matrices: (k, n), (k + 8, n), (k, n + 8), (k + 8, n + 8)
      uint32_t q[4];
      ldmatrix_x4_trans(q, b + (k0 + r + ((j & 1) << 3)) * ldb + n0 + 16 * np + ((j >> 1) << 3));
      bfr[2 * np][0] = q[0];
      bfr[2 * np][1] = q[1];
      bfr[2 * np + 1][0] = q[2];
      bfr[2 * np + 1][1] = q[3];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], af[mi], bfr[ni]);
  }
}

// The same product in fp32 on CUDA cores, into the same fragment layout.
// The k loop stays rolled to keep nvcc quick; the fp32 kernels serve
// checks and fp32 models, not the bf16 training path.
template <bool kAKMajor>
__device__ __forceinline__ void warp_product(float (&acc)[2][4][4], const float* a, int lda,
                                             const float* b, int ldb, int m0, int n0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll 1
  for (int k = 0; k < kStep; ++k) {
    float ar[2][2], br[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 16 * mi + g + 8 * h;
        ar[mi][h] = kAKMajor ? a[k * lda + m] : a[m * lda + k];
      }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      br[ni][0] = b[k * ldb + n0 + 8 * ni + 2 * t];
      br[ni][1] = b[k * ldb + n0 + 8 * ni + 2 * t + 1];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        acc[mi][ni][0] = fmaf(ar[mi][0], br[ni][0], acc[mi][ni][0]);
        acc[mi][ni][1] = fmaf(ar[mi][0], br[ni][1], acc[mi][ni][1]);
        acc[mi][ni][2] = fmaf(ar[mi][1], br[ni][0], acc[mi][ni][2]);
        acc[mi][ni][3] = fmaf(ar[mi][1], br[ni][1], acc[mi][ni][3]);
      }
  }
}

// Rows [r0, r0 + kStep) and columns [c0, c0 + kTile) of a [n_rows, n_cols]
// operand (row stride ld) into dst[kStep][kTile + kPad], 16 bytes a
// thread at a time; rows and columns outside are zero. n_cols is a
// multiple of the vector width. kGate: the tile is gp = src * [gate > 0]
// (gate compared in fp32), also stored to gp_out (row stride n_cols) when
// it is not null.
template <typename T, bool kGate>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int64_t ld, const T* gate,
                                          int64_t ld_gate, T* gp_out, int r0, int c0,
                                          int n_rows, int n_cols) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kTile / kVec;
  constexpr int LD = kTile + kPad;
  for (int v = threadIdx.x; v < kStep * kPerRow; v += kThreads) {
    const int r = v / kPerRow;
    const int c = (v % kPerRow) * kVec;
    const int row = r0 + r;
    const int col = c0 + c;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < n_rows && col < n_cols) {
      val = *reinterpret_cast<const uint4*>(src + row * ld + col);
      if (kGate) {
        const uint4 gv = *reinterpret_cast<const uint4*>(gate + row * ld_gate + col);
        T* x = reinterpret_cast<T*>(&val);
        const T* o = reinterpret_cast<const T*>(&gv);
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          if (!(to_float(o[i]) > 0.f)) x[i] = from_float<T>(0.f);
        if (gp_out != nullptr)
          *reinterpret_cast<uint4*>(gp_out + static_cast<int64_t>(row) * n_cols + col) = val;
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// Shared by moments (kGate false: B is z itself) and tail_bwd_reduce
// (kGate true: B is gp = g * [out > 0]). Block (tile, chunk) computes
// A^T B over its rows for one 64x64 output tile, with A = z[:, i tile]
// and B = z[:, j tile] or gp[:, j tile], and writes the tile, and the
// column sums of B where the block owns them, into its chunk's slice of
// partial [chunks, F + 1, n_b]: rows 0..F-1 the tile, row F the sums.
template <typename T, bool kGate>
__global__ void __launch_bounds__(kThreads)
    tail_reduce_kernel(const T* __restrict__ z, int64_t ldz, const T* __restrict__ g, int64_t ldg,
                  const T* __restrict__ gate, int64_t ld_gate, T* __restrict__ gp,
                  float* __restrict__ partial, int N, int F, int n_b, int chunk) {
  constexpr int LD = kTile + kPad;
  __shared__ __align__(16) T a_s[kStep * LD];
  __shared__ __align__(16) T b_s[kStep * LD];

  // moments: the upper triangle of (i, j) tile pairs; tail_bwd_reduce: all
  int ti, tj;
  if (kGate) {
    const int n_i = (F + kTile - 1) / kTile;
    ti = blockIdx.x % n_i;
    tj = blockIdx.x / n_i;
  } else {
    const int n_t = (F + kTile - 1) / kTile;
    int p = blockIdx.x;
    ti = 0;
    while (p >= n_t - ti) {
      p -= n_t - ti;
      ++ti;
    }
    tj = ti + p;
  }
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const bool diag = !kGate && ti == tj;
  // the block that owns column sums of B: the diagonal one (moments), the
  // first F tile (tail_bwd_reduce), which also writes gp
  const bool owner = kGate ? ti == 0 : diag;
  const int r_begin = blockIdx.y * chunk;
  const int r_end = min(r_begin + chunk, N);
  float* mine = partial + static_cast<int64_t>(blockIdx.y) * (F + 1) * n_b;

  const int warp = threadIdx.x >> 5;
  const int m0 = (warp & 1) * 32;
  const int n0 = (warp >> 1) * 32;
  float acc[2][4][4] = {};
  float csum = 0.f;
  const int c_col = threadIdx.x & (kTile - 1);
  const int c_half = threadIdx.x >> 6;  // rows [16 half, 16 half + 16) of a step

  const T* b_src = kGate ? g : z;
  const int64_t ld_b = kGate ? ldg : ldz;
  const T* b_tile = diag ? a_s : b_s;
  for (int r0 = r_begin; r0 < r_end; r0 += kStep) {
    __syncthreads();  // the previous step's reads are done
    load_rows<T, false>(a_s, z, ldz, nullptr, 0, nullptr, r0, i0, r_end, F);
    if (!diag)
      load_rows<T, kGate>(b_s, b_src, ld_b, gate, ld_gate, owner ? gp : nullptr, r0, j0,
                          r_end, n_b);
    __syncthreads();
    // A(m, k) = z[r0 + k][i0 + m]: the tile read down its columns
    warp_product<true>(acc, a_s, LD, b_tile, LD, m0, n0);
    if (owner) {
#pragma unroll 4
      for (int r = 16 * c_half; r < 16 * c_half + 16; ++r) csum += to_float(b_tile[r * LD + c_col]);
    }
  }

  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = i0 + m0 + 16 * mi + gq + (e >= 2 ? 8 : 0);
        const int col = j0 + n0 + 8 * ni + 2 * t + (e & 1);
        if (row < F && col < n_b) mine[static_cast<int64_t>(row) * n_b + col] = acc[mi][ni][e];
      }
  // the column sums: two threads per column (halves of each step), added
  // in a fixed order through shared memory
  __syncthreads();
  float* half_sums = reinterpret_cast<float*>(a_s);
  if (owner && c_half == 1) half_sums[c_col] = csum;
  __syncthreads();
  if (owner && c_half == 0 && j0 + c_col < n_b)
    mine[static_cast<int64_t>(F) * n_b + j0 + c_col] = csum + half_sums[c_col];
}

// out [F, n_b] and colsum [n_b] from partial [chunks, F + 1, n_b]: each
// element the sum of its chunks in ascending order. kMirror (moments): only
// the upper triangle of 64x64 tiles was computed; each element there is
// written at (row, col) and, off the diagonal tiles, at (col, row).
template <bool kMirror>
__global__ void __launch_bounds__(256)
    tail_sum_kernel(const float* __restrict__ partial, int chunks, int F, int n_b,
                    float* __restrict__ out, float* __restrict__ colsum) {
  const int64_t per_chunk = static_cast<int64_t>(F + 1) * n_b;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= per_chunk) return;
  const int row = static_cast<int>(idx / n_b);
  const int col = static_cast<int>(idx - static_cast<int64_t>(row) * n_b);
  if (kMirror && row < F && row / kTile > col / kTile) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[c * per_chunk + idx];
  if (row == F) {
    colsum[col] = s;
    return;
  }
  out[idx] = s;
  if (kMirror && row / kTile != col / kTile) out[static_cast<int64_t>(col) * n_b + row] = s;
}

// dz [N, F] = [gp | z] @ w + dmn on fp32 rows (CUDA cores): block (row
// tile, column tile) loops over K = E + F in steps of 32. w [K, F]
// contiguous.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    tail_dz_kernel(const T* __restrict__ gp, int64_t ldgp, const T* __restrict__ z, int64_t ldz,
              const T* __restrict__ w, const float* __restrict__ dmn, T* __restrict__ dz,
              int N, int F, int E) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int LDA = kStep + kPad;
  constexpr int LDB = kTile + kPad;
  __shared__ __align__(16) T a_s[kTile * LDA];
  __shared__ __align__(16) T b_s[kStep * LDB];
  const int n_base = blockIdx.x * kTile;
  const int f_base = blockIdx.y * kTile;
  const int K = E + F;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp & 1) * 32;
  const int n0 = (warp >> 1) * 32;
  float acc[2][4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kStep) {
    __syncthreads();
    // A rows: gp for k < E, z for E <= k < K (E and F are multiples of kVec,
    // so a vector never straddles the switch)
    for (int v = threadIdx.x; v < kTile * (kStep / kVec); v += kThreads) {
      const int r = v / (kStep / kVec);
      const int kk = (v % (kStep / kVec)) * kVec;
      const int row = n_base + r;
      const int k = k0 + kk;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row < N && k < K)
        val = k < E ? *reinterpret_cast<const uint4*>(gp + row * ldgp + k)
                    : *reinterpret_cast<const uint4*>(z + row * ldz + (k - E));
      *reinterpret_cast<uint4*>(a_s + r * LDA + kk) = val;
    }
    // B rows: w[k0 .. k0 + 32)
    for (int v = threadIdx.x; v < kStep * (kTile / kVec); v += kThreads) {
      const int r = v / (kTile / kVec);
      const int cc = (v % (kTile / kVec)) * kVec;
      const int k = k0 + r;
      const int col = f_base + cc;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k < K && col < F)
        val = *reinterpret_cast<const uint4*>(w + static_cast<int64_t>(k) * F + col);
      *reinterpret_cast<uint4*>(b_s + r * LDB + cc) = val;
    }
    __syncthreads();
    warp_product<false>(acc, a_s, LDA, b_s, LDB, m0, n0);
  }

  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = n_base + m0 + 16 * mi + gq + (e >= 2 ? 8 : 0);
        const int col = f_base + n0 + 8 * ni + 2 * t + (e & 1);
        if (row < N && col < F)
          dz[static_cast<int64_t>(row) * F + col] = from_float<T>(acc[mi][ni][e] + dmn[col]);
      }
}

// ---------------------------------------------------------------------------
// tail_bwd_dz on bf16 rows, on Hopper's own units: TMA, mbarriers, wgmma.
//
// The product is a GEMM of M = N rows, N = F columns and K = E + F, read
// through four 2-D tensor maps (ops/bottleneck_tail.py's
// dz_tensor_map_geometry): A from gp [N, E] for k < E and from z [N, F]
// after, each by its own row stride (a channels-last activation's rows need
// no copy); B from wa [E, F] and then c [F, F], MN-major (F contiguous).
// Every box is 64 x 64 bf16 with the 128-byte swizzle that the wgmma
// descriptors name; a box past an operand's edge lands as zeros, so the K
// loop takes ceil(E / 64) steps on (gp, wa) and then ceil(F / 64) on (z, c)
// and E, F need only be multiples of 8.
//   - Persistent blocks, one an SM: block b walks the output tiles b, b +
//     grid, ... of 128 rows x 64 kNB columns, column tile fastest, so blocks
//     at work together read the same A rows (L2 hits at F > 64).
//   - One producer warp streams the block's (tile, k step) stages through a
//     ring of kStages: A as two 64-row boxes, B as kNB boxes. It runs ahead
//     across tiles, so the next tile's loads overlap a tile's last products
//     and epilogue: at ResNet-50's stage 1 (K = 320, five k steps a tile)
//     the kernel is one stream of A at the rate of the ring, not a GEMM.
//   - Two consumer warpgroups, 64 rows of the tile each: per stage four k16
//     steps of kNB m64n64k16 wgmma (A K-major, B MN-major), committed as one
//     group; the previous stage is released once its group completes, so
//     one stage's products overlap the next one's wait.
//   - Epilogue: fp32 accumulators + dmn, one rounding to bf16, stored for
//     rows < N and columns < F. One block computes each dz element in a
//     fixed k order, so two launches give the same bits.

constexpr int kDzBox = 64;                          // rows and columns of a box
constexpr int kDzBoxBytes = kDzBox * kDzBox * 2;    // 8 KB
constexpr int kDzSlice = 16 * 128;                  // 16 rows of a box: one k16 step
constexpr int kDzTileRows = 128;                    // two consumer warpgroups
constexpr int kDzThreads = 2 * 128 + 32;            // and one producer warp

struct DzArgs {
  const float* dmn;  // [F]
  bf16* dz;          // [N, F] contiguous
  int N, F, E;
};

// grid: min(tiles, SMs); kNB: 64-column boxes of B per tile
template <int kNB, int kStages>
__global__ void __launch_bounds__(kDzThreads, 1)
    tail_dz_wgmma_kernel(__grid_constant__ const CUtensorMap map_gp,
                         __grid_constant__ const CUtensorMap map_z,
                         __grid_constant__ const CUtensorMap map_wa,
                         __grid_constant__ const CUtensorMap map_c, const DzArgs a) {
  constexpr int kStageBytes = (2 + kNB) * kDzBoxBytes;  // A boxes, then B boxes
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ke = (a.E + kDzBox - 1) / kDzBox;  // k steps on (gp, wa)
  const int n_k = ke + (a.F + kDzBox - 1) / kDzBox;
  const int n_nt = (a.F + kNB * kDzBox - 1) / (kNB * kDzBox);
  const int n_tiles = ((a.N + kDzTileRows - 1) / kDzTileRows) * n_nt;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // the producer
    if (lane == 0) {
      int i = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile / n_nt) * kDzTileRows;
        const int n0 = (tile % n_nt) * kNB * kDzBox;
        for (int ks = 0; ks < n_k; ++ks, ++i) {
          const int s = i % kStages;
          if (i >= kStages) mbar_wait(empty + s, ((i / kStages) & 1) ^ 1);
          unsigned char* st = ring + s * kStageBytes;
          const bool lo = ks < ke;  // gp and wa, else z and c
          const int k0 = (lo ? ks : ks - ke) * kDzBox;
          const CUtensorMap* ma = lo ? &map_gp : &map_z;
          const CUtensorMap* mb = lo ? &map_wa : &map_c;
          mbar_expect_tx(full + s, kStageBytes);
          tma_load(st, ma, full + s, k0, m0);
          tma_load(st + kDzBoxBytes, ma, full + s, k0, m0 + kDzBox);
#pragma unroll
          for (int nb = 0; nb < kNB; ++nb)
            tma_load(st + (2 + nb) * kDzBoxBytes, mb, full + s, n0 + nb * kDzBox, k0);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;  // this warpgroup's 64 rows of the tile
  const int g = lane >> 2;
  const int t = lane & 3;
  int i = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile / n_nt) * kDzTileRows;
    const int n0 = (tile % n_nt) * kNB * kDzBox;
    float acc[kNB][32];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[nb][e] = 0.f;
    for (int ks = 0; ks < n_k; ++ks, ++i) {
      const int s = i % kStages;
      const unsigned char* st = ring + s * kStageBytes;
      mbar_wait(full + s, (i / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb)
          wgmma_ss<0, 1>(acc[nb], desc(st + wg * kDzBoxBytes + kk * 32),
                         desc(st + (2 + nb) * kDzBoxBytes + kk * kDzSlice), ks > 0 || kk > 0);
      wgmma_commit();
      if (ks > 0) {  // the previous stage's products are done: release it
        wgmma_wait_1();
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + (i - 1) % kStages);
      }
    }
    wgmma_wait();
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) fence_regs(acc[nb]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + (i - 1) % kStages);

    // thread 32w + 4g + t of the warpgroup holds rows 16w + g (+8), columns
    // 8j + 2t (+1) of each 64-column box
    const int row = m0 + wg * kDzBox + 16 * (warp & 3) + g;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + nb * kDzBox + 8 * j + 2 * t;
        if (col >= a.F) continue;
        const float d0 = __ldg(a.dmn + col);
        const float d1 = __ldg(a.dmn + col + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row + 8 * h;
          if (r < a.N)
            *reinterpret_cast<uint32_t*>(a.dz + static_cast<int64_t>(r) * a.F + col) =
                pack2(acc[nb][4 * j + 2 * h] + d0, acc[nb][4 * j + 2 * h + 1] + d1);
        }
      }
  }
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

// A 2-D bf16 tensor map from ops/bottleneck_tail.py's dz_tensor_map_geometry:
// dims (columns, rows), the row stride in bytes, box (64, 64)
int encode_rows(CUtensorMap* map, const void* ptr, const int64_t* geo) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (geo[3] != kDzBox || geo[4] != kDzBox) return kInvalid;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(geo[0]), static_cast<cuuint64_t>(geo[1])};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(geo[2])};
  const cuuint32_t box[2] = {kDzBox, kDzBox};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kInvalid;
}

template <int kNB, int kStages>
int launch_dz_wgmma(const CUtensorMap (&maps)[4], const DzArgs& a, cudaStream_t st) {
  auto kernel = tail_dz_wgmma_kernel<kNB, kStages>;
  const int smem = 1024 + kStages * (2 + kNB) * kDzBoxBytes + 2 * kStages * 8;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_nt = (a.F + kNB * kDzBox - 1) / (kNB * kDzBox);
  const int64_t tiles = static_cast<int64_t>((a.N + kDzTileRows - 1) / kDzTileRows) * n_nt;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, kDzThreads, smem, st>>>(maps[0], maps[1], maps[2], maps[3], a);
  return static_cast<int>(cudaGetLastError());
}

// The reduction and the sum of its chunks, one launch each on one stream.
// chunk: rows per block (a multiple of kStep, from ops/bottleneck_tail.py's
// chunk_rows); partial: fp32 [ceil(N / chunk), F + 1, n_b] scratch.
template <typename T>
int launch_reduce(const void* z, int64_t ldz, const void* g, int64_t ldg, const void* out,
                  int64_t ldo, void* gp, int chunk, float* partial, float* acc_out,
                  float* colsum, int N, int F, int n_b, bool gated, cudaStream_t st) {
  const int n_i = (F + kTile - 1) / kTile;
  const int n_j = (n_b + kTile - 1) / kTile;
  const int n_tiles = gated ? n_i * n_j : n_i * (n_i + 1) / 2;
  if (chunk < kStep || chunk % kStep) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (N + chunk - 1) / chunk;
  const dim3 grid(n_tiles, chunks);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const T* zt = static_cast<const T*>(z);
  if (gated)
    tail_reduce_kernel<T, true><<<grid, kThreads, 0, st>>>(
        zt, ldz, static_cast<const T*>(g), ldg, static_cast<const T*>(out), ldo,
        static_cast<T*>(gp), partial, N, F, n_b, chunk);
  else
    tail_reduce_kernel<T, false><<<grid, kThreads, 0, st>>>(zt, ldz, nullptr, 0, nullptr, 0,
                                                           nullptr, partial, N, F, n_b, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_out = static_cast<int64_t>(F + 1) * n_b;
  const unsigned sum_blocks = static_cast<unsigned>((n_out + 255) / 256);
  if (gated)
    tail_sum_kernel<false><<<sum_blocks, 256, 0, st>>>(partial, chunks, F, n_b, acc_out, colsum);
  else
    tail_sum_kernel<true><<<sum_blocks, 256, 0, st>>>(partial, chunks, F, n_b, acc_out, colsum);
  return static_cast<int>(cudaGetLastError());
}

int launch_dz(const void* gp, int64_t ldgp, const void* z, int64_t ldz, const void* w,
              const float* dmn, void* dz, int N, int F, int E, cudaStream_t st) {
  const dim3 grid((N + kTile - 1) / kTile, (F + kTile - 1) / kTile);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  tail_dz_kernel<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(gp), ldgp,
                                                   static_cast<const float*>(z), ldz,
                                                   static_cast<const float*>(w), dmn,
                                                   static_cast<float*>(dz), N, F, E);
  return static_cast<int>(cudaGetLastError());
}

// F and E multiples of 8 (one 16-byte vector of bf16), N >= 1.
bool bad_dims(int dtype, int N, int F, int E) {
  return (dtype != 0 && dtype != 1) || N < 1 || F < 8 || E < 8 || F % 8 || E % 8;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (z, g, out, gp, dz). Row strides in
// elements, unit stride along the channels, rows 16-byte aligned. The fp32
// outputs (s, m2, p, sb) are written once each, by the sum kernel. Each
// returns the launches' cudaError_t (0 = launched).

// s [F] and m2 [F, F] of z [N, F]; partial: fp32 [ceil(N / chunk), F + 1, F].
extern "C" int pdt_moments(const void* z, int64_t ldz, int dtype, int N, int F, int chunk,
                           void* partial, void* s, void* m2, void* stream) {
  if (bad_dims(dtype, N, F, 8)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partial);
  auto* m = static_cast<float*>(m2);
  auto* sum = static_cast<float*>(s);
  return dtype == 1 ? launch_reduce<bf16>(z, ldz, nullptr, 0, nullptr, 0, nullptr, chunk, part,
                                          m, sum, N, F, F, false, st)
                    : launch_reduce<float>(z, ldz, nullptr, 0, nullptr, 0, nullptr, chunk, part,
                                           m, sum, N, F, F, false, st);
}

// gp [N, E] contiguous, p [F, E] and sb [E] of z [N, F], g and out [N, E];
// partial: fp32 [ceil(N / chunk), F + 1, E].
extern "C" int pdt_tail_bwd_reduce(const void* z, int64_t ldz, const void* g, int64_t ldg,
                                   const void* out, int64_t ldo, void* gp, int chunk,
                                   void* partial, void* p, void* sb, int dtype, int N, int F,
                                   int E, void* stream) {
  if (bad_dims(dtype, N, F, E)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partial);
  auto* pp = static_cast<float*>(p);
  auto* s = static_cast<float*>(sb);
  return dtype == 1 ? launch_reduce<bf16>(z, ldz, g, ldg, out, ldo, gp, chunk, part, pp, s, N, F,
                                          E, true, st)
                    : launch_reduce<float>(z, ldz, g, ldg, out, ldo, gp, chunk, part, pp, s, N,
                                           F, E, true, st);
}

// fp32 dz [N, F] contiguous from gp [N, E], z [N, F], w = [wa ; c] [E + F,
// F] (contiguous) and dmn [F], on CUDA cores.
extern "C" int pdt_tail_bwd_dz(const void* gp, int64_t ldgp, const void* z, int64_t ldz,
                               const void* w, const void* dmn, void* dz, int N, int F, int E,
                               void* stream) {
  if (bad_dims(0, N, F, E)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dz(gp, ldgp, z, ldz, w, static_cast<const float*>(dmn), dz, N, F, E,
                   static_cast<cudaStream_t>(stream));
}

// bf16 dz [N, F] contiguous from gp [N, E] and z [N, F] (row strides in the
// geometry), wa [E, F] and c [F, F] (contiguous bf16) and dmn [F] (fp32),
// on TMA and wgmma. geometry: 4 x 5 int64, the tensor maps of gp, z, wa
// and c (ops/bottleneck_tail.py: dz_tensor_map_geometry).
extern "C" int pdt_tail_bwd_dz_tc(const void* gp, const void* z, const void* wa, const void* c,
                                  const int64_t* geometry, const void* dmn, void* dz, int N,
                                  int F, int E, void* stream) {
  const int64_t* g = geometry;
  if (bad_dims(1, N, F, E) || g[0] != E || g[1] != N || g[5] != F || g[6] != N ||
      g[10] != F || g[11] != E || g[15] != F || g[16] != F)
    return kInvalid;
  CUtensorMap maps[4];
  const void* ptrs[4] = {gp, z, wa, c};
  for (int m = 0; m < 4; ++m) {
    const int err = encode_rows(&maps[m], ptrs[m], g + 5 * m);
    if (err != 0) return err;
  }
  const DzArgs a{static_cast<const float*>(dmn), static_cast<bf16*>(dz), N, F, E};
  auto st = static_cast<cudaStream_t>(stream);
  return F > kDzBox ? launch_dz_wgmma<2, 6>(maps, a, st) : launch_dz_wgmma<1, 8>(maps, a, st);
}

extern "C" const char* pdt_tail_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
