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
// What bounds them on the H100 (3.35 TB/s, 989 bf16 TFLOP/s), at ResNet-50's
// four expand-tail shapes (B 128: z [401408, 64], [100352, 128], [25088,
// 256], [6272, 512], E = 4F), bf16:
//   - moments: bytes at every stage (51, 26, 13, 7.5 MB: 15.3, 7.7, 3.9,
//     2.2 us), its 1.65 GFLOP (the upper triangle of z^T z, F(F+1)/2 sums)
//     taking 1.7 us; the downsample inputs (z [401408, 64], [100352, 256],
//     [25088, 512], [6272, 1024]) 15.3, 15.4, 8.0 us (bytes) and 6.7 us
//     (operations, 6.6 GFLOP);
//   - tail_bwd_reduce: bytes at every stage (668, 334, 168, 88 MB: 199.4,
//     99.8, 50.1, 26.2 us; 13 GFLOP each), g and out three quarters of them;
//   - tail_bwd_dz: bytes at stages 1-3 (92.0, 46.1, 23.4 us), operations at
//     stage 4 (16.6 us).
//
// What the design does about it:
//   - The Pallas kernels walk the batch in order and carry the sums in VMEM
//     from one grid step to the next. Here blocks run in parallel, each on
//     one chunk of rows, and write fp32 partial sums to a buffer [chunks,
//     F + 1, n_b] (row F the column sums); tail_merge_kernel, wide enough to
//     fill the card, adds the chunks in a fixed order, so two launches give
//     the same bits: no atomics. The caller sizes the chunks (reduce_plan
//     and reduce_grid in ops/bottleneck_tail.py, from the card's SM count)
//     and allocates the buffer; reduce_plan picks the bf16 kernel's tile
//     plan from tail_plans.cuh and passes its row's index.
//   - moments and tail_bwd_reduce on bf16 are one kernel,
//     tail_reduce_wgmma_kernel (further down): a TMA ring fed by a producer
//     warp, wgmma on operands that are both MN-major (the contraction runs
//     over rows), gp gated in shared memory and stored from there by TMA.
//     g and out, three quarters of tail_bwd_reduce's bytes, are read from
//     device memory once: its tiles span F at stages 1, 2 and 4, and at
//     stage 3 the two F tiles of a row range run side by side, the second
//     reading g and out from L2; z, a quarter of g, is read once per tile of
//     E, mostly from L2. moments computes the upper triangle of its tiles;
//     a diagonal tile reads one set of boxes for both operands, and the
//     merge writes each off-diagonal sum at both places, so the two halves
//     are equal bit for bit. Σz and Σgp come out of the same pass.
//   - tail_bwd_dz is one product of K = E + F: [gp | z] @ [wa ; c], plus
//     dmn in the fp32 epilogue before the one rounding to z's dtype. wa and c
//     come rounded to the operands' dtype for the tensor cores (bf16 for bf16
//     activations), where the Pallas kernel multiplies bf16 by fp32. On bf16
//     it is tail_dz_wgmma_kernel: TMA and wgmma, a persistent stream of (row
//     tile, k step) stages.
//   - fp32 operands take CUDA-core kernels for exact fp32 numerics:
//     tail_reduce_kernel<kGate> (64x64 tiles, synchronous loads into
//     padded shared memory) with the same merge, and tail_dz_kernel<float>.

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // four warps, each a 32x32 quadrant of the tile
constexpr int kTile = 64;      // output tile edge; the bf16 reductions' unit and box width
constexpr int kStep = 32;      // contraction rows per shared-memory step
constexpr int kPad = 8;        // row padding of the shared-memory tiles

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// acc += A B over k in [0, kStep) on CUDA cores for the warp's 32x32
// quadrant at rows m0 and columns n0 of the tile, from shared-memory tiles:
// B stored [k][n] (row stride ldb); A stored [k][m] when kAKMajor (the
// reductions' z^T), else [m][k] (row stride lda). acc[mi][ni] holds rows
// m0 + 16 mi + g (+8) and columns n0 + 8 ni + 2t (+1) for lane 4g + t, in
// elements 0, 1 (and 2, 3). The k loop stays rolled to keep nvcc quick; the
// fp32 kernels serve checks and fp32 models, not the bf16 training path.
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
template <bool kGate>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int64_t ld,
                                          const float* gate, int64_t ld_gate, float* gp_out,
                                          int r0, int c0, int n_rows, int n_cols) {
  constexpr int kVec = 4;  // fp32 a 16-byte vector
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
        float* x = reinterpret_cast<float*>(&val);
        const float* o = reinterpret_cast<const float*>(&gv);
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          if (!(o[i] > 0.f)) x[i] = 0.f;
        if (gp_out != nullptr)
          *reinterpret_cast<uint4*>(gp_out + static_cast<int64_t>(row) * n_cols + col) = val;
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// The fp32 reductions: moments (kGate false: B is z itself) and
// tail_bwd_reduce (kGate true: B is gp = g * [out > 0]). Block (tile,
// chunk) computes A^T B over its rows for one 64x64 output tile, with A =
// z[:, i tile] and B = z[:, j tile] or gp[:, j tile], and writes the tile,
// and the column sums of B where the block owns them, into its chunk's
// slice of partial [chunks, F + 1, n_b]: rows 0..F-1 the tile, row F the
// sums.
template <bool kGate>
__global__ void __launch_bounds__(kThreads)
    tail_reduce_kernel(const float* __restrict__ z, int64_t ldz, const float* __restrict__ g,
                       int64_t ldg, const float* __restrict__ gate, int64_t ld_gate,
                       float* __restrict__ gp, float* __restrict__ partial, int N, int F,
                       int n_b, int chunk) {
  constexpr int LD = kTile + kPad;
  __shared__ __align__(16) float a_s[kStep * LD];
  __shared__ __align__(16) float b_s[kStep * LD];

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

  const float* b_src = kGate ? g : z;
  const int64_t ld_b = kGate ? ldg : ldz;
  const float* b_tile = diag ? a_s : b_s;
  for (int r0 = r_begin; r0 < r_end; r0 += kStep) {
    __syncthreads();  // the previous step's reads are done
    load_rows<false>(a_s, z, ldz, nullptr, 0, nullptr, r0, i0, r_end, F);
    if (!diag)
      load_rows<kGate>(b_s, b_src, ld_b, gate, ld_gate, owner ? gp : nullptr, r0, j0, r_end,
                       n_b);
    __syncthreads();
    // A(m, k) = z[r0 + k][i0 + m]: the tile read down its columns
    warp_product<true>(acc, a_s, LD, b_tile, LD, m0, n0);
    if (owner) {
#pragma unroll 4
      for (int r = 16 * c_half; r < 16 * c_half + 16; ++r) csum += b_tile[r * LD + c_col];
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

// out [F, n_b] and colsum [n_b] from partial [chunks, F + 1, n_b] (row F
// the column sums), wide enough to fill the card: the 256 threads of a block
// split the chunks into n_runs runs (merge_runs: up to 8) and take 256 /
// n_runs float4 of the output each; a run adds its chunks in ascending
// order, then the runs are added in ascending order. The order is fixed by
// the chunk count, so two launches give the same bits. kGate false
// (moments): only the upper triangle of 64x64 tiles was computed; each
// element there is written at (row, col) and, off the diagonal tiles, at
// (col, row).
__host__ __device__ __forceinline__ int merge_runs(int chunks) {
  return chunks >= 8 ? 8 : chunks >= 4 ? 4 : chunks >= 2 ? 2 : 1;
}

template <bool kGate>
__global__ void __launch_bounds__(256)
    tail_merge_kernel(const float* __restrict__ partial, int chunks, int F, int n_b,
                      float* __restrict__ out, float* __restrict__ colsum) {
  __shared__ float4 runs[256];
  const int n_runs = merge_runs(chunks);
  const int width = 256 / n_runs;  // float4 a block
  const int q = threadIdx.x % width;
  const int run = threadIdx.x / width;
  const int64_t per_chunk = static_cast<int64_t>(F + 1) * n_b;
  const int64_t idx = (static_cast<int64_t>(blockIdx.x) * width + q) * 4;
  const int row = static_cast<int>(idx / n_b);
  const int col = static_cast<int>(idx - static_cast<int64_t>(row) * n_b);
  const bool live = idx < per_chunk && (kGate || row == F || row / kTile <= col / kTile);
  const int per_run = (chunks + n_runs - 1) / n_runs;
  const int c_end = min(chunks, (run + 1) * per_run);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
#pragma unroll 4
    for (int c = run * per_run; c < c_end; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(partial + c * per_chunk + idx);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  }
  runs[threadIdx.x] = s;
  __syncthreads();
  if (run != 0 || !live) return;
  for (int r = 1; r < n_runs; ++r) {
    const float4 v = runs[r * width + q];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  if (row == F) {
    *reinterpret_cast<float4*>(colsum + col) = s;
    return;
  }
  *reinterpret_cast<float4*>(out + static_cast<int64_t>(row) * n_b + col) = s;
  if (!kGate && row / kTile != col / kTile) {
    const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) out[static_cast<int64_t>(col + i) * n_b + row] = v[i];
  }
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
constexpr int kSlice = 16 * 128;                    // 16 rows of a box: one k16 step
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
                         desc(st + (2 + nb) * kDzBoxBytes + kk * kSlice), ks > 0 || kk > 0);
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

// ---------------------------------------------------------------------------
// moments and tail_bwd_reduce on bf16 rows, on Hopper's own units: TMA,
// mbarriers, wgmma.
//
// The product is z^T B over the rows: M = F (z's channels), N = n_b (B's
// channels: z's own for moments, gp's for tail_bwd_reduce), K = the rows.
// Every operand arrives as boxes of kR rows x 64 channels through 2-D tensor
// maps laid over its row stride (ops/bottleneck_tail.py's
// reduce_tensor_map_geometry), so a channels-last activation's rows need no
// copy; channels are contiguous in a box, with the 128-byte swizzle. So A =
// z^T and B are both MN-major for wgmma (bf16 allows it from shared memory),
// and a k16 step is 16 rows of a box, 2 KB on. A box past N or past the
// channels lands as zeros: N and the channel counts need no padding.
//   - Block (tile, chunk): a tile of kM x kN 64x64 units of the output, over
//     one chunk of rows (a multiple of 64), tiles fastest and F tiles
//     fastest among them, so that blocks at work together read the same
//     rows. tail_bwd_reduce's plans (tail_plans.cuh):
//     F <= 64 in one 64 x 256 tile, F <= 256 in 128 x 128 tiles (at F = 256
//     the two F tiles of a row range share g and out through L2, and read z
//     half as often as 256 x 128 tiles would), wider F in 512 x 64 tiles
//     (kM = 8 boxes, both warpgroups): each of g and out is read once, z
//     once per tile of E, mostly from L2. moments' tiles are the
//     upper triangle of square super-tiles of kM boxes; a diagonal one loads
//     its kM boxes once for both operands.
//   - One producer warp streams the chunk's stages through a ring of
//     kStages: kM boxes of z, then kN of B (none on moments' diagonal), then
//     kN of out (tail_bwd_reduce).
//   - Two consumer warpgroups. tail_bwd_reduce: all 256 threads gate the
//     stage's g boxes in place, gp = g * [float(out) > 0] position by
//     position (g and out share the box geometry and swizzle; a select, so gp
//     is bit-equal to the plain version and NaN or -0 in out give 0), each
//     thread summing 8 columns of gp in fp32 as it goes; a proxy fence and a
//     barrier, then one thread stores the gp boxes by TMA (blocks of the
//     first F tile only: gp is written once) and the warpgroups multiply.
//     moments' diagonal tiles sum z's columns the same way. Each warpgroup
//     owns half of the tile's units (m64n64k16 wgmma); a one-unit tile
//     (moments at F <= 64) is split by k16 steps instead, and warpgroup 1's
//     half is added to warpgroup 0's at the end. A stage is released once its
//     products are done and the gp stores have read it.
//   - Epilogue: the fp32 units and the column sums (32 row groups a column,
//     added in order) go to the chunk's slice of the partial buffer;
//     tail_merge_kernel adds the chunks.

constexpr int kRedThreads = 2 * 128 + 32;  // two consumer warpgroups, a producer warp

struct ReduceArgs {
  float* partial;  // [chunks, F + 1, n_b]
  int N, F, n_b;
  int chunk;       // rows a block, a multiple of 64
  int n_ti;        // tiles along F (moments: super-tiles along each side)
  int n_tiles;     // tiles of the output (moments: the upper triangle)
};

template <bool kGate, int kM, int kN, int kR, int kStages>
__global__ void __launch_bounds__(kRedThreads, 1)
    tail_reduce_wgmma_kernel(__grid_constant__ const CUtensorMap map_z,
                             __grid_constant__ const CUtensorMap map_g,
                             __grid_constant__ const CUtensorMap map_o,
                             __grid_constant__ const CUtensorMap map_gp, const ReduceArgs a) {
  static_assert(kGate || kM == kN, "moments' super-tiles are square");
  static_assert(kR % 32 == 0 && kR <= 256, "a box is 32 to 256 rows, 32 at a time");
  constexpr int kBoxBytes = kR * 128;
  constexpr int kU = kM * kN;               // units of the tile
  constexpr int kUW = kU > 1 ? kU / 2 : 1;  // units a warpgroup owns
  constexpr int kKK = kR / 16;              // k16 steps a stage
  constexpr int kBoxes = kM + (kGate ? 2 : 1) * kN;
  constexpr int kStageBytes = kBoxes * kBoxBytes;
  static_assert(kU == 1 || kU % 2 == 0, "the warpgroups share the units evenly");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tile = blockIdx.x % a.n_tiles;
  const int chunk = blockIdx.x / a.n_tiles;
  int ti, tj;
  if (kGate) {
    ti = tile % a.n_ti;
    tj = tile / a.n_ti;
  } else {
    int p = tile;
    ti = 0;
    while (p >= a.n_ti - ti) {
      p -= a.n_ti - ti;
      ++ti;
    }
    tj = ti + p;
  }
  const int i0 = ti * kM * kTile;  // the tile's first row of the output (z's channel)
  const int j0 = tj * kN * kTile;  // and first column (B's channel)
  const bool diag = !kGate && ti == tj;
  // the blocks that write gp and the column sums: the first F tile
  // (tail_bwd_reduce), the diagonal (moments)
  const bool owner = kGate ? ti == 0 : diag;
  const int r_begin = chunk * a.chunk;
  const int n_steps = (min(r_begin + a.chunk, a.N) - r_begin + kR - 1) / kR;

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
      const CUtensorMap* mb = kGate ? &map_g : &map_z;
      for (int s = 0; s < n_steps; ++s) {
        const int slot = s % kStages;
        if (s >= kStages) mbar_wait(empty + slot, ((s / kStages) & 1) ^ 1);
        unsigned char* st = ring + slot * kStageBytes;
        const int r0 = r_begin + s * kR;
        mbar_expect_tx(full + slot, (diag ? kM : kBoxes) * kBoxBytes);
#pragma unroll
        for (int m = 0; m < kM; ++m)
          tma_load(st + m * kBoxBytes, &map_z, full + slot, i0 + m * kTile, r0);
        if (!diag) {
#pragma unroll
          for (int n = 0; n < kN; ++n)
            tma_load(st + (kM + n) * kBoxBytes, mb, full + slot, j0 + n * kTile, r0);
        }
        if (kGate) {
#pragma unroll
          for (int n = 0; n < kN; ++n)
            tma_load(st + (kM + kN + n) * kBoxBytes, &map_o, full + slot, j0 + n * kTile, r0);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  // the 16-byte chunk (8 channels) of a box row that this thread gates and
  // sums, and its rows rr + 32 h; the 128-byte swizzle keeps chunk c of row r
  // at chunk c ^ (r % 8) of the row
  const int cc = tid & 7;
  const int rr = tid >> 3;
  const int b_off = diag ? 0 : kM;  // B's first box in a stage
  float acc[kUW][32];
#pragma unroll
  for (int u = 0; u < kUW; ++u)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[u][e] = 0.f;
  float csum[kN][8];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 8; ++e) csum[n][e] = 0.f;

  for (int s = 0; s < n_steps; ++s) {
    const int slot = s % kStages;
    unsigned char* st = ring + slot * kStageBytes;
    mbar_wait(full + slot, (s / kStages) & 1);
    if (kGate) {
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int h = 0; h < kR / 32; ++h) {
          const int r = rr + 32 * h;
          const int off = r * 128 + ((cc ^ (r & 7)) << 4);
          uint4* gq = reinterpret_cast<uint4*>(st + (kM + n) * kBoxBytes + off);
          uint4 gv = *gq;
          const uint4 ov = *reinterpret_cast<const uint4*>(st + (kM + kN + n) * kBoxBytes + off);
          bf16* x = reinterpret_cast<bf16*>(&gv);
          const bf16* o = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (!(__bfloat162float(o[e]) > 0.f)) x[e] = __float2bfloat16(0.f);
            csum[n][e] += __bfloat162float(x[e]);
          }
          *gq = gv;
        }
      fence_async_smem();
      sync_warps<256>();  // gp is in place for wgmma and the stores
      if (owner && tid == 0) {
#pragma unroll
        for (int n = 0; n < kN; ++n)
          tma_store(&map_gp, st + (kM + n) * kBoxBytes, j0 + n * kTile, r_begin + s * kR);
        bulk_commit();
      }
    } else if (diag) {
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int h = 0; h < kR / 32; ++h) {
          const int r = rr + 32 * h;
          const uint4 zv = *reinterpret_cast<const uint4*>(st + n * kBoxBytes + r * 128 +
                                                           ((cc ^ (r & 7)) << 4));
          const bf16* x = reinterpret_cast<const bf16*>(&zv);
#pragma unroll
          for (int e = 0; e < 8; ++e) csum[n][e] += __bfloat162float(x[e]);
        }
    }
    wgmma_fence();
    if (kU == 1) {  // warpgroup wg takes half of the stage's k16 steps
#pragma unroll
      for (int kk = 0; kk < kKK / 2; ++kk) {
        const int k = wg * (kKK / 2) + kk;
        wgmma_ss<1, 1>(acc[0], desc(st + k * kSlice), desc(st + b_off * kBoxBytes + k * kSlice),
                       s > 0 || kk > 0);
      }
    } else {
#pragma unroll
      for (int u = 0; u < kUW; ++u) {
        const int unit = wg * kUW + u;
        const unsigned char* ab = st + (unit / kN) * kBoxBytes;
        const unsigned char* bb = st + (b_off + unit % kN) * kBoxBytes;
#pragma unroll
        for (int kk = 0; kk < kKK; ++kk)
          wgmma_ss<1, 1>(acc[u], desc(ab + kk * kSlice), desc(bb + kk * kSlice), s > 0 || kk > 0);
      }
    }
    wgmma_commit();
    if (s > 0) {  // the previous stage's products are done: release it
      wgmma_wait_1();
      if (kGate && owner && tid == 0) bulk_wait_read<1>();  // and its gp stores have read it
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (s - 1) % kStages);
    }
  }
  wgmma_wait();
#pragma unroll
  for (int u = 0; u < kUW; ++u) fence_regs(acc[u]);
  if (kGate && owner && tid == 0) bulk_wait_read<0>();
  sync_warps<256>();  // every product is done and every store has read: the ring is free

  float* part = a.partial + static_cast<int64_t>(chunk) * (a.F + 1) * a.n_b;
  float* xs = reinterpret_cast<float*>(ring);
  if (owner) {  // the column sums: 32 row groups a column, added in order
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 8; ++e) xs[rr * (kN * kTile) + n * kTile + cc * 8 + e] = csum[n][e];
    sync_warps<256>();
    for (int c = tid; c < kN * kTile; c += 256) {
      float v = 0.f;
      for (int r = 0; r < 32; ++r) v += xs[r * (kN * kTile) + c];
      if (j0 + c < a.n_b) part[static_cast<int64_t>(a.F) * a.n_b + j0 + c] = v;
    }
    sync_warps<256>();  // xs is free again
  }
  if (kU == 1) {  // warpgroup 1's k steps are added to warpgroup 0's
    const int wt = tid & 127;
    if (wg == 1) {
#pragma unroll
      for (int e = 0; e < 32; ++e) xs[e * 128 + wt] = acc[0][e];
    }
    sync_warps<256>();
    if (wg == 1) return;
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[0][e] += xs[e * 128 + wt];
  }

  // thread 32w + 4g + t of a warpgroup holds rows 16w + g (+8), columns
  // 8j + 2t (+1) of each unit
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int u = 0; u < kUW; ++u) {
    const int unit = kU == 1 ? 0 : wg * kUW + u;
    const int mi = unit / kN;
    const int ni = unit % kN;
    if (!kGate && ti * kM + mi > tj * kN + ni) continue;  // below moments' diagonal
    const int row = i0 + mi * kTile + 16 * (warp & 3) + g;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j0 + ni * kTile + 8 * j + 2 * t;
      if (col >= a.n_b) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r < a.F)
          *reinterpret_cast<float2*>(part + static_cast<int64_t>(r) * a.n_b + col) =
              make_float2(acc[u][4 * j + 2 * h], acc[u][4 * j + 2 * h + 1]);
      }
    }
  }
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

// A 2-D bf16 tensor map from ops/bottleneck_tail.py's geometry (columns,
// rows, the row stride in bytes, box columns, box rows): box (64, box_rows),
// the 128-byte swizzle
int encode_rows(CUtensorMap* map, const void* ptr, const int64_t* geo, int box_rows = kDzBox) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (geo[3] != kDzBox || geo[4] != box_rows) return kInvalid;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(geo[0]), static_cast<cuuint64_t>(geo[1])};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(geo[2])};
  const cuuint32_t box[2] = {kDzBox, static_cast<cuuint32_t>(box_rows)};
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

// The chunks' merge into out [F, n_b] and colsum [n_b].
int launch_merge(const float* partial, int chunks, int F, int n_b, float* out, float* colsum,
                 bool gated, cudaStream_t st) {
  const int64_t quads = static_cast<int64_t>(F + 1) * n_b / 4;
  const int width = 256 / merge_runs(chunks);
  const int64_t blocks = (quads + width - 1) / width;
  if (blocks > 0x7fffffff) return kInvalid;
  if (gated)
    tail_merge_kernel<true><<<static_cast<unsigned>(blocks), 256, 0, st>>>(partial, chunks, F,
                                                                           n_b, out, colsum);
  else
    tail_merge_kernel<false><<<static_cast<unsigned>(blocks), 256, 0, st>>>(partial, chunks, F,
                                                                            n_b, out, colsum);
  return static_cast<int>(cudaGetLastError());
}

// The fp32 reduction (CUDA cores) and the merge of its chunks, one launch
// each on one stream. chunk: rows per block (a multiple of kStep, from
// ops/bottleneck_tail.py's reduce_grid); partial: fp32 [ceil(N / chunk),
// F + 1, n_b] scratch.
int launch_reduce(const float* z, int64_t ldz, const float* g, int64_t ldg, const float* out,
                  int64_t ldo, float* gp, int chunk, float* partial, float* acc_out,
                  float* colsum, int N, int F, int n_b, bool gated, cudaStream_t st) {
  const int n_i = (F + kTile - 1) / kTile;
  const int n_j = (n_b + kTile - 1) / kTile;
  const int n_tiles = gated ? n_i * n_j : n_i * (n_i + 1) / 2;
  if (chunk < kStep || chunk % kStep) return kInvalid;
  const int chunks = (N + chunk - 1) / chunk;
  const dim3 grid(n_tiles, chunks);
  if (grid.y > 65535) return kInvalid;
  if (gated)
    tail_reduce_kernel<true><<<grid, kThreads, 0, st>>>(z, ldz, g, ldg, out, ldo, gp, partial,
                                                        N, F, n_b, chunk);
  else
    tail_reduce_kernel<false><<<grid, kThreads, 0, st>>>(z, ldz, nullptr, 0, nullptr, 0, nullptr,
                                                         partial, N, F, n_b, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_merge(partial, chunks, F, n_b, acc_out, colsum, gated, st);
}

// The bf16 reduction (TMA + wgmma) at one tile plan and the merge of its
// chunks, one launch each on one stream.
template <bool kGate, int kM, int kN, int kR, int kStages>
int launch_reduce_wgmma(const CUtensorMap (&maps)[4], const ReduceArgs& a, float* acc_out,
                        float* colsum, cudaStream_t st) {
  auto kernel = tail_reduce_wgmma_kernel<kGate, kM, kN, kR, kStages>;
  constexpr int kBoxes = kM + (kGate ? 2 : 1) * kN;
  const int smem = 1024 + kStages * kBoxes * kR * 128 + 2 * kStages * 8;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int chunks = (a.N + a.chunk - 1) / a.chunk;
  const int64_t grid = static_cast<int64_t>(a.n_tiles) * chunks;
  if (grid > 0x7fffffff) return kInvalid;
  kernel<<<static_cast<unsigned>(grid), kRedThreads, smem, st>>>(maps[0], maps[1], maps[2],
                                                                 maps[3], a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_merge(a.partial, chunks, a.F, a.n_b, acc_out, colsum, kGate, st);
}

// The tile plans (tail_plans.cuh): each row's numbers, and its launcher.
struct TilePlan {
  bool gated;
  int f_max, km, kn, rows, stages;
};
constexpr TilePlan kTilePlans[] = {
#define TAIL_PLAN(gated, f_max, km, kn, rows, stages) {gated != 0, f_max, km, kn, rows, stages},
#include "tail_plans.cuh"
#undef TAIL_PLAN
};
constexpr int kNumPlans = sizeof(kTilePlans) / sizeof(kTilePlans[0]);
using ReduceLaunch = int (*)(const CUtensorMap (&)[4], const ReduceArgs&, float*, float*,
                             cudaStream_t);
constexpr ReduceLaunch kPlanLaunch[] = {
#define TAIL_PLAN(gated, f_max, km, kn, rows, stages) \
  &launch_reduce_wgmma<gated != 0, km, kn, rows, stages>,
#include "tail_plans.cuh"
#undef TAIL_PLAN
};

int launch_dz(const void* gp, int64_t ldgp, const void* z, int64_t ldz, const void* w,
              const float* dmn, void* dz, int N, int F, int E, cudaStream_t st) {
  const dim3 grid((N + kTile - 1) / kTile, (F + kTile - 1) / kTile);
  if (grid.y > 65535) return kInvalid;
  tail_dz_kernel<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(gp), ldgp,
                                                   static_cast<const float*>(z), ldz,
                                                   static_cast<const float*>(w), dmn,
                                                   static_cast<float*>(dz), N, F, E);
  return static_cast<int>(cudaGetLastError());
}

// F and E multiples of 8 (one 16-byte vector of bf16), N >= 1.
bool bad_dims(int N, int F, int E) { return N < 1 || F < 8 || E < 8 || F % 8 || E % 8; }

// The bf16 reductions' chunks: a whole number of 64-row boxes, and of stages, each.
bool bad_chunk(int chunk, int rows) { return chunk < 64 || chunk % 64 || chunk % rows; }

}  // namespace

// Row strides in elements, unit stride along the channels, rows 16-byte
// aligned. The fp32 outputs (s, m2, p, sb) are written once each, by the
// merge kernel. Each returns the launches' cudaError_t (0 = launched).

// fp32 s [F] and m2 [F, F] of z [N, F] on CUDA cores; partial: fp32
// [ceil(N / chunk), F + 1, F].
extern "C" int pdt_moments(const void* z, int64_t ldz, int N, int F, int chunk, void* partial,
                           void* s, void* m2, void* stream) {
  if (bad_dims(N, F, 8)) return kInvalid;
  return launch_reduce(static_cast<const float*>(z), ldz, nullptr, 0, nullptr, 0, nullptr, chunk,
                       static_cast<float*>(partial), static_cast<float*>(m2),
                       static_cast<float*>(s), N, F, F, false, static_cast<cudaStream_t>(stream));
}

// fp32 gp [N, E] contiguous, p [F, E] and sb [E] of z [N, F], g and out
// [N, E] on CUDA cores; partial: fp32 [ceil(N / chunk), F + 1, E].
extern "C" int pdt_tail_bwd_reduce(const void* z, int64_t ldz, const void* g, int64_t ldg,
                                   const void* out, int64_t ldo, void* gp, int chunk,
                                   void* partial, void* p, void* sb, int N, int F, int E,
                                   void* stream) {
  if (bad_dims(N, F, E)) return kInvalid;
  return launch_reduce(static_cast<const float*>(z), ldz, static_cast<const float*>(g), ldg,
                       static_cast<const float*>(out), ldo, static_cast<float*>(gp), chunk,
                       static_cast<float*>(partial), static_cast<float*>(p),
                       static_cast<float*>(sb), N, F, E, true, static_cast<cudaStream_t>(stream));
}

// bf16 s [F] and m2 [F, F] of z [N, F] on TMA and wgmma. geometry: z's
// tensor map, 5 int64 (ops/bottleneck_tail.py: reduce_tensor_map_geometry);
// plan: a moments row of tail_plans.cuh, chunk the rows a block
// (reduce_plan); partial: fp32 [ceil(N / chunk), F + 1, F].
extern "C" int pdt_moments_tc(const void* z, const int64_t* geometry, int N, int F, int plan,
                              int chunk, void* partial, void* s, void* m2, void* stream) {
  if (plan < 0 || plan >= kNumPlans || kTilePlans[plan].gated) return kInvalid;
  const TilePlan& t = kTilePlans[plan];
  if (bad_dims(N, F, 8) || bad_chunk(chunk, t.rows) || geometry[0] != F || geometry[1] != N)
    return kInvalid;
  CUtensorMap maps[4];
  const int err = encode_rows(&maps[0], z, geometry, t.rows);
  if (err != 0) return err;
  maps[1] = maps[2] = maps[3] = maps[0];  // moments reads z alone
  const int n_ti = (F + t.km * kTile - 1) / (t.km * kTile);
  const ReduceArgs a{static_cast<float*>(partial), N, F, F, chunk, n_ti, n_ti * (n_ti + 1) / 2};
  return kPlanLaunch[plan](maps, a, static_cast<float*>(m2), static_cast<float*>(s),
                           static_cast<cudaStream_t>(stream));
}

// bf16 gp [N, E] contiguous, p [F, E] and sb [E] of z [N, F], g and out
// [N, E] on TMA and wgmma. geometry: 4 x 5 int64, the tensor maps of z, g,
// out and gp (ops/bottleneck_tail.py: reduce_tensor_map_geometry); plan: a
// tail_bwd_reduce row of tail_plans.cuh, chunk the rows a block
// (reduce_plan); partial: fp32 [ceil(N / chunk), F + 1, E].
extern "C" int pdt_tail_bwd_reduce_tc(const void* z, const void* g, const void* out, void* gp,
                                      const int64_t* geometry, int N, int F, int E, int plan,
                                      int chunk, void* partial, void* p, void* sb,
                                      void* stream) {
  if (plan < 0 || plan >= kNumPlans || !kTilePlans[plan].gated) return kInvalid;
  const TilePlan& t = kTilePlans[plan];
  const int64_t* geo = geometry;
  if (bad_dims(N, F, E) || bad_chunk(chunk, t.rows) || geo[0] != F || geo[1] != N)
    return kInvalid;
  for (int m = 1; m < 4; ++m)
    if (geo[5 * m] != E || geo[5 * m + 1] != N) return kInvalid;
  CUtensorMap maps[4];
  const void* ptrs[4] = {z, g, out, gp};
  for (int m = 0; m < 4; ++m) {
    const int err = encode_rows(&maps[m], ptrs[m], geo + 5 * m, t.rows);
    if (err != 0) return err;
  }
  const int n_ti = (F + t.km * kTile - 1) / (t.km * kTile);
  const int n_tj = (E + t.kn * kTile - 1) / (t.kn * kTile);
  const ReduceArgs a{static_cast<float*>(partial), N, F, E, chunk, n_ti, n_ti * n_tj};
  return kPlanLaunch[plan](maps, a, static_cast<float*>(p), static_cast<float*>(sb),
                           static_cast<cudaStream_t>(stream));
}

// fp32 dz [N, F] contiguous from gp [N, E], z [N, F], w = [wa ; c] [E + F,
// F] (contiguous) and dmn [F], on CUDA cores.
extern "C" int pdt_tail_bwd_dz(const void* gp, int64_t ldgp, const void* z, int64_t ldz,
                               const void* w, const void* dmn, void* dz, int N, int F, int E,
                               void* stream) {
  if (bad_dims(N, F, E)) return kInvalid;
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
  if (bad_dims(N, F, E) || g[0] != E || g[1] != N || g[5] != F || g[6] != N ||
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
