// The other design of kernel 8's bf16 split, kept to be timed against the
// shipped one (paged_split_tc_kernel in csrc/paged_attention.cu) by
// tools/split_designs.py; no wrapper of the package calls it.
//
// One block per (worker, batch row) owns all H_kv heads of its span of the
// chain and lands whole pool blocks [bl, H_kv, D] of K and V per ring stage,
// contiguous in the pool, by one 1-D bulk copy each (variants 0, 2) or one
// 3-D TMA box (64, H_kv, bl) each (variants 1, 3; 128-byte swizzle), with 4
// stages and one block an SM (variants 0, 1) or 2 stages and two (2, 3).
// Four consumer warps take the heads h = warp + 4 i, CUDA-core products
// from shared memory (lane (key, half) for QK, lane d pairs for PV), the
// fp32 online softmax of the CUDA-core walk; the split's partials, ticket
// and in-launch merge as the shipped kernel. MHA decode only (G = C = 1),
// D = 64, H_kv <= 12: the shape of the serve's decode tick.
#include "hopper.cuh"

namespace {
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

struct WbParams {
  const __nv_bfloat16* q;  // [B, 1, H, 64] contiguous
  const __nv_bfloat16* k_pool;
  const __nv_bfloat16* v_pool;
  const int* tables;
  const int* qpos;
  __nv_bfloat16* out;
  float* part_acc;  // [B, H, S, 64]
  float* part_m;    // [B, H, S]
  float* part_l;
  int* tickets;     // [B]
  int H, bl, W, S, wc;
  float scale;
};

template <int kStages, int kHPW, int kMode, int kMinBlocks>
__global__ void __launch_bounds__(160, kMinBlocks)
    split_wb_kernel(__grid_constant__ const CUtensorMap map_k,
                    __grid_constant__ const CUtensorMap map_v, const WbParams p) {
  constexpr int D = 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);
  const int blk_bytes = p.bl * p.H * D * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 2 * blk_bytes);
  uint64_t* empty = full + kStages;
  __shared__ float q_s[4 * kHPW][D];
  __shared__ int is_last;
  const int sw = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qp = p.qpos[b];
  const int n_keys = qp < 0 ? 0 : min(p.W * p.bl, qp + 1);
  const int span = p.wc * p.bl;
  const int n_active = max(1, (n_keys + span - 1) / span);
  if (sw >= n_active) return;
  const int j_begin = sw * p.wc;
  const int j_stop = min(p.W, (min(n_keys, (sw + 1) * span) + p.bl - 1) / p.bl);
  const int n_blk = max(j_stop - j_begin, 0);
  const float sc_t = __bfloat162float(__float2bfloat16(p.scale));
  for (int i = tid; i < p.H * D; i += 160) {
    const float x = __bfloat162float(p.q[static_cast<int64_t>(b) * p.H * D + i]);
    q_s[i / D][i % D] = __bfloat162float(__float2bfloat16(x * sc_t));
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int* table = p.tables + static_cast<int64_t>(b) * p.W;
  if (warp == 4) {
    if (lane == 0) {
      for (int i = 0; i < n_blk; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty + s, ((i / kStages) & 1) ^ 1);
        const int blk = __ldg(table + j_begin + i);
        unsigned char* k_st = ring + 2 * s * blk_bytes;
        mbar_expect_tx(full + s, 2 * blk_bytes);
        if (kMode == 0) {
          const int64_t off = static_cast<int64_t>(blk) * p.bl * p.H * D;
          bulk_load(k_st, p.k_pool + off, blk_bytes, full + s);
          bulk_load(k_st + blk_bytes, p.v_pool + off, blk_bytes, full + s);
        } else {
          tma_load(k_st, &map_k, full + s, 0, 0, blk * p.bl);
          tma_load(k_st + blk_bytes, &map_v, full + s, 0, 0, blk * p.bl);
        }
      }
    }
    return;
  }
  const int kl = lane & 15, half = lane >> 4;
  float m[kHPW], l[kHPW], acc[kHPW][2];
#pragma unroll
  for (int hh = 0; hh < kHPW; ++hh) {
    m[hh] = -1e30f;
    l[hh] = 0.f;
    acc[hh][0] = acc[hh][1] = 0.f;
  }
  for (int i = 0; i < n_blk; ++i) {
    const int s = i % kStages;
    const unsigned char* k_st = ring + 2 * s * blk_bytes;
    const unsigned char* v_st = k_st + blk_bytes;
    mbar_wait(full + s, (i / kStages) & 1);
    const int j = j_begin + i;
#pragma unroll
    for (int hh = 0; hh < kHPW; ++hh) {
      const int h = warp + 4 * hh;
      if (h >= p.H) break;
      for (int t0 = 0; t0 < p.bl; t0 += 16) {
        const int t = t0 + kl;
        const int tr = min(t, p.bl - 1);
        const int r = tr * p.H + h;
        float sc = 0.f;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int c = half * 4 + ((cc + kl) & 3);
          const int phys = kMode == 1 ? (c ^ (r & 7)) : c;
          const uint4 x = *reinterpret_cast<const uint4*>(k_st + r * 128 + phys * 16);
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
          for (int u = 0; u < 8; ++u) sc += q_s[h][c * 8 + u] * __bfloat162float(e[u]);
        }
        sc += __shfl_xor_sync(kFull, sc, 16);
        const int kpos = j * p.bl + t;
        const bool vis = t < p.bl && kpos <= qp;
        sc = vis ? sc : -1e30f;
        float mb = sc;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) mb = fmaxf(mb, __shfl_xor_sync(kFull, mb, o));
        const float m_new = fmaxf(m[hh], mb);
        const float pv = vis ? __expf(sc - m_new) : 0.f;
        float ps = pv;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) ps += __shfl_xor_sync(kFull, ps, o);
        const float corr = __expf(m[hh] - m_new);
        l[hh] = l[hh] * corr + ps;
        m[hh] = m_new;
        acc[hh][0] *= corr;
        acc[hh][1] *= corr;
        const float pr = __bfloat162float(__float2bfloat16(pv));
        const int nk = min(16, p.bl - t0);
        for (int tt = 0; tt < nk; ++tt) {
          const float pt = __shfl_sync(kFull, pr, tt);
          const int r2 = (t0 + tt) * p.H + h;
          const int chunk = lane >> 2;
          const int phys = kMode == 1 ? (chunk ^ (r2 & 7)) : chunk;
          const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(
              v_st + r2 * 128 + phys * 16 + (lane & 3) * 4);
          acc[hh][0] += pt * __low2float(v2);
          acc[hh][1] += pt * __high2float(v2);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }
  const bool partial = n_active > 1;
#pragma unroll
  for (int hh = 0; hh < kHPW; ++hh) {
    const int h = warp + 4 * hh;
    if (h >= p.H) break;
    const int64_t pr = (static_cast<int64_t>(b) * p.H + h) * p.S + sw;
    if (partial) {
      if (lane == 0) {
        p.part_m[pr] = m[hh];
        p.part_l[pr] = l[hh];
      }
      *reinterpret_cast<float2*>(p.part_acc + pr * D + 2 * lane) = make_float2(acc[hh][0], acc[hh][1]);
    } else {
      const float lc = fmaxf(l[hh], 1e-37f);
      *reinterpret_cast<uint32_t*>(p.out + (static_cast<int64_t>(b) * p.H + h) * D + 2 * lane) =
          pack2(acc[hh][0] / lc, acc[hh][1] / lc);
    }
  }
  if (!partial) return;
  __threadfence();
  sync_consumers();
  if (tid == 0) is_last = atomicAdd(p.tickets + b, 1) == n_active - 1;
  sync_consumers();
  if (!is_last) return;
  __threadfence();
  for (int i = tid; i < p.H * (D / 2); i += 128) {
    const int h = i / (D / 2);
    const int d = 2 * (i - h * (D / 2));
    const int64_t pb = (static_cast<int64_t>(b) * p.H + h) * p.S;
    float ms = -1e30f;
    for (int w = 0; w < n_active; ++w) ms = fmaxf(ms, __ldcg(p.part_m + pb + w));
    float v0 = 0.f, v1 = 0.f, ls = 0.f;
    for (int w = 0; w < n_active; ++w) {
      const float al = __expf(__ldcg(p.part_m + pb + w) - ms);
      const float2 x = __ldcg(reinterpret_cast<const float2*>(p.part_acc + (pb + w) * D + d));
      v0 += x.x * al;
      v1 += x.y * al;
      ls += __ldcg(p.part_l + pb + w) * al;
    }
    const float lc = fmaxf(ls, 1e-37f);
    *reinterpret_cast<uint32_t*>(p.out + (static_cast<int64_t>(b) * p.H + h) * D + d) =
        pack2(v0 / lc, v1 / lc);
  }
  if (tid == 0) p.tickets[b] = 0;
}

int encode_block(CUtensorMap* map, const void* pool, int n_rows, int H, int bl) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return 1;
  const cuuint64_t dims[3] = {64, static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(n_rows)};
  const cuuint64_t strides[2] = {128, static_cast<cuuint64_t>(H) * 128};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(H), static_cast<cuuint32_t>(bl)};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(pool), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : 2;
}

template <int kStages, int kMode, int kMinBlocks>
int launch(const CUtensorMap& mk, const CUtensorMap& mv, const WbParams& p, int B,
           cudaStream_t st) {
  auto kernel = split_wb_kernel<kStages, 3, kMode, kMinBlocks>;
  const int smem = 1024 + kStages * 2 * p.bl * p.H * 128 + 2 * kStages * 8;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(p.S, B), 160, smem, st>>>(mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

// variant: 0 = bulk 4 stages 1 block, 1 = TMA box 4 stages 1 block,
// 2 = bulk 2 stages 2 blocks, 3 = TMA box 2 stages 2 blocks
extern "C" int pdt_split_wb(const void* q, const void* k_pool, const void* v_pool, int n_blocks,
                            const void* tables, const void* qpos, void* out, void* part_acc,
                            void* part_m, void* part_l, void* tickets, int B, int H, int bl,
                            int W, int S, float scale, int variant, void* stream) {
  if (H > 12 || S < 1 || S > W) return 1;
  CUtensorMap mk, mv;
  int err = encode_block(&mk, k_pool, n_blocks * bl, H, bl);
  if (err == 0) err = encode_block(&mv, v_pool, n_blocks * bl, H, bl);
  if (err) return err;
  WbParams p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
             static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int*>(tables),
             static_cast<const int*>(qpos), static_cast<__nv_bfloat16*>(out),
             static_cast<float*>(part_acc), static_cast<float*>(part_m),
             static_cast<float*>(part_l), static_cast<int*>(tickets), H, bl, W, S,
             (W + S - 1) / S, scale};
  auto st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<4, 0, 1>(mk, mv, p, B, st);
    case 1: return launch<4, 1, 1>(mk, mv, p, B, st);
    case 2: return launch<2, 0, 2>(mk, mv, p, B, st);
    case 3: return launch<2, 1, 2>(mk, mv, p, B, st);
    default: return 1;
  }
}
