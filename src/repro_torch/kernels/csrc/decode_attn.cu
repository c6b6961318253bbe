// GQA flash-decode attention over a (ring) KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attn.py::
// decode_attention (_kernel). One query token per sequence, q (B, Hq, D),
// attends over the cache k, v (B, S, Hkv, D); query head h G + j reads KV
// head h (G = Hq / Hkv). The position map pos (B, S) masks the slots: a slot
// is valid iff 0 <= pos <= idx. It computes what ref.decode_attention_ref
// computes, in f32 throughout: q upcast and scaled by D^-0.5, f32 scores, an
// invalid score set to -1e30 (not -inf, so a row with no valid slot gives
// the mean of v, as the reference does), softmax and P V in f32, and an f32
// output. Slots at or past S are not read: the TPU kernel's last block reads
// past a ragged S, which this kernel does not copy.
//
// Bound on the H100: bytes. Each (b, kv head) pair reads S rows of k and v
// once for at most 8 query rows (4 G flops per row pair of D elements), far
// below the ridge, so the least time is the cache's bytes over the HBM rate.
// No tensor cores: G <= 8 rows fill at most half of an mma's 16, and bf16
// operands would change q's rounding.
//
// Design: one launch. B Hkv is small at decode (32 at qwen3-1.7b's batch 4),
// so S is split over the blocks of a thread block cluster (grid (B Hkv,
// n_split), cluster (1, n_split, 1), n_split <= 8, the portable size). The
// wrapper's planner gives each split a run of whole 32-slot tiles, so no
// copy fetches a slot of the next split, and as many splits as let the
// grid fit in one wave of the clusters that
// repro_decode_attention_max_clusters says the card holds at once. A block
// is one producer warp and kConsumers consumer warps over a ring of kStages
// stages in shared memory, each stage a tile of k, v and pos of this
// block's kv head, guarded by a pair of mbarriers (full: the tile's bytes
// have landed; empty: its consumer is done with it). The producer's lane 0
// fetches a tile's k and v with the Tensor Memory Accelerator, through 3-D
// tensor maps over (Hkv D, S, B), one box of (at most 128 bytes of a row,
// 32 slots) per 128 bytes of D, swizzled so the consumers' reads hit
// distinct banks; slots at or past S are filled with zeros by the copy
// engine, never read. Its 32 lanes bring the tile's pos in with it, one
// 4-byte cp.async a slot whose completion arrives on the same barrier (a
// tile of pos starts at b S + s0, which a tensor map's 16-byte aligned
// boxes cannot take for every S). Consumer warp w takes the tiles t = w
// (mod kConsumers), whose stages it alone uses, so no phase of a barrier
// can be mistaken for another; the consumers load q while the first copies
// are in flight. On a tile it runs the TPU kernel's
// tile-wise online softmax: lane j scores slot j for all G rows (q in
// shared memory), invalid slots -1e30, slots past the split's end -inf
// (weight 0, never touched in P V); then one warp max, one rescale of
// (l, acc) and one expf per slot a row; then P V with lanes across D, p
// read back from shared memory. At the end the consumer warps merge, in
// the drained stages, into the block's partial (m, l, acc[G][D]); after
// cluster.sync() every block of the cluster merges a share of the G D
// outputs from all the blocks' partials through distributed shared memory
// (m = max m_c, w_c = exp(m_c - m), out = sum w_c acc_c / max(sum w_c l_c,
// 1e-20)), loading every block's partial in one round trip, and a last
// cluster.sync() keeps every partial alive until read.
// Nothing goes through a global workspace.
//
// C interface for ctypes: pointers as void*, the CUDA stream as void*, and
// the return value is the launch's cudaError_t. Nothing is allocated here.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mbarrier.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kConsumers = 2;                     // consumer warps a block
constexpr int kThreads = (kConsumers + 1) * 32;   // and one producer warp
constexpr int kTile = 32;                         // slots a stage: one a lane
constexpr int kMaxSplit = 8;                      // the portable cluster size
constexpr int kMinDepth = 2;                      // stages a consumer warp owns:
constexpr int kMaxDepth = 4;                      // a ring of 4 to 8 stages
// the aim, three blocks an SM: a third of the SM's 233 472 bytes, less 1 KB
// reserved; a ring of kMinDepth a warp that does not fit takes more (an
// f32 cache with D = 128: one block an SM)
constexpr int kSmemBudget = 233472 / 3 - 1024;
constexpr int kSmemMax = 232448;                  // what one block may use
constexpr float kNegInf = -1e30f;

// Dynamic shared memory of one block, from a 1024-byte aligned base:
// [stages: k boxes, v boxes][pos][q][p][barriers]; once drained, the
// stages hold the warps' partials and then the block's (part).
template <typename T, int G, int D>
struct Layout {
  static constexpr int kRow = D * (int)sizeof(T);             // one slot's row
  static constexpr int kBoxRow = kRow < 128 ? kRow : 128;     // a box's row: 64 or 128 bytes
  static constexpr int kBoxes = kRow / kBoxRow;               // boxes across D
  static constexpr int kBox = kTile * kBoxRow;                // bytes of one box
  static constexpr int kStage = 2 * kBoxes * kBox;            // k boxes, then v
  static constexpr int kQ = G * D * 4;
  static constexpr int kP = kConsumers * G * kTile * 4;
  static constexpr int kPart = G * (D + 2) * 4;               // acc[D], m, l a row
  static constexpr int kPerStage = kStage + kTile * 4 + 16;   // + pos, 2 barriers
  static constexpr int kFixed = 1024 + kQ + kP;               // + alignment slack
  static constexpr int kFit = (kSmemBudget - kFixed) / (kConsumers * kPerStage);
  static constexpr int kDepth =
      kFit < kMinDepth ? kMinDepth : (kFit < kMaxDepth ? kFit : kMaxDepth);
  static constexpr int kStages = kConsumers * kDepth;
  static constexpr int kPosOff = kStages * kStage;
  static constexpr int kQOff = kPosOff + kStages * kTile * 4;
  static constexpr int kPOff = kQOff + kQ;
  static constexpr int kBarOff = kPOff + kP;
  static constexpr int kPartOff = kConsumers * kPart;         // after the warps' partials
  static constexpr int kBytes = 1024 + kBarOff + kStages * 16;
  static_assert(kRow % kBoxRow == 0, "D spans whole boxes");
  static_assert(kBarOff % 8 == 0, "mbarriers are 8-byte aligned");
  static_assert(kBytes <= kSmemMax, "a block's shared memory");
  static_assert((kConsumers + 1) * kPart <= kStages * kStage, "the partials reuse the stages");
};

// The byte offset of 16-byte chunk c of row r in a box written by the copy
// engine with the swizzle of its row width (128B: c ^ r % 8; 64B:
// c ^ (r / 2) % 4), the box aligned to 1024 bytes.
template <int kBoxRow>
__device__ __forceinline__ int swizzled(int r, int c) {
  if constexpr (kBoxRow == 128) return r * 128 + ((c ^ (r & 7)) << 4);
  else return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// One box of a tensor map into this block's shared memory; bar counts it.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// 4 bytes from global to shared memory by cp.async
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// an arrival on bar once the thread's earlier cp.async copies have landed
// (counted in the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// 16 bytes in shared memory, as f32
__device__ __forceinline__ void load16(const unsigned char* p, float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}

__device__ __forceinline__ void load16(const unsigned char* p, float (&o)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// E contiguous elements in shared memory, as f32
template <int E>
__device__ __forceinline__ void load_elems(const float* p, float (&o)[E]) {
  if constexpr (E == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  } else if constexpr (E == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x; o[1] = t.y;
  } else {
    o[0] = *p;
  }
}

template <int E>
__device__ __forceinline__ void load_elems(const __nv_bfloat16* p, float (&o)[E]) {
  if constexpr (E == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  } else if constexpr (E == 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = a.x; o[1] = a.y;
  } else {
    o[0] = __bfloat162float(*p);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Grid (B Hkv, n_split), cluster (1, n_split, 1); block y takes the slots
// [y per, min(S, (y + 1) per)). tk, tv: k, v as (Hkv D, S, B) with boxes of
// (kBoxRow bytes, 32, 1). Writes out (B, Hq, D) f32.
template <typename T, int G, int D>
__global__ void __launch_bounds__(kThreads)
decode_attn_cluster_kernel(const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const void* __restrict__ qv, int q_bf16,
                           const int* __restrict__ pos, long long idx, float* __restrict__ out,
                           int s_len, int hkv, int per, float scale) {
  using L = Layout<T, G, D>;
  constexpr int E = D / 32;                         // P V: a lane's columns
  constexpr int C = 16 / (int)sizeof(T);            // scores: elements in 16 bytes
  constexpr int kChunks = L::kBoxRow / 16;          // 16-byte chunks of a box's row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  int* pos_s = reinterpret_cast<int*>(smem + L::kPosOff);
  float* q_s = reinterpret_cast<float*>(smem + L::kQOff);
  float* p_s = reinterpret_cast<float*>(smem + L::kPOff);
  float* part = reinterpret_cast<float*>(smem + L::kPartOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* empty = full + L::kStages;

  const int bh = blockIdx.x, b = bh / hkv, h = bh - b * hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s_begin = blockIdx.y * per;
  const int s_end = min(s_len, s_begin + per);
  const int n_tiles = (s_end - s_begin + kTile - 1) / kTile;

  const long long q0 = (long long)bh * G * D;
  if (threadIdx.x == 0) {
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(&full[st], 1 + 32);   // the copy engine's bytes and the pos lanes
      mbar_init(&empty[st], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float m[G], lsum[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    lsum[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.0f;
  }

  if (warp == kConsumers) {
    // producer: tile t into stage t % kStages, once its consumer freed it
    const int* pb = pos + (long long)b * s_len;
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % L::kStages, round = t / L::kStages;
      const int s0 = s_begin + t * kTile;
      if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
      if (s0 + lane < s_end) cp_async4(pos_s + st * kTile + lane, pb + s0 + lane);
      cp_async_arrive(&full[st]);
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[st], (uint32_t)L::kStage);
        unsigned char* ks = smem + st * L::kStage;
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x) {
          const int col = h * D + x * (L::kBoxRow / (int)sizeof(T));
          tma_load_3d(ks + x * L::kBox, &tk, col, s0, b, &full[st]);
          tma_load_3d(ks + (L::kBoxes + x) * L::kBox, &tv, col, s0, b, &full[st]);
        }
      }
      __syncwarp();
    }
  } else {
    // this kv head's G query rows, upcast and scaled in f32, while the
    // producer's first copies are in flight; then a barrier of the
    // consumer warps alone
    for (int i = threadIdx.x; i < G * D; i += kConsumers * 32) {
      const float x = q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(qv)[q0 + i])
                             : static_cast<const float*>(qv)[q0 + i];
      q_s[i] = x * scale;
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers * 32) : "memory");
    float* pw = p_s + warp * G * kTile;
    const float4* q4 = reinterpret_cast<const float4*>(q_s);
    for (int t = warp; t < n_tiles; t += kConsumers) {
      const int st = t % L::kStages, round = t / L::kStages;
      const int cnt = min(kTile, s_end - (s_begin + t * kTile));
      mbar_wait(&full[st], round & 1);
      const unsigned char* ks = smem + st * L::kStage;
      const unsigned char* vs = ks + L::kBoxes * L::kBox;

      // scores of the tile: lane j takes slot j for every row, two partial
      // sums a row to halve the FMA chain
      float sc[G];
      if (lane < cnt) {
        float s0[G], s1[G];
#pragma unroll
        for (int g = 0; g < G; ++g) s0[g] = s1[g] = 0.0f;
#pragma unroll
        for (int c = 0; c < D / C; ++c) {
          float kx[C];
          load16(ks + (c / kChunks) * L::kBox + swizzled<L::kBoxRow>(lane, c % kChunks), kx);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float& s = (c & 1) ? s1[g] : s0[g];
#pragma unroll
            for (int e4 = 0; e4 < C / 4; ++e4) {
              const float4 qq = q4[(g * D + c * C) / 4 + e4];
              s = fmaf(qq.x, kx[4 * e4], s);
              s = fmaf(qq.y, kx[4 * e4 + 1], s);
              s = fmaf(qq.z, kx[4 * e4 + 2], s);
              s = fmaf(qq.w, kx[4 * e4 + 3], s);
            }
          }
        }
        const int p = pos_s[st * kTile + lane];
        const bool ok = p >= 0 && (long long)p <= idx;
#pragma unroll
        for (int g = 0; g < G; ++g) sc[g] = ok ? s0[g] + s1[g] : kNegInf;
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g) sc[g] = -__int_as_float(0x7f800000);  // -inf: weight 0
      }

      // one max and one rescale a tile and row
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float m_new = fmaxf(m[g], warp_max(sc[g]));
        const float alpha = expf(m[g] - m_new);
        const float p = expf(sc[g] - m_new);
        lsum[g] = lsum[g] * alpha + p;                 // a lane's share of l
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
        m[g] = m_new;
        pw[g * kTile + lane] = p;
      }
      __syncwarp();

      // P V, lanes across D: a lane's E columns lie in one 16-byte chunk
      constexpr int kLaneBytes = E * (int)sizeof(T);
      const int col = lane * kLaneBytes;
      const unsigned char* vbox = vs + (col / L::kBoxRow) * L::kBox;
      const int chunk = (col % L::kBoxRow) / 16, within = col % 16;
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        float vx[E];
        load_elems<E>(reinterpret_cast<const T*>(vbox + swizzled<L::kBoxRow>(j, chunk) + within),
                      vx);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pj = pw[g * kTile + j];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pj, vx[e], acc[g][e]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  }

  // every copy has landed and been read: the stages hold the warps' partials
  __syncwarp();                     // the producer's lanes reconverge before the barrier
  __syncthreads();
  float* wpart = reinterpret_cast<float*>(smem);              // [kConsumers][G][D + 2]
  if (warp < kConsumers) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float* wp = wpart + (warp * G + g) * (D + 2);
      const float l = warp_sum(lsum[g]);
#pragma unroll
      for (int e = 0; e < E; ++e) wp[lane * E + e] = acc[g][e];
      if (lane == 0) {
        wp[D] = m[g];
        wp[D + 1] = l;
      }
    }
  }
  __syncthreads();
  // the block's partial (a warp with no tile holds m = -1e30, l = 0, acc = 0)
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float mm = wpart[g * (D + 2) + D];
#pragma unroll
    for (int w = 1; w < kConsumers; ++w) mm = fmaxf(mm, wpart[(w * G + g) * (D + 2) + D]);
    float ll = 0.0f, aa = 0.0f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      const float* wp = wpart + (w * G + g) * (D + 2);
      const float wt = expf(wp[D] - mm);
      ll += wt * wp[D + 1];
      aa += wt * wp[d];
    }
    part[g * (D + 2) + d] = aa;
    if (d == 0) {
      part[g * (D + 2) + D] = mm;
      part[g * (D + 2) + D + 1] = ll;
    }
  }
  __syncwarp();

  // merge the cluster's partials through distributed shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n_split = (int)gridDim.y;
  const int rank = (int)cluster.block_rank();
  for (int i = rank * kThreads + threadIdx.x; i < G * D; i += n_split * kThreads) {
    const int g = i / D, d = i - g * D;
    // every block's (m, l, acc[d]) loaded at once, one round trip; the
    // ranks past n_split weigh nothing (l = acc = 0)
    float mr[kMaxSplit], lr[kMaxSplit], ar[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      mr[r] = kNegInf;
      lr[r] = ar[r] = 0.0f;
      if (r < n_split) {
        const float* pr = cluster.map_shared_rank(part, r) + g * (D + 2);
        mr[r] = pr[D];
        lr[r] = pr[D + 1];
        ar[r] = pr[d];
      }
    }
    float mm = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) mm = fmaxf(mm, mr[r]);
    float ll = 0.0f, aa = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      const float wt = expf(mr[r] - mm);
      ll += wt * lr[r];
      aa += wt * ar[r];
    }
    out[q0 + i] = aa / fmaxf(ll, 1e-20f);
  }
  __syncwarp();
  cluster.sync();                   // no block leaves while its partial is read
}

// ------------------------------------------------------------------ host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the CUDA driver API's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                          cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// k or v (B, S, Hkv, D) as (Hkv D, S, B), boxes of (box_row bytes, 32, 1)
bool kv_map(CUtensorMap* map, const void* base, bool bf16, int b, int s, int hkv, int d,
            int box_row) {
  const cuuint64_t es = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)hkv * d, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[2] = {dims[0] * es, dims[0] * es * s};
  const cuuint32_t box[3] = {(cuuint32_t)(box_row / es), (cuuint32_t)kTile, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return encode_tiled()(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        box_row == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The cluster launch of one instantiation at grid (pairs, n_split).
template <typename T, int G, int D>
cudaLaunchConfig_t launch_config(dim3 grid, cudaStream_t st, cudaLaunchAttribute* attr) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Layout<T, G, D>::kBytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Allow the instantiation its dynamic shared memory (once: one card a process).
template <typename T, int G, int D>
cudaError_t size_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      decode_attn_cluster_kernel<T, G, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<T, G, D>::kBytes);
  return err;
}

template <typename T>
struct Type {
  using type = T;
};
template <int V>
using Int = std::integral_constant<int, V>;

// f(Type<T>, Int<G>, Int<D>) for the cache type, G and D of a call
template <typename F>
cudaError_t dispatch(int kv_bf16, int g, int d, F&& f) {
  auto by_d = [&](auto t, auto gc) -> cudaError_t {
    switch (d) {
      case 32: return f(t, gc, Int<32>{});
      case 64: return f(t, gc, Int<64>{});
      case 128: return f(t, gc, Int<128>{});
      default: return cudaErrorInvalidValue;
    }
  };
  auto by_g = [&](auto t) -> cudaError_t {
    switch (g) {
      case 1: return by_d(t, Int<1>{});
      case 2: return by_d(t, Int<2>{});
      case 4: return by_d(t, Int<4>{});
      case 8: return by_d(t, Int<8>{});
      default: return cudaErrorInvalidValue;
    }
  };
  return kv_bf16 ? by_g(Type<__nv_bfloat16>{}) : by_g(Type<float>{});
}

bool plan_ok(long long pairs, int s, int n_split, int per) {
  return pairs > 0 && pairs < (1LL << 31) && s > 0 && n_split >= 1 && n_split <= kMaxSplit &&
         per >= 1 && (long long)(n_split - 1) * per < s && (long long)n_split * per >= s;
}

}  // namespace

// q (B, Hq, D) f32 or bf16 (q_bf16); k, v (B, S, Hkv, D) f32 or bf16
// (kv_bf16), 16-byte aligned; pos (B, S) int32; out (B, Hq, D) f32.
// G in {1, 2, 4, 8}, D in {32, 64, 128}, S >= 1; the S slots are split into
// n_split <= 8 non-empty runs of per slots (the last may be shorter).
extern "C" int repro_decode_attention(const void* q, int q_bf16, const void* k, const void* v,
                                      int kv_bf16, const void* pos, long long idx, void* out,
                                      int b, int s, int hkv, int g, int d, int n_split, int per,
                                      float scale, void* stream) {
  if (b <= 0 || hkv <= 0 || !plan_ok((long long)b * hkv, s, n_split, per))
    return cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const dim3 grid(b * hkv, n_split);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dispatch(kv_bf16, g, d, [&](auto t, auto gc, auto dc) {
    using T = typename decltype(t)::type;
    constexpr int G = decltype(gc)::value, D = decltype(dc)::value;
    using L = Layout<T, G, D>;
    CUtensorMap tk, tv;
    const bool bf16 = std::is_same<T, __nv_bfloat16>::value;
    if (!kv_map(&tk, k, bf16, b, s, hkv, D, L::kBoxRow) ||
        !kv_map(&tv, v, bf16, b, s, hkv, D, L::kBoxRow))
      return cudaErrorInvalidValue;
    const cudaError_t e = size_smem<T, G, D>();
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config<T, G, D>(grid, st, attr);
    return cudaLaunchKernelEx(&cfg, decode_attn_cluster_kernel<T, G, D>, tk, tv, q, q_bf16,
                              static_cast<const int*>(pos), idx, static_cast<float*>(out), s,
                              hkv, per, scale);
  });
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of n_split blocks of the instantiation the card holds at
// once (cudaOccupancyMaxActiveClusters), written to *clusters: the wave the
// wrapper's split planner fills. Returns the cudaError_t.
extern "C" int repro_decode_attention_max_clusters(int kv_bf16, int g, int d, int n_split,
                                                   int* clusters) {
  if (n_split < 1 || n_split > kMaxSplit) return cudaErrorInvalidValue;
  return dispatch(kv_bf16, g, d, [&](auto t, auto gc, auto dc) {
    using T = typename decltype(t)::type;
    constexpr int G = decltype(gc)::value, D = decltype(dc)::value;
    const cudaError_t e = size_smem<T, G, D>();
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config<T, G, D>(dim3(n_split, n_split), nullptr, attr);
    return cudaOccupancyMaxActiveClusters(clusters, decode_attn_cluster_kernel<T, G, D>, &cfg);
  });
}
