// The decode attention kernel of decode_attn.cu (see there for what it
// computes and how), as templates over the cache's element type, the rows a
// block and D, with the host code that launches one instantiation. The
// instantiations are split over one translation unit a cache type
// (decode_attn_f32.cu, decode_attn_bf16.cu, decode_attn_i8.cu), which nvcc
// builds in parallel; decode_attn.cu holds the C entry points.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mbarrier.cuh"

namespace cg = cooperative_groups;

namespace decode_attn {

constexpr int kConsumers = 2;                     // consumer warps a block
constexpr int kThreads = (kConsumers + 1) * 32;   // and one producer warp
constexpr int kTile = 32;                         // slots a stage: one a lane
constexpr int kMaxSplit = 8;                      // the portable cluster size
constexpr int kMinDepth = 2;                      // stages a consumer warp owns:
constexpr int kMaxDepth = 4;                      // a ring of 4 to 8 stages
// the aim, three blocks an SM: a third of the SM's 233 472 bytes, less 1 KB
// reserved; a ring of kMinDepth a warp that does not fit takes more (an
// f32 cache with D = 128: one block an SM), and one of a single stage a
// warp where kMinDepth does not fit at all (an f32 cache with D = 256)
constexpr int kSmemBudget = 233472 / 3 - 1024;
constexpr int kSmemMax = 232448;                  // what one block may use
constexpr float kNegInf = -1e30f;

enum KvType { kF32 = 0, kBf16 = 1, kInt8 = 2 };

// Dynamic shared memory of one block, from a 1024-byte aligned base:
// [stages: k boxes, v boxes][pos (and k_scale, v_scale)][q][p][barriers];
// once drained, the stages hold the warps' partials and then the block's
// (part). R: the block's (padded) query rows.
template <typename T, int R, int D>
struct Layout {
  static constexpr bool kScaled = std::is_same<T, int8_t>::value;
  static constexpr int kRow = D * (int)sizeof(T);             // one slot's row
  static constexpr int kBoxRow = kRow < 128 ? kRow : 128;     // a box's row: 32, 64 or 128 bytes
  static constexpr int kBoxes = kRow / kBoxRow;               // boxes across D
  static constexpr int kBox = kTile * kBoxRow;                // bytes of one box
  static constexpr int kStage = 2 * kBoxes * kBox;            // k boxes, then v
  static constexpr int kSlotArrays = kScaled ? 3 : 1;         // pos (, k_scale, v_scale)
  static constexpr int kQ = R * D * 4;
  static constexpr int kP = kConsumers * R * kTile * 4;
  static constexpr int kPart = R * (D + 2) * 4;               // acc[D], m, l a row
  static constexpr int kPerStage = kStage + kSlotArrays * kTile * 4 + 16;   // + 2 barriers
  static constexpr int kFixed = 1024 + kQ + kP;               // + alignment slack
  static constexpr int kFit = (kSmemBudget - kFixed) / (kConsumers * kPerStage);
  static constexpr int kFitMax = (kSmemMax - kFixed) / (kConsumers * kPerStage);
  static constexpr int kFloor = kFitMax < kMinDepth ? kFitMax : kMinDepth;
  static constexpr int kDepth = kFit < kFloor ? kFloor : (kFit < kMaxDepth ? kFit : kMaxDepth);
  static constexpr int kStages = kConsumers * kDepth;
  static constexpr int kPosOff = kStages * kStage;
  static constexpr int kKscOff = kPosOff + kStages * kTile * 4;   // int8 cache only
  static constexpr int kVscOff = kKscOff + kStages * kTile * 4;
  static constexpr int kQOff = kPosOff + kSlotArrays * kStages * kTile * 4;
  static constexpr int kPOff = kQOff + kQ;
  static constexpr int kBarOff = kPOff + kP;
  static constexpr int kPartOff = kConsumers * kPart;         // after the warps' partials
  static constexpr int kBytes = 1024 + kBarOff + kStages * 16;
  static_assert(kRow % kBoxRow == 0, "D spans whole boxes");
  static_assert(kBoxRow == 32 || kBoxRow == 64 || kBoxRow == 128, "a swizzled box row");
  static_assert(kDepth >= 1, "one stage a consumer warp fits");
  static_assert(kBarOff % 8 == 0, "mbarriers are 8-byte aligned");
  static_assert(kBytes <= kSmemMax, "a block's shared memory");
  static_assert((kConsumers + 1) * kPart <= kStages * kStage, "the partials reuse the stages");
};

// The byte offset of 16-byte chunk c of row r in a box written by the copy
// engine with the swizzle of its row width (128B: c ^ r % 8; 64B:
// c ^ (r / 2) % 4; 32B: c ^ (r / 4) % 2), the box aligned to 1024 bytes.
template <int kBoxRow>
__device__ __forceinline__ int swizzled(int r, int c) {
  if constexpr (kBoxRow == 128) return r * 128 + ((c ^ (r & 7)) << 4);
  else if constexpr (kBoxRow == 64) return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
  else return r * 32 + ((c ^ ((r >> 2) & 1)) << 4);
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

__device__ __forceinline__ void bf16x2(uint32_t w, float* o) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  o[0] = f.x;
  o[1] = f.y;
}

__device__ __forceinline__ void load16(const unsigned char* p, float (&o)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  bf16x2(t.x, o); bf16x2(t.y, o + 2); bf16x2(t.z, o + 4); bf16x2(t.w, o + 6);
}

// four int8 codes of a word, as f32 (exact)
__device__ __forceinline__ void s8x4(uint32_t w, float* o) {
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = (float)(int8_t)(w >> (8 * j));
}

__device__ __forceinline__ void load16(const unsigned char* p, float (&o)[16]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  s8x4(t.x, o); s8x4(t.y, o + 4); s8x4(t.z, o + 8); s8x4(t.w, o + 12);
}

// E contiguous elements (at most 16 bytes, aligned to their size) in shared
// memory, as f32
template <int E>
__device__ __forceinline__ void load_elems(const float* p, float* o) {
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
__device__ __forceinline__ void load_elems(const __nv_bfloat16* p, float* o) {
  if constexpr (E == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    bf16x2(t.x, o); bf16x2(t.y, o + 2); bf16x2(t.z, o + 4); bf16x2(t.w, o + 6);
  } else if constexpr (E == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    bf16x2(t.x, o); bf16x2(t.y, o + 2);
  } else if constexpr (E == 2) {
    bf16x2(*reinterpret_cast<const uint32_t*>(p), o);
  } else {
    o[0] = __bfloat162float(*p);
  }
}

template <int E>
__device__ __forceinline__ void load_elems(const int8_t* p, float* o) {
  if constexpr (E == 8) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    s8x4(t.x, o); s8x4(t.y, o + 4);
  } else if constexpr (E == 4) {
    s8x4(*reinterpret_cast<const uint32_t*>(p), o);
  } else if constexpr (E == 2) {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(p);
    o[0] = (float)(int8_t)w;
    o[1] = (float)(int8_t)(w >> 8);
  } else {
    o[0] = (float)*p;
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

// Grid (B Hkv, n_split, ceil(g / R)), cluster (1, n_split, 1); block (x, y,
// z) takes the slots [y per, min(S, (y + 1) per)) for the query rows [z R,
// min(g, (z + 1) R)) of its kv head. tk, tv: k, v as (Hkv D, S, B) with
// boxes of (kBoxRow bytes, 32, 1); ksc, vsc: (B, S, Hkv) f32 for an int8
// cache (else unused). Writes out (B, Hq, D) f32 and, where lse is not null,
// each row's log-sum-exp m + log l (B, Hq) f32: l the sum of the row's
// probabilities before an int8 cache's v-scales, an empty row's -1e30 + log S.
template <typename T, int R, int D>
__global__ void __launch_bounds__(kThreads)
decode_attn_cluster_kernel(const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const void* __restrict__ qv, int q_bf16,
                           const int* __restrict__ pos, const float* __restrict__ ksc,
                           const float* __restrict__ vsc, long long idx, int window,
                           float* __restrict__ out, float* __restrict__ lse, int s_len,
                           int hkv, int g, int per, float scale) {
  using L = Layout<T, R, D>;
  constexpr int E = D / 32;                         // P V: a lane's columns
  constexpr int C = 16 / (int)sizeof(T);            // scores: elements in 16 bytes
  constexpr int kChunks = L::kBoxRow / 16;          // 16-byte chunks of a box's row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  int* pos_s = reinterpret_cast<int*>(smem + L::kPosOff);
  float* ksc_s = reinterpret_cast<float*>(smem + L::kKscOff);
  float* vsc_s = reinterpret_cast<float*>(smem + L::kVscOff);
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
  const int r0 = blockIdx.z * R;                    // this block's first row of the kv head
  const int rows = min(R, g - r0);                  // its real rows; the rest are padding
  // the first valid position: a slot is valid iff lo <= pos <= idx
  const long long lo = window > 0 ? max(0LL, idx - window + 1) : 0LL;

  const long long q0 = ((long long)bh * g + r0) * D;
  if (threadIdx.x == 0) {
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(&full[st], 1 + 32);   // the copy engine's bytes and the slot lanes
      mbar_init(&empty[st], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float m[R], lsum[R], acc[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    lsum[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.0f;
  }

  if (warp == kConsumers) {
    // producer: tile t into stage t % kStages, once its consumer freed it
    const long long slot0 = (long long)b * s_len;
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % L::kStages, round = t / L::kStages;
      const int s0 = s_begin + t * kTile;
      if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
      if (s0 + lane < s_end) {
        const long long slot = slot0 + s0 + lane;
        cp_async4(pos_s + st * kTile + lane, pos + slot);
        if constexpr (L::kScaled) {
          cp_async4(ksc_s + st * kTile + lane, ksc + slot * hkv + h);
          cp_async4(vsc_s + st * kTile + lane, vsc + slot * hkv + h);
        }
      }
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
    // this block's query rows, upcast and scaled in f32 (padding rows 0),
    // while the producer's first copies are in flight; then a barrier of
    // the consumer warps alone
    for (int i = threadIdx.x; i < R * D; i += kConsumers * 32) {
      float x = 0.0f;
      if (i < rows * D)
        x = q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(qv)[q0 + i])
                   : static_cast<const float*>(qv)[q0 + i];
      q_s[i] = x * scale;
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers * 32) : "memory");
    float* pw = p_s + warp * R * kTile;
    const float4* q4 = reinterpret_cast<const float4*>(q_s);
    for (int t = warp; t < n_tiles; t += kConsumers) {
      const int st = t % L::kStages, round = t / L::kStages;
      const int cnt = min(kTile, s_end - (s_begin + t * kTile));
      mbar_wait(&full[st], round & 1);
      const unsigned char* ks = smem + st * L::kStage;
      const unsigned char* vs = ks + L::kBoxes * L::kBox;

      // scores of the tile: lane j takes slot j for every row, two partial
      // sums a row to halve the FMA chain
      float sc[R];
      float vscale = 0.0f;                          // the slot's v_scale (int8 cache)
      if (lane < cnt) {
        float s0[R], s1[R];
#pragma unroll
        for (int r = 0; r < R; ++r) s0[r] = s1[r] = 0.0f;
#pragma unroll
        for (int c = 0; c < D / C; ++c) {
          float kx[C];
          load16(ks + (c / kChunks) * L::kBox + swizzled<L::kBoxRow>(lane, c % kChunks), kx);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float& s = (c & 1) ? s1[r] : s0[r];
#pragma unroll
            for (int e4 = 0; e4 < C / 4; ++e4) {
              const float4 qq = q4[(r * D + c * C) / 4 + e4];
              s = fmaf(qq.x, kx[4 * e4], s);
              s = fmaf(qq.y, kx[4 * e4 + 1], s);
              s = fmaf(qq.z, kx[4 * e4 + 2], s);
              s = fmaf(qq.w, kx[4 * e4 + 3], s);
            }
          }
        }
        const long long p = pos_s[st * kTile + lane];
        const bool ok = p >= lo && p <= idx;
        float kscale = 1.0f;
        if constexpr (L::kScaled) {
          kscale = ksc_s[st * kTile + lane];
          vscale = vsc_s[st * kTile + lane];
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float x = s0[r] + s1[r];
          if constexpr (L::kScaled) x *= kscale;
          sc[r] = ok ? x : kNegInf;
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) sc[r] = -__int_as_float(0x7f800000);  // -inf: weight 0
      }

      // one max and one rescale a tile and row; an int8 cache's slot
      // weight p is added into l before it is scaled by v_scale
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float m_new = fmaxf(m[r], warp_max(sc[r]));
        const float alpha = expf(m[r] - m_new);
        const float p = expf(sc[r] - m_new);
        lsum[r] = lsum[r] * alpha + p;                 // a lane's share of l
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
        m[r] = m_new;
        pw[r * kTile + lane] = L::kScaled ? p * vscale : p;
      }
      __syncwarp();

      // P V, lanes across D: a lane's E columns, in pieces of at most 16
      // bytes, each within one 16-byte chunk of a box's row
      constexpr int kLaneBytes = E * (int)sizeof(T);
      constexpr int kPiece = kLaneBytes < 16 ? kLaneBytes : 16;
      constexpr int kPieces = kLaneBytes / kPiece;
      constexpr int EP = E / kPieces;
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        float vx[E];
#pragma unroll
        for (int pc = 0; pc < kPieces; ++pc) {
          const int col = lane * kLaneBytes + pc * kPiece;
          const unsigned char* vbox = vs + (col / L::kBoxRow) * L::kBox;
          load_elems<EP>(reinterpret_cast<const T*>(
                             vbox + swizzled<L::kBoxRow>(j, (col % L::kBoxRow) / 16) + col % 16),
                         vx + pc * EP);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float pj = pw[r * kTile + j];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[r][e] = fmaf(pj, vx[e], acc[r][e]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  }

  // every copy has landed and been read: the stages hold the warps' partials
  __syncwarp();                     // the producer's lanes reconverge before the barrier
  __syncthreads();
  float* wpart = reinterpret_cast<float*>(smem);              // [kConsumers][R][D + 2]
  if (warp < kConsumers) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float* wp = wpart + (warp * R + r) * (D + 2);
      const float l = warp_sum(lsum[r]);
#pragma unroll
      for (int e = 0; e < E; ++e) wp[lane * E + e] = acc[r][e];
      if (lane == 0) {
        wp[D] = m[r];
        wp[D + 1] = l;
      }
    }
  }
  __syncthreads();
  // the block's partial (a warp with no tile holds m = -1e30, l = 0, acc = 0)
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    float mm = wpart[r * (D + 2) + D];
#pragma unroll
    for (int w = 1; w < kConsumers; ++w) mm = fmaxf(mm, wpart[(w * R + r) * (D + 2) + D]);
    float ll = 0.0f, aa = 0.0f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      const float* wp = wpart + (w * R + r) * (D + 2);
      const float wt = expf(wp[D] - mm);
      ll += wt * wp[D + 1];
      aa += wt * wp[d];
    }
    part[r * (D + 2) + d] = aa;
    if (d == 0) {
      part[r * (D + 2) + D] = mm;
      part[r * (D + 2) + D + 1] = ll;
    }
  }
  __syncwarp();

  // merge the cluster's partials through distributed shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n_split = (int)gridDim.y;
  const int rank = (int)cluster.block_rank();
  for (int i = rank * kThreads + threadIdx.x; i < rows * D; i += n_split * kThreads) {
    const int r = i / D, d = i - r * D;
    // every block's (m, l, acc[d]) loaded at once, one round trip; the
    // ranks past n_split weigh nothing (l = acc = 0)
    float mr[kMaxSplit], lr[kMaxSplit], ar[kMaxSplit];
#pragma unroll
    for (int c = 0; c < kMaxSplit; ++c) {
      mr[c] = kNegInf;
      lr[c] = ar[c] = 0.0f;
      if (c < n_split) {
        const float* pr = cluster.map_shared_rank(part, c) + r * (D + 2);
        mr[c] = pr[D];
        lr[c] = pr[D + 1];
        ar[c] = pr[d];
      }
    }
    float mm = kNegInf;
#pragma unroll
    for (int c = 0; c < kMaxSplit; ++c) mm = fmaxf(mm, mr[c]);
    float ll = 0.0f, aa = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxSplit; ++c) {
      const float wt = expf(mr[c] - mm);
      ll += wt * lr[c];
      aa += wt * ar[c];
    }
    out[q0 + i] = aa / fmaxf(ll, 1e-20f);
    if (lse != nullptr && d == 0) lse[q0 / D + r] = mm + logf(ll);
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
inline EncodeTiled encode_tiled() {
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

// k or v (B, S, Hkv, D) of T as (Hkv D, S, B), boxes of (box_row bytes, 32, 1)
template <typename T>
bool kv_map(CUtensorMap* map, const void* base, int b, int s, int hkv, int d, int box_row) {
  constexpr cuuint64_t es = sizeof(T);
  const cuuint64_t dims[3] = {(cuuint64_t)hkv * d, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[2] = {dims[0] * es, dims[0] * es * s};
  const cuuint32_t box[3] = {(cuuint32_t)(box_row / es), (cuuint32_t)kTile, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      std::is_same<T, float>::value           ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                              : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUtensorMapSwizzle swizzle = box_row == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_row == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                     : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_tiled()(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The cluster launch of one instantiation at grid (pairs, n_split, groups).
template <typename T, int R, int D>
cudaLaunchConfig_t launch_config(dim3 grid, cudaStream_t st, cudaLaunchAttribute* attr) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Layout<T, R, D>::kBytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Allow the instantiation its dynamic shared memory (once: one card a process).
template <typename T, int R, int D>
cudaError_t size_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      decode_attn_cluster_kernel<T, R, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<T, R, D>::kBytes);
  return err;
}

template <int V>
using Int = std::integral_constant<int, V>;

// f(Int<R>, Int<D>) for the rows a block and D of a call: R in {1, 2, 4, 8,
// 16} (at most 8 where D = 256), D in {32, 64, 128, 256}
template <typename F>
cudaError_t dispatch(int rows, int d, F&& f) {
  auto by_d = [&](auto rc) -> cudaError_t {
    switch (d) {
      case 32: return f(rc, Int<32>{});
      case 64: return f(rc, Int<64>{});
      case 128: return f(rc, Int<128>{});
      case 256:
        if constexpr (decltype(rc)::value <= 8) return f(rc, Int<256>{});
        else return cudaErrorInvalidValue;
      default: return cudaErrorInvalidValue;
    }
  };
  switch (rows) {
    case 1: return by_d(Int<1>{});
    case 2: return by_d(Int<2>{});
    case 4: return by_d(Int<4>{});
    case 8: return by_d(Int<8>{});
    case 16: return by_d(Int<16>{});
    default: return cudaErrorInvalidValue;
  }
}

// One launch's arguments, as repro_decode_attention takes them.
struct Args {
  const void* q;
  int q_bf16;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* pos;
  long long idx;
  int window;
  float* out;
  float* lse;
  int b, s, hkv, g, rows, d, n_split, per;
  float scale;
  cudaStream_t stream;
};

// The launch of the instantiation of T that the call's rows and D select.
template <typename T>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.b * a.hkv, a.n_split, (unsigned)((a.g + a.rows - 1) / a.rows));
  return dispatch(a.rows, a.d, [&](auto rc, auto dc) {
    constexpr int R = decltype(rc)::value, D = decltype(dc)::value;
    using L = Layout<T, R, D>;
    CUtensorMap tk, tv;
    if (!kv_map<T>(&tk, a.k, a.b, a.s, a.hkv, D, L::kBoxRow) ||
        !kv_map<T>(&tv, a.v, a.b, a.s, a.hkv, D, L::kBoxRow))
      return cudaErrorInvalidValue;
    const cudaError_t e = size_smem<T, R, D>();
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config<T, R, D>(grid, a.stream, attr);
    return cudaLaunchKernelEx(&cfg, decode_attn_cluster_kernel<T, R, D>, tk, tv, a.q, a.q_bf16,
                              a.pos, a.k_scale, a.v_scale, a.idx, a.window, a.out, a.lse, a.s,
                              a.hkv, a.g, a.per, a.scale);
  });
}

// cudaOccupancyMaxActiveClusters of the instantiation of T, rows and D in
// clusters of n_split blocks.
template <typename T>
cudaError_t max_clusters(int rows, int d, int n_split, int* clusters) {
  return dispatch(rows, d, [&](auto rc, auto dc) {
    constexpr int R = decltype(rc)::value, D = decltype(dc)::value;
    const cudaError_t e = size_smem<T, R, D>();
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        launch_config<T, R, D>(dim3(n_split, n_split, 1), nullptr, attr);
    return cudaOccupancyMaxActiveClusters(clusters, decode_attn_cluster_kernel<T, R, D>, &cfg);
  });
}

// the instantiations of one cache type, each in its own translation unit
cudaError_t launch_f32(const Args& a);
cudaError_t launch_bf16(const Args& a);
cudaError_t launch_i8(const Args& a);
cudaError_t max_clusters_f32(int rows, int d, int n_split, int* clusters);
cudaError_t max_clusters_bf16(int rows, int d, int n_split, int* clusters);
cudaError_t max_clusters_i8(int rows, int d, int n_split, int* clusters);

}  // namespace decode_attn
