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
// once for at most 8 query rows, so the work is 4 G flops per 2 D-element
// row pair, far below the ridge; the least time is the cache's bytes over
// the HBM rate. B Hkv is small at decode (32 at qwen3-1.7b's batch 4), so
// the design is split-S flash decoding: kernel 1 gives each block one
// (b, kv head) pair and a contiguous range of `split` slots; each warp walks
// its slots in groups of kUnroll (loads of the group issued before the math,
// so kUnroll rows of k and v are in flight per warp), lanes across D (E = D /
// 32 contiguous elements a lane, one vector load), a shuffle all-reduce for
// each of the G dot products, and an online (m, l, acc[G][E]) in registers.
// The block merges its warps through shared memory and writes one partial
// (m, l, acc) to an f32 workspace. Kernel 2 merges the partials of each
// (b, kv head): m = max m_c, w_c = exp(m_c - m),
// out = sum w_c acc_c / max(sum w_c l_c, 1e-20). No tensor cores: G <= 8
// query rows per KV row leave nothing for them to do.
//
// C interface for ctypes: pointers as void*, the CUDA stream as void*, and
// the return value is cudaGetLastError() after the launches. The workspace
// is allocated by the caller; nothing is allocated here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;       // slots a warp loads before it computes
constexpr int kMergeThreads = 256;
constexpr float kNegInf = -1e30f;

// E contiguous elements at p, as f32 (p aligned to E elements)
template <int E>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float (&o)[E]) {
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
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p, float (&o)[E]) {
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

// Grid (B Hkv, n_split). Writes the block's partial for each of its G rows:
// part_acc[(bh n_split + split) G + g][D], part_ml[...][2] = (m, l).
template <typename T, int G, int E>
__global__ void __launch_bounds__(kThreads)
decode_attn_partial(const void* __restrict__ qv, int q_bf16, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos, long long idx,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int s_len, int hkv, int split, float scale) {
  constexpr int D = 32 * E;
  __shared__ float sm_ml[kWarps][2][G];
  __shared__ float sm_acc[kWarps][G][D];

  const int bh = blockIdx.x, b = bh / hkv, h = bh - b * hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // this kv head's G query rows, upcast and scaled in f32, the lane's columns
  float q[G][E];
  const long long q0 = (long long)bh * G * D + lane * E;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const long long i = q0 + (long long)g * D + e;
      const float x = q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(qv)[i])
                             : static_cast<const float*>(qv)[i];
      q[g][e] = x * scale;
    }

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.0f;
  }

  const int s_begin = blockIdx.y * split;
  const int s_end = min(s_len, s_begin + split);
  const long long row = (long long)hkv * D;                 // between slots
  const long long base = ((long long)b * s_len * hkv + h) * D + lane * E;
  const int* pb = pos + (long long)b * s_len;

  for (int s0 = s_begin + warp * kUnroll; s0 < s_end; s0 += kWarps * kUnroll) {
    float kr[kUnroll][E], vr[kUnroll][E];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      if (s < s_end) {
        load_row<E>(k + base + s * row, kr[u]);
        load_row<E>(v + base + s * row, vr[u]);
        const int p = pb[s];
        ok[u] = p >= 0 && (long long)p <= idx;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s0 + u >= s_end) break;                            // warp-uniform
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(q[g][e], kr[u][e], dot);
        dot = warp_sum(dot);
        const float sc = ok[u] ? dot : kNegInf;
        const float m_new = fmaxf(m[g], sc);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(sc - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = acc[g][e] * alpha + p * vr[u][e];
        m[g] = m_new;
      }
    }
  }

  // merge the warps (a warp with no slots holds m = -1e30, l = 0, acc = 0)
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm_ml[warp][0][g] = m[g];
      sm_ml[warp][1][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][g][lane * E + e] = acc[g][e];
  __syncthreads();
  const long long out0 = ((long long)bh * gridDim.y + blockIdx.y) * G;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float mm = sm_ml[0][0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, sm_ml[w][0][g]);
    float ll = 0.0f, aa = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(sm_ml[w][0][g] - mm);
      ll += wt * sm_ml[w][1][g];
      aa += wt * sm_acc[w][g][d];
    }
    part_acc[out0 * D + i] = aa;
    if (d == 0) {
      part_ml[(out0 + g) * 2] = mm;
      part_ml[(out0 + g) * 2 + 1] = ll;
    }
  }
}

// Grid (B Hkv): merges the n_split partials of each of the G rows.
__global__ void __launch_bounds__(kMergeThreads)
decode_attn_merge(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                  float* __restrict__ out, int n_split, int g_rows, int d_head) {
  const long long bh = blockIdx.x;
  const float* ml = part_ml + bh * n_split * g_rows * 2;
  const float* acc = part_acc + bh * n_split * g_rows * d_head;
  for (int i = threadIdx.x; i < g_rows * d_head; i += kMergeThreads) {
    const int g = i / d_head;
    float mm = ml[g * 2];
    for (int c = 1; c < n_split; ++c) mm = fmaxf(mm, ml[(c * g_rows + g) * 2]);
    float ll = 0.0f, aa = 0.0f;
    for (int c = 0; c < n_split; ++c) {
      const float wt = expf(ml[(c * g_rows + g) * 2] - mm);
      ll += wt * ml[(c * g_rows + g) * 2 + 1];
      aa += wt * acc[(long long)c * g_rows * d_head + i];
    }
    out[bh * g_rows * d_head + i] = aa / fmaxf(ll, 1e-20f);
  }
}

template <typename T, int G>
bool launch_partial(int e, dim3 grid, cudaStream_t st, const void* q, int q_bf16,
                    const void* k, const void* v, const int* pos, long long idx,
                    float* part_acc, float* part_ml, int s, int hkv, int split, float scale) {
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  switch (e) {
    case 1:
      decode_attn_partial<T, G, 1><<<grid, kThreads, 0, st>>>(
          q, q_bf16, kt, vt, pos, idx, part_acc, part_ml, s, hkv, split, scale);
      return true;
    case 2:
      decode_attn_partial<T, G, 2><<<grid, kThreads, 0, st>>>(
          q, q_bf16, kt, vt, pos, idx, part_acc, part_ml, s, hkv, split, scale);
      return true;
    case 4:
      decode_attn_partial<T, G, 4><<<grid, kThreads, 0, st>>>(
          q, q_bf16, kt, vt, pos, idx, part_acc, part_ml, s, hkv, split, scale);
      return true;
    default:
      return false;
  }
}

template <typename T>
bool launch_g(int g, int e, dim3 grid, cudaStream_t st, const void* q, int q_bf16,
              const void* k, const void* v, const int* pos, long long idx, float* part_acc,
              float* part_ml, int s, int hkv, int split, float scale) {
  switch (g) {
    case 1: return launch_partial<T, 1>(e, grid, st, q, q_bf16, k, v, pos, idx, part_acc,
                                        part_ml, s, hkv, split, scale);
    case 2: return launch_partial<T, 2>(e, grid, st, q, q_bf16, k, v, pos, idx, part_acc,
                                        part_ml, s, hkv, split, scale);
    case 4: return launch_partial<T, 4>(e, grid, st, q, q_bf16, k, v, pos, idx, part_acc,
                                        part_ml, s, hkv, split, scale);
    case 8: return launch_partial<T, 8>(e, grid, st, q, q_bf16, k, v, pos, idx, part_acc,
                                        part_ml, s, hkv, split, scale);
    default: return false;
  }
}

}  // namespace

// q (B, Hq, D) f32 or bf16 (q_bf16); k, v (B, S, Hkv, D) f32 or bf16
// (kv_bf16), 16-byte aligned; pos (B, S) int32; out (B, Hq, D) f32;
// part_acc (B Hkv, n_split, G, D) and part_ml (B Hkv, n_split, G, 2) f32 with
// n_split = ceil(S / split). G in {1, 2, 4, 8}, D in {32, 64, 128}, S >= 1.
extern "C" int repro_decode_attention(const void* q, int q_bf16, const void* k, const void* v,
                                      int kv_bf16, const void* pos, long long idx,
                                      void* part_acc, void* part_ml, void* out, int b, int s,
                                      int hkv, int g, int d, int split, float scale,
                                      void* stream) {
  if (b <= 0 || s <= 0 || hkv <= 0 || split <= 0 || d % 32 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_split = (s + split - 1) / split;
  const dim3 grid(b * hkv, n_split);
  const int* p = static_cast<const int*>(pos);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  const bool ok = kv_bf16
      ? launch_g<__nv_bfloat16>(g, d / 32, grid, st, q, q_bf16, k, v, p, idx, pa, pm, s, hkv,
                                split, scale)
      : launch_g<float>(g, d / 32, grid, st, q, q_bf16, k, v, p, idx, pa, pm, s, hkv, split,
                        scale);
  if (!ok) return cudaErrorInvalidValue;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attn_merge<<<b * hkv, kMergeThreads, 0, st>>>(pa, pm, static_cast<float*>(out), n_split,
                                                       g, d);
  return cudaGetLastError();
}
