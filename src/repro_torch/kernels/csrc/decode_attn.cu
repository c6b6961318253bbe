// GQA flash-decode attention over a (ring) KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attn.py::
// decode_attention (_kernel), and computes what the reference model's
// _flash_decode computes around it (src/repro/models/attention.py): one
// query token per sequence, q (B, Hq, D), attends over the cache k, v (B,
// S, Hkv, D); query head h G + j reads KV head h (G = Hq / Hkv, any G >= 1).
// The position map pos (B, S) masks the slots: a slot is valid iff 0 <= pos
// <= idx and, with a window W > 0, pos > idx - W. The cache is f32, bf16 or
// int8 codes; an int8 cache comes with per-(slot, kv head) f32 scales
// k_scale, v_scale (B, S, Hkv), and then a score is (q D^-0.5) . codes x
// k_scale[slot] and a probability is multiplied by v_scale[slot] after it
// is added into the row's sum l, as the reference's l_c = p.sum(-1) and
// then p * vsc. It computes in f32 throughout (where the reference rounds q
// * scale and the probabilities to a bf16 cache's or q's dtype, this kernel
// keeps them f32): an invalid score set to -1e30 (not -inf, so a row with
// no valid slot gives the mean of v, or of v_scale x codes, as the
// reference does), softmax and P V in f32, and an f32 output. Slots at or
// past S are not read: the TPU kernel's last block reads past a ragged S,
// which this kernel does not copy.
//
// Bound on the H100: bytes. Each (b, kv head) pair reads S rows of k and v
// once for G query rows (4 G flops per row pair of D elements), far below
// the ridge, so the least time is the cache's bytes over the HBM rate. No
// tensor cores: the rows of a block fill at most one mma's 16, and bf16
// operands would change q's rounding.
//
// Design: one launch. B Hkv is small at decode (32 at qwen3-1.7b's batch 4,
// 4 at recurrentgemma-9b's), so S is split over the blocks of a thread
// block cluster (grid (B Hkv, n_split, row groups), cluster (1, n_split,
// 1), n_split <= 8, the portable size). A block takes R query rows of its kv
// head, R a template of 1, 2, 4, 8 or 16 (at most 8 where D = 256, which
// keeps a lane's accumulators at 64 floats); the wrapper picks the least R
// that holds G, or R = 16 (8) and ceil(G / R) row groups on the grid's z
// axis, so no G is refused. The real g comes at run time: rows of a block
// at or past g are zero in shared memory, never loaded from q and never
// stored. The wrapper's planner gives each split a run of whole 32-slot
// tiles, so no copy fetches a slot of the next split, and as many splits as
// let the grid fit in one wave of the clusters that
// repro_decode_attention_max_clusters says the card holds at once. A block
// is one producer warp and kConsumers consumer warps over a ring of kStages
// stages in shared memory, each stage a tile of k, v and pos (and, for an
// int8 cache, the two scales) of this block's kv head, guarded by a pair of
// mbarriers (full: the tile's bytes have landed; empty: its consumer is
// done with it). The producer's lane 0 fetches a tile's k and v with the
// Tensor Memory Accelerator, through 3-D tensor maps over (Hkv D, S, B),
// one box of (at most 128 bytes of a row, 32 slots) per 128 bytes of D,
// swizzled so the consumers' reads hit distinct banks; slots at or past S
// are filled with zeros by the copy engine, never read. Its 32 lanes bring
// the tile's pos (and scales) in with it, one 4-byte cp.async a slot and
// array, whose completion arrives on the same barrier (a tile of pos starts
// at b S + s0, which a tensor map's 16-byte aligned boxes cannot take for
// every S). The ring holds two to four stages a consumer warp, one where
// two do not fit in a block's shared memory (an f32 cache at D = 256: a
// stage is 64 KB). Consumer warp w takes the tiles t = w (mod kConsumers),
// whose stages it alone uses, so no phase of a barrier can be mistaken for
// another; the consumers load q while the first copies are in flight. On a
// tile it runs the TPU kernel's tile-wise online softmax: lane j scores
// slot j for all R rows (q in shared memory), invalid slots -1e30, slots
// past the split's end -inf (weight 0, never touched in P V); then one warp
// max, one rescale of (l, acc) and one expf per slot a row; then P V with
// lanes across D, p read back from shared memory. At the end the consumer
// warps merge, in the drained stages, into the block's partial (m, l,
// acc[R][D]); after cluster.sync() every block of the cluster merges a
// share of the R D outputs from all the blocks' partials through
// distributed shared memory (m = max m_c, w_c = exp(m_c - m), out = sum w_c
// acc_c / max(sum w_c l_c, 1e-20)), loading every block's partial in one
// round trip, and a last cluster.sync() keeps every partial alive until
// read. Nothing goes through a global workspace. Where the caller passes an
// lse buffer, the thread that merges a row's first column also writes the
// row's log-sum-exp m + log(sum w_c l_c) there, in the same epilogue: a
// tensor-parallel decode whose cache is split by length over ranks merges
// the ranks' outputs with it (o = sum_r exp(lse_r - lse) o_r). Without one
// the kernel does what it did before, one comparison a row more.
//
// The kernel and its launch are in decode_attn.cuh, instantiated in one
// translation unit a cache type (decode_attn_{f32,bf16,i8}.cu), which
// nvcc builds in parallel. This file holds the C interface for ctypes:
// pointers as void*, the CUDA stream as void*, and the return value is the
// launch's cudaError_t. Nothing is allocated here.

#include <cuda_runtime.h>

#include "decode_attn.cuh"

using namespace decode_attn;

namespace {

bool plan_ok(long long pairs, int s, int n_split, int per) {
  return pairs > 0 && pairs < (1LL << 31) && s > 0 && n_split >= 1 && n_split <= kMaxSplit &&
         per >= 1 && (long long)(n_split - 1) * per < s && (long long)n_split * per >= s;
}

}  // namespace

// q (B, Hq, D) f32 or bf16 (q_bf16); k, v (B, S, Hkv, D) f32, bf16 or int8
// (kv_type 0, 1, 2), 16-byte aligned; k_scale, v_scale (B, S, Hkv) f32 for
// an int8 cache (else ignored); pos (B, S) int32; window 0 (none) or the
// window W; out (B, Hq, D) f32; lse null or (B, Hq) f32, each row's
// log-sum-exp (before an int8 cache's v-scales). G = Hq / Hkv >= 1 query rows a kv head,
// taken rows at a time (rows in {1, 2, 4, 8, 16}, at most 8 where D = 256)
// over ceil(G / rows) row groups; D in {32, 64, 128, 256}; S >= 1; the S
// slots are split into n_split <= 8 non-empty runs of per slots (the last
// may be shorter).
extern "C" int repro_decode_attention(const void* q, int q_bf16, const void* k, const void* v,
                                      int kv_type, const void* k_scale, const void* v_scale,
                                      const void* pos, long long idx, int window, void* out,
                                      void* lse, int b, int s, int hkv, int g, int rows, int d,
                                      int n_split, int per, float scale, void* stream) {
  if (b <= 0 || hkv <= 0 || g <= 0 || rows <= 0 || window < 0 ||
      !plan_ok((long long)b * hkv, s, n_split, per))
    return cudaErrorInvalidValue;
  if (kv_type == kInt8 && (k_scale == nullptr || v_scale == nullptr))
    return cudaErrorInvalidValue;
  if (((long long)g + rows - 1) / rows > 65535) return cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const Args a = {q, q_bf16, k, v, static_cast<const float*>(k_scale),
                  static_cast<const float*>(v_scale), static_cast<const int*>(pos), idx, window,
                  static_cast<float*>(out), static_cast<float*>(lse), b, s, hkv, g, rows, d, n_split, per, scale,
                  static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (kv_type) {
    case kF32: err = launch_f32(a); break;
    case kBf16: err = launch_bf16(a); break;
    case kInt8: err = launch_i8(a); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of n_split blocks of the instantiation (cache type,
// rows a block, D) the card holds at once (cudaOccupancyMaxActiveClusters),
// written to *clusters: the wave the wrapper's split planner fills. Returns
// the cudaError_t.
extern "C" int repro_decode_attention_max_clusters(int kv_type, int rows, int d, int n_split,
                                                   int* clusters) {
  if (n_split < 1 || n_split > kMaxSplit) return cudaErrorInvalidValue;
  switch (kv_type) {
    case kF32: return max_clusters_f32(rows, d, n_split, clusters);
    case kBf16: return max_clusters_bf16(rows, d, n_split, clusters);
    case kInt8: return max_clusters_i8(rows, d, n_split, clusters);
    default: return cudaErrorInvalidValue;
  }
}
