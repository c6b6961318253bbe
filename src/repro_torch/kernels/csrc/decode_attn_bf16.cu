// The decode attention kernel's instantiations over a __nv_bfloat16 cache (see
// decode_attn.cu and decode_attn.cuh).
#include "decode_attn.cuh"

namespace decode_attn {

cudaError_t launch_bf16(const Args& a) { return launch<__nv_bfloat16>(a); }

cudaError_t max_clusters_bf16(int rows, int d, int n_split, int* clusters) {
  return max_clusters<__nv_bfloat16>(rows, d, n_split, clusters);
}

}  // namespace decode_attn
