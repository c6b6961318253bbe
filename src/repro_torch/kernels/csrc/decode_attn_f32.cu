// The decode attention kernel's instantiations over a float cache (see
// decode_attn.cu and decode_attn.cuh).
#include "decode_attn.cuh"

namespace decode_attn {

cudaError_t launch_f32(const Args& a) { return launch<float>(a); }

cudaError_t max_clusters_f32(int rows, int d, int n_split, int* clusters) {
  return max_clusters<float>(rows, d, n_split, clusters);
}

}  // namespace decode_attn
