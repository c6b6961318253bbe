// The decode attention kernel's instantiations over a int8_t cache (see
// decode_attn.cu and decode_attn.cuh).
#include "decode_attn.cuh"

namespace decode_attn {

cudaError_t launch_i8(const Args& a) { return launch<int8_t>(a); }

cudaError_t max_clusters_i8(int rows, int d, int n_split, int* clusters) {
  return max_clusters<int8_t>(rows, d, n_split, clusters);
}

}  // namespace decode_attn
