// table_lookup: out[r] = table[idx[r]] for a small table, and 0 where
// idx[r] is outside [0, L) (padding rows sit at leaf -1).
//
// Replaces: the Pallas kernel _lookup_kernel (lightgbm_tpu/ops/fused_level.py
// :811, launched by table_lookup :820), the per-row leaf-value score update
// (ref: src/boosting/score_updater.hpp:88 AddScore).
//
// Bound on the H100: bytes — 4 B of index in and 4 B of value out per row.
//
// Design: the TPU kernel reduces a sublane one-hot because random gathers
// are slow there; here one thread per row gathers directly. The table
// (L <= a few thousand floats) stays in L1 after the first warps touch it.
#include "fused_level.cuh"

namespace lgbt {

__global__ void __launch_bounds__(kThreads)
table_lookup_kernel(const int* __restrict__ idx,
                    const float* __restrict__ table, float* __restrict__ out,
                    int64_t R, int L) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (r >= R) return;
  const int i = idx[r];
  out[r] = (i >= 0 && i < L) ? table[i] : 0.0f;
}

}  // namespace lgbt

extern "C" int lgbt_table_lookup(const void* idx, const void* table,
                                 void* out, long long R, int L,
                                 void* stream) {
  const unsigned grid =
      static_cast<unsigned>((R + lgbt::kThreads - 1) / lgbt::kThreads);
  lgbt::table_lookup_kernel<<<grid, lgbt::kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(table),
      static_cast<float*>(out), R, L);
  return static_cast<int>(cudaGetLastError());
}
