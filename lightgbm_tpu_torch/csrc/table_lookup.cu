// table_lookup: out[r] = table[idx[r]] for a small table, and 0 where
// idx[r] is outside [0, L) (padding rows sit at leaf -1).
//
// Replaces: the Pallas kernel _lookup_kernel (lightgbm_tpu/ops/fused_level.py
// :811, launched by table_lookup :820), the per-row leaf-value score update
// (ref: src/boosting/score_updater.hpp:88 AddScore).
//
// Bound on the H100: bytes — 4 B of index in and 4 B of value out per row
// (8 MB, 2.4 us at 1M rows): a launch of a few microseconds at most.
//
// Design: the TPU kernel reduces a sublane one-hot because random gathers
// are slow there; here each thread gathers directly, four rows at a time:
// one 16-byte load of indices and one 16-byte store of values. The table
// (L <= kStagedEntries floats) is staged in each block's shared memory; a
// larger one is read through L1. The grid is a few blocks per SM with a
// grid-stride loop, and a scalar loop takes the rows past the last
// multiple of four (all rows when a pointer is not 16-byte aligned).
#include "fused_level.cuh"

namespace lgbt {

constexpr int kStagedEntries = 4096;
constexpr int kLookupBlocksPerSM = 4;

__device__ inline float look(const float* tab, int i, int L) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(L) ? tab[i] : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
table_lookup_kernel(const int* __restrict__ idx,
                    const float* __restrict__ table, float* __restrict__ out,
                    int64_t R, int64_t R4, int L) {
  __shared__ float s_tab[kStagedEntries];
  const float* tab = table;
  if (L <= kStagedEntries) {
    for (int i = threadIdx.x; i < L; i += blockDim.x) s_tab[i] = table[i];
    __syncthreads();
    tab = s_tab;
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  float4* out4 = reinterpret_cast<float4*>(out);
  for (int64_t q = first; q < R4; q += stride) {
    const int4 v = idx4[q];
    out4[q] = make_float4(look(tab, v.x, L), look(tab, v.y, L),
                          look(tab, v.z, L), look(tab, v.w, L));
  }
  for (int64_t r = R4 * 4 + first; r < R; r += stride) {
    out[r] = look(tab, idx[r], L);
  }
}

}  // namespace lgbt

extern "C" int lgbt_table_lookup(const void* idx, const void* table,
                                 void* out, long long R, int L,
                                 void* stream) {
  int dev = 0, sms = 0, optin = 0;
  const cudaError_t e = lgbt::device_limits(&dev, &sms, &optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool aligned = (reinterpret_cast<uintptr_t>(idx) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const long long R4 = aligned ? R / 4 : 0;
  const long long need = ((R4 > 0 ? R4 : R) + lgbt::kThreads - 1) /
                         lgbt::kThreads;
  const long long fit = static_cast<long long>(sms) *
                        lgbt::kLookupBlocksPerSM;
  const unsigned grid = static_cast<unsigned>(
      need < 1 ? 1 : (need < fit ? need : fit));
  lgbt::table_lookup_kernel<<<grid, lgbt::kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(table),
      static_cast<float*>(out), R, R4, L);
  return static_cast<int>(cudaGetLastError());
}
