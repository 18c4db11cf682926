// route_pass: the row -> leaf update of level_pass, with no histogram.
//
// Replaces: the Pallas kernel _route_kernel (lightgbm_tpu/ops/fused_level.py
// :575, launched by route_pass :604), used for the pass whose histograms
// could never be consumed (the leaf budget is spent, or no pass follows).
//
// Bound on the H100: bytes. Per row it reads F_oh bin bytes and the leaf
// and writes the new leaf (about 36 B at F_oh=28); one gather-add per
// feature is all the arithmetic.
//
// Design: one thread per row over feature-major bins (coalesced per
// feature), slot tables in shared memory, the 0/1 route table gathered
// through the cache; rows in no selected leaf copy their leaf through.
#include "fused_level.cuh"

namespace lgbt {

template <typename BinT>
__global__ void __launch_bounds__(kThreads)
route_pass_kernel(const BinT* __restrict__ bins,
                  const int* __restrict__ leaf,
                  const __nv_bfloat16* __restrict__ W,
                  const int* __restrict__ tbl, int* __restrict__ new_leaf,
                  int64_t Rp, int F_oh, int B, int Sp) {
  __shared__ SlotTables t;
  load_tables(t, tbl, Sp);
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (r >= Rp) return;
  const int lf = leaf[r];
  const int k = find_slot(t, lf, Sp);
  if (k < 0) {
    new_leaf[r] = lf;
    return;
  }
  const int64_t FB = static_cast<int64_t>(F_oh) * B;
  const bool left = goes_left(bins, Rp, r, W + k * FB, F_oh, B);
  new_leaf[r] = left ? lf : lf + t.delta[k];
}

template <typename BinT>
int launch_route(const void* bins, const void* leaf, const void* W,
           const void* tbl, void* new_leaf, long long Rp, int F_oh, int B,
           int Sp, void* stream) {
  const unsigned grid =
      static_cast<unsigned>((Rp + kThreads - 1) / kThreads);
  route_pass_kernel<BinT><<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const BinT*>(bins), static_cast<const int*>(leaf),
      static_cast<const __nv_bfloat16*>(W), static_cast<const int*>(tbl),
      static_cast<int*>(new_leaf), Rp, F_oh, B, Sp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lgbt

extern "C" int lgbt_route_pass(const void* bins, int bin_bytes,
                               const void* leaf, const void* W,
                               const void* tbl, void* new_leaf, long long Rp,
                               int F_oh, int B, int Sp, void* stream) {
  if (bin_bytes == 1) {
    return lgbt::launch_route<int8_t>(bins, leaf, W, tbl, new_leaf, Rp, F_oh, B,
                                Sp, stream);
  }
  return lgbt::launch_route<int16_t>(bins, leaf, W, tbl, new_leaf, Rp, F_oh, B, Sp,
                               stream);
}
