// route_pass: the row -> leaf update of level_pass, with no histogram.
//
// Replaces: the Pallas kernel _route_kernel (lightgbm_tpu/ops/fused_level.py
// :575, launched by route_pass :604), used for the pass whose histograms
// could never be consumed (the leaf budget is spent, or no pass follows),
// in its padded and packed (tpu_adaptive_bins) variants: a null ktab routes
// over slabs at f * B, else over each kernel row's offset and width. It
// never masks a feature (the TPU kernel builds its one-hot unmasked).
//
// Bound on the H100: bytes. Per row it reads K bin bytes (one per kernel
// row) and the leaf and writes the new leaf (about 36 B at K=28); one
// gather-add per kernel row is all the arithmetic.
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
                  const int* __restrict__ tbl, RowLayout lay,
                  int* __restrict__ new_leaf, int64_t Rp, int K, int64_t FB,
                  int Sp) {
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
  const bool left = goes_left(bins, Rp, r, W + k * FB, K, lay);
  new_leaf[r] = left ? lf : lf + t.delta[k];
}

template <typename BinT>
int launch_route(const void* bins, const void* leaf, const void* W,
                 const void* tbl, const RowLayout& lay, void* new_leaf,
                 long long Rp, int K, long long FB, int Sp, void* stream) {
  const unsigned grid =
      static_cast<unsigned>((Rp + kThreads - 1) / kThreads);
  route_pass_kernel<BinT><<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const BinT*>(bins), static_cast<const int*>(leaf),
      static_cast<const __nv_bfloat16*>(W), static_cast<const int*>(tbl),
      lay, static_cast<int*>(new_leaf), Rp, K, FB, Sp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lgbt

// ktab ([2, K] int32: offsets, then widths) may be null (padded layout).
extern "C" int lgbt_route_pass(const void* bins, int bin_bytes,
                               const void* leaf, const void* W,
                               const void* tbl, const void* ktab,
                               void* new_leaf, long long Rp, int K, int B,
                               long long FB, int Sp, void* stream) {
  const int* kt = static_cast<const int*>(ktab);
  const lgbt::RowLayout lay{kt, kt == nullptr ? nullptr : kt + K, nullptr,
                            B};
  if (bin_bytes == 1) {
    return lgbt::launch_route<int8_t>(bins, leaf, W, tbl, lay, new_leaf, Rp,
                                      K, FB, Sp, stream);
  }
  return lgbt::launch_route<int16_t>(bins, leaf, W, tbl, lay, new_leaf, Rp,
                                     K, FB, Sp, stream);
}
