// level_pass: route every row one tree level down and histogram the rows
// of each split's smaller child, in one pass over the rows.
//
// Replaces: the Pallas kernel _level_kernel (lightgbm_tpu/ops/fused_level.py
// :402, launched by level_pass :481), in all its compiled variants:
//   f32     bf16 gh channels (pack_gh) widened and summed in f32, so
//           hist_planes decodes the hi/lo channels unchanged;
//   quant   int8 gh channels (pack_gh_quant, tpu_quantized_grad 8 or 16)
//           summed in int32 — integer sums do not depend on order, so the
//           atomics below give the plain version's sums bit for bit;
//   packed  per-kernel-row slab offsets and widths on the flat axis
//           (tpu_adaptive_bins) in place of f * B;
//   fmask   a per-kernel-row 0/1 mask (tpu_gain_screening): a masked row's
//           slab adds nothing to the histogram or to the routing sum.
// Every combination is one template instance or one runtime table; a null
// table keeps the padded, unmasked path.
//
// Bound on the H100: bytes. Per row it reads K bin bytes, the leaf, nch
// channels (2 B each, 1 B quantized) and writes the new leaf (about 60 B at
// K=28, nch=5); the arithmetic is one gather-add per kernel row plus K*nch
// adds for the smaller-child rows, far below the card's rate. The
// [FB, nch*Sp] output (2.3 MB at Sp=64, FB=1792) does not fit a block's
// shared memory.
//
// Design: one thread per row, blocks over row ranges; the TPU's one-hot
// matmuls and its sequential-grid accumulator are gone. bins_T is
// feature-major, so a warp's reads of one kernel row are one contiguous
// segment. The slot tables sit in shared memory; the route table W and the
// per-row layout tables are read through L1/L2 (every thread of a warp
// reads the same entry of the layout tables). Smaller-child rows add their
// channels into the zeroed global histogram with atomicAdd, which makes the
// f32 sums' order (and so their last bits) vary from run to run; the int32
// sums do not. The time goes to those K*nch global atomics per
// smaller-child row. A two-launch variant — mark each row's smaller-child
// slot, then accumulate per-block shared-memory histograms over groups of
// two features and flush them — measured no faster on the H100 (PERF.md),
// so the single pass stays.
#include "fused_level.cuh"

namespace lgbt {

// Channel type and the accumulator it adds into: bf16 -> f32, int8 -> int.
template <typename ChT> struct Acc;
template <> struct Acc<__nv_bfloat16> {
  using T = float;
  static __device__ float of(__nv_bfloat16 v) { return __bfloat162float(v); }
};
template <> struct Acc<int8_t> {
  using T = int;
  static __device__ int of(int8_t v) { return static_cast<int>(v); }
};

template <typename BinT, typename ChT>
__global__ void __launch_bounds__(kThreads)
level_pass_kernel(const BinT* __restrict__ bins,
                  const int* __restrict__ leaf, const ChT* __restrict__ gh,
                  const __nv_bfloat16* __restrict__ W,
                  const int* __restrict__ tbl, RowLayout lay,
                  typename Acc<ChT>::T* __restrict__ hist,
                  int* __restrict__ new_leaf, int64_t Rp, int K, int64_t FB,
                  int Sp, int nch) {
  using AccT = typename Acc<ChT>::T;
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
  if (left != (t.small_left[k] != 0)) return;   // not in the smaller child

  AccT g[kMaxChannels];
#pragma unroll
  for (int ch = 0; ch < kMaxChannels; ++ch) {
    g[ch] = ch < nch ? Acc<ChT>::of(gh[ch * Rp + r]) : AccT(0);
  }
  const int64_t C = static_cast<int64_t>(nch) * Sp;
  for (int j = 0; j < K; ++j) {
    const int64_t p = lay.pos(j, static_cast<int>(bins[j * Rp + r]));
    if (p < 0) continue;
    AccT* cell = hist + p * C + k;
#pragma unroll
    for (int ch = 0; ch < kMaxChannels; ++ch) {
      if (ch < nch) atomicAdd(cell + ch * Sp, g[ch]);
    }
  }
}

template <typename BinT, typename ChT>
int launch_level(const void* bins, const void* leaf, const void* gh,
                 const void* W, const void* tbl, const RowLayout& lay,
                 void* hist, void* new_leaf, long long Rp, int K,
                 long long FB, int Sp, int nch, void* stream) {
  const unsigned grid =
      static_cast<unsigned>((Rp + kThreads - 1) / kThreads);
  level_pass_kernel<BinT, ChT><<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const BinT*>(bins), static_cast<const int*>(leaf),
      static_cast<const ChT*>(gh), static_cast<const __nv_bfloat16*>(W),
      static_cast<const int*>(tbl), lay,
      static_cast<typename Acc<ChT>::T*>(hist), static_cast<int*>(new_leaf),
      Rp, K, FB, Sp, nch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lgbt

// hist must be zeroed by the caller (f32, or int32 when quant); bin_bytes
// is 1 (int8) or 2 (int16); gh is bf16, or int8 when quant. ktab ([2, K]
// int32: offsets, then widths) and kmask ([K] uint8) may be null.
extern "C" int lgbt_level_pass(const void* bins, int bin_bytes,
                               const void* leaf, const void* gh, int quant,
                               const void* W, const void* tbl,
                               const void* ktab, const void* kmask,
                               void* hist, void* new_leaf, long long Rp,
                               int K, int B, long long FB, int Sp, int nch,
                               void* stream) {
  const int* kt = static_cast<const int*>(ktab);
  const lgbt::RowLayout lay{kt, kt == nullptr ? nullptr : kt + K,
                            static_cast<const uint8_t*>(kmask), B};
  if (bin_bytes == 1) {
    return quant ? lgbt::launch_level<int8_t, int8_t>(
                       bins, leaf, gh, W, tbl, lay, hist, new_leaf, Rp, K,
                       FB, Sp, nch, stream)
                 : lgbt::launch_level<int8_t, __nv_bfloat16>(
                       bins, leaf, gh, W, tbl, lay, hist, new_leaf, Rp, K,
                       FB, Sp, nch, stream);
  }
  return quant ? lgbt::launch_level<int16_t, int8_t>(
                     bins, leaf, gh, W, tbl, lay, hist, new_leaf, Rp, K, FB,
                     Sp, nch, stream)
               : lgbt::launch_level<int16_t, __nv_bfloat16>(
                     bins, leaf, gh, W, tbl, lay, hist, new_leaf, Rp, K, FB,
                     Sp, nch, stream);
}
