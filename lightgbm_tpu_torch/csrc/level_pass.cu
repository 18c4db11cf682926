// level_pass: route every row one tree level down and histogram the rows
// of each split's smaller child, in one pass over the rows.
//
// Replaces: the Pallas kernel _level_kernel (lightgbm_tpu/ops/fused_level.py
// :402, launched by level_pass :481). Same inputs and outputs, same
// arithmetic: the gh channels are the bf16 values of pack_gh, widened and
// summed in f32, so hist_planes decodes the hi/lo channels unchanged.
//
// Bound on the H100: bytes. Per row it reads F_oh bin bytes, the leaf, nch
// bf16 channels and writes the new leaf (about 60 B at F_oh=28, nch=5);
// the arithmetic is one gather-add per feature plus F_oh*nch adds for the
// smaller-child rows, far below the card's rate. The [FB, nch*Sp] f32
// output (2.3 MB at Sp=64) does not fit a block's shared memory.
//
// Design: one thread per row, blocks over row ranges; the TPU's one-hot
// matmuls and its sequential-grid accumulator are gone. bins_T is
// feature-major, so a warp's reads of one feature are one contiguous
// segment. The slot tables sit in shared memory; the route table W is
// gathered through L1/L2 (it is at most 64 x 1792 bf16 = 229 KB and every
// block reads the same one). Smaller-child rows add their channels into the
// zeroed global histogram with atomicAdd, which makes the f32 sums' order
// (and so their last bits) vary from run to run. The time goes to those
// F_oh*nch global atomics per smaller-child row. A two-launch variant —
// mark each row's smaller-child slot, then accumulate per-block
// shared-memory histograms over groups of two features and flush them —
// measured no faster on the H100 (PERF.md), so the single pass stays.
#include "fused_level.cuh"

namespace lgbt {

template <typename BinT>
__global__ void __launch_bounds__(kThreads)
level_pass_kernel(const BinT* __restrict__ bins,
                  const int* __restrict__ leaf,
                  const __nv_bfloat16* __restrict__ gh,
                  const __nv_bfloat16* __restrict__ W,
                  const int* __restrict__ tbl, float* __restrict__ hist,
                  int* __restrict__ new_leaf, int64_t Rp, int F_oh, int B,
                  int Sp, int nch) {
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
  if (left != (t.small_left[k] != 0)) return;   // not in the smaller child

  float g[kMaxChannels];
#pragma unroll
  for (int ch = 0; ch < kMaxChannels; ++ch) {
    g[ch] = ch < nch ? __bfloat162float(gh[ch * Rp + r]) : 0.0f;
  }
  const int64_t C = static_cast<int64_t>(nch) * Sp;
  for (int f = 0; f < F_oh; ++f) {
    const int b = static_cast<int>(bins[f * Rp + r]);
    float* cell = hist + (static_cast<int64_t>(f) * B + b) * C + k;
#pragma unroll
    for (int ch = 0; ch < kMaxChannels; ++ch) {
      if (ch < nch) atomicAdd(cell + ch * Sp, g[ch]);
    }
  }
}

template <typename BinT>
int launch_level(const void* bins, const void* leaf, const void* gh,
                 const void* W, const void* tbl, void* hist, void* new_leaf,
                 long long Rp, int F_oh, int B, int Sp, int nch,
                 void* stream) {
  const unsigned grid =
      static_cast<unsigned>((Rp + kThreads - 1) / kThreads);
  level_pass_kernel<BinT><<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const BinT*>(bins), static_cast<const int*>(leaf),
      static_cast<const __nv_bfloat16*>(gh),
      static_cast<const __nv_bfloat16*>(W), static_cast<const int*>(tbl),
      static_cast<float*>(hist), static_cast<int*>(new_leaf), Rp, F_oh, B,
      Sp, nch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lgbt

// hist must be zeroed by the caller; bin_bytes is 1 (int8) or 2 (int16).
extern "C" int lgbt_level_pass(const void* bins, int bin_bytes,
                               const void* leaf, const void* gh,
                               const void* W, const void* tbl, void* hist,
                               void* new_leaf, long long Rp, int F_oh, int B,
                               int Sp, int nch, void* stream) {
  if (bin_bytes == 1) {
    return lgbt::launch_level<int8_t>(bins, leaf, gh, W, tbl, hist, new_leaf,
                                      Rp, F_oh, B, Sp, nch, stream);
  }
  return lgbt::launch_level<int16_t>(bins, leaf, gh, W, tbl, hist, new_leaf,
                                     Rp, F_oh, B, Sp, nch, stream);
}
