// Shared device code of the fused-level kernels (level_pass.cu,
// route_pass.cu, table_lookup.cu): the per-level slot tables and the
// table-driven row routing of lightgbm_tpu/ops/fused_level.py.
//
// Layouts (the JAX package's, unchanged):
//   bins_T [Fp, Rp] int8 or int16  feature-major, so thread r reading
//                                  bins_T[f * Rp + r] reads neighbouring
//                                  bytes of its warp's neighbours
//   leaf_T [Rp] int32              row -> leaf; -1 on padding rows
//   W      [Sp, F_oh * B] bf16     W[k, f*B + b] = 1 iff a row with bin b of
//                                  feature f goes LEFT under slot k's split
//   tbl    [Sp, 128] int32         col 0 leaf_of_slot (-2 = inactive),
//                                  col 1 right_delta, col 2 small_is_left
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lgbt {

constexpr int kMaxSlots = 128;
constexpr int kTblCols = 128;
constexpr int kMaxChannels = 8;
constexpr int kThreads = 256;

struct SlotTables {
  int leaf[kMaxSlots];
  int delta[kMaxSlots];
  int small_left[kMaxSlots];
};

// Stage this level's slot tables in shared memory (every thread of the
// block reads all of them for its row).
__device__ inline void load_tables(SlotTables& t, const int* tbl, int Sp) {
  for (int k = threadIdx.x; k < Sp; k += blockDim.x) {
    t.leaf[k] = tbl[k * kTblCols + 0];
    t.delta[k] = tbl[k * kTblCols + 1];
    t.small_left[k] = tbl[k * kTblCols + 2] > 0 ? 1 : 0;
  }
  __syncthreads();
}

// The slot whose leaf this row sits in, or -1. Selected leaves are
// distinct, inactive slots hold -2 and padding rows -1, so at most one
// slot matches.
__device__ inline int find_slot(const SlotTables& t, int leaf, int Sp) {
  for (int k = 0; k < Sp; ++k) {
    if (t.leaf[k] == leaf) return k;
  }
  return -1;
}

// D = sum_f W[k, f*B + bin_f]: the TPU kernel's W @ one-hot contraction for
// one row and one slot. W is 0/1 and non-zero only on the slot's split
// feature, so D is exactly 0 or 1; the row goes left iff D > 0.5. Missing-
// bin routing is already encoded in W.
template <typename BinT>
__device__ inline bool goes_left(const BinT* __restrict__ bins, int64_t Rp,
                                 int64_t r,
                                 const __nv_bfloat16* __restrict__ Wk,
                                 int F_oh, int B) {
  float D = 0.0f;
  for (int f = 0; f < F_oh; ++f) {
    const int b = static_cast<int>(bins[f * Rp + r]);
    D += __bfloat162float(Wk[f * B + b]);
  }
  return D > 0.5f;
}

}  // namespace lgbt
