// Shared device code of the fused-level kernels (level_pass.cu,
// route_pass.cu, epilogue_pass.cu, table_lookup.cu): the per-level slot
// tables, the table-driven row routing of lightgbm_tpu/ops/fused_level.py
// (in full, or through the slab table), and the scan of per-slot counts.
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
//   ktab   [2, K] int32 or null    packed layout: each kernel row's flat
//                                  offset, then its slab width
//   kmask  [K] uint8 or null       gain screening: 0 = row's slab masked
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace lgbt {

constexpr int kMaxSlots = 128;
constexpr int kTblCols = 128;
constexpr int kMaxChannels = 8;
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

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

// The same lookup through an open-addressing hash of the active slots'
// leaves, for kernels whose rows would otherwise scan all Sp slots (the
// scan's cost grows with Sp: PERF.md). kSlotHash >= 2 * kMaxSlots keeps
// the load at most one half, so a lookup takes about two probes.
constexpr int kSlotHash = 2 * kMaxSlots;
constexpr int kNoKey = -1;       // row leaves are >= -1; -1 matches no slot

struct SlotHash {
  int key[kSlotHash];
  int slot[kSlotHash];
};

__device__ inline int slot_hash_home(int leaf) {
  return static_cast<int>((static_cast<uint32_t>(leaf) * 2654435761u) >>
                          (32 - 8)) & (kSlotHash - 1);
}

// Fill h from the staged tables t (all threads; ends in __syncthreads()).
// Inactive slots (leaf -2) are left out: no row sits in leaf -2.
__device__ inline void build_slot_hash(SlotHash& h, const SlotTables& t,
                                       int Sp) {
  for (int i = threadIdx.x; i < kSlotHash; i += blockDim.x) h.key[i] = kNoKey;
  __syncthreads();
  for (int k = threadIdx.x; k < Sp; k += blockDim.x) {
    const int leaf = t.leaf[k];
    if (leaf < 0) continue;
    int i = slot_hash_home(leaf);
    while (atomicCAS(&h.key[i], kNoKey, leaf) != kNoKey) {
      i = (i + 1) & (kSlotHash - 1);     // selected leaves are distinct
    }
    h.slot[i] = k;
  }
  __syncthreads();
}

// find_slot through the hash: the slot whose leaf this row sits in, or -1.
__device__ inline int hash_slot(const SlotHash& h, int leaf) {
  if (leaf < 0) return -1;
  for (int i = slot_hash_home(leaf);; i = (i + 1) & (kSlotHash - 1)) {
    const int key = h.key[i];
    if (key == leaf) return h.slot[i];
    if (key == kNoKey) return -1;
  }
}

// Where each kernel row (a row of bins_T) puts its one-hot slab on the flat
// axis of W and of the histogram. Padded layout (off == nullptr): row f's
// slab starts at f*B, B wide. Packed layout (tpu_adaptive_bins): row j's
// slab starts at off[j] and is width[j] wide; a bin at or past the width
// has no position there, as in the TPU kernel's one-hot. A row whose mask
// entry is 0 (gain screening) has an all-zero slab: it adds nothing to the
// routing sum or to the histogram.
struct RowLayout {
  const int* off;        // [K] or nullptr (padded)
  const int* width;      // [K], read only when off is set
  const uint8_t* mask;   // [K] 0/1 or nullptr (no row masked)
  int B;

  // Flat position of bin b of kernel row j, or -1 when its slab holds none.
  __device__ inline int64_t pos(int j, int b) const {
    if (!live(j)) return -1;
    if (off == nullptr) return static_cast<int64_t>(j) * B + b;
    return b < width[j] ? static_cast<int64_t>(off[j]) + b : -1;
  }
  // The same, split for a loop that keeps one kernel row: whether row j
  // adds anything, where its slab starts, how wide it is, and whether bin
  // b has a position in a slab that wide (padded: always).
  __device__ inline bool live(int j) const {
    return mask == nullptr || mask[j] != 0;
  }
  __device__ inline int64_t start(int j) const {
    return off == nullptr ? static_cast<int64_t>(j) * B
                          : static_cast<int64_t>(off[j]);
  }
  __device__ inline int width_of(int j) const {
    return off == nullptr ? B : width[j];
  }
  __device__ inline bool in_slab(int b, int w) const {
    return off == nullptr || b < w;
  }
};

// Exclusive scan of the Sp <= kMaxSlots per-slot counts into s_off[0..Sp]
// (s_off[Sp] = the total), by the block's first warp: each lane sums four
// counts, then a warp scan. The caller syncs before reading s_off.
__device__ inline void slot_offsets(const int* counts, int Sp, int* s_off) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int c[4];
  int sum = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = lane * 4 + q;
    c[q] = k < Sp ? counts[k] : 0;
    sum += c[q];
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  int run = incl - sum;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = lane * 4 + q;
    if (k < Sp) s_off[k] = run;
    run += c[q];
  }
  if (lane == 31) s_off[Sp] = incl;
}

// D = sum_j W[k, pos(j, bin_j)]: the TPU kernel's W @ one-hot contraction
// for one row and one slot. W is 0/1 and non-zero only on the slot's split
// feature, so D is exactly 0 or 1; the row goes left iff D > 0.5. Missing-
// bin routing is already encoded in W.
template <typename BinT>
__device__ inline bool goes_left(const BinT* __restrict__ bins, int64_t Rp,
                                 int64_t r,
                                 const __nv_bfloat16* __restrict__ Wk,
                                 int K, const RowLayout& lay) {
  float D = 0.0f;
  for (int j = 0; j < K; ++j) {
    const int64_t p = lay.pos(j, static_cast<int>(bins[j * Rp + r]));
    if (p >= 0) D += __bfloat162float(Wk[p]);
  }
  return D > 0.5f;
}

// The slab table (launch_slabs): for each W row k, the one kernel row j
// whose slab holds a non-zero, or one of these.
constexpr int kNoSlab = -1;      // W row all zero: every row goes right
constexpr int kManySlabs = -2;   // non-zero on several slabs: full sum

// goes_left through the slab table: a W row non-zero on one slab js (as
// the grower builds it) reads one bin and one W entry; one over several
// slabs takes the full sum; an all-zero one sends the row right. Equal to
// goes_left for any 0/1 W.
template <typename BinT>
__device__ inline bool slab_left(const BinT* __restrict__ bins, int64_t Rp,
                                 int64_t r,
                                 const __nv_bfloat16* __restrict__ Wk,
                                 int js, int K, const RowLayout& lay) {
  if (js >= 0) {
    const int64_t p = lay.pos(js, static_cast<int>(bins[js * Rp + r]));
    return p >= 0 && __bfloat162float(Wk[p]) > 0.5f;
  }
  return js == kManySlabs && goes_left(bins, Rp, r, Wk, K, lay);
}

// Launch level_slabs_kernel (level_pass.cu): slab_of[k] for the Sp rows of
// W, one block per row, on `stream`. level_pass, route_pass and
// epilogue_pass each start with it.
cudaError_t launch_slabs(const __nv_bfloat16* W, const RowLayout& lay,
                         int* slab_of, int K, int64_t FB, int Sp,
                         cudaStream_t stream);

// The current device, its SM count and opt-in shared memory per block,
// read once per device (kMaxDevices at most).
inline cudaError_t device_limits(int* dev, int* sms, int* smem_optin) {
  static int s_sms[kMaxDevices] = {}, s_optin[kMaxDevices] = {};
  static std::mutex lock;
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(lock);
  if (s_sms[*dev] == 0) {
    int n = 0, optin = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, *dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    }
    if (e != cudaSuccess) return e;
    s_sms[*dev] = n;
    s_optin[*dev] = optin;
  }
  *sms = s_sms[*dev];
  *smem_optin = s_optin[*dev];
  return cudaSuccess;
}

}  // namespace lgbt
