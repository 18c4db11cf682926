// level_pass: route every row one tree level down and histogram the rows
// of each split's smaller child, as four kernels on one stream.
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
// shared memory, but one slot's tile does (40,960 B).
//
// Design: the smaller-child rows are grouped by slot first, so a block
// accumulates one slot's tile in shared memory and flushes it once, in
// place of K*nch global atomics per smaller-child row (which serialised on
// the hot cells of narrow slabs).
//   1. mark (level_slabs_kernel, level_mark_kernel). A route table row is
//      0/1 and, as the grower builds it, non-zero on one kernel row's slab
//      only (the split feature's; at the root the first kernel row's). One
//      block per slot finds that kernel row, so the mark kernel routes a
//      row with one bin and one W read instead of K of each; a W row over
//      several slabs takes the full sum. One thread per row, slot tables
//      in shared memory: it writes the new leaf; a smaller-child row with
//      a non-zero channel records its slot in row_slot (else -1) and is
//      counted per slot in shared memory, then with one global atomic per
//      (block, slot).
//   2. partition (level_partition_kernel): every block takes the exclusive
//      scan of the Sp <= 128 counts itself (one warp); a shared atomic
//      gives each marked row its rank in the block, one global atomic per
//      (block, slot) the block's place in the slot's bucket. The row's
//      thread writes a staging record there — its K bins and nch channels,
//      in 16-byte stores (48 B at K=28, int8 bins, nch=5) — reading bins_T
//      and gh_T coalesced, in row order. Order inside a bucket is
//      arbitrary. (Gathering bins and channels by row index in stage 3
//      instead, from an index list, cost more: 33 scattered sectors per
//      row; PERF.md.)
//   3. histogram (level_hist_kernel): grid.x blocks split the n records
//      evenly (n is read on the device: the host never syncs); grid.y
//      splits the kernel rows into groups whose tile fits the shared
//      memory the card allows a block. A block walks its range one slot
//      segment at a time, one warp per record (one or two sectors), one
//      lane per kernel row; the tile gives each kernel row its own bank,
//      so the 32 lanes of one shared atomic hit 32 banks and never the
//      same cell (the narrow slabs' hot cells contend only across warps).
//      At each slot change and at the end it flushes every non-zero cell
//      with one global atomic: at most (grid.x + Sp) tiles per group.
// Shared-memory f32 atomicAdd is a compare-and-swap loop on sm_90 (SASS
// ATOMS.CAST.SPIN); the int32 one is native (ATOMS.ADD). Atomics make the
// order of the f32 sums, and so their last bits, vary from run to run; the
// weight channel and the int32 sums are exact.
#include "fused_level.cuh"

namespace lgbt {

constexpr int kMarkRows = 4 * kThreads;   // rows per mark/partition block
constexpr int kHistThreads = 1024;
constexpr int kHistUnroll = 4;            // rows in flight per warp
constexpr int kHistMinRows = 512;         // fewest rows worth a block
constexpr int kLevelChannels = 5;         // nch is 3 or 5 (the wrapper checks)
// the bits lgbt_level_pass reports, one per kernel it launched
constexpr int kSlabsBit = 1, kMarkBit = 2, kPartitionBit = 4, kHistBit = 8;

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

// slab_of[k]: the one kernel row whose slab of W row k holds a non-zero,
// or kNoSlab / kManySlabs. Block k scans W row k, a warp per kernel row.
__global__ void __launch_bounds__(kThreads)
level_slabs_kernel(const __nv_bfloat16* __restrict__ W, RowLayout lay,
                   int* __restrict__ slab_of, int K, int64_t FB) {
  __shared__ int s_first, s_count;
  if (threadIdx.x == 0) {
    s_first = K;
    s_count = 0;
  }
  __syncthreads();
  const __nv_bfloat16* Wk = W + blockIdx.x * FB;
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < K; j += blockDim.x >> 5) {
    const int64_t st = lay.start(j);
    const int width = lay.width_of(j);
    bool any = false;
    for (int b = lane; b < width; b += 32) {
      any |= __bfloat162float(Wk[st + b]) != 0.0f;
    }
    if (__any_sync(0xffffffffu, any) && lane == 0) {
      atomicAdd(&s_count, 1);
      atomicMin(&s_first, j);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    slab_of[blockIdx.x] = s_count == 0 ? kNoSlab
                          : s_count == 1 ? s_first : kManySlabs;
  }
}

cudaError_t launch_slabs(const __nv_bfloat16* W, const RowLayout& lay,
                         int* slab_of, int K, int64_t FB, int Sp,
                         cudaStream_t stream) {
  level_slabs_kernel<<<Sp, kThreads, 0, stream>>>(W, lay, slab_of, K, FB);
  return cudaGetLastError();
}

template <typename BinT, typename ChT>
__global__ void __launch_bounds__(kThreads)
level_mark_kernel(const BinT* __restrict__ bins,
                  const int* __restrict__ leaf, const ChT* __restrict__ gh,
                  const __nv_bfloat16* __restrict__ W,
                  const int* __restrict__ tbl,
                  const int* __restrict__ slab_of, RowLayout lay,
                  int* __restrict__ new_leaf, int8_t* __restrict__ row_slot,
                  int* __restrict__ counts, int64_t Rp, int K, int64_t FB,
                  int Sp, int nch) {
  __shared__ SlotTables t;
  __shared__ int s_slab[kMaxSlots];
  __shared__ int s_cnt[kMaxSlots];
  for (int k = threadIdx.x; k < Sp; k += blockDim.x) {
    s_cnt[k] = 0;
    s_slab[k] = slab_of[k];
  }
  load_tables(t, tbl, Sp);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kMarkRows;
  for (int i = threadIdx.x; i < kMarkRows; i += blockDim.x) {
    const int64_t r = base + i;
    if (r >= Rp) break;
    const int lf = leaf[r];
    const int k = find_slot(t, lf, Sp);
    int mark = -1;
    if (k < 0) {
      new_leaf[r] = lf;
    } else {
      const bool left = slab_left(bins, Rp, r, W + k * FB, s_slab[k], K,
                                  lay);
      new_leaf[r] = left ? lf : lf + t.delta[k];
      if (left == (t.small_left[k] != 0)) {
        bool live = false;   // a row whose channels are all zero adds 0
        for (int ch = 0; ch < nch; ++ch) {
          live |= Acc<ChT>::of(gh[ch * Rp + r]) != 0;
        }
        if (live) {
          mark = k;
          atomicAdd(s_cnt + k, 1);
        }
      }
    }
    row_slot[r] = static_cast<int8_t>(mark);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < Sp; k += blockDim.x) {
    if (s_cnt[k] != 0) atomicAdd(counts + k, s_cnt[k]);
  }
}

// Raw bits of a bin or a channel value, for packing a staging record.
__device__ inline uint32_t raw_bits(int8_t v) { return static_cast<uint8_t>(v); }
__device__ inline uint32_t raw_bits(int16_t v) {
  return static_cast<uint16_t>(v);
}
__device__ inline uint32_t raw_bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// Bytes [16 c, 16 c + 16) of row r's staging record: its K bins (BinT, in
// kernel-row order) from byte 0, its nch channels (ChT) from byte ch_off
// (a multiple of 4, so no word mixes the two), zeros elsewhere. All loads
// of the piece are issued before any is used.
template <typename BinT, typename ChT>
__device__ inline uint4 record_piece(int c, const BinT* __restrict__ bins,
                                     const ChT* __restrict__ gh, int64_t Rp,
                                     int64_t r, int K, int ch_off, int nch) {
  constexpr int kBin = sizeof(BinT), kCh = sizeof(ChT);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  const int o = 16 * c;
  if (o < K * kBin) {
    uint32_t v[16 / kBin];
#pragma unroll
    for (int e = 0; e < 16 / kBin; ++e) {
      const int j = o / kBin + e;
      v[e] = j < K ? raw_bits(bins[j * Rp + r]) : 0u;
    }
#pragma unroll
    for (int e = 0; e < 16 / kBin; ++e) {
      w[e * kBin / 4] |= v[e] << (8 * (e * kBin % 4));
    }
  }
  if (o + 16 > ch_off && o < ch_off + nch * kCh) {
    uint32_t v[16 / kCh];
#pragma unroll
    for (int e = 0; e < 16 / kCh; ++e) {
      const int at = o + e * kCh - ch_off;
      v[e] = at >= 0 && at < nch * kCh ? raw_bits(gh[at / kCh * Rp + r])
                                       : 0u;
    }
#pragma unroll
    for (int e = 0; e < 16 / kCh; ++e) {
      w[e * kCh / 4] |= v[e] << (8 * (e * kCh % 4));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename BinT, typename ChT>
__global__ void __launch_bounds__(kThreads)
level_partition_kernel(const int8_t* __restrict__ row_slot,
                       const int* __restrict__ counts,
                       int* __restrict__ cursor,
                       const BinT* __restrict__ bins,
                       const ChT* __restrict__ gh, uint8_t* __restrict__ stage,
                       int64_t Rp, int Sp, int K, int nch, int ch_off,
                       int rec_bytes) {
  __shared__ int s_off[kMaxSlots + 1];
  __shared__ int s_cnt[kMaxSlots];
  __shared__ int s_base[kMaxSlots];
  slot_offsets(counts, Sp, s_off);
  for (int k = threadIdx.x; k < Sp; k += blockDim.x) s_cnt[k] = 0;
  __syncthreads();
  constexpr int kPer = kMarkRows / kThreads;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kMarkRows;
  int slot[kPer];
  int rank[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int64_t r = base + u * kThreads + threadIdx.x;
    slot[u] = r < Rp ? row_slot[r] : -1;
    rank[u] = slot[u] >= 0 ? atomicAdd(s_cnt + slot[u], 1) : 0;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < Sp; k += blockDim.x) {
    if (s_cnt[k] != 0) s_base[k] = s_off[k] + atomicAdd(cursor + k, s_cnt[k]);
  }
  __syncthreads();
  for (int u = 0; u < kPer; ++u) {
    if (slot[u] < 0) continue;
    const int64_t r = base + u * kThreads + threadIdx.x;
    const int64_t at = s_base[slot[u]] + rank[u];
    uint4* rec = reinterpret_cast<uint4*>(stage + at * rec_bytes);
    for (int c = 0; c < rec_bytes / 16; ++c) {
      rec[c] = record_piece(c, bins, gh, Rp, r, K, ch_off, nch);
    }
  }
}

// Kernel rows [j0, j0 + Kg) of group blockIdx.y in the block's tile: Cw
// columns (32 but where one band of 32 does not fit), one per kernel row,
// bins down the rows, Wg rows (the widest slab) per band of Cw kernel
// rows. Kernel row j = j0 + band * Cw + col, bin b, channel ch sits at
//   tile[ch * cells + (band * Wg + b) * Cw + col],
// so a warp whose lane l adds for kernel row band * Cw + l hits 32
// different banks whatever the bins are: no bank conflicts. Row q of the
// partitioned order is the staging record at stage + q * rec_bytes.
template <typename BinT, typename ChT>
__global__ void __launch_bounds__(kHistThreads)
level_hist_kernel(const uint8_t* __restrict__ stage,
                  const int* __restrict__ counts, RowLayout lay,
                  typename Acc<ChT>::T* __restrict__ hist, int K, int Kg,
                  int Cw, int Wg, int Sp, int nch, int ch_off,
                  int rec_bytes) {
  using AccT = typename Acc<ChT>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AccT* tile = reinterpret_cast<AccT*>(smem_raw);
  __shared__ int s_off[kMaxSlots + 1];
  slot_offsets(counts, Sp, s_off);
  __syncthreads();
  const int64_t n = s_off[Sp];
  const int64_t b0 = n * blockIdx.x / gridDim.x;
  const int64_t b1 = n * (blockIdx.x + 1) / gridDim.x;
  if (b0 >= b1) return;                     // the whole block: no rows
  const int j0 = blockIdx.y * Kg;
  const int j1 = min(K, j0 + Kg);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int cells = (Kg + Cw - 1) / Cw * Wg * Cw;   // per channel
  const int64_t C = static_cast<int64_t>(nch) * Sp;

  int k = 0;
  while (s_off[k + 1] <= b0) ++k;           // the slot whose bucket holds b0
  for (int64_t i = b0; i < b1;) {
    const int64_t seg_end = s_off[k + 1] < b1 ? s_off[k + 1] : b1;
    for (int c = threadIdx.x; c < nch * cells; c += blockDim.x) {
      tile[c] = AccT(0);
    }
    __syncthreads();
    for (int jc = j0; jc < j1; jc += Cw) {
      const int j = jc + lane;
      const bool on = lane < Cw && j < j1 && lay.live(j);
      const int width = on ? lay.width_of(j) : 0;
      AccT* col = tile + (jc - j0) / Cw * Wg * Cw + lane;
      for (int64_t q = i + warp * kHistUnroll; q < seg_end;
           q += nwarps * kHistUnroll) {
        bool ok[kHistUnroll];
        int b[kHistUnroll];
        AccT v[kHistUnroll][kLevelChannels];
#pragma unroll
        for (int u = 0; u < kHistUnroll; ++u) {
          ok[u] = q + u < seg_end;
          const uint8_t* rec = stage + (ok[u] ? q + u : q) * rec_bytes;
          const BinT* rb = reinterpret_cast<const BinT*>(rec);
          const ChT* rc = reinterpret_cast<const ChT*>(rec + ch_off);
          b[u] = on && ok[u] ? static_cast<int>(rb[j]) : 0;
#pragma unroll
          for (int ch = 0; ch < kLevelChannels; ++ch) {
            v[u][ch] = ch < nch && ok[u] ? Acc<ChT>::of(rc[ch]) : AccT(0);
          }
        }
#pragma unroll
        for (int u = 0; u < kHistUnroll; ++u) {
          if (!on || !ok[u] || !lay.in_slab(b[u], width)) continue;
          AccT* cell = col + b[u] * Cw;
#pragma unroll
          for (int ch = 0; ch < kLevelChannels; ++ch) {
            if (ch < nch) atomicAdd(cell + ch * cells, v[u][ch]);
          }
        }
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < nch * cells; c += blockDim.x) {
      const AccT x = tile[c];
      if (x != AccT(0)) {
        const int ch = c / cells;
        const int t = c - ch * cells;
        const int band = t / (Wg * Cw);
        const int b = t / Cw - band * Wg;
        const int j = j0 + band * Cw + t % Cw;
        atomicAdd(hist + (lay.start(j) + b) * C + ch * Sp + k, x);
      }
    }
    __syncthreads();                        // the tile is zeroed again next
    i = seg_end;
    while (k < Sp - 1 && s_off[k + 1] <= i) ++k;
  }
}

template <typename BinT, typename ChT>
cudaError_t launch_mark(const void* bins, const void* leaf, const void* gh,
                        const void* W, const void* tbl, const RowLayout& lay,
                        void* new_leaf, void* row_slot, void* counts,
                        int* slab_of, long long Rp, int K, long long FB,
                        int Sp, int nch, cudaStream_t stream,
                        int* launched) {
  const __nv_bfloat16* Wb = static_cast<const __nv_bfloat16*>(W);
  cudaError_t e = launch_slabs(Wb, lay, slab_of, K, FB, Sp, stream);
  if (e != cudaSuccess) return e;
  *launched |= kSlabsBit;
  const unsigned grid = static_cast<unsigned>((Rp + kMarkRows - 1) /
                                              kMarkRows);
  level_mark_kernel<BinT, ChT><<<grid, kThreads, 0, stream>>>(
      static_cast<const BinT*>(bins), static_cast<const int*>(leaf),
      static_cast<const ChT*>(gh), Wb, static_cast<const int*>(tbl), slab_of,
      lay, static_cast<int*>(new_leaf), static_cast<int8_t*>(row_slot),
      static_cast<int*>(counts), Rp, K, FB, Sp, nch);
  e = cudaGetLastError();
  if (e == cudaSuccess) *launched |= kMarkBit;
  return e;
}

template <typename BinT, typename ChT>
cudaError_t launch_partition(const void* row_slot, const void* counts,
                             void* cursor, const void* bins, const void* gh,
                             void* stage, long long Rp, int Sp, int K,
                             int nch, int ch_off, int rec_bytes,
                             cudaStream_t stream, int* launched) {
  const unsigned grid = static_cast<unsigned>((Rp + kMarkRows - 1) /
                                              kMarkRows);
  level_partition_kernel<BinT, ChT><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(row_slot), static_cast<const int*>(counts),
      static_cast<int*>(cursor), static_cast<const BinT*>(bins),
      static_cast<const ChT*>(gh), static_cast<uint8_t*>(stage),
      Rp, Sp, K, nch, ch_off, rec_bytes);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) *launched |= kPartitionBit;
  return e;
}

// grid.x: as many blocks as fit on the card at once (fewer for few rows).
// The dynamic shared memory above 48 KB is opted into once per instance
// and device, and the occupancy of the last tile size is kept per device,
// so a launch inside a CUDA graph capture makes no other API call.
template <typename BinT, typename ChT>
cudaError_t launch_hist(const void* stage, const void* counts,
                        const RowLayout& lay, void* hist, long long Rp,
                        int K, int Kg, int Cw, int Wg, int Sp, int nch,
                        int ch_off, int rec_bytes, cudaStream_t stream,
                        int* launched) {
  using AccT = typename Acc<ChT>::T;
  struct Cache {
    int opted = 48 * 1024;
    int occ_smem = -1;
    int occ = 0;
  };
  static Cache cache[kMaxDevices];
  static std::mutex lock;
  auto kernel = level_hist_kernel<BinT, ChT>;
  const size_t smem = static_cast<size_t>(nch) * ((Kg + Cw - 1) / Cw) *
                      Wg * Cw * sizeof(AccT);
  int dev = 0, sms = 0, optin = 0, occ = 0;
  cudaError_t e = device_limits(&dev, &sms, &optin);
  if (e != cudaSuccess) return e;
  {
    std::lock_guard<std::mutex> hold(lock);
    Cache& c = cache[dev];
    if (smem > static_cast<size_t>(c.opted)) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) {
        cudaGetLastError();
        return e;
      }
      c.opted = static_cast<int>(smem);
    }
    if (c.occ_smem != static_cast<int>(smem)) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.occ, kernel,
                                                        kHistThreads, smem);
      if (e != cudaSuccess) return e;
      c.occ_smem = static_cast<int>(smem);
    }
    occ = c.occ;
  }
  const long long want = (Rp + kHistMinRows - 1) / kHistMinRows;
  const long long fit = static_cast<long long>(sms) * (occ > 0 ? occ : 1);
  const dim3 grid(static_cast<unsigned>(want < fit ? want : fit),
                  static_cast<unsigned>((K + Kg - 1) / Kg));
  kernel<<<grid, kHistThreads, smem, stream>>>(
      static_cast<const uint8_t*>(stage), static_cast<const int*>(counts),
      lay, static_cast<AccT*>(hist), K, Kg, Cw, Wg, Sp, nch, ch_off,
      rec_bytes);
  e = cudaGetLastError();
  if (e == cudaSuccess) *launched |= kHistBit;
  return e;
}

struct LevelArgs {
  const void* bins; int bin_bytes; const void* leaf; const void* gh;
  int quant; const void* W; const void* tbl; RowLayout lay; void* hist;
  void* new_leaf; void* row_slot; void* counts; void* stage;
  long long Rp; int K; long long FB; int Sp; int nch; int Kg; int Cw;
  int Wg; int ch_off; int rec_bytes; cudaStream_t stream; int* launched;
};

template <typename BinT, typename ChT>
cudaError_t run_stages(const LevelArgs& a, bool mark, bool part, bool hist) {
  int* counts = static_cast<int*>(a.counts);
  cudaError_t e = cudaSuccess;
  if (mark) {
    e = launch_mark<BinT, ChT>(a.bins, a.leaf, a.gh, a.W, a.tbl, a.lay,
                               a.new_leaf, a.row_slot, counts,
                               counts + 2 * a.Sp, a.Rp, a.K, a.FB, a.Sp,
                               a.nch, a.stream, a.launched);
  }
  if (e == cudaSuccess && part) {
    e = launch_partition<BinT, ChT>(a.row_slot, counts, counts + a.Sp,
                                    a.bins, a.gh, a.stage, a.Rp, a.Sp, a.K,
                                    a.nch, a.ch_off, a.rec_bytes, a.stream,
                                    a.launched);
  }
  if (e == cudaSuccess && hist) {
    e = launch_hist<BinT, ChT>(a.stage, counts, a.lay, a.hist, a.Rp, a.K,
                               a.Kg, a.Cw, a.Wg, a.Sp, a.nch, a.ch_off,
                               a.rec_bytes, a.stream, a.launched);
  }
  return e;
}

inline int dispatch(const LevelArgs& a, bool mark, bool part, bool hist) {
  cudaError_t e;
  if (a.bin_bytes == 1) {
    e = a.quant ? run_stages<int8_t, int8_t>(a, mark, part, hist)
                : run_stages<int8_t, __nv_bfloat16>(a, mark, part, hist);
  } else {
    e = a.quant ? run_stages<int16_t, int8_t>(a, mark, part, hist)
                : run_stages<int16_t, __nv_bfloat16>(a, mark, part, hist);
  }
  return static_cast<int>(e);
}

}  // namespace lgbt

// The stages in order (stages = 7), or one of them (1 mark, 2 partition,
// 4 histogram), on one stream with no host sync. bin_bytes is 1 (int8) or
// 2 (int16); gh is bf16, or int8 when quant. ktab ([2, K] int32: offsets,
// then widths) and kmask ([K] uint8) may be null. counts is [3 * Sp] int32:
// the per-slot counts and the partition's cursors, zeroed by the caller,
// then the mark stage's slab table; hist is zeroed by the caller (f32, or
// int32 when quant); row_slot is [Rp] int8 and stage [Rp, rec_bytes] uint8
// scratch (ops/fused_level.py record_layout gives ch_off and rec_bytes).
// Kg kernel rows per histogram group, Cw tile columns, Wg the widest slab
// (level_hist_kernel). *launched gets one bit for each kernel launched,
// in the order slabs, mark, partition, histogram (1, 2, 4, 8), also when
// a later launch fails.
extern "C" int lgbt_level_pass(const void* bins, int bin_bytes,
                               const void* leaf, const void* gh, int quant,
                               const void* W, const void* tbl,
                               const void* ktab, const void* kmask,
                               void* hist, void* new_leaf, void* row_slot,
                               void* counts, void* stage, long long Rp,
                               int K, int B, long long FB, int Sp, int nch,
                               int Kg, int Cw, int Wg, int ch_off,
                               int rec_bytes, int stages, void* stream,
                               int* launched) {
  const int* kt = static_cast<const int*>(ktab);
  *launched = 0;
  const lgbt::LevelArgs a{
      bins, bin_bytes, leaf, gh, quant, W, tbl,
      lgbt::RowLayout{kt, kt == nullptr ? nullptr : kt + K,
                      static_cast<const uint8_t*>(kmask), B},
      hist, new_leaf, row_slot, counts, stage, Rp, K, FB, Sp, nch, Kg, Cw,
      Wg, ch_off, rec_bytes, static_cast<cudaStream_t>(stream), launched};
  return lgbt::dispatch(a, stages & 1, stages & 2, stages & 4);
}

// The current card's SM count and the shared memory a block may opt into.
extern "C" int lgbt_device_limits(int* sms, int* smem_optin) {
  int dev = 0;
  return static_cast<int>(lgbt::device_limits(&dev, sms, smem_optin));
}
