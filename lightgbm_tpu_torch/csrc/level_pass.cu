// level_pass: route every row one tree level down and histogram the rows
// of each split's smaller child, as six kernels on one stream.
//
// Replaces: the Pallas kernel _level_kernel (lightgbm_tpu/ops/fused_level.py
// :402, launched by level_pass :481), in all its compiled variants:
//   f32     bf16 gh channels (pack_gh) widened and summed in f32, so
//           hist_planes decodes the hi/lo channels unchanged;
//   quant   int8 gh channels (pack_gh_quant, tpu_quantized_grad 8 or 16)
//           summed exactly in int32;
//   packed  per-kernel-row slab offsets and widths on the flat axis
//           (tpu_adaptive_bins) in place of f * B;
//   fmask   a per-kernel-row 0/1 mask (tpu_gain_screening): a masked row's
//           slab adds nothing to the histogram or to the routing sum;
//   bundled EFB bundle columns (ops/efb.py): kernel rows are bundle columns
//           of B = Bc_p bins (int16 above 128), W rows come from
//           build_route_table_bundled — any slab width up to 32768 bins.
// Every combination is one template instance or one runtime table; a null
// table keeps the padded, unmasked path.
//
// Bound on the H100: bytes. Per row it reads K bin bytes, the leaf, nch
// channels (2 B each, 1 B quantized) and writes the new leaf (about 60 B at
// K=28, nch=5); the arithmetic is one gather per row plus K*nch adds for
// the smaller-child rows, far below the card's rate.
//
// Design (the fixed-order plan of hist_pass.cu, over staging records). No
// f32 atomic anywhere, so the f32 sums are the same bits on every call:
//   1. level_slabs: for each W row, the one kernel row whose slab holds a
//      non-zero (the split's; at the root the first kernel row), so a row
//      routes with one bin and one W read (slab_left). A W row over several
//      slabs takes the full sum.
//   2. level_mark: blocks of kMarkRows consecutive rows, warp w the 128
//      rows from w * 128 on, 32 per step; a row finds its slot through a
//      shared leaf -> slot hash (about two probes, not a scan of all Sp
//      slots). A row writes its new leaf; a
//      smaller-child row with a non-zero channel records its slot in
//      row_slot (else -1). Each warp counts its rows per slot in a counter
//      row of its own (match_any groups; a group's first lane adds), and the
//      block writes its per-slot totals, cnt[slot][block]: no atomic.
//   3. level_scan: one block scans cnt slot-major into off (where each
//      block's rows of each slot start in the buckets) and slot_off.
//   4. level_partition: the same blocks count their warps' rows again and
//      write each marked row's staging record — its K bins and nch
//      channels, 16-byte pieces (record_layout) — at off[slot][block] +
//      its warps' earlier rows + its rank in its warp. The order inside a
//      bucket is row order (slot, block, warp, step, lane).
//   5. level_tiles: grid (row blocks, kernel-row groups, bin groups). Block
//      x takes an even share of the n records (n read on the device: the
//      host never syncs), kernel rows [y * Cw, y * Cw + Cw) and bins
//      [z * Bw, z * Bw + Bw). Each warp owns a private tile of one channel:
//      Bw bins x 32 lanes, lane l's cells in bank l. Lane l adds for kernel
//      row l % Cw and for every R-th record of the warp's share (R = 32 /
//      Cw replicas: narrow bundle layouts keep every lane busy), with plain
//      loads, adds and stores — no two lanes, and no two warps, share a
//      cell; a lane takes four records per step, their cells loaded
//      together (a record whose bin an earlier one of the step has adds
//      onto that one's sum; the stores go in record order, so every cell
//      sums in record order). The nch x nr warps split as nch channels x
//      nr record lanes. At
//      each slot change and at the end the block sums its tiles in a fixed
//      order (record lane, then replica) into the part slice of (block,
//      slot), and zeroes them.
//   6. level_reduce: each histogram cell is the sum of the part slices of
//      the blocks that hold its slot, in block order.
// int32 (quant) sums are exact whatever the order; the same plan serves
// them. A slab of any width runs: bins beyond Bw take more bin groups.
#include "fused_level.cuh"

namespace lgbt {

constexpr int kMarkThreads = kThreads;    // 8 warps
constexpr int kMarkWarps = kMarkThreads / 32;
constexpr int kMarkSteps = 8;             // 32-row steps per warp
constexpr int kMarkRows = kMarkThreads * kMarkSteps;   // rows per block
constexpr int kScanThreads = 1024;
constexpr int kTileUnroll = 4;            // records in flight per lane
constexpr int kReduceThreads = 256;
// the bits lgbt_level_pass reports, one per kernel it launched
constexpr int kSlabsBit = 1, kMarkBit = 2, kScanBit = 4, kPartitionBit = 8,
              kTilesBit = 16, kReduceBit = 32;

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

// Row of step u of this thread: warp w of block x holds the 128 rows from
// x * kMarkRows + w * 128 on, 32 per step — so (warp, step, lane) is row
// order inside a block.
__device__ inline int64_t mark_row(int u) {
  return static_cast<int64_t>(blockIdx.x) * kMarkRows +
         (threadIdx.x >> 5) * (32 * kMarkSteps) + u * 32 + (threadIdx.x & 31);
}

// wc (this warp's counter row, [Sp], zeroed) += the warp's rows of each
// slot; rank[u] = the row's place among its warp's rows of its slot, in
// row order. One group per distinct slot in a step (match_any); its first
// lane adds: no atomic.
__device__ inline void count_warp(const int (&slot)[kMarkSteps], int* wc,
                                  int (&rank)[kMarkSteps]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kMarkSteps; ++u) {
    const unsigned m = __match_any_sync(0xffffffffu, slot[u]);
    rank[u] = slot[u] >= 0 ? wc[slot[u]] + __popc(m & ((1u << lane) - 1u))
                           : 0;
    __syncwarp();
    if (slot[u] >= 0 && lane == __ffs(m) - 1) wc[slot[u]] += __popc(m);
    __syncwarp();
  }
}

template <typename BinT, typename ChT>
__global__ void __launch_bounds__(kMarkThreads)
level_mark_kernel(const BinT* __restrict__ bins,
                  const int* __restrict__ leaf, const ChT* __restrict__ gh,
                  const __nv_bfloat16* __restrict__ W,
                  const int* __restrict__ tbl,
                  const int* __restrict__ slab_of, RowLayout lay,
                  int* __restrict__ new_leaf, int8_t* __restrict__ row_slot,
                  int* __restrict__ cnt, int64_t Rp, int K, int64_t FB,
                  int Sp, int nch) {
  __shared__ SlotTables t;
  __shared__ SlotHash hash;
  __shared__ int s_slab[kMaxSlots];
  __shared__ int s_wc[kMarkWarps][kMaxSlots];
  for (int k = threadIdx.x; k < Sp; k += blockDim.x) s_slab[k] = slab_of[k];
  for (int i = threadIdx.x; i < kMarkWarps * kMaxSlots; i += blockDim.x) {
    (&s_wc[0][0])[i] = 0;
  }
  load_tables(t, tbl, Sp);   // ends in __syncthreads()
  build_slot_hash(hash, t, Sp);
  int slot[kMarkSteps];
#pragma unroll
  for (int u = 0; u < kMarkSteps; ++u) {
    const int64_t r = mark_row(u);
    slot[u] = -1;
    if (r >= Rp) continue;
    const int lf = leaf[r];
    const int k = hash_slot(hash, lf);
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
        if (live) slot[u] = k;
      }
    }
    row_slot[r] = static_cast<int8_t>(slot[u]);
  }
  int rank[kMarkSteps];
  count_warp(slot, s_wc[threadIdx.x >> 5], rank);
  __syncthreads();
  for (int k = threadIdx.x; k < Sp; k += blockDim.x) {
    int sum = 0;
    for (int w = 0; w < kMarkWarps; ++w) sum += s_wc[w][k];
    cnt[static_cast<int64_t>(k) * gridDim.x + blockIdx.x] = sum;
  }
}

// Exclusive scan of v[0..n) in place (n <= kScanPer * blockDim.x);
// returns the total to every thread. Ends in __syncthreads().
constexpr int kScanPer = 8;
__device__ inline int block_scan(int* v, int n, int* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i0 = threadIdx.x * kScanPer;
  int x[kScanPer];
  int sum = 0;
#pragma unroll
  for (int q = 0; q < kScanPer; ++q) {
    x[q] = i0 + q < n ? v[i0 + q] : 0;
    sum += x[q];
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    if (w < warp) before += s_warp[w];
    total += s_warp[w];
  }
  int run = before + incl - sum;
#pragma unroll
  for (int q = 0; q < kScanPer; ++q) {
    if (i0 + q < n) v[i0 + q] = run;
    run += x[q];
  }
  __syncthreads();
  return total;
}

// One block: off = the exclusive scan of cnt taken slot-major (off[k * nb
// + x] is where block x's rows of slot k start in the buckets), slot_off[k]
// = off[k * nb] and slot_off[Sp] = the total.
__global__ void __launch_bounds__(kScanThreads)
level_scan_kernel(const int* __restrict__ cnt, int* __restrict__ off,
                  int* __restrict__ slot_off, int nb, int Sp) {
  constexpr int kTile = kScanPer * kScanThreads;
  __shared__ int s_v[kTile];
  __shared__ int s_warp[kScanThreads / 32];
  const int64_t n = static_cast<int64_t>(nb) * Sp;
  int carry = 0;
  for (int64_t t0 = 0; t0 < n; t0 += kTile) {
    const int len = static_cast<int>(n - t0 < kTile ? n - t0 : kTile);
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      s_v[i] = i < len ? cnt[t0 + i] : 0;
    }
    __syncthreads();
    const int total = block_scan(s_v, len, s_warp);
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      off[t0 + i] = carry + s_v[i];
    }
    for (int k = threadIdx.x; k < Sp; k += blockDim.x) {
      const int64_t g = static_cast<int64_t>(k) * nb - t0;   // block 0 of k
      if (g >= 0 && g < len) slot_off[k] = carry + s_v[g];
    }
    carry += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) slot_off[Sp] = carry;
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
__global__ void __launch_bounds__(kMarkThreads)
level_partition_kernel(const int8_t* __restrict__ row_slot,
                       const int* __restrict__ off,
                       const BinT* __restrict__ bins,
                       const ChT* __restrict__ gh, uint8_t* __restrict__ stage,
                       int64_t Rp, int Sp, int K, int nch, int ch_off,
                       int rec_bytes) {
  __shared__ int s_wc[kMarkWarps][kMaxSlots];
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kMarkWarps * kMaxSlots; i += blockDim.x) {
    (&s_wc[0][0])[i] = 0;
  }
  __syncthreads();
  int slot[kMarkSteps];
#pragma unroll
  for (int u = 0; u < kMarkSteps; ++u) {
    const int64_t r = mark_row(u);
    slot[u] = r < Rp ? row_slot[r] : -1;
  }
  int rank[kMarkSteps];
  count_warp(slot, s_wc[warp], rank);
  __syncthreads();
  // each warp's place in each slot's run: the block's offset plus the
  // earlier warps' rows (one thread per slot, warps in order)
  for (int k = threadIdx.x; k < Sp; k += blockDim.x) {
    int run = off[static_cast<int64_t>(k) * gridDim.x + blockIdx.x];
    for (int w = 0; w < kMarkWarps; ++w) {
      const int c = s_wc[w][k];
      s_wc[w][k] = run;
      run += c;
    }
  }
  __syncthreads();
  for (int u = 0; u < kMarkSteps; ++u) {
    if (slot[u] < 0) continue;
    const int64_t r = mark_row(u);
    const int64_t at = static_cast<int64_t>(s_wc[warp][slot[u]]) + rank[u];
    uint4* rec = reinterpret_cast<uint4*>(stage + at * rec_bytes);
    for (int c = 0; c < rec_bytes / 16; ++c) {
      rec[c] = record_piece(c, bins, gh, Rp, r, K, ch_off, nch);
    }
  }
}

// The records of block x of gx: [n x / gx, n (x + 1) / gx).
__device__ inline int64_t share_start(int64_t n, int x, int gx) {
  return n * x / gx;
}

// The part slice of (block x, slot k) for kernel-row group y and bin
// group z: (x + k) is unique among the pairs that hold rows (block ranges
// are monotone), so at most gx + Sp slices per (y, z).
__device__ inline int64_t slice_index(int x, int k, int y, int z, int gy,
                                      int gz) {
  return (static_cast<int64_t>(x + k) * gy + y) * gz + z;
}

// grid (gx row blocks, gy kernel-row groups of Cw, gz bin groups of Bw);
// nch * nr warps: warp w adds channel w % nch for record lane w / nch.
// Lane l adds kernel row y * Cw + l % Cw for replica l / Cw (R = 32 / Cw
// replicas). part slice (x, k, y, z) holds [nch][Bw][Cw] sums in the
// accumulator type, written only where block x holds rows of slot k.
// (A warp adding all nch channels of its records, on tiles nch times as
// large and so with nch times fewer warps, was slower on the H100 at every
// shape of chip_smoke.py's phase 2.)
template <typename BinT, typename ChT>
__global__ void __launch_bounds__(1024)
level_tiles_kernel(const uint8_t* __restrict__ stage,
                   const int* __restrict__ slot_off, RowLayout lay,
                   typename Acc<ChT>::T* __restrict__ part, int K, int Cw,
                   int Bw, int nr, int Sp, int nch, int ch_off,
                   int rec_bytes) {
  using AccT = typename Acc<ChT>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AccT* tiles = reinterpret_cast<AccT*>(smem_raw);
  __shared__ int64_t s_off[kMaxSlots + 1];
  for (int k = threadIdx.x; k <= Sp; k += blockDim.x) s_off[k] = slot_off[k];
  __syncthreads();
  const int64_t n = s_off[Sp];
  const int x = blockIdx.x, gx = gridDim.x;
  const int64_t b0 = share_start(n, x, gx);
  const int64_t b1 = share_start(n, x + 1, gx);
  if (b0 >= b1) return;                     // the whole block: no rows
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = warp % nch;                 // this warp's channel
  const int wr = warp / nch;                // its record lane
  const int R = 32 / Cw;
  const int col = lane % Cw;
  const int rep = lane / Cw;
  const int j = blockIdx.y * Cw + col;
  const bool on = rep < R && j < K && lay.live(j);
  const int width = on ? lay.width_of(j) : 0;
  const int b_lo = blockIdx.z * Bw;
  const int tile_cells = Bw * 32;
  AccT* mine = tiles + warp * tile_cells + lane;
  const int cells = nch * Bw * Cw;          // per part slice
  const int step = nr * R;
  // this lane's bin and this warp's channel within a record (record
  // offsets fit 32 bits: the wrapper checks Rp * rec_bytes)
  const BinT* bin0 = reinterpret_cast<const BinT*>(stage) + j;
  const ChT* chan0 = reinterpret_cast<const ChT*>(stage + ch_off) + c;

  int k = 0;
  while (s_off[k + 1] <= b0) ++k;           // the slot whose bucket holds b0
  for (int64_t i = b0; i < b1;) {
    const int64_t seg_end = s_off[k + 1] < b1 ? s_off[k + 1] : b1;
    for (int b = 0; b < Bw; ++b) mine[b * 32] = AccT(0);
    if (on) {
      for (int64_t q = i + wr * R + rep; q < seg_end;
           q += kTileUnroll * step) {
        int bb[kTileUnroll];
        AccT v[kTileUnroll];
#pragma unroll
        for (int u = 0; u < kTileUnroll; ++u) {
          const int64_t p = q + u * step;
          const bool in = p < seg_end;
          const uint32_t at = static_cast<uint32_t>(in ? p : q) *
                              static_cast<uint32_t>(rec_bytes);
          const int b = static_cast<int>(*reinterpret_cast<const BinT*>(
              reinterpret_cast<const uint8_t*>(bin0) + at));
          v[u] = Acc<ChT>::of(*reinterpret_cast<const ChT*>(
              reinterpret_cast<const uint8_t*>(chan0) + at));
          bb[u] = in && lay.in_slab(b, width) ? b - b_lo : -1;
        }
        // the step's cells loaded together; a record whose bin an earlier
        // record of the step has adds onto that record's new sum, and the
        // stores go in record order, so the last store of a cell holds
        // every add, in record order
        bool ok[kTileUnroll];
        AccT sum[kTileUnroll];
#pragma unroll
        for (int u = 0; u < kTileUnroll; ++u) {
          ok[u] = static_cast<unsigned>(bb[u]) < static_cast<unsigned>(Bw);
          sum[u] = ok[u] ? mine[bb[u] * 32] : AccT(0);
        }
#pragma unroll
        for (int u = 0; u < kTileUnroll; ++u) {
#pragma unroll
          for (int t = 0; t < u; ++t) {       // later t wins: the newest
            if (ok[t] && bb[t] == bb[u]) sum[u] = sum[t];
          }
          sum[u] += v[u];
        }
#pragma unroll
        for (int u = 0; u < kTileUnroll; ++u) {
          if (ok[u]) mine[bb[u] * 32] = sum[u];
        }
      }
    }
    __syncthreads();
    // the tiles summed in a fixed order (record lane, then replica) into
    // the part slice of (block, slot)
    AccT* out = part + slice_index(x, k, blockIdx.y, blockIdx.z, gridDim.y,
                                   gridDim.z) * cells;
    for (int e = threadIdx.x; e < cells; e += blockDim.x) {
      const int ce = e / (Bw * Cw);
      const int rest = e - ce * Bw * Cw;
      const int b = rest / Cw;
      const int cl = rest - b * Cw;
      AccT sum = AccT(0);
      for (int w = 0; w < nr; ++w) {
        const AccT* tw = tiles + (w * nch + ce) * tile_cells + b * 32 + cl;
        for (int r = 0; r < R; ++r) sum += tw[r * Cw];
      }
      out[e] = sum;
    }
    __syncthreads();                        // the tiles are zeroed again next
    i = seg_end;
    while (k < Sp - 1 && s_off[k + 1] <= i) ++k;
  }
}

// The block of gx whose share of n holds record s (the last of any equal
// starts, so a non-empty one).
__device__ inline int share_block(int64_t n, int gx, int64_t s) {
  int x = static_cast<int>(s * gx / n);
  while (x + 1 < gx && share_start(n, x + 1, gx) <= s) ++x;
  while (x > 0 && share_start(n, x, gx) > s) --x;
  return x;
}

// hist[(start(j) + b) * C + ch * Sp + k] = the sum, in block order, of the
// part slices of the blocks holding rows of slot k (their range is found
// once per block and slot); grid (cells of the widest slab /
// kReduceThreads, K). Empty slots and masked kernel rows are left as the
// caller zeroed them.
template <typename AccT>
__global__ void __launch_bounds__(kReduceThreads)
level_reduce_kernel(const AccT* __restrict__ part,
                    const int* __restrict__ slot_off, RowLayout lay,
                    AccT* __restrict__ hist, int Cw, int Bw, int gx, int gy,
                    int gz, int Sp, int nch) {
  __shared__ int s_x0[kMaxSlots], s_x1[kMaxSlots];
  const int64_t n = slot_off[Sp];
  for (int k = threadIdx.x; k < Sp; k += blockDim.x) {
    const int64_t s0 = slot_off[k], s1 = slot_off[k + 1];
    s_x0[k] = s0 < s1 ? share_block(n, gx, s0) : 0;
    s_x1[k] = s0 < s1 ? share_block(n, gx, s1 - 1) : -1;
  }
  __syncthreads();
  const int j = blockIdx.y;
  if (!lay.live(j)) return;
  const int width = lay.width_of(j);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= static_cast<int64_t>(width) * nch * Sp) return;
  const int k = static_cast<int>(t % Sp);
  const int ch = static_cast<int>(t / Sp % nch);
  const int b = static_cast<int>(t / Sp / nch);
  const int x0 = s_x0[k], x1 = s_x1[k];
  if (x1 < x0) return;                      // an empty slot
  const int y = j / Cw, col = j - y * Cw;
  const int z = b / Bw, bb = b - z * Bw;
  const int cells = nch * Bw * Cw;
  const int e = (ch * Bw + bb) * Cw + col;
  // with n >= gx every block's share holds rows; else skip the empty ones,
  // which wrote no slice
  const bool all_live = n >= gx;
  AccT sum = AccT(0);
  for (int x = x0; x <= x1; ++x) {
    if (all_live || share_start(n, x, gx) < share_start(n, x + 1, gx)) {
      sum += part[slice_index(x, k, y, z, gy, gz) * cells + e];
    }
  }
  hist[(lay.start(j) + b) * static_cast<int64_t>(nch) * Sp +
       static_cast<int64_t>(ch) * Sp + k] = sum;
}

struct LevelArgs {
  const void* bins; int bin_bytes; const void* leaf; const void* gh;
  int quant; const void* W; const void* tbl; RowLayout lay; void* hist;
  void* new_leaf; void* row_slot; void* counts; void* stage; void* part;
  long long Rp; int K; long long FB; int Sp; int nch; int Cw; int Bw;
  int width; int nr; int gx; int ch_off; int rec_bytes;
  cudaStream_t stream; int* launched;
};

// The counts buffer: [cnt: Sp * nb][off: Sp * nb][slot_off: Sp + 1]
// [slab_of: Sp], nb the mark stage's row blocks.
inline int mark_blocks(long long Rp) {
  return static_cast<int>((Rp + kMarkRows - 1) / kMarkRows);
}

template <typename BinT, typename ChT>
cudaError_t launch_mark(const LevelArgs& a) {
  const int nb = mark_blocks(a.Rp);
  int* cnt = static_cast<int*>(a.counts);
  int* off = cnt + static_cast<int64_t>(a.Sp) * nb;
  int* slot_off = off + static_cast<int64_t>(a.Sp) * nb;
  int* slab_of = slot_off + a.Sp + 1;
  const __nv_bfloat16* Wb = static_cast<const __nv_bfloat16*>(a.W);
  cudaError_t e = launch_slabs(Wb, a.lay, slab_of, a.K, a.FB, a.Sp,
                               a.stream);
  if (e != cudaSuccess) return e;
  *a.launched |= kSlabsBit;
  level_mark_kernel<BinT, ChT><<<nb, kMarkThreads, 0, a.stream>>>(
      static_cast<const BinT*>(a.bins), static_cast<const int*>(a.leaf),
      static_cast<const ChT*>(a.gh), Wb, static_cast<const int*>(a.tbl),
      slab_of, a.lay, static_cast<int*>(a.new_leaf),
      static_cast<int8_t*>(a.row_slot), cnt, a.Rp, a.K, a.FB, a.Sp, a.nch);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  *a.launched |= kMarkBit;
  level_scan_kernel<<<1, kScanThreads, 0, a.stream>>>(cnt, off, slot_off,
                                                      nb, a.Sp);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  *a.launched |= kScanBit;
  return e;
}

template <typename BinT, typename ChT>
cudaError_t launch_partition(const LevelArgs& a) {
  const int nb = mark_blocks(a.Rp);
  const int* off = static_cast<const int*>(a.counts) +
                   static_cast<int64_t>(a.Sp) * nb;
  level_partition_kernel<BinT, ChT><<<nb, kMarkThreads, 0, a.stream>>>(
      static_cast<const int8_t*>(a.row_slot), off,
      static_cast<const BinT*>(a.bins), static_cast<const ChT*>(a.gh),
      static_cast<uint8_t*>(a.stage), a.Rp, a.Sp, a.K, a.nch, a.ch_off,
      a.rec_bytes);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) *a.launched |= kPartitionBit;
  return e;
}

// The tiles' dynamic shared memory above 48 KB is opted into once per
// instance, size and device, so a launch inside a CUDA graph capture makes
// no other API call.
template <typename BinT, typename ChT>
cudaError_t launch_hist(const LevelArgs& a) {
  using AccT = typename Acc<ChT>::T;
  static int opted[kMaxDevices] = {};
  static std::mutex lock;
  auto kernel = level_tiles_kernel<BinT, ChT>;
  const int warps = a.nch * a.nr;
  const size_t smem = static_cast<size_t>(warps) * a.Bw * 32 * sizeof(AccT);
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = device_limits(&dev, &sms, &optin);
  if (e != cudaSuccess) return e;
  // record offsets are 32-bit in the tiles kernel
  if (warps * 32 > 1024 || a.Cw < 1 || a.Cw > 32 ||
      a.Rp * a.rec_bytes >= (1LL << 32) ||
      smem > static_cast<size_t>(optin)) {
    return cudaErrorInvalidValue;
  }
  {
    std::lock_guard<std::mutex> hold(lock);
    if (smem > 48 * 1024 && static_cast<int>(smem) > opted[dev]) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) {
        cudaGetLastError();
        return e;
      }
      opted[dev] = static_cast<int>(smem);
    }
  }
  const int* slot_off = static_cast<const int*>(a.counts) +
                        2 * static_cast<int64_t>(a.Sp) * mark_blocks(a.Rp);
  const int gy = (a.K + a.Cw - 1) / a.Cw;
  const int gz = (a.width + a.Bw - 1) / a.Bw;
  kernel<<<dim3(a.gx, gy, gz), warps * 32, smem, a.stream>>>(
      static_cast<const uint8_t*>(a.stage), slot_off, a.lay,
      static_cast<AccT*>(a.part), a.K, a.Cw, a.Bw, a.nr, a.Sp, a.nch,
      a.ch_off, a.rec_bytes);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  *a.launched |= kTilesBit;
  const long long outs = static_cast<long long>(a.width) * a.nch * a.Sp;
  level_reduce_kernel<AccT><<<dim3(static_cast<unsigned>(
                                       (outs + kReduceThreads - 1) /
                                       kReduceThreads), a.K),
                              kReduceThreads, 0, a.stream>>>(
      static_cast<const AccT*>(a.part), slot_off, a.lay,
      static_cast<AccT*>(a.hist), a.Cw, a.Bw, a.gx, gy, gz, a.Sp, a.nch);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  *a.launched |= kReduceBit;
  return e;
}

template <typename BinT, typename ChT>
cudaError_t run_stages(const LevelArgs& a, bool mark, bool part, bool hist) {
  cudaError_t e = cudaSuccess;
  if (mark) e = launch_mark<BinT, ChT>(a);
  if (e == cudaSuccess && part) e = launch_partition<BinT, ChT>(a);
  if (e == cudaSuccess && hist) e = launch_hist<BinT, ChT>(a);
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

// The stages in order (stages = 7), or any of them (1 mark: slab table,
// mark and scan; 2 partition; 4 histogram: tiles and reduce), on one stream
// with no host sync. bin_bytes is 1 (int8) or 2 (int16); gh is bf16, or
// int8 when quant. ktab ([2, K] int32: offsets, then widths) and kmask
// ([K] uint8) may be null. counts is int32 scratch of 2 * Sp * nb + 2 * Sp
// + 1 words (nb = ceil(Rp / 2048)): the per-(slot, block) counts, their
// offsets, the slot offsets and the slab table (the mark stage writes all
// of them). hist is zeroed by the caller (f32, or int32 when quant);
// row_slot is [Rp] int8, stage [Rp, rec_bytes] uint8 and part the tiles'
// slices, (gx + Sp) * gy * gz * nch * Bw * Cw accumulators (gy = ceil(K /
// Cw), gz = ceil(width / Bw)). Cw kernel rows per tile (<= 32), Bw bins per
// tile, width the widest slab, nr record lanes, gx row blocks
// (ops/fused_level.py level_tile_shape). Rp * rec_bytes < 2^32. *launched gets one bit for each
// kernel launched, in the order slabs, mark, scan, partition, tiles,
// reduce (1, 2, 4, 8, 16, 32), also when a later launch fails.
extern "C" int lgbt_level_pass(const void* bins, int bin_bytes,
                               const void* leaf, const void* gh, int quant,
                               const void* W, const void* tbl,
                               const void* ktab, const void* kmask,
                               void* hist, void* new_leaf, void* row_slot,
                               void* counts, void* stage, void* part,
                               long long Rp, int K, int B, long long FB,
                               int Sp, int nch, int Cw, int Bw, int width,
                               int nr, int gx, int ch_off, int rec_bytes,
                               int stages, void* stream, int* launched) {
  const int* kt = static_cast<const int*>(ktab);
  *launched = 0;
  const lgbt::LevelArgs a{
      bins, bin_bytes, leaf, gh, quant, W, tbl,
      lgbt::RowLayout{kt, kt == nullptr ? nullptr : kt + K,
                      static_cast<const uint8_t*>(kmask), B},
      hist, new_leaf, row_slot, counts, stage, part, Rp, K, FB, Sp, nch, Cw,
      Bw, width, nr, gx, ch_off, rec_bytes,
      static_cast<cudaStream_t>(stream), launched};
  return lgbt::dispatch(a, stages & 1, stages & 2, stages & 4);
}

// The current card's SM count and the shared memory a block may opt into.
extern "C" int lgbt_device_limits(int* sms, int* smem_optin) {
  int dev = 0;
  return static_cast<int>(lgbt::device_limits(&dev, sms, smem_optin));
}
