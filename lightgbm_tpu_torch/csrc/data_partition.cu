// data_partition: the leaf-wise grower's rows kept as one index list on the
// card, grouped by leaf (the reference LightGBM's DataPartition,
// src/treelearner/data_partition.hpp), and the two row passes of a leaf-wise
// step that read only a leaf's listed rows.
//
// State (models/learner.py grow_tree_leafwise, per tree):
//   order      [R] int32  row ids grouped by leaf, in row order within a leaf
//   leaf_begin [L] int32  where each leaf's segment of order starts
//   leaf_rows  [L] int32  its length (every row counts, zero weight or not)
//   scratch    [R] int32  the partition's staging list
// The split leaf, the new leaf and the step's do-split flag are one-element
// device tensors (int64, int64, bool), so a step reads nothing on the host.
//
// 1. leaf_partition (two kernels): rewrites the split leaf l's segment
//    stably, its left rows first, then its right rows, and sets
//    leaf_rows[l], leaf_begin[new] and leaf_rows[new]. A row goes left iff
//    left_tab[bins[row, col]] is 1 (the split's decision for every value of
//    the kernel's bin column, built by the grower from its routing code:
//    the bundle window, the missing rules and the category set). With the
//    flag false it writes nothing.
//    Replaces: the leaf-wise grower's per-row partition update,
//    jnp.where over all R rows (lightgbm_tpu/models/learner.py:735-736;
//    no Pallas kernel: the JAX package leaves it to XLA).
//    Bound on the H100: bytes. The segment's row ids are read, each row's
//    one bin gathered and its id written twice (the staging list, then the
//    segment): 16 B per row, 0.1 MB at 6,000 rows, ~0.03 us at 3.35 TB/s;
//    the time is latency (three dependent loads, then the writes).
//    Design: a fixed grid of kPartBlocks blocks; each takes a contiguous
//    share of the segment, whose length it reads from device memory (at
//    least kPartThreads rows a block, so a small segment uses few blocks).
//    partition_split: a block loads up to kPartItems tiles of its rows at
//    once (ids, then bins, then the table), ranks each tile's left and
//    right rows by warp ballots and a scan over the block's warps, writes
//    the left rows to the front of its share of scratch in order and the
//    right rows to the back in reverse, and stores its left count; block 0
//    keeps the segment's begin and length beside the counts. partition_copy:
//    each block scans the counts (every block's left rows before it, and
//    the total), copies its left rows to the left child's place and its
//    right rows, reversed again, to the right child's, in order; block 0
//    writes the children's begins and lengths. Two launches, no atomic,
//    integer work only: the same output on every call.
//
// 2. leaf_hist (one kernel): the [3, Fp, Bk] f32 planes (g, h, count
//    weight) of the rows listed in one leaf's segment:
//        out[c, f, bins[r, f]] += gh[r, c]   for r in the segment
//    the channels as given (no bf16 rounding), summed in f64 and rounded to
//    f32 once, as the plain version sums them; bins outside [0, Bk) adding
//    nothing; with the flag false every cell is 0.
//    Replaces: the leaf-wise step's smaller-child histogram, the XLA
//    engine's build_histograms at one slot (lightgbm_tpu/ops/
//    histogram.py:71, over where(row_leaf == target, 0, -1)), which the
//    port ran through hist_pass's unrounded variant: five kernels that read
//    every row's slot to find ~3,000 child rows among 1M.
//    Bound on the H100: bytes. Each listed row's id, its Fp bins and its 3
//    channels are read (4 * (1 + Fp + 3) B) and the planes written once
//    (12 * Fp * Bk B): 0.40 MB at 3,041 rows, Fp = 28, Bk = 64, 0.12 us;
//    the adds are 3 * Fp per row.
//    Design: grid.y takes tiles of 32 features (one lane each) by 16 bins;
//    grid.x a fixed number of blocks, each a contiguous share of the list
//    (at least kLhMinShare rows, so a small child uses few blocks). A block
//    takes its share in chunks of kLhChunk listed rows: their ids (loaded
//    during the previous chunk's adds, or while the tiles are zeroed) and
//    channels go to shared memory, and each of its 8 warps loads the 32
//    bins of the tile for each of its rows of the chunk (every 8th, in
//    list order) into registers, all in flight at once: two dependent
//    loads a chunk. The warp then adds those rows into a private f64 tile
//    of 3 x 16 bins x 32 lanes (lane f's cells side by side), with plain
//    loads, adds and stores. Rows whose channels are all zero (out of the
//    bag) are skipped: adding a zero changes no sum. The block sums its
//    warps' tiles in warp order into its f64 partial slice; the last block
//    to arrive at the tile's integer counter (zeroed on the stream before
//    the launch, so every call stands alone) sums the slices in block
//    order, kLhSliceBatch slices' loads in flight at once, and writes the
//    tile's cells rounded to f32. No f32 atomic: the same bits on every
//    call. Why f64: one f32 cell that most listed rows share (a bundle
//    column's default bin) is a chain of ~1,000 sequential f32 adds per
//    warp at 14d's first step (42,000 rows, 5 blocks a tile), 1.3e-5 of the
//    cell's |value| sum off the exact sum; in f64 the chain costs nothing
//    and the answer is the plain version's up to f64 order.
//    Versions timed on one H100 at 3,041 listed rows of 1M (PERF.md,
//    scripts/kernel_ab.py list): the bins staged in shared memory one row
//    per loop step, 0.0213 ms (loads that waited on each other: 1.08 ms at
//    1M rows); the same registers design with f32 tiles of 32 bins,
//    0.0119-0.0122; clusters of 8 blocks summing their tiles in
//    distributed shared memory, 0.0115-0.0137 at 128-512 threads a block,
//    slower at 30,000 rows and more, not kept. What holds this design
//    above index_add_ (0.008) is its floor: a step that does not split
//    takes 0.006-0.009 ms (the leaf's begin read through the leaf index,
//    the tiles zeroed and summed, the arrival count, the write).
#include "fused_level.cuh"

namespace lgbt {

// ------------------------------------------------------- leaf_partition
constexpr int kPartThreads = 256;
constexpr int kPartWarps = kPartThreads / 32;
constexpr int kPartBlocks = 256;     // ops/data_partition.PART_BLOCKS
constexpr int kPartItems = 8;        // tiles of rows a thread loads at once
// the bits lgbt_leaf_partition reports, one per kernel it launched
constexpr int kSplitBit = 1, kCopyBit = 2;

// Rows per block of a segment of n rows: an even share of kPartBlocks, at
// least one tile, in whole tiles.
__device__ inline int part_share(int n) {
  int s = (n + kPartBlocks - 1) / kPartBlocks;
  s = ((s + kPartThreads - 1) / kPartThreads) * kPartThreads;
  return s < kPartThreads ? kPartThreads : s;
}

__device__ inline unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__global__ void __launch_bounds__(kPartThreads)
partition_split_kernel(const int* __restrict__ order, int* __restrict__ scratch,
                       const int* __restrict__ leaf_begin,
                       const int* __restrict__ leaf_rows,
                       const long long* __restrict__ leaf,
                       const bool* __restrict__ ds,
                       const int* __restrict__ bins, int Fp,
                       const long long* __restrict__ col,
                       const uint8_t* __restrict__ left_tab, int Bk,
                       int* __restrict__ work) {
  if (!*ds) return;
  const long long l = *leaf;
  const int b = leaf_begin[l];
  const int n = leaf_rows[l];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    work[kPartBlocks] = b;
    work[kPartBlocks + 1] = n;
  }
  const int share = part_share(n);
  const long long cs64 = static_cast<long long>(blockIdx.x) * share;
  if (cs64 >= n) return;
  const int cs = static_cast<int>(cs64);
  const int ce = min(cs + share, n);
  const long long c = *col;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = lanes_below();
  __shared__ int s_left[kPartWarps];
  __shared__ int s_rows[kPartWarps];
  int run_l = 0, run_r = 0;
  for (int base = cs; base < ce; base += kPartThreads * kPartItems) {
    int row[kPartItems];
    int bin[kPartItems];
#pragma unroll
    for (int k = 0; k < kPartItems; ++k) {
      const int i = base + k * kPartThreads + threadIdx.x;
      row[k] = i < ce ? order[b + i] : 0;
    }
#pragma unroll
    for (int k = 0; k < kPartItems; ++k) {
      const int i = base + k * kPartThreads + threadIdx.x;
      bin[k] = i < ce ? bins[static_cast<long long>(row[k]) * Fp + c] : 0;
    }
#pragma unroll
    for (int k = 0; k < kPartItems; ++k) {
      const int i = base + k * kPartThreads + threadIdx.x;
      const bool valid = i < ce;
      const int v = min(max(bin[k], 0), Bk - 1);
      const bool left = valid && __ldg(left_tab + v) != 0;
      const unsigned ml = __ballot_sync(0xffffffffu, left);
      const unsigned mv = __ballot_sync(0xffffffffu, valid);
      if (lane == 0) {
        s_left[warp] = __popc(ml);
        s_rows[warp] = __popc(mv);
      }
      __syncthreads();
      int off_l = 0, off_v = 0, tot_l = 0, tot_v = 0;
#pragma unroll
      for (int w = 0; w < kPartWarps; ++w) {
        const int wl = s_left[w], wv = s_rows[w];
        if (w < warp) {
          off_l += wl;
          off_v += wv;
        }
        tot_l += wl;
        tot_v += wv;
      }
      if (valid) {
        if (left) {
          scratch[b + cs + run_l + off_l + __popc(ml & below)] = row[k];
        } else {
          const int r = run_r + (off_v - off_l) + __popc(mv & ~ml & below);
          scratch[b + ce - 1 - r] = row[k];
        }
      }
      run_l += tot_l;
      run_r += tot_v - tot_l;
      __syncthreads();          // s_left / s_rows are read before reuse
    }
  }
  if (threadIdx.x == 0) work[blockIdx.x] = run_l;
}

// Block-wide sums of two ints (every thread gets both).
__device__ inline void block_sum2(int& a, int& c, int* s) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, d);
    c += __shfl_xor_sync(0xffffffffu, c, d);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s[warp] = a;
    s[kPartWarps + warp] = c;
  }
  __syncthreads();
  a = 0;
  c = 0;
#pragma unroll
  for (int w = 0; w < kPartWarps; ++w) {
    a += s[w];
    c += s[kPartWarps + w];
  }
}

__global__ void __launch_bounds__(kPartThreads)
partition_copy_kernel(int* __restrict__ order,
                      const int* __restrict__ scratch,
                      int* __restrict__ leaf_begin, int* __restrict__ leaf_rows,
                      const long long* __restrict__ leaf,
                      const long long* __restrict__ new_leaf,
                      const bool* __restrict__ ds,
                      const int* __restrict__ work) {
  if (!*ds) return;
  __shared__ int s_sum[2 * kPartWarps];
  const int b = work[kPartBlocks];
  const int n = work[kPartBlocks + 1];
  const int share = part_share(n);
  const int active = (n + share - 1) / share;
  int total = 0, before = 0;
  for (int x = threadIdx.x; x < active; x += kPartThreads) {
    const int v = work[x];
    total += v;
    if (x < static_cast<int>(blockIdx.x)) before += v;
  }
  block_sum2(total, before, s_sum);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const long long nl = *new_leaf;
    leaf_rows[*leaf] = total;
    leaf_begin[nl] = b + total;
    leaf_rows[nl] = n - total;
  }
  if (static_cast<int>(blockIdx.x) >= active) return;
  const int cs = blockIdx.x * share;
  const int ce = min(cs + share, n);
  const int n_left = work[blockIdx.x];
  const int n_right = ce - cs - n_left;
  for (int k = threadIdx.x; k < n_left; k += kPartThreads) {
    order[b + before + k] = scratch[b + cs + k];
  }
  const int right = b + total + (cs - before);
  for (int k = threadIdx.x; k < n_right; k += kPartThreads) {
    order[right + k] = scratch[b + ce - 1 - k];
  }
}

// ------------------------------------------------------------ leaf_hist
constexpr int kLhThreads = 256;
constexpr int kLhWarps = kLhThreads / 32;
constexpr int kLhLanes = 32;                  // features per tile
constexpr int kLhBins = 16;                   // bins per tile
constexpr int kLhCells = 3 * kLhBins * kLhLanes;
constexpr int kLhChunk = kLhThreads;          // listed rows staged at once
constexpr int kLhRowsPerWarp = kLhChunk / kLhWarps;
constexpr int kLhMinShare = 256;              // fewest rows worth a block
constexpr int kLhOutPitch = kLhBins + 1;      // the last block's out tile
constexpr int kLhCellsPerThread = kLhCells / kLhThreads;
constexpr int kLhSliceBatch = 4;              // slices loaded at once
constexpr size_t kLhSmem =
    sizeof(double) * static_cast<size_t>(kLhWarps) * kLhCells +
    sizeof(float) * 3 * kLhChunk + sizeof(int) * kLhChunk;

__global__ void __launch_bounds__(kLhThreads)
leaf_hist_kernel(const int* __restrict__ bins, int Fp, int Bk,
                 const float* __restrict__ gh, const int* __restrict__ order,
                 const int* __restrict__ leaf_begin,
                 const int* __restrict__ leaf_rows,
                 const long long* __restrict__ leaf,
                 const bool* __restrict__ ds, double* __restrict__ part,
                 unsigned* __restrict__ counter, float* __restrict__ out,
                 int Gy) {
  extern __shared__ double smem[];
  double* tiles = smem;                                 // [W][3][16][32]
  float* s_ch = reinterpret_cast<float*>(tiles + kLhWarps * kLhCells);
  int* s_id = reinterpret_cast<int*>(s_ch + 3 * kLhChunk);   // [chunk]
  __shared__ bool s_last;

  const int tile = blockIdx.y;
  const int f0 = (tile % Gy) * kLhLanes;
  const int b0 = (tile / Gy) * kLhBins;
  const int nf = min(kLhLanes, Fp - f0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool on = *ds;
  const long long l = *leaf;
  const int seg = on ? leaf_begin[l] : 0;
  const int n = on ? leaf_rows[l] : 0;
  int share = (n + gridDim.x - 1) / gridDim.x;
  share = share < kLhMinShare ? kLhMinShare : share;
  const int active = n > 0 ? (n + share - 1) / share : 1;
  if (static_cast<int>(blockIdx.x) >= active) return;
  const int rs = blockIdx.x * share;
  const int re = min(rs + share, n);

  // the first chunk's row ids are on their way while the tiles are zeroed
  int next_id = rs + static_cast<int>(threadIdx.x) < re
                    ? order[seg + rs + threadIdx.x] : 0;
  for (int i = threadIdx.x; i < kLhWarps * kLhCells; i += kLhThreads) {
    tiles[i] = 0.0;
  }
  double* mine = tiles + warp * kLhCells;
  for (int cs = rs; cs < re; cs += kLhChunk) {
    const int m = min(kLhChunk, re - cs);
    __syncthreads();            // the previous chunk's adds are done
    const int id = next_id;
    float g = 0.0f, h = 0.0f, w = 0.0f;
    if (static_cast<int>(threadIdx.x) < m) {
      s_id[threadIdx.x] = id;
      const float* v = gh + static_cast<long long>(id) * 3;
      g = v[0];
      h = v[1];
      w = v[2];
    }
    __syncthreads();            // s_id
    // the next chunk's ids, and this chunk's bins for this warp's rows
    // (every kLhWarps-th row of the chunk, lane f its tile's feature f),
    // all in flight at once
    const int nxt = cs + kLhChunk + static_cast<int>(threadIdx.x);
    next_id = nxt < re ? order[seg + nxt] : 0;
    int bin[kLhRowsPerWarp];
#pragma unroll
    for (int q = 0; q < kLhRowsPerWarp; ++q) {
      const int j = warp + q * kLhWarps;
      bin[q] = j < m && lane < nf
                   ? bins[static_cast<long long>(s_id[j]) * Fp + f0 + lane]
                   : -1;
    }
    if (static_cast<int>(threadIdx.x) < m) {
      s_ch[threadIdx.x] = g;
      s_ch[kLhChunk + threadIdx.x] = h;
      s_ch[2 * kLhChunk + threadIdx.x] = w;
    }
    __syncthreads();            // s_ch
#pragma unroll
    for (int q = 0; q < kLhRowsPerWarp; ++q) {
      const int j = warp + q * kLhWarps;
      if (j >= m) break;
      const float cg = s_ch[j], chh = s_ch[kLhChunk + j],
                  cw = s_ch[2 * kLhChunk + j];
      if (cg == 0.0f && chh == 0.0f && cw == 0.0f) continue;
      const int raw = bin[q];
      const int v = raw - b0;
      if (static_cast<unsigned>(raw) < static_cast<unsigned>(Bk) &&
          static_cast<unsigned>(v) < static_cast<unsigned>(kLhBins)) {
        mine[v * kLhLanes + lane] += static_cast<double>(cg);
        mine[(kLhBins + v) * kLhLanes + lane] += static_cast<double>(chh);
        mine[(2 * kLhBins + v) * kLhLanes + lane] += static_cast<double>(cw);
      }
    }
  }
  __syncthreads();
  // this block's partial slice: its warps' tiles summed in warp order
  double* slice = part + (static_cast<size_t>(blockIdx.x) * gridDim.y + tile) *
                             kLhCells;
  for (int i = threadIdx.x; i < kLhCells; i += kLhThreads) {
    double s = tiles[i];
#pragma unroll
    for (int w = 1; w < kLhWarps; ++w) s += tiles[w * kLhCells + i];
    slice[i] = s;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(counter + tile, 1u) == static_cast<unsigned>(active - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block: every slice of the tile summed in block order (a few
  // slices' loads in flight at once), rounded to f32 once, through shared
  // memory so the output rows are written whole
  double acc[kLhCellsPerThread];
#pragma unroll
  for (int k = 0; k < kLhCellsPerThread; ++k) acc[k] = 0.0;
  for (int x0 = 0; x0 < active; x0 += kLhSliceBatch) {
    double v[kLhSliceBatch][kLhCellsPerThread];
#pragma unroll
    for (int u = 0; u < kLhSliceBatch; ++u) {
      const double* src =
          part + (static_cast<size_t>(x0 + u) * gridDim.y + tile) * kLhCells +
          threadIdx.x;
#pragma unroll
      for (int k = 0; k < kLhCellsPerThread; ++k) {
        v[u][k] = x0 + u < active ? __ldcg(src + k * kLhThreads) : 0.0;
      }
    }
#pragma unroll
    for (int u = 0; u < kLhSliceBatch; ++u) {
      if (x0 + u < active) {
#pragma unroll
        for (int k = 0; k < kLhCellsPerThread; ++k) acc[k] += v[u][k];
      }
    }
  }
  float* s_out = reinterpret_cast<float*>(tiles);    // [3][32 lanes][17]
#pragma unroll
  for (int k = 0; k < kLhCellsPerThread; ++k) {
    const int i = threadIdx.x + k * kLhThreads;
    const int c = i / (kLhBins * kLhLanes);
    const int v = (i / kLhLanes) % kLhBins;
    const int f = i % kLhLanes;
    s_out[(c * kLhLanes + f) * kLhOutPitch + v] = static_cast<float>(acc[k]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kLhCells; i += kLhThreads) {
    const int c = i / (kLhBins * kLhLanes);
    const int f = (i / kLhBins) % kLhLanes;
    const int v = i % kLhBins;
    if (f < nf && b0 + v < Bk) {
      out[(static_cast<size_t>(c) * Fp + f0 + f) * Bk + b0 + v] =
          s_out[(c * kLhLanes + f) * kLhOutPitch + v];
    }
  }
}

}  // namespace lgbt

// leaf_partition: partition_split, then partition_copy, on `stream`.
// work [kPartBlocks + 2] int32 (no initial value). `launched` gets one bit
// per kernel launched.
extern "C" int lgbt_leaf_partition(void* order, void* scratch,
                                   void* leaf_begin, void* leaf_rows,
                                   const void* leaf, const void* new_leaf,
                                   const void* ds, const void* bins, int Fp,
                                   const void* col, const void* left_tab,
                                   int Bk, void* work, void* stream,
                                   int* launched) {
  *launched = 0;
  if (Fp < 1 || Bk < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lgbt::partition_split_kernel<<<lgbt::kPartBlocks, lgbt::kPartThreads, 0,
                                 st>>>(
      static_cast<const int*>(order), static_cast<int*>(scratch),
      static_cast<const int*>(leaf_begin), static_cast<const int*>(leaf_rows),
      static_cast<const long long*>(leaf), static_cast<const bool*>(ds),
      static_cast<const int*>(bins), Fp, static_cast<const long long*>(col),
      static_cast<const uint8_t*>(left_tab), Bk, static_cast<int*>(work));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *launched |= lgbt::kSplitBit;
  lgbt::partition_copy_kernel<<<lgbt::kPartBlocks, lgbt::kPartThreads, 0,
                                st>>>(
      static_cast<int*>(order), static_cast<const int*>(scratch),
      static_cast<int*>(leaf_begin), static_cast<int*>(leaf_rows),
      static_cast<const long long*>(leaf),
      static_cast<const long long*>(new_leaf), static_cast<const bool*>(ds),
      static_cast<const int*>(work));
  e = cudaGetLastError();
  if (e == cudaSuccess) *launched |= lgbt::kCopyBit;
  return static_cast<int>(e);
}

// leaf_hist: the tiles' arrival counters zeroed, then one launch of grid
// (Gx, Gy * Gz), both on `stream` (a CUDA graph can capture the pair), Gy =
// ceil(Fp / 32) feature tiles by Gz = ceil(Bk / 16) bin tiles. part [Gx, Gy
// * Gz, 1536] f64 and counter [Gy * Gz] uint32, neither with an initial
// value; a call's buffers are its own, so calls on two streams may overlap.
extern "C" int lgbt_leaf_hist(const void* bins, int Fp, int Bk,
                              const void* gh, const void* order,
                              const void* leaf_begin, const void* leaf_rows,
                              const void* leaf, const void* ds, void* part,
                              void* counter, void* out, int Gx, void* stream) {
  if (Fp < 1 || Bk < 1 || Gx < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int Gy = (Fp + lgbt::kLhLanes - 1) / lgbt::kLhLanes;
  const int Gz = (Bk + lgbt::kLhBins - 1) / lgbt::kLhBins;
  if (static_cast<long long>(Gy) * Gz > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // opt in to the shared memory once per device
  static bool opted[lgbt::kMaxDevices] = {};
  static std::mutex lock;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= lgbt::kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  {
    std::lock_guard<std::mutex> hold(lock);
    if (!opted[dev]) {
      e = cudaFuncSetAttribute(lgbt::leaf_hist_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(lgbt::kLhSmem));
      if (e != cudaSuccess) return static_cast<int>(e);
      opted[dev] = true;
    }
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(counter, 0, sizeof(unsigned) * Gy * Gz, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(Gx), static_cast<unsigned>(Gy * Gz));
  lgbt::leaf_hist_kernel<<<grid, lgbt::kLhThreads, lgbt::kLhSmem, st>>>(
      static_cast<const int*>(bins), Fp, Bk, static_cast<const float*>(gh),
      static_cast<const int*>(order), static_cast<const int*>(leaf_begin),
      static_cast<const int*>(leaf_rows),
      static_cast<const long long*>(leaf), static_cast<const bool*>(ds),
      static_cast<double*>(part), static_cast<unsigned*>(counter),
      static_cast<float*>(out), Gy);
  return static_cast<int>(cudaGetLastError());
}
