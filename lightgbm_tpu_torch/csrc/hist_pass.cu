// hist_pass: the slot-keyed histogram of the frontier-v1 engine and of the
// XLA engine's growers. For every row r with slot s = row_slot[r] in
// [0, Sp), every feature f < Fp and every channel c < nch:
//
//     out[c, s, f, bins[r, f]] += v[r, c]
//
// f32 variant: v = the bf16 rounding (to nearest even) of gh[r, c], summed
// in f32, as the TPU kernel's bf16 one-hot matmul takes it. quant variant:
// v = the int8 channel gh[r, c] (ops/quantize.py encode_channels), summed
// exactly in int32, so it equals its plain version bit for bit. unrounded
// f32 variant (nch <= 3): v = gh[r, c] as given, summed in f32, as the XLA
// engine's build_histograms sums its f32 channels. Rows with slot -1 (or
// >= Sp) add nothing whatever their gh; bins outside [0, Bp) add nothing.
//
// Replaces: the Pallas kernel _hist_kernel (lightgbm_tpu/ops/
// pallas_histogram.py:60, launched by _run_hist_kernel :103); its unrounded
// variant replaces no Pallas kernel: it is the XLA engine's build_histograms
// (lightgbm_tpu/ops/histogram.py:71, segment_sum or one-hot einsum). Layouts
// are the contract's: bins [R, Fp] int32 row-major, row_slot [R] int32, gh
// [R, nch] f32 or int8, out [nch, Sp, Fp, Bp] f32 or int32, every cell
// written here (the caller does not zero it). Any R: the TPU's 512-row tile
// padding is not carried over.
//
// Bound on the H100: bytes. It must read every row's slot, and the Fp bins
// and nch channels of each slotted row (128 B at Fp=28, nch=3 f32), and
// write the output once (1.4 MB at Sp=64, Fp=28, Bp=64, nch=3); the
// arithmetic is Fp*nch adds per slotted row.
//
// Design: the TPU kernel contracts a [rows, Sp] slot one-hot against a
// [rows, Fp*Bp] bin one-hot on the MXU over a sequential grid. Here the
// rows are grouped by slot first, so a block adds one slot's tile at a time
// in shared memory. Five kernels on one stream, with no host sync (the row
// counts are read on the device), each after the first launched as a
// programmatic dependant of the one before: its blocks are scheduled while
// that one drains and wait for it before reading what it wrote. A launch
// takes a window of at most kMaxWindow slots [lo, lo + Sw).
//   1. hist_count: blocks of kCountRows consecutive rows; a row adds iff its
//      slot is in the window and a channel is non-zero (out-of-bag rows add
//      nothing). Each warp counts its rows per slot in a counter row of its
//      own (match_any groups; a group's first lane adds); the block writes
//      its per-slot totals, cnt[slot][block].
//   2. hist_scan: one block scans cnt slot-major into off (where each
//      block's rows of each slot start in the buckets) and the window's
//      slot offsets.
//   3. hist_bucket: the same blocks count their warps' rows again (kept in
//      registers) and lay out a record per live row — its channels (bf16
//      bits, int8 bytes or f32 words) and its row index — in shared memory,
//      in a fixed order (slot, block, warp, row: row order within a slot),
//      then write
//      each slot's run contiguously at its place. The fixed order makes the
//      f32 sums below the same on every call.
//   4. hist_tiles: grid.x blocks take even shares of the bucketed rows;
//      grid.y the features in groups of 32 (one lane each); grid.z channel
//      groups x bin groups (where one tile would not fit). A block stages
//      chunks of its rows' records and, gathered by their row indices, the
//      rows' bins (a row's feature slice is contiguous: 16-byte cp.async
//      pieces where aligned; the records a chunk ahead of the bins, so no
//      copy waits on a global load), double buffered, so the copy of the
//      next chunk overlaps the adds of this one. f32: each adding warp owns
//      a tile of Bw bins x 32 lanes x C channels, lane f's cells in bank f,
//      and adds four rows per step with plain loads, adds and stores (a row
//      whose bin an earlier row of the step has adds onto that row's sum).
//      int32: every warp adds into one shared tile with native
//      shared-memory integer atomics (exact and order-free), so the block
//      keeps all its warps even where a tile is wide. At each slot change
//      and at the end the block sums its tiles, in warp order, into the
//      part slice of (block, slot), and zeroes them.
//   5. hist_reduce: sums each cell's part slices in a fixed order and
//      writes every cell of out (empty slots, padding features: zeros).
// No f32 atomic anywhere: the f32 sums are the same on every call on one
// card and the weight channel counts rows exactly; int32 sums are exact.
// Any Bp (bins beyond kMaxBinWidth take more bin groups of grid.z) and any
// Sp (slots beyond a window take more launches).
//
// Measured at R = 1M, Fp = 28, Bp = 64, Sp = 64, f32, on one H100
// (PERF.md): this design 0.117 ms; the staging-record variant, each row's
// bins copied into a 128-byte bucket record that the histogram stage reads
// contiguously, 0.223 ms (its bucket stage alone 0.137).
#include <algorithm>
#include <mutex>
#include <type_traits>

#include "fused_level.cuh"

namespace lgbt {

constexpr int kCountThreads = 512;          // hist_count, hist_bucket
constexpr int kCountWarps = kCountThreads / 32;
constexpr int kCountSteps = 16;             // 32-row steps of a warp
constexpr int kCountRows = kCountThreads * kCountSteps;   // rows per block
constexpr int kScanThreads = 1024;
constexpr int kMaxWindow = 512;             // slots per launch
constexpr int kMaxCh = 8;                   // nch <= 8
constexpr int kChunk = 128;                 // bucketed rows per staged chunk
// chunk buffers of bins (the next chunk's gathered while this one is
// added) and of records (staged a chunk before their bins)
constexpr int kBinBufs = 2;
constexpr int kRecBufs = 3;
constexpr int kTileMaxWarps = 16;
constexpr int kLanes = 32;                  // features per tile block
constexpr int kMaxCn = 5;                   // channels per tile block
constexpr int kMaxBinWidth = 1024;          // bins per tile block
constexpr int kReduceWarps = 8;             // bins per reduce block
// the bits lgbt_hist_pass reports, one per kernel it launched
constexpr int kCountBit = 1, kScanBit = 2, kBucketBit = 4, kTilesBit = 8,
              kReduceBit = 16;

// ---------------------------------------------------------------- 1-3

// Programmatic dependent launch: a stage launched with launch_after may be
// scheduled while the stage before it drains; it waits here, before it
// reads anything that stage wrote. Every stage lets its dependant be
// scheduled as soon as all of its own blocks are running.
__device__ inline void wait_for_previous_stage() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ inline void let_next_stage_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ inline int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// The unrounded f32 variant's channel type: an f32 taken as it is (the
// f32 variant's channels, plain float, are rounded to bf16).
struct RawF32 {
  float v;
};

// Bits of channel c of row r as the histogram takes it: the bf16 rounding
// of an f32 channel, the int8 byte, or the unrounded f32 word.
__device__ inline uint32_t channel_bits(const float* __restrict__ gh,
                                        int64_t i) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(gh[i]));
}
__device__ inline uint32_t channel_bits(const int8_t* __restrict__ gh,
                                        int64_t i) {
  return static_cast<uint8_t>(gh[i]);
}
__device__ inline uint32_t channel_bits(const RawF32* __restrict__ gh,
                                        int64_t i) {
  return __float_as_uint(gh[i].v);
}
template <typename ValT> struct ChannelCode;
template <> struct ChannelCode<float> {
  static constexpr int kBytes = 2;
  static constexpr uint32_t kNonZero = 0x7FFFu;   // +-0 adds nothing
};
template <> struct ChannelCode<int8_t> {
  static constexpr int kBytes = 1;
  static constexpr uint32_t kNonZero = 0xFFu;
};
template <> struct ChannelCode<RawF32> {
  static constexpr int kBytes = 4;
  static constexpr uint32_t kNonZero = 0x7FFFFFFFu;
};

// Bytes of a record whose channel pack takes `pack` bytes: the pack, then
// the row index, in 16 bytes where they fit, else 32.
__host__ __device__ constexpr int record_bytes(int pack) {
  return pack <= 12 ? 16 : 32;
}

// Row of step j of this thread: block x holds rows [x * kCountRows, (x +
// 1) * kCountRows),
// warp w the 32 * kCountSteps from x * kCountRows + w * 32 * kCountSteps
// on, 32 per step.
__device__ inline int64_t step_row(int j) {
  return static_cast<int64_t>(blockIdx.x) * kCountRows +
         (threadIdx.x >> 5) * (32 * kCountSteps) + j * 32 + (threadIdx.x & 31);
}

// The window slot of each of this thread's kCountSteps rows if it adds
// anything (slot in [lo, lo + Sw), a channel non-zero), else -1, and its
// channels packed in kWords words (as the records hold them). Every step's
// loads are issued at once; the channels are read whatever the slot (their
// sectors are shared with the neighbouring rows').
template <typename ValT, int kWords>
__device__ inline void live_slots(const int* __restrict__ slot,
                                  const ValT* __restrict__ gh, int64_t R,
                                  int lo, int Sw, int nch,
                                  int (&k)[kCountSteps],
                                  uint32_t (&w)[kCountSteps][kWords]) {
  constexpr int kB = ChannelCode<ValT>::kBytes;
  uint32_t any[kCountSteps];
#pragma unroll
  for (int j = 0; j < kCountSteps; ++j) {
    const int64_t r = step_row(j);
    k[j] = r < R ? slot[r] - lo : -1;
    any[j] = 0u;
#pragma unroll
    for (int q = 0; q < kWords; ++q) w[j][q] = 0u;
#pragma unroll
    for (int c = 0; c < kMaxCh && c * kB < 4 * kWords; ++c) {
      if (c < nch && r < R) {
        const uint32_t bits = channel_bits(gh, r * nch + c);
        any[j] |= bits & ChannelCode<ValT>::kNonZero;
        w[j][c * kB / 4] |= bits << (8 * (c * kB % 4));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kCountSteps; ++j) {
    if (static_cast<unsigned>(k[j]) >= static_cast<unsigned>(Sw) ||
        any[j] == 0u) {
      k[j] = -1;
    }
  }
}

// wc[k] (this warp's counter row, zeroed) = the warp's live rows of window
// slot k; m[j] = the lanes of step j whose row has this lane's slot. One
// group per distinct slot in a step (match_any); its first lane adds, in
// the warp's own row: no atomic.
__device__ inline void count_steps(const int (&k)[kCountSteps],
                                   unsigned (&m)[kCountSteps], int* wc) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kCountSteps; ++j) {
    m[j] = __match_any_sync(0xffffffffu, k[j]);
    if (k[j] >= 0 && lane == __ffs(m[j]) - 1) wc[k[j]] += __popc(m[j]);
    __syncwarp();
  }
}

// cnt[k * gridDim.x + x] = block x's live rows of window slot k.
template <typename ValT>
__global__ void __launch_bounds__(kCountThreads)
hist_count_kernel(const int* __restrict__ slot, const ValT* __restrict__ gh,
                  int* __restrict__ cnt, int64_t R, int lo, int Sw,
                  int nch) {
  extern __shared__ int s_wc[];                 // [kCountWarps][Sw]
  let_next_stage_launch();
  for (int i = threadIdx.x; i < kCountWarps * Sw; i += blockDim.x) {
    s_wc[i] = 0;
  }
  int k[kCountSteps];
  unsigned m[kCountSteps];
  uint32_t w[kCountSteps][4];            // unused here
  live_slots<ValT, 4>(slot, gh, R, lo, Sw, nch, k, w);
  __syncthreads();
  count_steps(k, m, s_wc + (threadIdx.x >> 5) * Sw);
  __syncthreads();
  for (int i = threadIdx.x; i < Sw; i += blockDim.x) {
    int sum = 0;
    for (int w = 0; w < kCountWarps; ++w) sum += s_wc[w * Sw + i];
    cnt[static_cast<int64_t>(i) * gridDim.x + blockIdx.x] = sum;
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
// + x] is where block x's rows of slot k start in the buckets), and
// slot_off[k] = off[k * nb], slot_off[Sw] = the total; in tiles of
// kScanPer * kScanThreads counts (one at 1M rows and 64 slots).
__global__ void __launch_bounds__(kScanThreads)
hist_scan_kernel(const int* __restrict__ cnt, int* __restrict__ off,
                 int* __restrict__ slot_off, int nb, int Sw) {
  constexpr int kTile = kScanPer * kScanThreads;
  __shared__ int s_v[kTile];
  __shared__ int s_warp[kScanThreads / 32];
  const int64_t n = static_cast<int64_t>(nb) * Sw;
  let_next_stage_launch();
  wait_for_previous_stage();
  int carry = 0;
  for (int64_t t0 = 0; t0 < n; t0 += kTile) {
    const int len = static_cast<int>(min64(kTile, n - t0));
    int v[kScanPer];
#pragma unroll
    for (int q = 0; q < kScanPer; ++q) {      // all loads in flight at once
      const int i = q * kScanThreads + threadIdx.x;
      v[q] = i < len ? cnt[t0 + i] : 0;
    }
#pragma unroll
    for (int q = 0; q < kScanPer; ++q) {
      s_v[q * kScanThreads + threadIdx.x] = v[q];
    }
    __syncthreads();
    const int total = block_scan(s_v, len, s_warp);
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      off[t0 + i] = carry + s_v[i];
    }
    for (int k = threadIdx.x; k < Sw; k += blockDim.x) {
      const int64_t g = static_cast<int64_t>(k) * nb - t0;   // block 0 of k
      if (g >= 0 && g < len) slot_off[k] = carry + s_v[g];
    }
    carry += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) slot_off[Sw] = carry;
}

// Each live row's record at its place in its slot's bucket: its channel
// pack (bf16 bits or int8 bytes, kWords = 2 or 4 words; unrounded f32
// words, kWords = 3), then its row index, in 16 or 32 bytes
// (record_bytes). The order is fixed: slot, block, warp, step,
// lane — row order within a slot. The block first lays its 16-byte records
// out in shared memory in that order (its rows of each slot together),
// then writes each slot's run to its place with consecutive threads on
// consecutive records (32-byte records go straight to their place).
template <typename ValT, int kWords>
__global__ void __launch_bounds__(kCountThreads)
hist_bucket_kernel(const int* __restrict__ slot, const ValT* __restrict__ gh,
                   const int* __restrict__ off, uint4* __restrict__ recs,
                   int64_t R, int lo, int Sw, int nch) {
  constexpr int kRec = record_bytes(4 * kWords) / 16;   // uint4s a record
  extern __shared__ __align__(16) int s_bucket[];
  int* s_wc = s_bucket;                       // [kCountWarps][Sw]
  int* s_start = s_wc + kCountWarps * Sw;     // [Sw + 1]: local run starts
  uint4* s_rec = reinterpret_cast<uint4*>(
      s_start + ((Sw + 4) & ~3));             // [kCountRows] (16-byte ones)
  __shared__ int s_warp[kCountThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  let_next_stage_launch();
  for (int i = threadIdx.x; i < kCountWarps * Sw; i += blockDim.x) {
    s_wc[i] = 0;
  }
  int k[kCountSteps];
  unsigned m[kCountSteps];
  uint32_t w[kCountSteps][kWords];
  live_slots<ValT, kWords>(slot, gh, R, lo, Sw, nch, k, w);
  __syncthreads();
  int* wc = s_wc + warp * Sw;
  count_steps(k, m, wc);
  __syncthreads();
  wait_for_previous_stage();           // off, from the scan
  // the block's run of each slot, and each warp's place in it
  for (int i = threadIdx.x; i < Sw; i += blockDim.x) {
    int run = 0;
    for (int v = 0; v < kCountWarps; ++v) {
      const int c = s_wc[v * Sw + i];
      s_wc[v * Sw + i] = run;
      run += c;
    }
    s_start[i] = run;
  }
  __syncthreads();
  const int total = block_scan(s_start, Sw, s_warp);
  for (int i = threadIdx.x; i < Sw; i += blockDim.x) {
    for (int v = 0; v < kCountWarps; ++v) s_wc[v * Sw + i] += s_start[i];
  }
  if (threadIdx.x == 0) s_start[Sw] = total;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kCountSteps; ++j) {
    if (k[j] >= 0) {
      const int at = wc[k[j]] + __popc(m[j] & ((1u << lane) - 1u));
      const uint32_t row = static_cast<uint32_t>(step_row(j));
      if constexpr (kWords == 2) {
        s_rec[at] = make_uint4(w[j][0], w[j][1], row, 0u);
      } else if constexpr (kWords == 3) {
        s_rec[at] = make_uint4(w[j][0], w[j][1], w[j][2], row);
      } else {                 // 32-byte records: straight to their place
        const int64_t g = off[static_cast<int64_t>(k[j]) * gridDim.x +
                              blockIdx.x] + (at - s_start[k[j]]);
        recs[2 * g] = make_uint4(w[j][0], w[j][1 % kWords], w[j][2 % kWords],
                                 w[j][3 % kWords]);
        recs[2 * g + 1] = make_uint4(row, 0u, 0u, 0u);
      }
    }
    __syncwarp();
    if (k[j] >= 0 && lane == __ffs(m[j]) - 1) wc[k[j]] += __popc(m[j]);
    __syncwarp();
  }
  if constexpr (kRec != 1) return;
  __syncthreads();
  // local record i of slot k goes to off[k * nb + x] + (i - s_start[k])
  for (int r = threadIdx.x; r < total; r += blockDim.x) {
    int lo_k = 0, hi_k = Sw - 1;             // s_start[k] <= r < s_start[k+1]
    while (lo_k < hi_k) {
      const int mid = (lo_k + hi_k + 1) >> 1;
      if (s_start[mid] <= r) lo_k = mid; else hi_k = mid - 1;
    }
    recs[off[static_cast<int64_t>(lo_k) * gridDim.x + blockIdx.x] +
         (r - s_start[lo_k])] = s_rec[r];
  }
}

// ---------------------------------------------------------------- 4

__device__ inline void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src));
  }
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The accumulator of a variant and its vectors.
template <typename AccT, int N> struct VecOf;
template <> struct VecOf<float, 1> { using T = float; };
template <> struct VecOf<float, 2> { using T = float2; };
template <> struct VecOf<float, 4> { using T = float4; };
template <> struct VecOf<int, 1> { using T = int; };
template <> struct VecOf<int, 2> { using T = int2; };
template <> struct VecOf<int, 4> { using T = int4; };
template <typename T> __device__ inline T& at(T& v, int) { return v; }
__device__ inline float& at(float2& v, int i) { return i == 0 ? v.x : v.y; }
__device__ inline float& at(float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ inline int& at(int2& v, int i) { return i == 0 ? v.x : v.y; }
__device__ inline int& at(int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Channel c of a staged record as the accumulator adds it, by the
// variant (the accumulator and the pack's bytes tell them apart): the bf16
// bits widened to f32 (f32, packs of 8 or 16 bytes), the unrounded f32 word
// (f32, 12-byte packs), or the int8 byte (int32). get: one broadcast shared
// load; word: channel c's value from the 32-bit word that holds it.
template <typename AccT, int kPack> struct RecCode;
template <int kPack> struct RecCode<float, kPack> {
  static constexpr int kBytes = 2;
  static __device__ float get(const unsigned char* rec, int c) {
    return __uint_as_float(
        static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(rec)[c])
        << 16);
  }
  static __device__ float word(uint32_t w, int c) {
    return __uint_as_float(c % 2 ? (w & 0xFFFF0000u) : (w << 16));
  }
};
template <> struct RecCode<float, 12> {
  static constexpr int kBytes = 4;
  static __device__ float get(const unsigned char* rec, int c) {
    return reinterpret_cast<const float*>(rec)[c];
  }
  static __device__ float word(uint32_t w, int) { return __uint_as_float(w); }
};
template <int kPack> struct RecCode<int, kPack> {
  static constexpr int kBytes = 1;
  static __device__ int get(const unsigned char* rec, int c) {
    return reinterpret_cast<const int8_t*>(rec)[c];
  }
  static __device__ int word(uint32_t w, int c) {
    return static_cast<int>(static_cast<int8_t>(w >> (8 * (c % 4))));
  }
};

// Channels c0g .. c0g + C - 1 of a staged record: where c0g is 0 (a block
// whose channels start at the first, as when one pass takes them all) from
// one 8-byte shared load of the pack (a group's channels take at most 6
// bytes; 8 or 12 for unrounded f32, one 16-byte load of the record then),
// else one load per channel.
template <typename AccT, int kPack, int C, bool kFromZero>
__device__ inline void rec_channels(const unsigned char* rec, int c0g,
                                    AccT (&v)[C]) {
  using Code = RecCode<AccT, kPack>;
  constexpr int kB = Code::kBytes;
  if constexpr (kFromZero && C * kB <= 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(rec);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[c] = Code::word((c * kB) / 4 == 0 ? w.x : w.y, c);
    }
  } else if constexpr (kFromZero && kB == 4 && C <= 4) {
    const uint4 w = *reinterpret_cast<const uint4*>(rec);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = Code::word(words[c], c);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[c] = Code::get(rec + (c0g + c) * kB, 0);
    }
  }
}

// A lane's C sums of one bin: the first kVec as one vector (one shared
// load or store), the last kRest (0 or 1) apart. A warp's tile: [Bw][32
// lanes] vectors, then [Bw][32 lanes] single sums when kRest; lane f's
// cells are in bank f.
template <int C>
struct TileCell {
  static constexpr int kVec = C >= 4 ? 4 : C >= 2 ? 2 : 1;
  static constexpr int kRest = C - kVec;
  __device__ static int offset(int Bw, int bin, int c, int f) {
    return c < kVec ? (bin * kLanes + f) * kVec + c
                    : Bw * kLanes * kVec + bin * kLanes + f;
  }
};

// Where sum c (of cn) of bin `bin`, feature lane f sits in a block's tile
// memory, and so in its part slices (a flush copies the tiles as they lie):
// the int32 variant's one tile [cn][Bw][32]; else a warp's tile, TileCell
// layout.
__host__ __device__ inline int slice_offset(int Bw, int cn, bool shared,
                                            int bin, int c, int f) {
  if (shared) return (c * Bw + bin) * kLanes + f;
  const int kv = cn >= 4 ? 4 : cn >= 2 ? 2 : 1;
  return c < kv ? (bin * kLanes + f) * kv + c
                : Bw * kLanes * kv + bin * kLanes + f;
}

// What a tile block adds — its features, channels and bins — and the
// layout of its staging: kBinBufs chunk buffers of kChunk rows of rs words
// of bins, kRecBufs buffers of kChunk records.
struct TileArgs {
  int f0, nf;        // features [f0, f0 + nf) on lanes 0..nf-1
  int nch;           // all channels
  int b_lo, bw;      // bins [b_lo, b_lo + bw) on tile rows 0..bw-1
  int Bw;            // tile rows
  int rs;            // staged row stride, words
  int pack, rec;     // bytes of a channel pack and of a record
};

__host__ __device__ inline size_t tile_stage_bytes(int rs, int rec) {
  return kBinBufs * static_cast<size_t>(kChunk) * rs * 4 +
         kRecBufs * static_cast<size_t>(kChunk) * rec;
}

// One adding warp's share of chunk rows [lo, hi): rows lo + 4 i .. lo + 4 i
// + 3, then every 4 n-th such step, C channels from channel c0g on
// (channels past nch are zero in the pack), into the warp's tile. A row
// adds where its bin lies in the block's bin range (every bucketed row has
// a non-zero channel; adding a zero is exact). The four rows' cells are
// loaded together; a row whose bin an earlier row of the step has adds
// onto that row's new sum, and the stores go in row order, so the last
// store of a cell holds every add. The next step's bins and channels are
// loaded before this step's tile stores (the staged chunk is read-only
// here; a row past hi, read ahead, stays inside the block's shared memory
// and adds nothing). Lanes past the block's features see no row.
template <typename AccT, int kPack, int C, bool kFromZero>
__device__ inline void add_rows(AccT* tile, const TileArgs& a, int c0g,
                                const int* sb, const unsigned char* sr,
                                int lo, int hi, int i, int n, int lane,
                                bool on) {
  constexpr int kVec = TileCell<C>::kVec;
  constexpr int kRest = TileCell<C>::kRest;
  constexpr int kRows = 4;
  constexpr int kRec = record_bytes(kPack);
  using V = typename VecOf<AccT, kVec>::T;
  V* tv = reinterpret_cast<V*>(tile) + lane;
  AccT* tr = tile + a.Bw * kLanes * kVec + lane;
  const int* sbl = sb + lane;
  const int hl = on ? hi : lo;          // this lane's rows end here
  const unsigned bw = static_cast<unsigned>(a.bw);
  const int step = kRows * n;
  int q = lo + kRows * i;
  int b[kRows];
  AccT v[kRows][C];
  auto load = [&](int p) {
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int x = sbl[(p + u) * a.rs] - a.b_lo;
      b[u] = p + u < hl ? x : -1;
      rec_channels<AccT, kPack, C, kFromZero>(sr + (p + u) * kRec, c0g,
                                              v[u]);
    }
  };
  if (q < hi) load(q);
  for (; q < hi; q += step) {
    int cb[kRows];
    AccT w[kRows][C];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      cb[u] = b[u];
#pragma unroll
      for (int c = 0; c < C; ++c) w[u][c] = v[u][c];
    }
    load(q + step);
    bool ok[kRows];
    int o[kRows];
    V av[kRows];
    AccT ar[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      ok[u] = static_cast<unsigned>(cb[u]) < bw;
      o[u] = (ok[u] ? cb[u] : 0) * kLanes;
      av[u] = tv[o[u]];
      if (kRest) ar[u] = tr[o[u]];
    }
    // each row's cell value before its add: the newest earlier row of the
    // step with its bin, else the loaded one
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
#pragma unroll
      for (int t = 0; t < u; ++t) {           // later t wins: newest
        if (cb[t] == cb[u]) {
          av[u] = av[t];
          if (kRest) ar[u] = ar[t];
        }
      }
#pragma unroll
      for (int c = 0; c < kVec; ++c) at(av[u], c) += w[u][c];
      if (kRest) ar[u] += w[u][C - 1];
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (ok[u]) {
        tv[o[u]] = av[u];
        if (kRest) tr[o[u]] = ar[u];
      }
    }
  }
}

// The int32 variant: every warp of the block adds into one shared tile
// [C][Bw][32 lanes] (lane f's cells in bank f) with native shared-memory
// integer atomics. Integer sums do not depend on order, so the result is
// exact and the same on every call; the warps need no tile of their own,
// so a block has all kTileMaxWarps of them even where a tile is wide.
// Warp i of n adds chunk rows lo + i, lo + i + n, ... of [lo, hi).
template <int kPack, int C, bool kFromZero>
__device__ inline void add_rows_shared(int* tile, const TileArgs& a,
                                       int c0g, const int* sb,
                                       const unsigned char* sr, int lo,
                                       int hi, int i, int n, int lane,
                                       bool on) {
  constexpr int kRows = 4;
  constexpr int kRec = record_bytes(kPack);
  const int* sbl = sb + lane;
  const int hl = on ? hi : lo;
  const unsigned bw = static_cast<unsigned>(a.bw);
  const int cells = a.Bw * kLanes;
  int* tl = tile + lane;
  for (int q = lo + i; q < hi; q += kRows * n) {
    int b[kRows];
    int v[kRows][C];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int p = q + u * n;
      const int x = sbl[p * a.rs] - a.b_lo;
      b[u] = p < hl ? x : -1;
      rec_channels<int, kPack, C, kFromZero>(sr + p * kRec, c0g, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (static_cast<unsigned>(b[u]) < bw) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (v[u][c] != 0) atomicAdd(tl + c * cells + b[u] * kLanes, v[u][c]);
        }
      }
    }
  }
}

// Records [e, e + cnt) into a record buffer (16-byte pieces, contiguous).
__device__ inline void stage_records(unsigned char* sr, const uint4* recs,
                                     int64_t e, int cnt, int rec) {
  const int pieces = cnt * rec / 16;
  const uint4* src = recs + e * (rec / 16);
  for (int i = threadIdx.x; i < pieces; i += blockDim.x) {
    cp_async(sr + 16 * i, src + i, 16);
  }
}

// The bins of the cnt rows whose records sr holds into a chunk buffer:
// each row's nf bins from feature f0 on, gathered by the record's row
// index (16-byte pieces where `vec`, else 4-byte).
__device__ inline void stage_bins(int* sb, const unsigned char* sr,
                                  const int* bins, int cnt, int Fp,
                                  const TileArgs& a, bool vec) {
  const int pw = vec ? 4 : 1;                 // words per piece
  const int ppr = (a.nf + pw - 1) / pw;       // pieces per row
  for (int i = threadIdx.x; i < cnt * ppr; i += blockDim.x) {
    const int el = i / ppr;
    const int p = i - el * ppr;
    const int64_t r = *reinterpret_cast<const int*>(sr + el * a.rec +
                                                    a.pack);
    cp_async(sb + el * a.rs + p * pw, bins + r * Fp + a.f0 + p * pw,
             4 * pw);
  }
}

// grid (row blocks, feature groups of 32, channel groups x bin groups);
// block x adds bucketed rows [x * share, (x + 1) * share) of the n that
// slot_off[Sw] counts. part slice ((x + k) * gy + y) * gz + z, cell
// slice_offset(bin, c, f), is block (x, y, z)'s sum over its rows of window
// slot k (written only where the block holds rows of slot k). Chunk it +
// 1's bins are gathered while chunk it is added, by the row indices of its
// records, staged a chunk before: no thread waits on a global load to issue
// a copy.
template <typename AccT, int CN, int kPack>
__global__ void __launch_bounds__(kTileMaxWarps * 32)
hist_tiles_kernel(const int* __restrict__ bins,
                  const uint4* __restrict__ recs,
                  const int* __restrict__ slot_off, AccT* __restrict__ part,
                  int Fp, int Bp, int Bw, int nbg, int Sw, int nch,
                  bool vec) {
  // int32 sums: one tile that every warp adds into (add_rows_shared)
  constexpr bool kShared = std::is_same<AccT, int>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_w = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  TileArgs a;
  a.f0 = blockIdx.y * kLanes;
  a.nf = min(kLanes, Fp - a.f0);
  const int c0 = blockIdx.z / nbg * CN;
  a.nch = nch;
  a.b_lo = blockIdx.z % nbg * Bw;
  a.bw = min(Bw, Bp - a.b_lo);
  a.Bw = Bw;
  a.rs = (min(kLanes, Fp) + 3) & ~3;
  a.pack = kPack;
  a.rec = record_bytes(kPack);
  const int bin_bytes = kChunk * a.rs * 4;
  unsigned char* srec = smem + kBinBufs * bin_bytes;   // [kRecBufs][kChunk]
  AccT* tiles0 = reinterpret_cast<AccT*>(smem +
                                         tile_stage_bytes(a.rs, a.rec));
  const int n_t = kShared ? 1 : n_w;     // tiles
  const int all = n_t * Bw * CN * kLanes;
  let_next_stage_launch();
  wait_for_previous_stage();           // the buckets
  const int64_t n = slot_off[Sw];
  const int64_t share = (n + gridDim.x - 1) / gridDim.x;
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * share;
  const int64_t e1 = min64(n, e0 + share);
  if (e0 >= e1) return;                 // the whole block: no rows
  using V4 = typename VecOf<AccT, 4>::T;
  V4* t4 = reinterpret_cast<V4*>(tiles0);
  for (int i = threadIdx.x; i < all / 4; i += blockDim.x) t4[i] = V4{};
  int k = 0;                            // slot_off[k] <= e0 < slot_off[k+1]
  {
    int hi = Sw;
    while (k < hi) {
      const int mid = (k + hi + 1) >> 1;
      if (slot_off[mid] <= e0) k = mid; else hi = mid - 1;
    }
  }
  int64_t k_end = slot_off[k + 1];
  const bool on = lane < a.nf;
  const int64_t slice = static_cast<int64_t>(Bw) * CN * kLanes;
  // chunk j: rows [e0 + j * kChunk, ...); its bins in buffer j % kBinBufs,
  // its records in buffer j % kRecBufs
  auto rows_of = [&](int j) {
    const int64_t e = e0 + static_cast<int64_t>(j) * kChunk;
    return static_cast<int>(e < e1 ? min64(kChunk, e1 - e) : 0);
  };
  auto recs_of = [&](int j) { return srec + (j % kRecBufs) * kChunk * a.rec; };
  auto bins_of = [&](int j) {
    return reinterpret_cast<int*>(smem + (j % kBinBufs) * bin_bytes);
  };
  auto stage_recs = [&](int j) {
    stage_records(recs_of(j), recs, e0 + static_cast<int64_t>(j) * kChunk,
                  rows_of(j), a.rec);
  };
  // the copies issued while chunk j - 1 is added: chunk j's bins, by the
  // row indices of its records (staged with chunk j - 1's), and chunk
  // j + 1's records
  auto stage_group = [&](int j) {
    stage_bins(bins_of(j), recs_of(j), bins, rows_of(j), Fp, a, vec);
    stage_recs(j + 1);
    cp_async_commit();
  };
  stage_recs(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  stage_group(0);
  int it = 0;
  for (int64_t e = e0; e < e1; e += kChunk, ++it) {
    cp_async_wait_all();       // this chunk's bins, the next one's records
    __syncthreads();
    stage_group(it + 1);
    const int* sb = bins_of(it);
    const unsigned char* sr = recs_of(it);
    const int64_t end = min64(e + kChunk, e1);
    for (int64_t s = e; s < end;) {
      const int64_t seg = min64(end, k_end);
      const int lo = static_cast<int>(s - e), hi = static_cast<int>(seg - e);
      if constexpr (kShared) {
        if (c0 == 0) {
          add_rows_shared<kPack, CN, true>(tiles0, a, 0, sb, sr, lo, hi,
                                           warp, n_w, lane, on);
        } else {
          add_rows_shared<kPack, CN, false>(tiles0, a, c0, sb, sr, lo, hi,
                                            warp, n_w, lane, on);
        }
      } else {
        AccT* tile = tiles0 + warp * Bw * CN * kLanes;
        if (c0 == 0) {
          add_rows<AccT, kPack, CN, true>(tile, a, 0, sb, sr, lo, hi, warp,
                                          n_w, lane, on);
        } else {
          add_rows<AccT, kPack, CN, false>(tile, a, c0, sb, sr, lo, hi, warp,
                                           n_w, lane, on);
        }
      }
      s = seg;
      if (seg == k_end || seg == e1) {
        // slot k done here: the tiles, summed in warp order, into its
        // slice (in their own layout, four sums at a time), and zeroed
        __syncthreads();
        AccT* out = part + (((static_cast<int64_t>(blockIdx.x) + k) *
                                 gridDim.y + blockIdx.y) * gridDim.z +
                                blockIdx.z) * slice;
        V4* out4 = reinterpret_cast<V4*>(out);
        const int len = Bw * CN * kLanes / 4;         // a tile, in V4s
        for (int i = threadIdx.x; i < len; i += blockDim.x) {
          V4 sum = t4[i];
          t4[i] = V4{};
          for (int w = 1; w < n_t; ++w) {
            V4 v = t4[w * len + i];
            t4[w * len + i] = V4{};
#pragma unroll
            for (int j = 0; j < 4; ++j) at(sum, j) += at(v, j);
          }
          out4[i] = sum;
        }
        __syncthreads();
        if (seg < e1) {
          while (slot_off[k + 1] <= seg) ++k;   // skip empty slots
          k_end = slot_off[k + 1];
        }
      }
    }
    __syncthreads();           // this chunk's buffer is refilled next
  }
  cp_async_wait_all();
}

// ---------------------------------------------------------------- 5

// out[c, lo + s, f, b] for s < Sw: the sum of the part slices of the tile
// blocks x0..x1 that hold rows of slot s (none: 0), in a fixed order for
// the slot's blocks. Block (group of kReduceWarps bins, feature group y,
// c * Sw + s), lane f feature f. Up to kReduceWarps blocks: warp w sums bin
// b0 + w over them in block order. More (the root level, one slot over
// every tile block): warp w sums blocks x0 + w, x0 + w + kReduceWarps, ...
// in order for all the bins, then the warps' sums are added in warp order.
template <typename AccT>
__global__ void __launch_bounds__(32 * kReduceWarps)
hist_reduce_kernel(const AccT* __restrict__ part,
                   const int* __restrict__ slot_off, AccT* __restrict__ out,
                   int gx, int gz, int nbg, int cn, int Bw, int Fp, int Bp,
                   int Sp, int lo, int Sw) {
  __shared__ AccT s_sum[kReduceWarps][kReduceWarps][kLanes];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = blockIdx.z % Sw;
  const int c = blockIdx.z / Sw;
  const int y = blockIdx.y;
  const int gy = gridDim.y;
  const int b0 = blockIdx.x * kReduceWarps;
  wait_for_previous_stage();           // the part slices
  const int64_t n = slot_off[Sw];
  const int64_t share = n > 0 ? (n + gx - 1) / gx : 1;
  const int64_t e_lo = slot_off[s], e_hi = slot_off[s + 1];
  const int x0 = static_cast<int>(e_lo / share);
  const int x1 = e_hi > e_lo ? static_cast<int>((e_hi - 1) / share) : x0 - 1;
  const int cg = c / cn, cl = c - cg * cn;
  const int64_t slice = static_cast<int64_t>(Bw) * cn * kLanes;
  const int64_t step = static_cast<int64_t>(gy) * gz * slice;   // x -> x+1
  // bin b's cell in the slices of block x = 0 for slot s
  auto cell = [&](int b) {
    const int bg = b / Bw, bl = b - bg * Bw;
    return part + s * step +
           (static_cast<int64_t>(y) * gz + cg * nbg + bg) * slice +
           slice_offset(Bw, cn, std::is_same<AccT, int>::value, bl, cl, lane);
  };
  const int b = b0 + warp;
  AccT total = AccT(0);
  if (x1 - x0 < kReduceWarps) {
    if (b < Bp) {
      const AccT* p = cell(b);
      AccT v[kReduceWarps];                  // all loads first, then in order
#pragma unroll
      for (int j = 0; j < kReduceWarps; ++j) {
        v[j] = x0 + j <= x1 ? p[(x0 + j) * step] : AccT(0);
      }
#pragma unroll
      for (int j = 0; j < kReduceWarps; ++j) total += v[j];
    }
  } else {
    AccT acc[kReduceWarps];
    const AccT* p[kReduceWarps];
#pragma unroll
    for (int j = 0; j < kReduceWarps; ++j) {
      acc[j] = AccT(0);
      p[j] = cell(min(b0 + j, Bp - 1));
    }
    for (int x = x0 + warp; x <= x1; x += kReduceWarps) {
#pragma unroll
      for (int j = 0; j < kReduceWarps; ++j) acc[j] += p[j][x * step];
    }
#pragma unroll
    for (int j = 0; j < kReduceWarps; ++j) s_sum[warp][j][lane] = acc[j];
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kReduceWarps; ++w) total += s_sum[w][warp][lane];
  }
  const int f = y * kLanes + lane;
  if (b < Bp && f < Fp) {
    out[((static_cast<int64_t>(c) * Sp + lo + s) * Fp + f) * Bp + b] = total;
  }
}

// ---------------------------------------------------------------- host

// The launch shape of one window: count/bucket blocks; the tile kernel's
// channels per block (cn), adding warps, bin width and groups, grid and
// shared memory; the scratch sizes.
struct HistPlan {
  int nb = 0;
  int cn = 0, warps = 0, Bw = 0, nbg = 0, gx = 0, gy = 0, gz = 0;
  int pack = 0;
  size_t smem = 0;
  int64_t part_elems = 0;
};

struct LaunchCache {
  int smem = -1;
  int occ = 0;
};

template <typename AccT>
using TileKernel = void (*)(const int*, const uint4*, const int*, AccT*, int,
                            int, int, int, int, int, bool);

template <typename AccT, int kPack>
TileKernel<AccT> tile_kernel_of(int cn) {
  switch (cn) {
    case 1: return hist_tiles_kernel<AccT, 1, kPack>;
    case 2: return hist_tiles_kernel<AccT, 2, kPack>;
    case 3: return hist_tiles_kernel<AccT, 3, kPack>;
    case 4: return hist_tiles_kernel<AccT, 4, kPack>;
    default: return hist_tiles_kernel<AccT, 5, kPack>;
  }
}

// The tile kernel instance for cn channels per block and a pack of `pack`
// bytes (int8 channels always fit 8; 12 is the unrounded f32 pack).
template <typename AccT>
TileKernel<AccT> tile_kernel(int cn, int pack) {
  if constexpr (std::is_same<AccT, float>::value) {
    if (pack == 16) return tile_kernel_of<AccT, 16>(cn);
    if (pack == 12) return tile_kernel_of<AccT, 12>(cn);
  }
  return tile_kernel_of<AccT, 8>(cn);
}

// The tile kernel's dynamic shared memory above 48 KB is opted into once
// per instance, size and device, and its occupancy kept, so a launch
// inside a CUDA graph capture makes no other API call.
template <typename AccT>
cudaError_t tile_occupancy(int cn, int pack, int dev, int threads,
                           size_t smem, int* occ) {
  static LaunchCache cache[kMaxCn + 1][3][kMaxDevices];
  static std::mutex lock;
  std::lock_guard<std::mutex> hold(lock);
  LaunchCache& c = cache[cn][pack / 4 - 2][dev];
  if (c.smem != static_cast<int>(smem)) {
    auto kern = tile_kernel<AccT>(cn, pack);
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.occ, kern,
                                                        threads, smem);
    }
    if (e != cudaSuccess) {
      cudaGetLastError();
      return e;
    }
    c.smem = static_cast<int>(smem);
  }
  *occ = c.occ;
  return *occ > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// Channels per tile block: of the cn (<= kMaxCn) whose tiles fit with
// their staging, the one with the most useful channel adds in flight
// (adding warps x nch / channel groups), the more warps on a tie.
template <typename AccT>
cudaError_t hist_plan(int64_t R, int Fp, int Bp, int Sw, int nch,
                      int elem_bytes, HistPlan* p) {
  int dev = 0, sms = 0, optin = 0, occ = 0;
  cudaError_t e = device_limits(&dev, &sms, &optin);
  if (e != cudaSuccess) return e;
  HistPlan h;
  // unrounded f32 (4-byte channels, nch <= 3): always the 12-byte pack
  h.pack = elem_bytes == 4 ? 12 : nch * elem_bytes <= 8 ? 8 : 16;
  h.nb = static_cast<int>(std::max<int64_t>(
      (R + kCountRows - 1) / kCountRows, 1));
  h.Bw = std::min(Bp, kMaxBinWidth);
  h.nbg = (Bp + h.Bw - 1) / h.Bw;
  const size_t stage = tile_stage_bytes((std::min(kLanes, Fp) + 3) & ~3,
                                        record_bytes(h.pack));
  double best = 0.0;
  for (int cn = std::min(nch, kMaxCn); cn >= 1; --cn) {
    const size_t tile = static_cast<size_t>(h.Bw) * cn * kLanes *
                        sizeof(AccT);
    if (stage + tile > static_cast<size_t>(optin)) continue;
    // the int32 variant's warps share one tile; f32 warps own theirs
    const bool shared = std::is_same<AccT, int>::value;
    const int warps = shared ? kTileMaxWarps
                             : static_cast<int>(std::min<size_t>(
                                   kTileMaxWarps, (optin - stage) / tile));
    const int gzc = (nch + cn - 1) / cn;
    const double score = static_cast<double>(warps) * nch / gzc;
    if (score > best || (score == best && warps > h.warps)) {
      best = score;
      h.cn = cn;
      h.warps = warps;
      h.smem = stage + (shared ? 1 : static_cast<size_t>(warps)) * tile;
    }
  }
  if (h.cn == 0) return cudaErrorInvalidConfiguration;
  e = tile_occupancy<AccT>(h.cn, h.pack, dev, h.warps * 32, h.smem, &occ);
  if (e != cudaSuccess) return e;
  h.gy = (Fp + kLanes - 1) / kLanes;
  h.gz = (nch + h.cn - 1) / h.cn * h.nbg;
  int64_t gx = static_cast<int64_t>(sms) * occ / (h.gy * h.gz);
  gx = std::min<int64_t>(gx, (R + kChunk - 1) / kChunk);
  h.gx = static_cast<int>(std::max<int64_t>(gx, 1));
  h.part_elems = (static_cast<int64_t>(h.gx) + Sw - 1) * h.gy * h.gz *
                 h.Bw * h.cn * kLanes;
  *p = h;
  return cudaSuccess;
}

// Launch a stage that reads what the stage before it on the stream wrote,
// as a programmatic dependant of that stage (wait_for_previous_stage).
template <typename... KArgs, typename... Args>
cudaError_t launch_after(void (*kern)(KArgs...), dim3 grid, dim3 block,
                         size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

struct HistArgs {
  const void* bins; const void* gh; const void* slot; void* out;
  void* cnt; void* off; void* slot_off; void* recs; void* part;
  int64_t R; int Fp; int Bp; int Sp; int lo; int Sw; int nch;
  cudaStream_t stream; int* launched;
};

// Launch the bucket kernel with `smem` bytes of dynamic shared memory (its
// records take more than the default 48 KB: opted into once per size).
template <typename ValT, int kWords>
cudaError_t bucket_launch(size_t smem, int nb, const HistArgs& a,
                          const int* off, uint4* recs) {
  static int opted[kMaxDevices] = {};
  static std::mutex lock;
  auto kern = hist_bucket_kernel<ValT, kWords>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  {
    std::lock_guard<std::mutex> hold(lock);
    if (opted[dev] != static_cast<int>(smem)) {
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      opted[dev] = static_cast<int>(smem);
    }
  }
  return launch_after(kern, dim3(nb), dim3(kCountThreads), smem, a.stream,
                      static_cast<const int*>(a.slot),
                      static_cast<const ValT*>(a.gh), off, recs, a.R, a.lo,
                      a.Sw, a.nch);
}

template <typename ValT, typename AccT>
cudaError_t run_hist(const HistArgs& a, int stages) {
  HistPlan h;
  cudaError_t e = hist_plan<AccT>(a.R, a.Fp, a.Bp, a.Sw, a.nch,
                                  ChannelCode<ValT>::kBytes, &h);
  if (e != cudaSuccess) return e;
  const int* slot = static_cast<const int*>(a.slot);
  const ValT* gh = static_cast<const ValT*>(a.gh);
  int* cnt = static_cast<int*>(a.cnt);
  int* off = static_cast<int*>(a.off);
  int* slot_off = static_cast<int*>(a.slot_off);
  uint4* recs = static_cast<uint4*>(a.recs);
  AccT* part = static_cast<AccT*>(a.part);
  const size_t wc_bytes = sizeof(int) * kCountWarps * a.Sw;
  if (stages & kCountBit) {
    hist_count_kernel<ValT><<<h.nb, kCountThreads, wc_bytes, a.stream>>>(
        slot, gh, cnt, a.R, a.lo, a.Sw, a.nch);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    *a.launched |= kCountBit;
  }
  if (stages & kScanBit) {
    e = launch_after(hist_scan_kernel, dim3(1), dim3(kScanThreads), 0,
                     a.stream, static_cast<const int*>(cnt), off, slot_off,
                     h.nb, a.Sw);
    if (e != cudaSuccess) return e;
    *a.launched |= kScanBit;
  }
  if (stages & kBucketBit) {
    const size_t smem = wc_bytes + sizeof(int) * ((a.Sw + 4) & ~3) +
                        (record_bytes(h.pack) == 16
                             ? static_cast<size_t>(kCountRows) * 16 : 0);
    if constexpr (std::is_same<ValT, RawF32>::value) {
      e = bucket_launch<ValT, 3>(smem, h.nb, a, off, recs);
    } else if (h.pack == 8) {
      e = bucket_launch<ValT, 2>(smem, h.nb, a, off, recs);
    } else {
      e = bucket_launch<ValT, 4>(smem, h.nb, a, off, recs);
    }
    if (e != cudaSuccess) return e;
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    *a.launched |= kBucketBit;
  }
  if (stages & kTilesBit) {
    const bool vec = reinterpret_cast<uintptr_t>(a.bins) % 16 == 0 &&
                     a.Fp % 4 == 0;
    e = launch_after(tile_kernel<AccT>(h.cn, h.pack),
                     dim3(h.gx, h.gy, h.gz), dim3(h.warps * 32), h.smem,
                     a.stream, static_cast<const int*>(a.bins),
                     static_cast<const uint4*>(recs),
                     static_cast<const int*>(slot_off), part, a.Fp, a.Bp,
                     h.Bw, h.nbg, a.Sw, a.nch, vec);
    if (e != cudaSuccess) return e;
    *a.launched |= kTilesBit;
  }
  if (stages & kReduceBit) {
    const dim3 grid((a.Bp + kReduceWarps - 1) / kReduceWarps, h.gy,
                    a.nch * a.Sw);
    e = launch_after(hist_reduce_kernel<AccT>, grid, dim3(32 * kReduceWarps),
                     0, a.stream, static_cast<const AccT*>(part),
                     static_cast<const int*>(slot_off),
                     static_cast<AccT*>(a.out), h.gx, h.gz, h.nbg, h.cn,
                     h.Bw, a.Fp, a.Bp, a.Sp, a.lo, a.Sw);
    if (e != cudaSuccess) return e;
    *a.launched |= kReduceBit;
  }
  return e;
}

}  // namespace lgbt

// Any of the stages (1 count, 2 scan, 4 bucket, 8 tiles, 16 reduce; 31 =
// all, in order) for the window of slots [lo, lo + Sw) (Sw <= 512) of out
// [nch, Sp, Fp, Bp], on one stream with no host sync. quant = 0: gh f32
// (rounded to bf16), out and part f32; quant = 1: gh int8, out and part
// int32; quant = 2: gh f32 as given (nch <= 3), out and part f32. Scratch,
// of
// lgbt_hist_plan's sizes: cnt and off (int32 each), slot_off (Sw + 1
// int32), recs (R records), part. The reduce writes every cell
// of the window's slots. *launched gets one bit for each kernel launched,
// also when a later launch fails.
extern "C" int lgbt_hist_pass(const void* bins, const void* gh,
                              const void* slot, void* out, void* cnt,
                              void* off, void* slot_off, void* recs,
                              void* part, long long R, int Fp, int Bp,
                              int Sp, int lo, int Sw, int nch,
                              int quant, int stages, void* stream,
                              int* launched) {
  *launched = 0;
  if (Sw < 1 || Sw > lgbt::kMaxWindow || nch < 1 || nch > lgbt::kMaxCh ||
      quant < 0 || quant > 2 || (quant == 2 && nch > 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const lgbt::HistArgs a{bins, gh, slot, out, cnt, off, slot_off, recs,
                         part, R, Fp, Bp, Sp, lo, Sw, nch,
                         static_cast<cudaStream_t>(stream), launched};
  const cudaError_t e =
      quant == 1 ? lgbt::run_hist<int8_t, int>(a, stages)
      : quant == 2 ? lgbt::run_hist<lgbt::RawF32, float>(a, stages)
                   : lgbt::run_hist<float, float>(a, stages);
  return static_cast<int>(e);
}

// The scratch one window of these arguments takes: sizes[0] the int32s of
// cnt and of off each, [1] bytes of a record (recs holds R of them),
// [2] part elements (4 bytes each); sizes[3] the tile kernel's row blocks,
// [4] its channels per block, [5] its adding warps, [6] the bytes of a
// record's channel pack (its row index follows). quant as for
// lgbt_hist_pass.
extern "C" int lgbt_hist_plan(long long R, int Fp, int Bp, int Sw, int nch,
                              int quant, long long* sizes) {
  lgbt::HistPlan h;
  if (quant < 0 || quant > 2 || (quant == 2 && nch > 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e =
      quant == 1 ? lgbt::hist_plan<int>(R, Fp, Bp, Sw, nch, 1, &h)
                 : lgbt::hist_plan<float>(R, Fp, Bp, Sw, nch,
                                          quant == 2 ? 4 : 2, &h);
  sizes[0] = static_cast<long long>(h.nb) * Sw;
  sizes[1] = lgbt::record_bytes(h.pack);
  sizes[2] = h.part_elems;
  sizes[3] = h.gx;
  sizes[4] = h.cn;
  sizes[5] = h.warps;
  sizes[6] = h.pack;
  return static_cast<int>(e);
}
