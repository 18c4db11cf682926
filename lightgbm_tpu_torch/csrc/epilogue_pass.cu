// epilogue_pass: the fused boosting epilogue — the deferred final route, the
// leaf-value score update, the binary or L2 gradients from the updated
// score times the next iteration's bag weights, their bf16 channel pack,
// and the next tree's root histogram — as four kernels on one stream.
//
// Replaces: the Pallas kernel _epilogue_kernel (lightgbm_tpu/ops/
// fused_level.py:641, launched by epilogue_pass :739). Same inputs and
// outputs: hist [F_oh*B, nch*8] f32 in the root level_pass layout (slot 0
// of each 8-column channel block live, slots 1-7 zero), new_score [Rp] f32
// and gh [8, Rp] bf16 in pack_gh's layout (rows >= nch zero). Each
// histogram entry is the f32 sum of the bf16-rounded channel values, as
// the TPU kernel's bf16 one-hot matmul takes it. The gradient arithmetic
// uses IEEE-rounded intrinsics so nvcc cannot contract it into FMAs, and
// expf (the file is built without --use_fast_math).
//
// Bound on the H100: bytes. Per row it reads F_oh bin bytes, the leaf, the
// score, two operand rows and the bag weight and writes the score and
// eight bf16 channels (about 68 B at F_oh=28 int8); the arithmetic is a
// few dozen flops plus F_oh*nch adds per row with a non-zero channel. Those
// adds (140 per row at F_oh=28, nch=5) are what costs. Designs measured
// per launch at 1M rows on one H100 (PERF.md): shared-memory f32
// atomicAdds, each a compare-and-swap loop on sm_90 (SASS ATOMS.CAST.SPIN),
// 0.36 ms; a two-level one-hot product on the tensor cores (mma.sync
// m16n8k16, A = one_hot(lo), B = the channels masked by hi) in the same
// one-pass kernel, 0.25 ms, bound by the ~40 instructions that build the
// fragments of every 16 rows x feature and by the HMMA rate; the design
// below with one adding warp per tile, 0.17 ms, and with the element-wise
// part in producer warps of the histogram kernel, 0.34 ms (too few threads
// for the route's dependent loads); the design below, 0.13 ms. Its adds are
// bound by shared-memory traffic and latency: a load and a store of each
// cell per row, feature and channel.
//
// Design:
//   1. epilogue_slabs: the slab table of the deferred W (level_slabs_kernel
//      through launch_slabs), so the route reads one bin and one W entry per
//      routed row (slab_left).
//   2. epilogue_pass_kernel: one thread per row, grid-stride, slot tables,
//      their leaf -> slot hash and the slab table in shared memory: route,
//      score update, gradients and pack; new_score and the eight gh rows
//      written coalesced. Nothing here waits on a histogram, so the card
//      keeps enough rows in flight for the route's dependent loads.
//   3. epilogue_hist_kernel: lanes over features, and no atomics. Each
//      adding warp owns a private f32 tile in shared memory, laid out so
//      lane f's cells sit in bank f (vectors of up to four sums per lane and
//      bin, consecutive lanes on consecutive vectors): a row's features add
//      into their own banks with a plain load, add and store. The block's
//      CN channels split into two groups (ChannelSplit), each added by its
//      own warps over the same rows, so twice the warps share the tile
//      memory and each row's load-add-store chain is shorter. A block
//      stages 256-row chunks of its 32 features' bins and its CN channel
//      rows (the gh rows step 2 just wrote, from L2) with 16-byte cp.async,
//      double buffered, so the copy of the next chunk overlaps the adds of
//      this one. A warp adds four rows per step (one bin load, one 8-byte
//      load per channel, the next step's loaded before this step's tile
//      stores); two rows of one bin: the second store, of (old + v0) + v1,
//      wins; rows whose channels are all zero (out of the bag, padding) are
//      skipped by the whole warp. Features beyond 32 take grid.y blocks;
//      channels that do not fit the tiles with enough warps take grid.z
//      blocks of CN (chosen on the host; CN is a template argument so the
//      channel loops unroll). At the end a block sums its tiles in warp
//      order into its partial slab.
//   4. epilogue_reduce: sums the blocks' partial slabs in block order and
//      writes every column of hist (so the wrapper needs no memset): the
//      f32 sums are the same from run to run on one card, and the weight
//      channel counts rows exactly.
#include <algorithm>

#include "fused_level.cuh"

namespace lgbt {

constexpr int kEpiThreads = 256;
constexpr int kEpiBlocksPerSm = 8;      // grid of step 2, grid-stride
constexpr int kHistChunk = 256;         // rows per staged chunk
constexpr int kHistMaxWarps = 16;
constexpr int kLanes = 32;              // features per hist block
constexpr int kMaxCn = 5;               // channels per hist block (nch <= 5)
constexpr int kReduceSlices = 8;        // warps summing one output's blocks
constexpr int kKindBinary = 0;          // 1 = l2
// the bits lgbt_epilogue_pass reports, one per kernel it launched
constexpr int kEpiSlabsBit = 1, kEpiPassBit = 2, kEpiHistBit = 4,
              kEpiReduceBit = 8;

template <typename BinT>
__global__ void __launch_bounds__(kEpiThreads)
epilogue_pass_kernel(const BinT* __restrict__ bins,
                     const int* __restrict__ leaf,
                     const __nv_bfloat16* __restrict__ W,
                     const int* __restrict__ tbl,
                     const int* __restrict__ slab_of,
                     const float* __restrict__ leaf_values, int L,
                     const float* __restrict__ score,
                     const float* __restrict__ ops,
                     const float* __restrict__ bag,
                     float* __restrict__ new_score,
                     __nv_bfloat16* __restrict__ gh, int64_t Rp, int F_oh,
                     int B, int Sp, int nch, int kind, float sigmoid) {
  __shared__ SlotTables t;
  __shared__ SlotHash hash;
  __shared__ int s_slab[kMaxSlots];
  for (int k = threadIdx.x; k < Sp; k += blockDim.x) s_slab[k] = slab_of[k];
  load_tables(t, tbl, Sp);   // ends in __syncthreads()
  build_slot_hash(hash, t, Sp);
  const RowLayout lay{nullptr, nullptr, nullptr, B};
  const int64_t FB = static_cast<int64_t>(F_oh) * B;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < Rp; r += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    // deferred final route (an all-inactive table matches no row)
    int lf = leaf[r];
    const int k = hash_slot(hash, lf);
    if (k >= 0 &&
        !slab_left(bins, Rp, r, W + k * FB, s_slab[k], F_oh, lay)) {
      lf += t.delta[k];
    }
    // score update; padding rows sit at -1 and add nothing
    const float s =
        __fadd_rn(score[r], (lf >= 0 && lf < L) ? leaf_values[lf] : 0.0f);
    new_score[r] = s;
    // gradients from the updated score (ref: binary_objective.hpp:
    // 107-136, regression_objective.hpp:127-141), times the bag weight
    const float op0 = ops[r];
    const float op1 = ops[Rp + r];
    float g, h;
    if (kind == kKindBinary) {
      const float a = __fmul_rn(op0, sigmoid);
      const float resp =
          __fdiv_rn(__fmul_rn(-op0, sigmoid),
                    __fadd_rn(1.0f, expf(__fmul_rn(a, s))));
      const float ar = fabsf(resp);
      g = __fmul_rn(resp, op1);
      h = __fmul_rn(__fmul_rn(ar, __fsub_rn(sigmoid, ar)), op1);
    } else {
      g = __fmul_rn(__fsub_rn(s, op0), op1);
      h = op1;
    }
    const float w = bag[r];
    g = __fmul_rn(g, w);
    h = __fmul_rn(h, w);
    // pack_gh (round to nearest even; hi/lo split when nch = 5)
    __nv_bfloat16 ch[kMaxChannels];
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) ch[c] = zero;
    if (nch == 5) {
      ch[0] = __float2bfloat16_rn(g);
      ch[1] = __float2bfloat16_rn(__fsub_rn(g, __bfloat162float(ch[0])));
      ch[2] = __float2bfloat16_rn(h);
      ch[3] = __float2bfloat16_rn(__fsub_rn(h, __bfloat162float(ch[2])));
      ch[4] = __float2bfloat16_rn(w);
    } else {
      ch[0] = __float2bfloat16_rn(g);
      ch[1] = __float2bfloat16_rn(h);
      ch[2] = __float2bfloat16_rn(w);
    }
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) gh[c * Rp + r] = ch[c];
  }
}

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src));
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The shared memory of one hist block: two staging buffers, each the bins
// of kLanes features (rows padded by 16 bytes, so 16-byte copies stay
// aligned and the 32 lanes' reads of one row position fall in 8 bank
// quads, not one) and the chunk's CN channel rows; then the adding warps'
// tiles, B * CN * 32 f32 for each set of one warp per channel group.
template <typename BinT>
struct HistSmem {
  static constexpr int kRowBytes =
      kHistChunk * static_cast<int>(sizeof(BinT)) + 16;
  static constexpr size_t kBinBytes = static_cast<size_t>(kLanes) * kRowBytes;
  __host__ __device__ static size_t stage_bytes(int cn) {
    return kBinBytes + static_cast<size_t>(cn) * kHistChunk * 2;
  }
  // with `sets` adding warps of each channel group (sets full tiles)
  __host__ __device__ static size_t bytes(int B, int cn, int sets) {
    return 2 * stage_bytes(cn) +
           static_cast<size_t>(sets) * B * cn * kLanes * sizeof(float);
  }
};

// Stage the chunk at `base` into one buffer: 16-byte cp.async where every
// copy is aligned and inside Rp, else plain loads (zeros past Rp).
template <typename BinT, int CN>
__device__ inline void stage_chunk(unsigned char* buf, const BinT* bins,
                                   const uint16_t* gh, int64_t Rp,
                                   int64_t base, int f0, int nf, int c0,
                                   bool vec) {
  using S = HistSmem<BinT>;
  uint16_t* sc = reinterpret_cast<uint16_t*>(buf + S::kBinBytes);
  if (vec && base + kHistChunk <= Rp) {
    constexpr int kPieces = kHistChunk * static_cast<int>(sizeof(BinT)) / 16;
    for (int i = threadIdx.x; i < nf * kPieces; i += blockDim.x) {
      const int fl = i / kPieces;
      const int k = i - fl * kPieces;
      cp_async16(buf + fl * S::kRowBytes + 16 * k,
                 reinterpret_cast<const unsigned char*>(
                     bins + (f0 + fl) * Rp + base) + 16 * k);
    }
    constexpr int kChPieces = kHistChunk / 8;
    for (int i = threadIdx.x; i < CN * kChPieces; i += blockDim.x) {
      const int c = i / kChPieces;
      const int k = i - c * kChPieces;
      cp_async16(sc + c * kHistChunk + 8 * k,
                 gh + (c0 + c) * Rp + base + 8 * k);
    }
  } else {
    for (int i = threadIdx.x; i < nf * kHistChunk; i += blockDim.x) {
      const int fl = i / kHistChunk;
      const int k = i - fl * kHistChunk;
      reinterpret_cast<BinT*>(buf + fl * S::kRowBytes)[k] =
          base + k < Rp ? bins[(f0 + fl) * Rp + base + k] : BinT(0);
    }
    for (int i = threadIdx.x; i < CN * kHistChunk; i += blockDim.x) {
      const int c = i / kHistChunk;
      const int k = i - c * kHistChunk;
      sc[c * kHistChunk + k] =
          base + k < Rp ? gh[(c0 + c) * Rp + base + k] : uint16_t(0);
    }
  }
}

// Bins of rows 4q .. 4q+3 of a staged row: one 32-bit (int8) or 64-bit
// (int16) load, and bin i of them.
template <typename BinT> struct Quad;
template <> struct Quad<int8_t> {
  using T = uint32_t;
  static __device__ T load(const int8_t* row, int q) {
    return *reinterpret_cast<const uint32_t*>(row + 4 * q);
  }
  static __device__ int bin(T v, int i) {
    return static_cast<int>((v >> (8 * i)) & 0xFFu);
  }
};
template <> struct Quad<int16_t> {
  using T = uint2;
  static __device__ T load(const int16_t* row, int q) {
    return *reinterpret_cast<const uint2*>(row + 4 * q);
  }
  static __device__ int bin(T v, int i) {
    return static_cast<int>(((i < 2 ? v.x : v.y) >> (16 * (i & 1))) &
                            0xFFFFu);
  }
};

// A lane's C sums of one bin: the first kVec of them as one vector (4, 2
// or 1 floats: one shared load or store), the last kRest (0 or 1) apart.
// A warp's tile: [B][32 lanes] vectors, then [B][32 lanes] single sums
// when kRest; lane f's cells are in bank f (one vector per lane,
// consecutive lanes on consecutive vectors).
template <int C>
struct TileCell {
  static constexpr int kVec = C >= 4 ? 4 : C >= 2 ? 2 : 1;
  static constexpr int kRest = C - kVec;
  // float offset of sum c of (bin, lane f) in a tile of B bins
  __device__ static int offset(int B, int bin, int c, int f) {
    return c < kVec ? (bin * kLanes + f) * kVec + c
                    : B * kLanes * kVec + bin * kLanes + f;
  }
};
template <int N> struct VecOf;
template <> struct VecOf<1> { using T = float; };
template <> struct VecOf<2> { using T = float2; };
template <> struct VecOf<4> { using T = float4; };

__device__ inline float& at(float& v, int) { return v; }
__device__ inline float& at(float2& v, int i) { return i == 0 ? v.x : v.y; }
__device__ inline float& at(float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The two channel groups a block's CN channels split into, each added by
// warps of its own: twice the warps share the tile memory one group of
// CN-channel tiles would take, and each row's chain of shared loads, adds
// and stores is shorter.
template <int CN>
struct ChannelSplit {
  static constexpr int kC0 = (CN + 1) / 2;
  static constexpr int kC1 = CN - kC0;
  static constexpr int kGroups = kC1 > 0 ? 2 : 1;
};

// One adding warp's share of a staged chunk: quads q = i, i + n, ... of
// rows, C channels from the channel rows at sc, into the warp's tile of B
// bins. Four rows per step (one bin load and one 8-byte load per channel,
// the next step's loaded before this step's tile stores: the buffer is
// read-only here); two rows of one bin: the second store, of (old + v0) +
// v1, wins; rows whose C channels are all zero are skipped by the whole
// warp.
template <typename BinT, int C>
__device__ inline void add_chunk(float* tile, int B, const BinT* row,
                                 const uint16_t* sc, int i, int n,
                                 int lane) {
  using Q = Quad<BinT>;
  constexpr int kVec = TileCell<C>::kVec;
  constexpr int kRest = TileCell<C>::kRest;
  using V = typename VecOf<kVec>::T;
  V* tv = reinterpret_cast<V*>(tile) + lane;
  float* tr = tile + B * kLanes * kVec + lane;
  uint2 w[C];
  typename Q::T bq{};
  int q = i;
  if (q < kHistChunk / 4) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      w[c] = *reinterpret_cast<const uint2*>(sc + c * kHistChunk + 4 * q);
    }
    bq = Q::load(row, q);
  }
  for (; q < kHistChunk / 4; q += n) {
    uint2 cw[C];
#pragma unroll
    for (int c = 0; c < C; ++c) cw[c] = w[c];
    const typename Q::T bins4 = bq;
    const int next = q + n;
    if (next < kHistChunk / 4) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        w[c] = *reinterpret_cast<const uint2*>(sc + c * kHistChunk +
                                               4 * next);
      }
      bq = Q::load(row, next);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {              // rows 4q + 2h, 4q + 2h + 1
      uint32_t any = 0;
      float v0[C], v1[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const uint32_t x = h ? cw[c].y : cw[c].x;
        any |= x;
        v0[c] = __uint_as_float(x << 16);      // bf16 -> f32, row 4q + 2h
        v1[c] = __uint_as_float(x & 0xFFFF0000u);
      }
      if ((any & 0x7FFF7FFFu) == 0u) continue;  // both rows all +-0
      const int b0 = Q::bin(bins4, 2 * h);
      const int b1 = Q::bin(bins4, 2 * h + 1);
      const bool same = b0 == b1;
      const int o0 = b0 * kLanes, o1 = b1 * kLanes;
      V a0 = tv[o0], a1 = tv[o1];
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const float s0 = __fadd_rn(at(a0, c), v0[c]);
        at(a1, c) = __fadd_rn(same ? s0 : at(a1, c), v1[c]);
        at(a0, c) = s0;
      }
      if (kRest) {
        const float r0 = tr[o0], r1 = tr[o1];
        const float s0 = __fadd_rn(r0, v0[C - 1]);
        tv[o0] = a0;
        tv[o1] = a1;
        tr[o0] = s0;
        tr[o1] = __fadd_rn(same ? s0 : r1, v1[C - 1]);
      } else {
        tv[o0] = a0;
        tv[o1] = a1;
      }
    }
  }
}

// The sum over a group's n warps' tiles of sum c of (bin, lane f).
template <int C>
__device__ inline float group_sum(const float* tiles, int n, int B, int bin,
                                  int c, int f) {
  const int len = B * C * kLanes;
  const int at = TileCell<C>::offset(B, bin, c, f);
  float sum = 0.0f;
  for (int k = 0; k < n; ++k) sum += tiles[k * len + at];
  return sum;
}

// grid (row blocks, feature groups of kLanes, channel groups of CN);
// part[((x * gy + y) * gz + z) * B*CN*32 + (bin*CN + c)*32 + f] is block
// (x, y, z)'s sum of pack_gh row z*CN + c over feature y*32 + f (the last
// group's rows past nch are zero). The block's adding warps: n per channel
// group of ChannelSplit<CN>, the first group's n tiles, then the second's.
template <typename BinT, int CN>
__global__ void __launch_bounds__(kHistMaxWarps * 32)
epilogue_hist_kernel(const BinT* __restrict__ bins,
                     const uint16_t* __restrict__ gh,
                     float* __restrict__ part, int64_t Rp, int F_oh, int B,
                     bool vec) {
  using S = HistSmem<BinT>;
  using Split = ChannelSplit<CN>;
  constexpr int kC0 = Split::kC0;
  constexpr int kC1 = Split::kC1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = (blockDim.x >> 5) / Split::kGroups;    // warps per group
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = warp / n;
  const int wi = warp - grp * n;
  const int f0 = blockIdx.y * kLanes;
  const int nf = min(kLanes, F_oh - f0);
  const int c0 = blockIdx.z * CN;
  constexpr size_t kStage = S::kBinBytes + CN * kHistChunk * 2;
  float* tiles0 = reinterpret_cast<float*>(smem + 2 * kStage);
  float* tiles1 = tiles0 + n * B * kC0 * kLanes;
  const int all = n * B * CN * kLanes;
  for (int i = threadIdx.x; i < all; i += blockDim.x) tiles0[i] = 0.0f;
  const bool on = lane < nf;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kHistChunk;
  int64_t base = static_cast<int64_t>(blockIdx.x) * kHistChunk;
  if (base < Rp) {
    stage_chunk<BinT, CN>(smem, bins, gh, Rp, base, f0, nf, c0, vec);
  }
  cp_async_commit();
  for (int it = 0; base < Rp; base += stride, ++it) {
    if (base + stride < Rp) {
      stage_chunk<BinT, CN>(smem + ((it + 1) & 1) * kStage, bins, gh, Rp,
                            base + stride, f0, nf, c0, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();        // this thread's copies of this chunk
    __syncthreads();           // everyone's
    const unsigned char* buf = smem + (it & 1) * kStage;
    const BinT* row = reinterpret_cast<const BinT*>(buf + lane * S::kRowBytes);
    const uint16_t* sc =
        reinterpret_cast<const uint16_t*>(buf + S::kBinBytes);
    if (on) {
      if (grp == 0) {
        add_chunk<BinT, kC0>(tiles0 + wi * B * kC0 * kLanes, B, row, sc, wi,
                             n, lane);
      } else if (kC1 > 0) {
        add_chunk<BinT, (kC1 > 0 ? kC1 : 1)>(
            tiles1 + wi * B * kC1 * kLanes, B, row, sc + kC0 * kHistChunk,
            wi, n, lane);
      }
    }
    __syncthreads();           // this buffer is refilled next
  }
  cp_async_wait<0>();
  __syncthreads();
  // the groups' tiles, each summed in warp order, into the block's slab
  float* out = part + ((static_cast<int64_t>(blockIdx.x) * gridDim.y +
                        blockIdx.y) * gridDim.z + blockIdx.z) *
                          (static_cast<int64_t>(B) * CN * kLanes);
  for (int i = threadIdx.x; i < B * CN * kLanes; i += blockDim.x) {
    const int f = i & (kLanes - 1);
    const int bc = i >> 5;                 // bin * CN + c
    const int bin = bc / CN;
    const int c = bc - bin * CN;
    out[i] = c < kC0 ? group_sum<kC0>(tiles0, n, B, bin, c, f)
                     : group_sum<(kC1 > 0 ? kC1 : 1)>(tiles1, n, B, bin,
                                                     c - kC0, f);
  }
}

// hist[(f*B + bin)*C + 8*ch] = the sum over the gx row blocks of their
// partials, in block order: each block takes 32 consecutive outputs in the
// partial slabs' order, each of its kReduceSlices warps sums every
// kReduceSlices-th row block for them, and the slices are added in order.
// Each block also zeroes its share of the other columns.
__global__ void __launch_bounds__(32 * kReduceSlices)
epilogue_reduce_kernel(const float* __restrict__ part,
                       float* __restrict__ hist, int gx, int gy, int gz,
                       int cpg, int F_oh, int B, int nch) {
  __shared__ float s_sum[kReduceSlices][32];
  const int lane = threadIdx.x & 31;
  const int slice = threadIdx.x >> 5;
  const int64_t per_x = static_cast<int64_t>(B) * cpg * kLanes * gy * gz;
  const int64_t o = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  float sum = 0.0f;
  if (o < per_x) {
    for (int b = slice; b < gx; b += kReduceSlices) sum += part[b * per_x + o];
  }
  s_sum[slice][lane] = sum;
  __syncthreads();
  const int64_t C = static_cast<int64_t>(nch) * 8;
  if (slice == 0 && o < per_x) {
    float total = 0.0f;
#pragma unroll
    for (int k = 0; k < kReduceSlices; ++k) total += s_sum[k][lane];
    // o = slab (y * gz + z), then (bin * cpg + c) * 32 + f within it
    const int64_t slab = static_cast<int64_t>(B) * cpg * kLanes;
    const int yz = static_cast<int>(o / slab);
    const int y = yz / gz;
    const int z = yz - y * gz;
    const int in = static_cast<int>(o - yz * slab);
    const int fl = in % kLanes;
    const int c = in / kLanes % cpg;
    const int bin = in / kLanes / cpg;
    const int f = y * kLanes + fl;
    const int ch = z * cpg + c;
    if (f < F_oh && ch < nch) {
      hist[(static_cast<int64_t>(f) * B + bin) * C + 8 * ch] = total;
    }
  }
  const int64_t n = static_cast<int64_t>(F_oh) * B * C;
  const int64_t per = (n + gridDim.x - 1) / gridDim.x;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * per;
  const int64_t end = min(n, begin + per);
  for (int64_t i = begin + threadIdx.x; i < end; i += blockDim.x) {
    if (i % 8 != 0) hist[i] = 0.0f;
  }
}

struct EpiArgs {
  const void* bins; const void* leaf; const void* W; const void* tbl;
  const void* leaf_values; int L; const void* score; const void* ops;
  const void* bag; void* hist; void* new_score; void* gh; void* part;
  int* slab_of; long long Rp; int F_oh; int B; int Sp; int nch; int kind;
  float sigmoid; int smem_limit; int max_blocks; cudaStream_t stream;
  int* launched;
};

// The hist kernel's shape: channels per block (cpg) and adding warps per
// block (as many per channel group of ChannelSplit<cpg>), the most
// channel-rows a block adds at once (cpg x warps, at most kHistMaxWarps
// warps) whose tiles and staging fit smem_limit, the larger cpg on a tie;
// then its grid.
struct HistShape {
  int cpg = 0, warps = 0, gx = 0, gy = 0, gz = 0;
  size_t smem = 0;
};

// The dynamic shared memory above 48 KB is opted into once per kernel,
// size and device, and the occupancy of the last size is kept, so a launch
// inside a CUDA graph capture makes no other API call.
struct LaunchCache {
  int smem = -1;
  int occ = 0;
};

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, LaunchCache* cache, std::mutex* lock,
                   int dev, int threads, size_t smem, int* occ) {
  std::lock_guard<std::mutex> hold(*lock);
  LaunchCache& c = cache[dev];
  if (c.smem != static_cast<int>(smem)) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.occ, kernel,
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

template <typename BinT>
using HistKernel = void (*)(const BinT*, const uint16_t*, float*, int64_t,
                            int, int, bool);

// The hist kernel instance for cn channels per block (1..kMaxCn).
template <typename BinT>
HistKernel<BinT> hist_kernel(int cn) {
  switch (cn) {
    case 1: return epilogue_hist_kernel<BinT, 1>;
    case 2: return epilogue_hist_kernel<BinT, 2>;
    case 3: return epilogue_hist_kernel<BinT, 3>;
    case 4: return epilogue_hist_kernel<BinT, 4>;
    default: return epilogue_hist_kernel<BinT, 5>;
  }
}

template <typename BinT>
cudaError_t hist_shape(const EpiArgs& a, HistShape* hs) {
  static LaunchCache cache[kMaxCn + 1][kMaxDevices];
  static std::mutex lock;
  int dev = 0, sms = 0, optin = 0, occ = 0;
  cudaError_t e = device_limits(&dev, &sms, &optin);
  if (e != cudaSuccess) return e;
  HistShape best;
  for (int cpg = std::min(a.nch, kMaxCn); cpg >= 1; --cpg) {
    const size_t tile = static_cast<size_t>(a.B) * cpg * kLanes *
                        sizeof(float);
    const size_t stage = 2 * HistSmem<BinT>::stage_bytes(cpg);
    if (stage + tile > static_cast<size_t>(a.smem_limit)) continue;
    // tile memory for `groups` warps of each channel group per cpg-channel
    // tile: the adding warps come in sets of one warp per group
    const int groups = cpg > 1 ? 2 : 1;
    const int warps = groups * static_cast<int>(
        std::min(static_cast<size_t>(kHistMaxWarps / groups),
                 (static_cast<size_t>(a.smem_limit) - stage) / tile));
    if (cpg * warps > best.cpg * best.warps) {
      best.cpg = cpg;
      best.warps = warps;
    }
  }
  if (best.cpg == 0) return cudaErrorInvalidConfiguration;
  best.smem = HistSmem<BinT>::bytes(a.B, best.cpg,
                                    best.warps / (best.cpg > 1 ? 2 : 1));
  e = opt_in(hist_kernel<BinT>(best.cpg), cache[best.cpg], &lock, dev,
             best.warps * 32, best.smem, &occ);
  if (e != cudaSuccess) return e;
  best.gy = (a.F_oh + kLanes - 1) / kLanes;
  best.gz = (a.nch + best.cpg - 1) / best.cpg;
  long long gx = static_cast<long long>(sms) * occ / (best.gy * best.gz);
  const long long chunks = (a.Rp + kHistChunk - 1) / kHistChunk;
  if (gx > chunks) gx = chunks;
  if (gx > a.max_blocks) gx = a.max_blocks;
  if (gx < 1) gx = 1;
  best.gx = static_cast<int>(gx);
  *hs = best;
  return cudaSuccess;
}

// The stages asked for (bits of kEpi*Bit); with `shape`, also the hist
// kernel's shape (and with no stage, only that).
template <typename BinT>
cudaError_t run_epilogue(const EpiArgs& a, int stages, HistShape* shape) {
  const int64_t FB = static_cast<int64_t>(a.F_oh) * a.B;
  const __nv_bfloat16* Wb = static_cast<const __nv_bfloat16*>(a.W);
  const BinT* bins = static_cast<const BinT*>(a.bins);
  cudaError_t e = cudaSuccess;
  if (stages & kEpiSlabsBit) {
    e = launch_slabs(Wb, RowLayout{nullptr, nullptr, nullptr, a.B},
                     a.slab_of, a.F_oh, FB, a.Sp, a.stream);
    if (e != cudaSuccess) return e;
    *a.launched |= kEpiSlabsBit;
  }
  if (stages & kEpiPassBit) {
    int dev = 0, sms = 0, optin = 0;
    if ((e = device_limits(&dev, &sms, &optin)) != cudaSuccess) return e;
    long long grid = (a.Rp + kEpiThreads - 1) / kEpiThreads;
    const long long fit = static_cast<long long>(sms) * kEpiBlocksPerSm;
    if (grid > fit) grid = fit;
    if (grid < 1) grid = 1;
    epilogue_pass_kernel<BinT><<<static_cast<unsigned>(grid), kEpiThreads, 0,
                                 a.stream>>>(
        bins, static_cast<const int*>(a.leaf), Wb,
        static_cast<const int*>(a.tbl), a.slab_of,
        static_cast<const float*>(a.leaf_values), a.L,
        static_cast<const float*>(a.score), static_cast<const float*>(a.ops),
        static_cast<const float*>(a.bag), static_cast<float*>(a.new_score),
        static_cast<__nv_bfloat16*>(a.gh), a.Rp, a.F_oh, a.B, a.Sp, a.nch,
        a.kind, a.sigmoid);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    *a.launched |= kEpiPassBit;
  }
  HistShape hs;
  if ((stages & (kEpiHistBit | kEpiReduceBit)) || shape != nullptr) {
    if ((e = hist_shape<BinT>(a, &hs)) != cudaSuccess) return e;
    if (shape != nullptr) *shape = hs;
  }
  if (stages & kEpiHistBit) {
    const uint16_t* gh = static_cast<const uint16_t*>(a.gh);
    const bool vec = reinterpret_cast<uintptr_t>(bins) % 16 == 0 &&
                     (a.Rp * sizeof(BinT)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(gh) % 16 == 0 &&
                     a.Rp % 8 == 0;
    hist_kernel<BinT>(hs.cpg)<<<dim3(hs.gx, hs.gy, hs.gz), hs.warps * 32,
                                hs.smem, a.stream>>>(
        bins, gh, static_cast<float*>(a.part), a.Rp, a.F_oh, a.B, vec);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    *a.launched |= kEpiHistBit;
  }
  if (stages & kEpiReduceBit) {
    const long long outs = static_cast<long long>(a.B) * hs.cpg * kLanes *
                           hs.gy * hs.gz;
    epilogue_reduce_kernel<<<static_cast<unsigned>((outs + 31) / 32),
                             32 * kReduceSlices, 0, a.stream>>>(
        static_cast<const float*>(a.part), static_cast<float*>(a.hist),
        hs.gx, hs.gy, hs.gz, hs.cpg, a.F_oh, a.B, a.nch);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    *a.launched |= kEpiReduceBit;
  }
  return e;
}

}  // namespace lgbt

// Any of the stages (1 slab table, 2 pass, 4 hist, 8 reduce; 15 = all, in
// order) on one stream with no host sync. bin_bytes is 1 (int8) or 2
// (int16); kind 0 = binary, 1 = l2. smem_limit is the shared memory a hist
// block may use (the card's opt-in limit); part is f32 scratch of
// lgbt_epilogue_blocks' size and max_blocks its row blocks; slab_of is
// [Sp] int32 scratch; hist is written whole. *launched gets one bit for
// each kernel launched, also when a later launch fails.
extern "C" int lgbt_epilogue_pass(
    const void* bins, int bin_bytes, const void* leaf, const void* W,
    const void* tbl, const void* leaf_values, int L, const void* score,
    const void* ops, const void* bag, void* hist, void* new_score, void* gh,
    void* part, void* slab_of, long long Rp, int F_oh, int B, int Sp,
    int nch, int kind, float sigmoid, int smem_limit, int max_blocks,
    int stages, void* stream, int* launched) {
  *launched = 0;
  const lgbt::EpiArgs a{bins, leaf, W, tbl, leaf_values, L, score, ops, bag,
                        hist, new_score, gh, part,
                        static_cast<int*>(slab_of), Rp, F_oh, B, Sp, nch,
                        kind, sigmoid, smem_limit, max_blocks,
                        static_cast<cudaStream_t>(stream), launched};
  const cudaError_t e =
      bin_bytes == 1 ? lgbt::run_epilogue<int8_t>(a, stages, nullptr)
                     : lgbt::run_epilogue<int16_t>(a, stages, nullptr);
  return static_cast<int>(e);
}

// The hist kernel's row blocks (*blocks, which the caller passes back as
// max_blocks) and the f32 scratch its partials take (*floats), for these
// arguments.
extern "C" int lgbt_epilogue_blocks(int bin_bytes, int B, int F_oh, int nch,
                                    long long Rp, int smem_limit,
                                    long long* floats, int* blocks) {
  lgbt::EpiArgs a{};
  a.B = B;
  a.F_oh = F_oh;
  a.nch = nch;
  a.Rp = Rp;
  a.smem_limit = smem_limit;
  a.max_blocks = 1 << 30;
  lgbt::HistShape hs;
  const cudaError_t e =
      bin_bytes == 1 ? lgbt::run_epilogue<int8_t>(a, 0, &hs)
                     : lgbt::run_epilogue<int16_t>(a, 0, &hs);
  *blocks = hs.gx;
  *floats = static_cast<long long>(hs.gx) * hs.gy * hs.gz * B * hs.cpg *
            lgbt::kLanes;
  return static_cast<int>(e);
}
