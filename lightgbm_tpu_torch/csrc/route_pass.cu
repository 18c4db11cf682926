// route_pass: the row -> leaf update of level_pass, with no histogram, as
// two kernels on one stream.
//
// Replaces: the Pallas kernel _route_kernel (lightgbm_tpu/ops/fused_level.py
// :575, launched by route_pass :604), used for the pass whose histograms
// could never be consumed (the leaf budget is spent, or no pass follows),
// in its padded and packed (tpu_adaptive_bins) variants: a null ktab routes
// over slabs at f * B, else over each kernel row's offset and width. It
// never masks a feature (the TPU kernel builds its one-hot unmasked).
//
// Bound on the H100: bytes. Per row it reads the leaf and writes the new
// leaf; a row in a selected leaf also reads the one bin its slot's W row
// routes on (as the grower builds W) — about 9 B a row; one compare per
// routed row is all the arithmetic.
//
// Design: 1. the slab table (level_slabs_kernel through launch_slabs, on
// route_pass's own W and layout): one block per slot finds the one kernel
// row whose slab of the slot's W row is non-zero. 2. route_pass_kernel:
// each thread takes four consecutive rows, reading their leaves with one
// 16-byte load and writing the new leaves with one 16-byte store (scalar
// where Rp or the pointers do not allow it), slot tables and slab table in
// shared memory; a routed row reads one bin and one W entry (slab_left): a
// W row over several slabs takes the full sum, an all-zero one sends the
// row right, so any 0/1 W routes as the full sum does. Rows in no selected
// leaf copy their leaf through. The slot of a row's leaf comes from an
// open-addressing hash of the active slots' leaves in shared memory (about
// two probes), not a scan of all Sp slots, whose cost grew with Sp (PERF.md).
// The grid is as many blocks as fit on the card, striding over the row
// quads, so each block stages its tables once.
#include "fused_level.cuh"

namespace lgbt {

constexpr int kRouteBlocksPerSm = 8;
// the bits lgbt_route_pass reports, one per kernel it launched
constexpr int kRouteSlabsBit = 1, kRouteBit = 2;

template <typename BinT>
__global__ void __launch_bounds__(kThreads)
route_pass_kernel(const BinT* __restrict__ bins,
                  const int* __restrict__ leaf,
                  const __nv_bfloat16* __restrict__ W,
                  const int* __restrict__ tbl,
                  const int* __restrict__ slab_of, RowLayout lay,
                  int* __restrict__ new_leaf, int64_t Rp, int K, int64_t FB,
                  int Sp, bool vec) {
  __shared__ SlotTables t;
  __shared__ SlotHash hash;
  __shared__ int s_slab[kMaxSlots];
  for (int k = threadIdx.x; k < Sp; k += blockDim.x) s_slab[k] = slab_of[k];
  load_tables(t, tbl, Sp);   // ends in __syncthreads()
  build_slot_hash(hash, t, Sp);
  const int64_t quads = (Rp + 3) / 4;
  const int64_t full = vec ? Rp / 4 : 0;   // quads moved as one int4
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       q < quads; q += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r0 = 4 * q;
    int lf[4];
    if (q < full) {
      const int4 v = reinterpret_cast<const int4*>(leaf)[q];
      lf[0] = v.x; lf[1] = v.y; lf[2] = v.z; lf[3] = v.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) lf[u] = r0 + u < Rp ? leaf[r0 + u] : -1;
    }
    int out[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      out[u] = lf[u];
      const int k = hash_slot(hash, lf[u]);
      if (k >= 0 && r0 + u < Rp &&
          !slab_left(bins, Rp, r0 + u, W + k * FB, s_slab[k], K, lay)) {
        out[u] += t.delta[k];
      }
    }
    if (q < full) {
      reinterpret_cast<int4*>(new_leaf)[q] =
          make_int4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (r0 + u < Rp) new_leaf[r0 + u] = out[u];
      }
    }
  }
}

template <typename BinT>
cudaError_t launch_route(const void* bins, const void* leaf, const void* W,
                         const void* tbl, int* slab_of, const RowLayout& lay,
                         void* new_leaf, long long Rp, int K, long long FB,
                         int Sp, cudaStream_t stream, int* launched) {
  const __nv_bfloat16* Wb = static_cast<const __nv_bfloat16*>(W);
  cudaError_t e = launch_slabs(Wb, lay, slab_of, K, FB, Sp, stream);
  if (e != cudaSuccess) return e;
  *launched |= kRouteSlabsBit;
  int dev = 0, sms = 0, optin = 0;
  if ((e = device_limits(&dev, &sms, &optin)) != cudaSuccess) return e;
  const long long quads = (Rp + 3) / 4;
  long long grid = (quads + kThreads - 1) / kThreads;
  const long long fit = static_cast<long long>(sms) * kRouteBlocksPerSm;
  if (grid > fit) grid = fit;
  if (grid < 1) grid = 1;
  const bool vec = reinterpret_cast<uintptr_t>(leaf) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(new_leaf) % 16 == 0;
  route_pass_kernel<BinT><<<static_cast<unsigned>(grid), kThreads, 0,
                            stream>>>(
      static_cast<const BinT*>(bins), static_cast<const int*>(leaf), Wb,
      static_cast<const int*>(tbl), slab_of, lay,
      static_cast<int*>(new_leaf), Rp, K, FB, Sp, vec);
  e = cudaGetLastError();
  if (e == cudaSuccess) *launched |= kRouteBit;
  return e;
}

}  // namespace lgbt

// ktab ([2, K] int32: offsets, then widths) may be null (padded layout);
// slab_of is [Sp] int32 scratch. *launched gets one bit for each kernel
// launched, in the order slab table, route (1, 2), also when a later
// launch fails.
extern "C" int lgbt_route_pass(const void* bins, int bin_bytes,
                               const void* leaf, const void* W,
                               const void* tbl, const void* ktab,
                               void* slab_of, void* new_leaf, long long Rp,
                               int K, int B, long long FB, int Sp,
                               void* stream, int* launched) {
  const int* kt = static_cast<const int*>(ktab);
  const lgbt::RowLayout lay{kt, kt == nullptr ? nullptr : kt + K, nullptr,
                            B};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* so = static_cast<int*>(slab_of);
  *launched = 0;
  const cudaError_t e =
      bin_bytes == 1
          ? lgbt::launch_route<int8_t>(bins, leaf, W, tbl, so, lay, new_leaf,
                                       Rp, K, FB, Sp, s, launched)
          : lgbt::launch_route<int16_t>(bins, leaf, W, tbl, so, lay,
                                        new_leaf, Rp, K, FB, Sp, s, launched);
  return static_cast<int>(e);
}
