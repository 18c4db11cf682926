// hist_pass: the slot-keyed histogram of the frontier-v1 engine. For every
// row r with slot s = row_slot[r] in [0, Sp), every feature f < Fp and every
// channel c < nch:
//
//     out[c, s, f, bins[r, f]] += v[r, c]
//
// f32 variant: v = the bf16 rounding (to nearest even) of gh[r, c], summed
// in f32, as the TPU kernel's bf16 one-hot matmul takes it. quant variant:
// v = the int8 channel gh[r, c] (ops/quantize.py encode_channels), summed
// in int32 — integer atomics are exact and order-free, so this variant
// equals its plain version bit for bit. Rows with slot -1 (or >= Sp) add
// nothing whatever their gh; bins outside [0, Bp) add nothing.
//
// Replaces: the Pallas kernel _hist_kernel (lightgbm_tpu/ops/
// pallas_histogram.py:60, launched by _run_hist_kernel :103). Layouts are
// the contract's: bins [R, Fp] int32 row-major, row_slot [R] int32, gh
// [R, nch] f32 or int8, out [nch, Sp, Fp, Bp] f32 or int32, zeroed by the
// caller. Any R: the TPU's 512-row tile padding is not carried over.
//
// Bound on the H100: bytes. Per row it reads Fp int32 bins, nch channels
// and the slot (128 B at Fp=28, nch=3 f32), and it writes the output once
// (1.4 MB at Sp=64, Fp=28, Bp=64, nch=3); the arithmetic is Fp*nch adds
// per slotted row.
//
// Design: the TPU kernel contracts a [rows, Sp] slot one-hot against a
// [rows, Fp*Bp] bin one-hot on the MXU over a sequential grid. Here a grid
// of (blocks per group) x (feature groups), as many blocks as fit on the
// card at once, walks the rows with one thread per row. Each block keeps a
// private [nch, Sp, G, Bp] histogram of its group of G features in shared
// memory — G as large as a block's shared memory allows, the groups
// balanced (at Sp=64, Bp=64, nch=3 one feature's slab is 48 KB, so 7
// groups of 4; at Sp=8 all 28 features fit in one) — adds with
// shared-memory atomics, and flushes its non-zero entries with one global
// atomic each. Where even one feature's slab exceeds shared memory (Sp=64,
// Bp=256, nch=5 is 320 KB) every add goes straight to global memory.
// Unslotted rows are skipped after reading their slot alone, before their
// bins or channels (on deep levels at least half the rows), and rows whose
// channels are all zero (out of the bag) add nothing. f32 atomics make the
// order of the sums, and so their last bits, vary from run to run; the
// weight channel counts rows exactly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lgbt {

constexpr int kHistThreads = 1024;
constexpr int kHistMaxChannels = 8;

__device__ inline float load_channel(const float* __restrict__ gh,
                                     int64_t i) {
  return __bfloat162float(__float2bfloat16_rn(gh[i]));
}

__device__ inline int load_channel(const int8_t* __restrict__ gh,
                                   int64_t i) {
  return static_cast<int>(gh[i]);
}

template <typename ValT, typename AccT, bool kShared>
__global__ void __launch_bounds__(kHistThreads, 1)
hist_pass_kernel(const int* __restrict__ bins, const ValT* __restrict__ gh,
                 const int* __restrict__ slot, AccT* __restrict__ out,
                 int64_t R, int Fp, int Bp, int Sp, int nch, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AccT* s_hist = reinterpret_cast<AccT*>(smem_raw);   // [nch, Sp, G, Bp]
  const int f0 = blockIdx.y * G;
  const int gn = min(G, Fp - f0);
  const int s_len = kShared ? nch * Sp * G * Bp : 0;
  for (int i = threadIdx.x; i < s_len; i += blockDim.x) s_hist[i] = AccT(0);
  if (kShared) __syncthreads();

  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < R; r += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int s = slot[r];
    if (s < 0 || s >= Sp) continue;
    AccT v[kHistMaxChannels];
    bool any = false;
#pragma unroll
    for (int c = 0; c < kHistMaxChannels; ++c) {
      v[c] = c < nch ? load_channel(gh, r * nch + c) : AccT(0);
      any = any || v[c] != AccT(0);
    }
    if (!any) continue;
    const int* row = bins + r * Fp + f0;
    for (int j = 0; j < gn; ++j) {
      const int b = row[j];
      if (b < 0 || b >= Bp) continue;
#pragma unroll
      for (int c = 0; c < kHistMaxChannels; ++c) {
        if (c < nch && v[c] != AccT(0)) {
          if (kShared) {
            atomicAdd(s_hist + ((c * Sp + s) * G + j) * Bp + b, v[c]);
          } else {
            atomicAdd(out + (static_cast<int64_t>(c * Sp + s) * Fp + f0 + j)
                                * Bp + b,
                      v[c]);
          }
        }
      }
    }
  }

  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < s_len; i += blockDim.x) {
      const AccT x = s_hist[i];
      if (x == AccT(0)) continue;
      const int b = i % Bp;
      const int t = i / Bp;
      const int j = t % G;
      const int cs = t / G;             // c * Sp + s
      if (j < gn) {
        atomicAdd(out + (static_cast<int64_t>(cs) * Fp + f0 + j) * Bp + b,
                  x);
      }
    }
  }
}

template <typename ValT, typename AccT>
int launch_hist(const void* bins, const void* gh, const void* slot,
                void* out, long long R, int Fp, int Bp, int Sp, int nch,
                cudaStream_t stream) {
  int dev = 0;
  int sms = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // the largest feature group whose histogram fits, then groups balanced
  const size_t per_feature =
      static_cast<size_t>(nch) * Sp * Bp * sizeof(AccT);
  const int g_max = static_cast<int>(
      per_feature > 0 ? static_cast<size_t>(optin) / per_feature : 0);
  const bool shared = g_max >= 1;
  int groups = 1;
  int G = Fp;
  size_t smem = 0;
  if (shared) {
    const int g = g_max < Fp ? g_max : Fp;
    groups = (Fp + g - 1) / g;
    G = (Fp + groups - 1) / groups;
    smem = per_feature * G;
  }
  auto kern = shared ? hist_pass_kernel<ValT, AccT, true>
                     : hist_pass_kernel<ValT, AccT, false>;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kHistThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long per_group = static_cast<long long>(per_sm) * sms / groups;
  const long long tiles = (R + kHistThreads - 1) / kHistThreads;
  if (tiles < per_group) per_group = tiles;
  if (per_group < 1) per_group = 1;
  const dim3 grid(static_cast<unsigned>(per_group),
                  static_cast<unsigned>(groups));
  kern<<<grid, kHistThreads, smem, stream>>>(
      static_cast<const int*>(bins), static_cast<const ValT*>(gh),
      static_cast<const int*>(slot), static_cast<AccT*>(out), R, Fp, Bp, Sp,
      nch, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lgbt

// out must be zeroed by the caller. quant = 0: gh f32, out f32; quant = 1:
// gh int8, out int32.
extern "C" int lgbt_hist_pass(const void* bins, const void* gh,
                              const void* slot, void* out, long long R,
                              int Fp, int Bp, int Sp, int nch, int quant,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quant) {
    return lgbt::launch_hist<int8_t, int>(bins, gh, slot, out, R, Fp, Bp, Sp,
                                          nch, s);
  }
  return lgbt::launch_hist<float, float>(bins, gh, slot, out, R, Fp, Bp, Sp,
                                         nch, s);
}
