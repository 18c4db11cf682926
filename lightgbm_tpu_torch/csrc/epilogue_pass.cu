// epilogue_pass: the fused boosting epilogue — the deferred final route, the
// leaf-value score update, the binary or L2 gradients from the updated
// score times the next iteration's bag weights, their bf16 channel pack,
// and the next tree's root histogram, in one pass over the rows.
//
// Replaces: the Pallas kernel _epilogue_kernel (lightgbm_tpu/ops/
// fused_level.py:641, launched by epilogue_pass :739). Same inputs and
// outputs: hist [F_oh*B, nch*8] f32 in the root level_pass layout (slot 0
// of each 8-column channel block live, slots 1-7 zero), new_score [Rp] f32
// and gh [8, Rp] bf16 in pack_gh's layout. Each histogram entry is the f32
// sum of the bf16-rounded channel values, as the TPU kernel's bf16 one-hot
// matmul takes it. The gradient arithmetic uses IEEE-rounded intrinsics so
// nvcc cannot contract it into FMAs, and expf (the file is built without
// --use_fast_math).
//
// Bound on the H100: bytes. Per row it reads F_oh bin bytes, the leaf, the
// score, two operand rows and the bag weight and writes the score and
// eight bf16 channels (about 68 B at F_oh=28 int8); the arithmetic is a
// few dozen flops plus F_oh*nch adds per row.
//
// Design: one thread per row in a grid-stride loop over as many blocks as
// fit on the card at once. The TPU kernel's one-hot matmuls, sublane leaf
// one-hot and sequential-grid accumulator are gone. Each block keeps its
// own copy of the root histogram (F_oh*B*nch f32: 35,840 B at F_oh=28,
// B=64, nch=5) and of the leaf-value table (while L <= 4096) in shared
// memory, adds every row's channels there with shared-memory atomics, and
// flushes its non-zero entries with one global atomicAdd each at the end.
// A histogram larger than a block's shared memory goes straight to global
// atomics instead. Rows whose channels are all zero (out of the bag, or
// padding) add nothing. Atomics make the order of the f32 sums, and so
// their last bits, vary from run to run; the weight channel counts rows
// exactly.
#include "fused_level.cuh"

namespace lgbt {

constexpr int kEpiThreads = 512;
constexpr int kMaxSharedLeaves = 4096;
constexpr int kKindBinary = 0;   // 1 = l2

template <typename BinT, bool kSharedHist>
__global__ void __launch_bounds__(kEpiThreads)
epilogue_pass_kernel(const BinT* __restrict__ bins,
                     const int* __restrict__ leaf,
                     const __nv_bfloat16* __restrict__ W,
                     const int* __restrict__ tbl,
                     const float* __restrict__ leaf_values, int L,
                     const float* __restrict__ score,
                     const float* __restrict__ ops,
                     const float* __restrict__ bag, float* __restrict__ hist,
                     float* __restrict__ new_score,
                     __nv_bfloat16* __restrict__ gh, int64_t Rp, int F_oh,
                     int B, int Sp, int nch, int kind, float sigmoid) {
  __shared__ SlotTables t;
  extern __shared__ float smem[];
  const int FB = F_oh * B;
  const int hist_len = kSharedHist ? nch * FB : 0;
  float* s_hist = smem;                   // [nch, FB] when kSharedHist
  float* s_lv = smem + hist_len;          // [L] while L <= kMaxSharedLeaves
  const bool lv_shared = L <= kMaxSharedLeaves;
  for (int i = threadIdx.x; i < hist_len; i += blockDim.x) s_hist[i] = 0.0f;
  if (lv_shared) {
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
      s_lv[i] = leaf_values[i];
    }
  }
  load_tables(t, tbl, Sp);   // ends in __syncthreads()
  const float* lv = lv_shared ? s_lv : leaf_values;
  const int C = nch * 8;

  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < Rp; r += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    // ---- deferred final route (an all-inactive table matches no row)
    int lf = leaf[r];
    const int k = find_slot(t, lf, Sp);
    if (k >= 0 && !goes_left(bins, Rp, r, W + static_cast<int64_t>(k) * FB,
                             F_oh, B)) {
      lf += t.delta[k];
    }
    // ---- score update; padding rows sit at -1 and add nothing
    const float s =
        __fadd_rn(score[r], (lf >= 0 && lf < L) ? lv[lf] : 0.0f);
    new_score[r] = s;

    // ---- gradients from the updated score (ref: binary_objective.hpp:
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

    // ---- pack_gh (round to nearest even; hi/lo split when nch = 5)
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
    float v[kMaxChannels];
    bool any = false;
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      gh[c * Rp + r] = ch[c];
      v[c] = __bfloat162float(ch[c]);
      any = any || (c < nch && v[c] != 0.0f);
    }
    if (!any) continue;

    // ---- root histogram: every row adds its channels at (f, bin_f)
    for (int f = 0; f < F_oh; ++f) {
      const int cell = f * B + static_cast<int>(bins[f * Rp + r]);
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) {
        if (c < nch) {
          if (kSharedHist) {
            atomicAdd(s_hist + c * FB + cell, v[c]);
          } else {
            atomicAdd(hist + static_cast<int64_t>(cell) * C + c * 8, v[c]);
          }
        }
      }
    }
  }

  if (kSharedHist) {
    __syncthreads();
    for (int i = threadIdx.x; i < hist_len; i += blockDim.x) {
      const float x = s_hist[i];
      if (x != 0.0f) {
        const int c = i / FB;
        const int cell = i - c * FB;
        atomicAdd(hist + static_cast<int64_t>(cell) * C + c * 8, x);
      }
    }
  }
}

template <typename BinT, bool kSharedHist>
int launch_epilogue(const void* bins, const void* leaf, const void* W,
                    const void* tbl, const void* leaf_values, int L,
                    const void* score, const void* ops, const void* bag,
                    void* hist, void* new_score, void* gh, long long Rp,
                    int F_oh, int B, int Sp, int nch, int kind,
                    float sigmoid, size_t smem, cudaStream_t stream) {
  auto kern = epilogue_pass_kernel<BinT, kSharedHist>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kEpiThreads, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = (Rp + kEpiThreads - 1) / kEpiThreads;
  long long grid = static_cast<long long>(per_sm) * sms;
  if (tiles < grid) grid = tiles;
  if (grid < 1) grid = 1;
  kern<<<static_cast<unsigned>(grid), kEpiThreads, smem, stream>>>(
      static_cast<const BinT*>(bins), static_cast<const int*>(leaf),
      static_cast<const __nv_bfloat16*>(W), static_cast<const int*>(tbl),
      static_cast<const float*>(leaf_values), L,
      static_cast<const float*>(score), static_cast<const float*>(ops),
      static_cast<const float*>(bag), static_cast<float*>(hist),
      static_cast<float*>(new_score), static_cast<__nv_bfloat16*>(gh), Rp,
      F_oh, B, Sp, nch, kind, sigmoid);
  return static_cast<int>(cudaGetLastError());
}

template <typename BinT>
int dispatch_epilogue(const void* bins, const void* leaf, const void* W,
                      const void* tbl, const void* leaf_values, int L,
                      const void* score, const void* ops, const void* bag,
                      void* hist, void* new_score, void* gh, long long Rp,
                      int F_oh, int B, int Sp, int nch, int kind,
                      float sigmoid, cudaStream_t stream) {
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t lv_bytes =
      L <= kMaxSharedLeaves ? static_cast<size_t>(L) * sizeof(float) : 0;
  const size_t hist_bytes =
      static_cast<size_t>(nch) * F_oh * B * sizeof(float);
  const size_t room = static_cast<size_t>(optin) - sizeof(SlotTables);
  if (hist_bytes + lv_bytes <= room) {
    return launch_epilogue<BinT, true>(
        bins, leaf, W, tbl, leaf_values, L, score, ops, bag, hist,
        new_score, gh, Rp, F_oh, B, Sp, nch, kind, sigmoid,
        hist_bytes + lv_bytes, stream);
  }
  return launch_epilogue<BinT, false>(
      bins, leaf, W, tbl, leaf_values, L, score, ops, bag, hist, new_score,
      gh, Rp, F_oh, B, Sp, nch, kind, sigmoid, lv_bytes, stream);
}

}  // namespace lgbt

// hist must be zeroed by the caller; bin_bytes is 1 (int8) or 2 (int16);
// kind 0 = binary, 1 = l2.
extern "C" int lgbt_epilogue_pass(const void* bins, int bin_bytes,
                                  const void* leaf, const void* W,
                                  const void* tbl, const void* leaf_values,
                                  int L, const void* score, const void* ops,
                                  const void* bag, void* hist,
                                  void* new_score, void* gh, long long Rp,
                                  int F_oh, int B, int Sp, int nch, int kind,
                                  float sigmoid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1) {
    return lgbt::dispatch_epilogue<int8_t>(
        bins, leaf, W, tbl, leaf_values, L, score, ops, bag, hist, new_score,
        gh, Rp, F_oh, B, Sp, nch, kind, sigmoid, s);
  }
  return lgbt::dispatch_epilogue<int16_t>(
      bins, leaf, W, tbl, leaf_values, L, score, ops, bag, hist, new_score,
      gh, Rp, F_oh, B, Sp, nch, kind, sigmoid, s);
}
