// predict_pass: every row through every tree of a packed tree stack, the
// leaf values summed per class in float32.
//
// Replaces: no Pallas kernel. The JAX package computes the stacked
// traversal in plain XLA: _run_binned_body and _run_raw_body
// (lightgbm_tpu/models/predictor.py:69, :93), a lax.scan over the trees of
// route_rows_to_leaves / route_raw_rows_to_leaves (lightgbm_tpu/ops/
// predict.py:24, :76) and raw[tid] += lv[t][leaves]. Here it is one launch
// per call, where plain PyTorch takes ~8 launches per tree and step.
//
// Layouts (models/predictor.py packs them once per model):
//   enc  [R, F] int32 (binned: training bins of the used features) or
//        float32 (raw: feature values), row-major
//   sf   [T, N] int32  split feature (inner index, or raw column)
//   thr  [T, N] int32 threshold bin (binned) or float32 threshold, the
//        largest float32 <= the model's float64 threshold (raw)
//   dl   [T, N] uint8  default left
//   mt   [T, N] int32  missing type per node (raw only)
//   lc, rc [T, N] int32 children; < 0 is ~leaf
//   lv   [T, L] float32 leaf values
//   tids [T] int32      class of each tree
//   cf   [T, N] uint8, cm [T, N, M] uint8 categorical nodes and their left
//        sets over bins (binned, M = B) or category values (raw, M = C);
//        both null when no node is categorical
//   num_bin, missing, default_bin [F] int32 (binned only)
//   out  [k, R] float32
//
// Design: one thread per row walks every tree in tree order (at most
// max_steps levels each) and adds its leaf's value to the class's
// accumulator: registers for k <= kRegClasses (an unrolled predicated add
// keeps the array in registers), else the row's own column of out. No
// atomics, and the adds of each class in the plain version's order, so the
// kernel and predict_pass_plain give the same bits. Per step a thread
// issues the node's loads together (feature, threshold, children, flags),
// then the row's value, then the feature's missing bins: three dependent
// rounds, L1/L2 hits on a model of a few MB. Shared-memory tree tiles and
// tree-parallel blocks are left to a redesign.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace lgbt {

constexpr int kPredictThreads = 128;
constexpr int kRegClasses = 8;
constexpr float kZeroThreshold = 1e-35f;

struct PredictStack {
  const int* sf;
  const void* thr;
  const uint8_t* dl;
  const int* mt;
  const int* lc;
  const int* rc;
  const float* lv;
  const int* tids;
  const uint8_t* cf;
  const uint8_t* cm;
  const int* num_bin;
  const int* missing;
  const int* default_bin;
  int T, N, L, M;
};

// Does the row go left at node nd (flat index t * N + node)?
template <bool kRaw, bool kCat>
__device__ __forceinline__ bool go_left(const PredictStack& s,
                                        const void* row, int64_t nd) {
  const int f = __ldg(s.sf + nd);
  const bool dflt = __ldg(s.dl + nd) != 0;
  if (kRaw) {
    const float v = __ldg(static_cast<const float*>(row) + f);
    const bool nan = isnan(v);
    if (kCat && __ldg(s.cf + nd)) {
      // range-checked before the cast; (-1, 0) truncates to category 0
      const bool bad = nan || v <= -1.0f || v >= static_cast<float>(s.M);
      const int iv = bad ? -1 : static_cast<int>(v);
      return iv >= 0 && __ldg(s.cm + nd * s.M + iv) != 0;
    }
    const int mt = __ldg(s.mt + nd);
    const bool zero = fabsf(v) <= kZeroThreshold;
    const bool miss = mt == 2 ? nan : (mt == 1 ? (zero || nan) : false);
    const float ve = (nan && mt != 2) ? 0.0f : v;
    return miss ? dflt
                : ve <= __ldg(static_cast<const float*>(s.thr) + nd);
  }
  const int b = __ldg(static_cast<const int*>(row) + f);
  if (kCat && __ldg(s.cf + nd)) {
    return static_cast<unsigned>(b) < static_cast<unsigned>(s.M) &&
           __ldg(s.cm + nd * s.M + b) != 0;
  }
  const int fm = __ldg(s.missing + f);
  const bool miss = (fm == 1 && b == __ldg(s.default_bin + f)) ||
                    (fm == 2 && b == __ldg(s.num_bin + f) - 1);
  return miss ? dflt : b <= __ldg(static_cast<const int*>(s.thr) + nd);
}

template <bool kRaw, bool kCat, bool kReg>
__global__ void __launch_bounds__(kPredictThreads)
predict_pass_kernel(const void* __restrict__ enc, int64_t R, int F,
                    PredictStack s, int k, int max_steps,
                    float* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (r >= R) return;
  const char* row = static_cast<const char*>(enc) + r * F * 4;
  float acc[kRegClasses];
#pragma unroll
  for (int j = 0; j < kRegClasses; ++j) acc[j] = 0.0f;
  if (!kReg) {
    for (int c = 0; c < k; ++c) out[c * R + r] = 0.0f;
  }
  for (int t = 0; t < s.T; ++t) {
    const int64_t base = static_cast<int64_t>(t) * s.N;
    int node = 0;
    for (int step = 0; step < max_steps && node >= 0; ++step) {
      const int64_t nd = base + node;
      node = go_left<kRaw, kCat>(s, row, nd) ? __ldg(s.lc + nd)
                                             : __ldg(s.rc + nd);
    }
    const int leaf = node < 0 ? ~node : 0;
    const float v = __ldg(s.lv + static_cast<int64_t>(t) * s.L + leaf);
    const int c = __ldg(s.tids + t);
    if (kReg) {
#pragma unroll
      for (int j = 0; j < kRegClasses; ++j) {
        if (j == c) acc[j] += v;
      }
    } else {
      out[c * R + r] += v;
    }
  }
  if (kReg) {
#pragma unroll
    for (int j = 0; j < kRegClasses; ++j) {
      if (j < k) out[j * R + r] = acc[j];
    }
  }
}

template <bool kRaw, bool kCat>
void launch_predict(const void* enc, int64_t R, int F,
                    const PredictStack& s, int k, int max_steps, float* out,
                    cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(
      (R + kPredictThreads - 1) / kPredictThreads);
  if (k <= kRegClasses) {
    predict_pass_kernel<kRaw, kCat, true><<<grid, kPredictThreads, 0,
                                            stream>>>(enc, R, F, s, k,
                                                      max_steps, out);
  } else {
    predict_pass_kernel<kRaw, kCat, false><<<grid, kPredictThreads, 0,
                                             stream>>>(enc, R, F, s, k,
                                                       max_steps, out);
  }
}

}  // namespace lgbt

extern "C" int lgbt_predict_pass(
    const void* enc, int raw, long long R, int F, int T, int N, int L, int M,
    int k, int max_steps, const void* sf, const void* thr, const void* dl,
    const void* mt, const void* lc, const void* rc, const void* lv,
    const void* tids, const void* cf, const void* cm, const void* num_bin,
    const void* missing, const void* default_bin, void* out, void* stream) {
  if (R <= 0) return 0;
  lgbt::PredictStack s;
  s.sf = static_cast<const int*>(sf);
  s.thr = thr;
  s.dl = static_cast<const uint8_t*>(dl);
  s.mt = static_cast<const int*>(mt);
  s.lc = static_cast<const int*>(lc);
  s.rc = static_cast<const int*>(rc);
  s.lv = static_cast<const float*>(lv);
  s.tids = static_cast<const int*>(tids);
  s.cf = static_cast<const uint8_t*>(cf);
  s.cm = static_cast<const uint8_t*>(cm);
  s.num_bin = static_cast<const int*>(num_bin);
  s.missing = static_cast<const int*>(missing);
  s.default_bin = static_cast<const int*>(default_bin);
  s.T = T;
  s.N = N;
  s.L = L;
  s.M = M;
  const bool cat = cf != nullptr;
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (raw) {
    if (cat) {
      lgbt::launch_predict<true, true>(enc, R, F, s, k, max_steps, o, st);
    } else {
      lgbt::launch_predict<true, false>(enc, R, F, s, k, max_steps, o, st);
    }
  } else {
    if (cat) {
      lgbt::launch_predict<false, true>(enc, R, F, s, k, max_steps, o, st);
    } else {
      lgbt::launch_predict<false, false>(enc, R, F, s, k, max_steps, o, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
