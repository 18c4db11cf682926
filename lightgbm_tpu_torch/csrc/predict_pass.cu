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
//   nodes [T, N, 4] int32 one 16-byte record per node (ops/predict.py
//        pack_records): x = split feature (bits 0-23) | default left << 24
//        | missing type << 25 | categorical << 27 (binned: the feature's
//        missing type), y = threshold (binned: the bin; raw: the bits of
//        the largest float32 <= the model's float64 threshold), z = left
//        child, w = right child; a child < 0 is ~leaf
//   lv   [T, L] float32 leaf values
//   tids [T] int32      class of each tree
//   cm   [T, N, M] uint8 categorical nodes' left sets over bins (binned,
//        M = B) or category values (raw, M = C); null when no node is
//        categorical
//   fmiss [F] int32     binned: each feature's missing bin (its default bin
//        for missing type Zero, its last bin for NaN, else -1)
//   out  [k, R] float32
//
// Bound on the H100: at a serving bucket (1,024 rows) the rows, the output
// and the part of the stack that the rows reach move in well under a
// microsecond (PERF.md row 6), so the time is latency: each tree step is a
// dependent load of a node, then of the row's value. At 1M rows it is the
// walk's instruction issue and the stack's reads.
//
// The first design gave one thread per row and walked every tree from
// per-field stacks in global memory: three dependent loads per step, and
// at 1,024 rows 8 blocks on 132 SMs. This design tiles the rows per block
// (RT = 128, 256 or 512 rows, one thread per row), and stages the block's
// row tile and a chunk of TC trees' node records and leaf values in shared
// memory (cp.async), so a tree step reads one 16-byte record and one row
// value from shared memory.
// Where the row tiles alone would not fill the card (a bucket of 1,024 rows
// is 8 tiles), the trees are split across TS blocks per row tile (grid.y):
// each block writes its trees' leaf values per row to a [T, R] scratch, and
// the last block of the row tile to finish (an int arrival count) sums every
// tree's value per row in tree order. Partial sums per split would not give
// the same bits, so none are formed. Each class's raw score is the f32 sum
// of the leaves' values in tree order, as in the plain version: registers
// for k <= kRegClasses (an unrolled predicated add), else the row's own
// column of out. No f32 atomic.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace lgbt {

constexpr int kRegClasses = 8;
constexpr float kZeroThreshold = 1e-35f;

struct TiledArgs {
  const void* enc;
  int64_t R;
  int F;
  const int4* nodes;
  const float* lv;
  const int* tids;
  const uint8_t* cm;
  const int* fmiss;
  float* out;
  float* scratch;     // [T, R] when TS > 1
  int* done;          // [row tiles] arrival counts, zero at launch (TS > 1)
  int T, N, L, M, k, max_steps;
  int RT, TS, Ts, TC;
  int rows_smem, nodes_smem;
};

// Does a row go left at the node whose record is rec (of tree t, node nd)?
// row: the row's values (int bins, or float bits), in shared or global
// memory; fm: the features' missing bins (binned).
template <bool kRaw, bool kCat>
__device__ __forceinline__ bool record_left(const int4 rec,
                                            const int* row, const int* fm,
                                            const TiledArgs& a, int t,
                                            int nd) {
  const int f = rec.x & 0xFFFFFF;
  const bool dflt = (rec.x >> 24) & 1;
  const int mt = (rec.x >> 25) & 3;
  const bool cat = kCat && ((rec.x >> 27) & 1);
  const int64_t mrow = (static_cast<int64_t>(t) * a.N + nd) * a.M;
  if (kRaw) {
    const float v = __int_as_float(row[f]);
    const bool nan = isnan(v);
    if (cat) {
      // range-checked before the cast; (-1, 0) truncates to category 0
      const bool bad = nan || v <= -1.0f || v >= static_cast<float>(a.M);
      const int iv = bad ? -1 : static_cast<int>(v);
      return iv >= 0 && __ldg(a.cm + mrow + iv) != 0;
    }
    const bool zero = fabsf(v) <= kZeroThreshold;
    const bool miss = mt == 2 ? nan : (mt == 1 ? (zero || nan) : false);
    const float ve = (nan && mt != 2) ? 0.0f : v;
    return miss ? dflt : ve <= __int_as_float(rec.y);
  }
  const int b = row[f];
  if (cat) {
    return static_cast<unsigned>(b) < static_cast<unsigned>(a.M) &&
           __ldg(a.cm + mrow + b) != 0;
  }
  const bool miss = mt != 0 && b == fm[f];
  return miss ? dflt : b <= rec.y;
}

// Asynchronous copies into shared memory (the rows and the tree chunks):
// every thread's loads in flight at once, none held in registers.
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src));
  }
}
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void add_class(float (&acc)[kRegClasses], int c,
                                          float v) {
#pragma unroll
  for (int j = 0; j < kRegClasses; ++j) {
    if (j == c) acc[j] += v;
  }
}

template <bool kRaw, bool kCat, bool kReg>
__global__ void __launch_bounds__(512)
predict_tiled_kernel(const TiledArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x;
  const int64_t r0 = static_cast<int64_t>(tile) * a.RT;
  const int64_t left_rows = a.R - r0;
  const int nrows = static_cast<int>(left_rows < a.RT ? left_rows : a.RT);
  const int t_lo = blockIdx.y * a.Ts;
  const int t_hi = min(a.T, t_lo + a.Ts);
  // shared memory: [TC * N] node records, [TC * L] leaf values (when the
  // stack's trees fit), then [RT * F] row values and [F] missing bins
  int4* snodes = reinterpret_cast<int4*>(smem);
  const int tree_nodes = a.nodes_smem ? a.TC * a.N : 0;
  float* slv = reinterpret_cast<float*>(snodes + tree_nodes);
  int* srow = reinterpret_cast<int*>(slv + (a.nodes_smem ? a.TC * a.L : 0));
  int* sfm = srow + (a.rows_smem ? a.RT * a.F : 0);
  const int* genc = static_cast<const int*>(a.enc);
  if (a.rows_smem) {
    const int64_t base = r0 * a.F;
    const int n = nrows * a.F;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      copy_async(srow + i, genc + base + i, 4);
    }
    if (!kRaw) {
      for (int f = threadIdx.x; f < a.F; f += blockDim.x) {
        copy_async(sfm + f, a.fmiss + f, 4);
      }
    }
    copy_async_wait();
  }
  const int r = threadIdx.x;
  const bool live = r < nrows;
  const int64_t row_i = r0 + r;
  const int* row = a.rows_smem ? srow + r * a.F : genc + row_i * a.F;
  const int* fm = a.rows_smem ? sfm : a.fmiss;
  const bool split = a.TS > 1;
  float acc[kRegClasses];
#pragma unroll
  for (int j = 0; j < kRegClasses; ++j) acc[j] = 0.0f;
  if (!kReg && !split && live) {
    for (int c = 0; c < a.k; ++c) a.out[c * a.R + row_i] = 0.0f;
  }
  for (int c0 = t_lo; c0 < t_hi; c0 += a.TC) {
    const int tc = min(a.TC, t_hi - c0);
    if (a.nodes_smem) {
      __syncthreads();  // the previous chunk's walks are done
      const int4* gn = a.nodes + static_cast<int64_t>(c0) * a.N;
      for (int i = threadIdx.x; i < tc * a.N; i += blockDim.x) {
        copy_async(snodes + i, gn + i, 16);
      }
      const float* gl = a.lv + static_cast<int64_t>(c0) * a.L;
      for (int i = threadIdx.x; i < tc * a.L; i += blockDim.x) {
        copy_async(slv + i, gl + i, 4);
      }
      copy_async_wait();
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < tc; ++j) {
      const int t = c0 + j;
      const int4* tn = a.nodes_smem ? snodes + j * a.N
                                    : a.nodes + static_cast<int64_t>(t) * a.N;
      const float* tl = a.nodes_smem ? slv + j * a.L
                                     : a.lv + static_cast<int64_t>(t) * a.L;
      int node = 0;
      for (int step = 0; step < a.max_steps && node >= 0; ++step) {
        const int4 rec = tn[node];
        node = record_left<kRaw, kCat>(rec, row, fm, a, t, node) ? rec.z
                                                                 : rec.w;
      }
      const float v = tl[node < 0 ? ~node : 0];
      if (split) {
        a.scratch[static_cast<int64_t>(t) * a.R + row_i] = v;
      } else if (kReg) {
        add_class(acc, __ldg(a.tids + t), v);
      } else {
        a.out[static_cast<int64_t>(__ldg(a.tids + t)) * a.R + row_i] += v;
      }
    }
  }
  if (split) {
    // the last block of this row tile to finish sums every tree's value
    // per row, in tree order
    __shared__ int s_last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      s_last = atomicAdd(a.done + tile, 1) == a.TS - 1;
    }
    __syncthreads();
    if (!s_last || !live) return;
    __threadfence();
    if (!kReg) {
      for (int c = 0; c < a.k; ++c) a.out[c * a.R + row_i] = 0.0f;
    }
#pragma unroll 16
    for (int t = 0; t < a.T; ++t) {
      const float v = __ldcg(a.scratch + static_cast<int64_t>(t) * a.R +
                             row_i);
      const int c = __ldg(a.tids + t);
      if (kReg) {
        add_class(acc, c, v);
      } else {
        a.out[static_cast<int64_t>(c) * a.R + row_i] += v;
      }
    }
  } else if (!live) {
    return;
  }
  if (kReg) {
#pragma unroll
    for (int j = 0; j < kRegClasses; ++j) {
      if (j < a.k) a.out[j * a.R + row_i] = acc[j];
    }
  }
}

size_t tiled_smem_bytes(const TiledArgs& a) {
  size_t b = 0;
  if (a.nodes_smem) b += static_cast<size_t>(a.TC) * (16 * a.N + 4 * a.L);
  if (a.rows_smem) b += static_cast<size_t>(a.RT) * a.F * 4 + 4 * a.F;
  return b;
}

constexpr int kMaxDevices = 64;

template <bool kRaw, bool kCat, bool kReg>
cudaError_t launch_tiled(const TiledArgs& a, cudaStream_t stream) {
  auto kern = predict_tiled_kernel<kRaw, kCat, kReg>;
  const size_t smem = tiled_smem_bytes(a);
  // opt in to the shared memory once per device and size
  static int opted[kMaxDevices] = {};
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> hold(lock);
    if (opted[dev] < static_cast<int>(smem)) {
      err = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      opted[dev] = static_cast<int>(smem);
    }
  }
  const dim3 grid(static_cast<unsigned>((a.R + a.RT - 1) / a.RT),
                  static_cast<unsigned>(a.TS));
  kern<<<grid, a.RT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kRaw, bool kCat>
cudaError_t launch_tiled_k(const TiledArgs& a, cudaStream_t stream) {
  return a.k <= kRegClasses ? launch_tiled<kRaw, kCat, true>(a, stream)
                            : launch_tiled<kRaw, kCat, false>(a, stream);
}

}  // namespace lgbt

// One launch (header). RT rows per block (one thread each, at most
// 512), TS tree splits per row tile of Ts trees each, TC trees per shared-
// memory chunk; rows_smem / nodes_smem stage the rows / the trees in shared
// memory. scratch [T, R] and done [row tiles] (zeroed) when TS > 1.
extern "C" int lgbt_predict_pass(
    const void* enc, int raw, long long R, int F, int T, int N, int L, int M,
    int k, int max_steps, const void* nodes, const void* lv,
    const void* tids, const void* cm, const void* fmiss, void* out,
    void* scratch, void* done, int RT, int TS, int Ts, int TC,
    int rows_smem, int nodes_smem, void* stream) {
  if (R <= 0) return 0;
  if (RT < 32 || RT > 512 || TS < 1 || Ts < 1 || TC < 1 ||
      (TS > 1 && (scratch == nullptr || done == nullptr)) ||
      (!raw && fmiss == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lgbt::TiledArgs a;
  a.enc = enc;
  a.R = R;
  a.F = F;
  a.nodes = static_cast<const int4*>(nodes);
  a.lv = static_cast<const float*>(lv);
  a.tids = static_cast<const int*>(tids);
  a.cm = static_cast<const uint8_t*>(cm);
  a.fmiss = static_cast<const int*>(fmiss);
  a.out = static_cast<float*>(out);
  a.scratch = static_cast<float*>(scratch);
  a.done = static_cast<int*>(done);
  a.T = T;
  a.N = N;
  a.L = L;
  a.M = M;
  a.k = k;
  a.max_steps = max_steps;
  a.RT = RT;
  a.TS = TS;
  a.Ts = Ts;
  a.TC = TC;
  a.rows_smem = rows_smem;
  a.nodes_smem = nodes_smem;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cat = cm != nullptr;
  cudaError_t err;
  if (raw) {
    err = cat ? lgbt::launch_tiled_k<true, true>(a, st)
              : lgbt::launch_tiled_k<true, false>(a, st);
  } else {
    err = cat ? lgbt::launch_tiled_k<false, true>(a, st)
              : lgbt::launch_tiled_k<false, false>(a, st);
  }
  return static_cast<int>(err);
}
