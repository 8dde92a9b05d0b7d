// Regression-forest traversal (K2) and the fused meta-search scoring tail
// (K3): normalize -> traverse -> tree mean -> (max, first argmax).
//
// K2 replaces the Pallas kernel `forest_predict` in
// src/repro/kernels/forest.py; K3 replaces `score_block_max` in
// src/repro/kernels/stage_fused.py.
//
// Bound on the H100: neither bytes nor operations, but the latency of
// `depth` dependent gathers per (tree, sample) pair. A 24-tree depth-9
// forest's node arrays are about 0.5 MiB, more than one block's shared
// memory, so the TPU layout (every tree resident in fast memory) does not
// carry over. The nodes are read through the read-only cache (__ldg) and
// stay in L2; parallelism comes from one thread per (tree, sample) pair,
// and a block stages its samples' feature rows in shared memory.
//
// The tree mean is taken in a fixed order (trees ascending, f32), so the
// result does not depend on the launch shape. K3 reduces each block to its
// (max, first argmax) and a second one-block pass folds the per-block
// partials in block order with a strict '>', keeping np.argmax's first-max
// tie-break. Rows at or beyond n_real are -inf and can never win.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kSamples = 32;   // samples per block
constexpr int kThreads = 256;

// Leaf index reached by sample row `x` in tree `t`. child is interleaved
// per tree: child[t*2M + 2*i] = left, [.. + 1] = right, tree-local indices;
// leaves self-loop so every pair advances exactly `depth` levels.
__device__ __forceinline__ int traverse(const float* __restrict__ thr,
                                        const int* __restrict__ feat,
                                        const int* __restrict__ child,
                                        const float* x, int t, int m,
                                        int depth) {
  const float* tthr = thr + static_cast<size_t>(t) * m;
  const int* tfeat = feat + static_cast<size_t>(t) * m;
  const int* tchild = child + static_cast<size_t>(t) * 2 * m;
  int idx = 0;
  for (int l = 0; l < depth; ++l) {
    const float xv = x[__ldg(tfeat + idx)];
    const int right = xv > __ldg(tthr + idx) ? 1 : 0;
    idx = __ldg(tchild + 2 * idx + right);
  }
  return idx;
}

// Per block: kSamples rows. Shared memory: kSamples*F staged features, then
// T*kSamples leaf values. Writes the (f32, trees-ascending) tree mean of
// each row to `mean_out[row]`, or, when `norm` is set, normalizes features
// first: (x - xm) / xs.
__device__ void block_tree_means(const float* __restrict__ thr,
                                 const int* __restrict__ feat,
                                 const int* __restrict__ child,
                                 const float* __restrict__ value,
                                 const float* __restrict__ x,
                                 const float* __restrict__ xm,
                                 const float* __restrict__ xs, int rows,
                                 int t_count, int m, int f, int depth,
                                 float* smem, float* means) {
  float* xsh = smem;                    // kSamples * f
  float* vals = smem + kSamples * f;    // t_count * kSamples
  const int row0 = blockIdx.x * kSamples;
  for (int e = threadIdx.x; e < kSamples * f; e += blockDim.x) {
    const int s = e / f, c = e % f;
    const int r = row0 + s;
    float v = 0.0f;
    if (r < rows) {
      v = x[static_cast<size_t>(r) * f + c];
      if (xm != nullptr) v = (v - xm[c]) / xs[c];
    }
    xsh[e] = v;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < t_count * kSamples; p += blockDim.x) {
    const int t = p / kSamples, s = p % kSamples;
    float v = 0.0f;
    if (row0 + s < rows) {
      const int leaf = traverse(thr, feat, child, xsh + s * f, t, m, depth);
      v = __ldg(value + static_cast<size_t>(t) * m + leaf);
    }
    vals[p] = v;
  }
  __syncthreads();
  if (threadIdx.x < kSamples) {
    float acc = 0.0f;
    for (int t = 0; t < t_count; ++t) acc += vals[t * kSamples + threadIdx.x];
    means[threadIdx.x] = acc / static_cast<float>(t_count);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
forest_predict_kernel(const float* __restrict__ thr,
                      const int* __restrict__ feat,
                      const int* __restrict__ child,
                      const float* __restrict__ value,
                      const float* __restrict__ x, float* __restrict__ out,
                      int rows, int t_count, int m, int f, int depth) {
  extern __shared__ float smem[];
  __shared__ float means[kSamples];
  block_tree_means(thr, feat, child, value, x, nullptr, nullptr, rows,
                   t_count, m, f, depth, smem, means);
  const int r = blockIdx.x * kSamples + threadIdx.x;
  if (threadIdx.x < kSamples && r < rows) out[r] = means[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads)
score_block_kernel(const float* __restrict__ thr, const int* __restrict__ feat,
                   const int* __restrict__ child,
                   const float* __restrict__ value,
                   const float* __restrict__ xm, const float* __restrict__ xs,
                   const float* __restrict__ x, int rows, int n_real,
                   int t_count, int m, int f, int depth,
                   float* __restrict__ part_val, int* __restrict__ part_arg) {
  extern __shared__ float smem[];
  __shared__ float means[kSamples];
  block_tree_means(thr, feat, child, value, x, xm, xs, rows, t_count, m, f,
                   depth, smem, means);
  if (threadIdx.x == 0) {
    const int row0 = blockIdx.x * kSamples;
    float best = -INFINITY;
    int arg = row0;
    for (int s = 0; s < kSamples; ++s) {
      const int r = row0 + s;
      const float v = (r < n_real && r < rows) ? means[s] : -INFINITY;
      if (v > best) {
        best = v;
        arg = r;
      }
    }
    part_val[blockIdx.x] = best;
    part_arg[blockIdx.x] = arg;
  }
}

__global__ void score_fold_kernel(const float* __restrict__ part_val,
                                  const int* __restrict__ part_arg,
                                  int n_blocks, float* __restrict__ out_val,
                                  int* __restrict__ out_arg) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  float best = -INFINITY;
  int arg = 0;
  for (int i = 0; i < n_blocks; ++i) {
    if (part_val[i] > best) {
      best = part_val[i];
      arg = part_arg[i];
    }
  }
  out_val[0] = best;
  out_arg[0] = arg;
}

size_t smem_bytes(int t_count, int f) {
  return static_cast<size_t>(kSamples) * (f + t_count) * sizeof(float);
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int forest_blocks(int rows) {
  return (rows + kSamples - 1) / kSamples;
}

// thr, value: (T, M) f32; feat: (T, M) i32 (leaf features clamped to 0);
// child: (T, 2M) i32; x: (rows, F) f32 already normalized; out: (rows,) f32.
extern "C" int forest_predict_launch(const float* thr, const int* feat,
                                     const int* child, const float* value,
                                     const float* x, float* out, int rows,
                                     int t_count, int m, int f, int depth,
                                     void* stream) {
  const size_t bytes = smem_bytes(t_count, f);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(forest_predict_kernel), bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  forest_predict_kernel<<<forest_blocks(rows), kThreads, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      thr, feat, child, value, x, out, rows, t_count, m, f, depth);
  return static_cast<int>(cudaGetLastError());
}

// As forest_predict_launch, with raw features x normalized in the kernel by
// xm/xs (F,), rows >= n_real masked to -inf, and the (max, first argmax)
// written to out_val[0] / out_arg[0]. part_val/part_arg hold
// forest_blocks(rows) per-block partials.
extern "C" int score_block_max_launch(const float* thr, const int* feat,
                                      const int* child, const float* value,
                                      const float* xm, const float* xs,
                                      const float* x, int rows, int n_real,
                                      int t_count, int m, int f, int depth,
                                      float* part_val, int* part_arg,
                                      float* out_val, int* out_arg,
                                      void* stream) {
  const size_t bytes = smem_bytes(t_count, f);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(score_block_kernel), bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = forest_blocks(rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  score_block_kernel<<<blocks, kThreads, bytes, s>>>(
      thr, feat, child, value, xm, xs, x, rows, n_real, t_count, m, f, depth,
      part_val, part_arg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  score_fold_kernel<<<1, 32, 0, s>>>(part_val, part_arg, blocks, out_val,
                                     out_arg);
  return static_cast<int>(cudaGetLastError());
}
