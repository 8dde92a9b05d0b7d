// Regression-forest traversal (K2) and the fused meta-search scoring tail
// (K3): normalize -> traverse -> tree mean -> (max, first argmax).
//
// K2 replaces the Pallas kernel `forest_predict` in
// src/repro/kernels/forest.py; K3 replaces `score_block_max` in
// src/repro/kernels/stage_fused.py.
//
// Bound on the H100: neither bytes nor operations, but latency: `depth`
// dependent node reads per (tree, row) pair at batches of 1 to 48 rows.
// The design shortens that chain and keeps it out of L2:
//   * one 16-byte record per node (threshold bits, feature clamped to 0 at
//     leaves, left, right), packed once per fitted forest by
//     kernels/ops.py::pack_forest, so a level is one 128-bit load and one
//     shared-memory read of the row's feature;
//   * a thread-block cluster of up to 8 CTAs per block of rows splits the
//     trees (CTA r takes trees [r*T/C, (r+1)*T/C)). Each CTA copies its
//     trees' records and leaf values into shared memory (cp.async) and
//     walks every row of the block for those trees there. A forest whose
//     slice does not fit (the wrapper decides from the shape: the "l2"
//     route) reads its records through L2 instead;
//   * each leaf value goes to the leader CTA (rank 0) through distributed
//     shared memory; the leader sums trees ascending in f32 and divides by
//     T, the order of ref._tree_mean, so the bits do not depend on the
//     split;
//   * K3 is one launch, over the first n_real rows only (later rows are
//     -inf and never win): the leader reduces its block to (max, first
//     argmax); with more than one cluster, the last leader to finish folds
//     the per-cluster partials in cluster order with a strict '>' and
//     resets the counter it counted on, so np.argmax's first max is kept
//     and the next launch on the stream starts from zero. Launches that
//     share a scratch counter must be ordered (one stream).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

struct Params {
  const int4* rec;      // (T, M) node records
  const float* value;   // (T, M) leaf values, M a multiple of 4
  const float* x;       // (>= rows, f) features
  const float* xm;      // (f,) K3 only: x is normalized as (x - xm) / xs
  const float* xs;
  float* out;           // K2: (rows,) tree means; K3: the max value
  int* out_arg;         // K3: its first argmax
  int* ws;              // K3 with > 1 cluster: counter, partial values, args
  int rows;             // K2: rows; K3: n_real
  int t_count, m, f, depth, cluster, block_rows;
};

__host__ __device__ inline int x_stride(int f) { return f | 1; }
__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

template <bool kScore, bool kSmem>
__device__ __forceinline__ void forest_cluster(const Params& p) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive();  // this CTA runs: its shared memory may be written
  const int c = p.cluster, t_count = p.t_count, m = p.m;
  const int rb = p.block_rows, xst = x_stride(p.f);
  const int rank = static_cast<int>(cluster.block_rank());
  const int blk = blockIdx.x / c;
  const int row0 = blk * rb;
  const int nrows = min(rb, p.rows - row0);
  const int t0 = rank * t_count / c;
  const int nt = (rank + 1) * t_count / c - t0;
  const int slice = (t_count + c - 1) / c;

  // Shared memory: [records | values] of the slice (smem route), the
  // block's feature rows (odd stride: rows reading one feature hit
  // distinct banks), then the leader's (T, rows) leaf values.
  extern __shared__ __align__(16) unsigned char smem[];
  int4* srec = reinterpret_cast<int4*>(smem);
  float* sval = reinterpret_cast<float*>(srec + (kSmem ? slice * m : 0));
  float* xsh = sval + (kSmem ? slice * m : 0);
  float* vals = xsh + round4(rb * xst);

  if (kSmem) {
    const int4* grec = p.rec + static_cast<size_t>(t0) * m;
    for (int i = threadIdx.x; i < nt * m; i += blockDim.x)
      cp_async16(srec + i, grec + i);
    const int4* gval =
        reinterpret_cast<const int4*>(p.value + static_cast<size_t>(t0) * m);
    int4* sval4 = reinterpret_cast<int4*>(sval);
    for (int i = threadIdx.x; i < nt * m / 4; i += blockDim.x)
      cp_async16(sval4 + i, gval + i);
  }
  for (int e = threadIdx.x; e < nrows * p.f; e += blockDim.x) {
    const int s = e / p.f, col = e - s * p.f;
    float v = p.x[static_cast<size_t>(row0 + s) * p.f + col];
    if (kScore) v = (v - p.xm[col]) / p.xs[col];
    xsh[s * xst + col] = v;
  }
  if (kSmem) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  cluster_wait();  // every CTA of the cluster runs

  float* lead = cluster.map_shared_rank(vals, 0);
  for (int q = threadIdx.x; q < nt * nrows; q += blockDim.x) {
    const int tl = q / nrows, s = q - tl * nrows;
    const float* xr = xsh + s * xst;
    int idx = 0;
    float v;
    if (kSmem) {
      const int4* tr = srec + tl * m;
      for (int l = 0; l < p.depth; ++l) {
        const int4 r = tr[idx];
        idx = xr[r.y] > __int_as_float(r.x) ? r.w : r.z;
      }
      v = sval[tl * m + idx];
    } else {
      const size_t base = static_cast<size_t>(t0 + tl) * m;
      const int4* tr = p.rec + base;
      for (int l = 0; l < p.depth; ++l) {
        const int4 r = __ldg(tr + idx);
        idx = xr[r.y] > __int_as_float(r.x) ? r.w : r.z;
      }
      v = __ldg(p.value + base + idx);
    }
    lead[(t0 + tl) * rb + s] = v;
  }
  cluster.sync();  // the leader holds every tree's leaf values
  if (rank != 0) return;

  const float tf = static_cast<float>(t_count);
  for (int s = threadIdx.x; s < nrows; s += blockDim.x) {
    float acc = 0.0f;
    for (int t = 0; t < t_count; ++t) acc += vals[t * rb + s];
    // Column s is read and written by this thread alone.
    if (kScore) vals[s] = acc / tf;
    else p.out[row0 + s] = acc / tf;
  }
  if (!kScore) return;
  __syncthreads();
  if (threadIdx.x >= 32) return;
  // First max: each lane scans its rows ascending with a strict '>', then
  // the lanes fold, a tie going to the lower row.
  const int lane = threadIdx.x;
  float best = -INFINITY;
  int arg = 0x7fffffff;
  if (lane < nrows) {
    best = vals[lane];
    arg = row0 + lane;
  }
  for (int s = lane + 32; s < nrows; s += 32) {
    if (vals[s] > best) {
      best = vals[s];
      arg = row0 + s;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oa = __shfl_down_sync(0xffffffffu, arg, off);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  if (lane != 0) return;
  const int n_clusters = gridDim.x / c;
  if (n_clusters == 1) {
    p.out[0] = best;
    p.out_arg[0] = arg;
    return;
  }
  float* part_val = reinterpret_cast<float*>(p.ws + 1);
  int* part_arg = p.ws + 1 + n_clusters;
  part_val[blk] = best;
  part_arg[blk] = arg;
  __threadfence();
  if (atomicAdd(p.ws, 1) != n_clusters - 1) return;
  __threadfence();
  best = __ldcg(part_val);
  arg = __ldcg(part_arg);
  for (int i = 1; i < n_clusters; ++i) {
    const float v = __ldcg(part_val + i);
    if (v > best) {
      best = v;
      arg = __ldcg(part_arg + i);
    }
  }
  p.out[0] = best;
  p.out_arg[0] = arg;
  p.ws[0] = 0;
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
forest_predict_cluster_kernel(const Params p) {
  forest_cluster<false, kSmem>(p);
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
score_block_max_cluster_kernel(const Params p) {
  forest_cluster<true, kSmem>(p);
}

size_t smem_bytes(const Params& p, bool smem_route) {
  const int slice = (p.t_count + p.cluster - 1) / p.cluster;
  const size_t nodes = smem_route ? static_cast<size_t>(slice) * p.m * 20 : 0;
  return nodes + (static_cast<size_t>(round4(p.block_rows * x_stride(p.f))) +
                  static_cast<size_t>(p.t_count) * p.block_rows) *
                     sizeof(float);
}

int launch(void (*kernel)(const Params), const Params& p, size_t smem,
           void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_clusters = (p.rows + p.block_rows - 1) / p.block_rows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_clusters * p.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, p));
}

}  // namespace

// rec: (T, M, 4) i32 packed records; value: (T, M) f32; x: (rows, F) f32
// already normalized; out: (rows,) f32. cluster: CTAs per cluster, 1 to 8,
// the trees split among them as evenly as they go (ops.tree_slice);
// block_rows rows per cluster; smem_route 1 keeps each CTA's records in
// shared memory, 0 reads them through L2.
extern "C" int forest_predict_launch(const void* rec, const float* value,
                                     const float* x, float* out, int rows,
                                     int t_count, int m, int f, int depth,
                                     int cluster, int block_rows,
                                     int smem_route, void* stream) {
  Params p = {};
  p.rec = static_cast<const int4*>(rec);
  p.value = value;
  p.x = x;
  p.out = out;
  p.rows = rows;
  p.t_count = t_count;
  p.m = m;
  p.f = f;
  p.depth = depth;
  p.cluster = cluster;
  p.block_rows = block_rows;
  const size_t smem = smem_bytes(p, smem_route != 0);
  return smem_route ? launch(forest_predict_cluster_kernel<true>, p, smem,
                             stream)
                    : launch(forest_predict_cluster_kernel<false>, p, smem,
                             stream);
}

// As forest_predict_launch, over the first n_real rows of raw features x,
// normalized in the kernel by xm/xs (F,); writes the (max, first argmax)
// to out_val[0] / out_arg[0]. ws: 1 + 2 * ceil(n_real / block_rows) i32,
// zero in its first entry, which every launch leaves at zero.
extern "C" int score_block_max_launch(const void* rec, const float* value,
                                      const float* xm, const float* xs,
                                      const float* x, int n_real, int t_count,
                                      int m, int f, int depth, int cluster,
                                      int block_rows, int smem_route, int* ws,
                                      float* out_val, int* out_arg,
                                      void* stream) {
  Params p = {};
  p.rec = static_cast<const int4*>(rec);
  p.value = value;
  p.x = x;
  p.xm = xm;
  p.xs = xs;
  p.out = out_val;
  p.out_arg = out_arg;
  p.ws = ws;
  p.rows = n_real;
  p.t_count = t_count;
  p.m = m;
  p.f = f;
  p.depth = depth;
  p.cluster = cluster;
  p.block_rows = block_rows;
  const size_t smem = smem_bytes(p, smem_route != 0);
  return smem_route ? launch(score_block_max_cluster_kernel<true>, p, smem,
                             stream)
                    : launch(score_block_max_cluster_kernel<false>, p, smem,
                             stream);
}
