// Deterministic path walk over a batch of designs (K4): per-pair hop counts
// and wire-delay sums, f-weighted directed link utilization and f-weighted
// router visits (Eqs. 1, 2 and 8 of the objective stack).
//
// Replaces the Pallas kernel `walk_accumulate` in
// src/repro/kernels/link_util.py (and the scatter-add walk
// core/routing.walk_paths that the reference evaluator runs).
//
// Bound on the H100: latency of dependent next-hop reads, not bytes
// (B*N^2 int reads and 4 small outputs) nor operations. The reference walk
// is a scatter-add; float atomics on the card would make util and visits
// change from run to run and break the delta-on == delta-off bit-equality
// of the evaluator. So there are no float atomics. One block per design,
// one thread per slot, destinations in ascending order:
//   * thread s walks s -> d in path order, as the reference does, so hops,
//     the delay sum (path-order f32 adds) and all_done are bit-equal;
//   * the flow through u toward d is f[u,d] plus the flows of u's children
//     in d's in-tree (v with nh[v,d] == u, one hop further), added in
//     ascending v, level by level from the leaves in;
//   * thread u owns row u of util and its visit count and adds flow_d[u]
//     into util[u, nh[u,d]] and visits[u] for d ascending, then adds the
//     column sum of f (s ascending) for the destination router.
// The plain version in kernels/ref.py repeats this arithmetic in the same
// order, so the card and the CPU agree bit for bit on a connected design.

#include <cuda_runtime.h>

namespace {

__global__ void walk_kernel(const int* __restrict__ nh,
                            const float* __restrict__ f,
                            const float* __restrict__ delay, int n,
                            int max_hops, int* __restrict__ hops_out,
                            float* __restrict__ delay_out,
                            float* __restrict__ util_out,
                            float* __restrict__ visits_out,
                            int* __restrict__ done_out) {
  extern __shared__ int smem[];
  int* nh_col = smem;                                     // n
  int* hop_col = smem + n;                                // n
  float* flow = reinterpret_cast<float*>(smem + 2 * n);   // n
  __shared__ int max_level;
  __shared__ int all_done;

  const size_t mat = static_cast<size_t>(n) * n;
  const int* nhb = nh + blockIdx.x * mat;
  const float* fb = f + blockIdx.x * mat;
  int* hb = hops_out + blockIdx.x * mat;
  float* db = delay_out + blockIdx.x * mat;
  float* ub = util_out + blockIdx.x * mat;
  const int u = threadIdx.x;  // blockDim.x == n

  for (int j = 0; j < n; ++j) ub[static_cast<size_t>(u) * n + j] = 0.0f;
  if (u == 0) all_done = 1;
  float vis = 0.0f;
  int done_all = 1;

  for (int d = 0; d < n; ++d) {
    // Walk u -> d in path order.
    int cur = u, h = 0;
    float dsum = 0.0f;
    for (int t = 0; t < max_hops && cur != d; ++t) {
      const int nxt = __ldg(nhb + static_cast<size_t>(cur) * n + d);
      dsum += __ldg(delay + static_cast<size_t>(cur) * n + nxt);
      ++h;
      cur = nxt;
    }
    if (cur != d) done_all = 0;
    hb[static_cast<size_t>(u) * n + d] = h;
    db[static_cast<size_t>(u) * n + d] = dsum;
    const int parent = __ldg(nhb + static_cast<size_t>(u) * n + d);
    nh_col[u] = parent;
    hop_col[u] = h;
    flow[u] = __ldg(fb + static_cast<size_t>(u) * n + d);
    if (u == 0) max_level = 0;
    __syncthreads();
    atomicMax(&max_level, h);
    __syncthreads();

    // In-tree flows, leaves in: nodes one hop further are final when a
    // level pulls from them.
    for (int level = max_level - 1; level >= 1; --level) {
      if (h == level) {
        float acc = flow[u];
        for (int v = 0; v < n; ++v)
          if (nh_col[v] == u && hop_col[v] == level + 1) acc += flow[v];
        flow[u] = acc;
      }
      __syncthreads();
    }

    if (u != d) {
      ub[static_cast<size_t>(u) * n + parent] += flow[u];
      vis += flow[u];
    }
    __syncthreads();  // nh_col / hop_col / flow are rewritten for d + 1
  }

  // Destination router traversal: column sum of f, s ascending.
  float col = 0.0f;
  for (int s = 0; s < n; ++s) col += __ldg(fb + static_cast<size_t>(s) * n + u);
  visits_out[static_cast<size_t>(blockIdx.x) * n + u] = vis + col;

  if (!done_all) atomicAnd(&all_done, 0);
  __syncthreads();
  if (u == 0) done_out[blockIdx.x] = all_done;
}

}  // namespace

// nh: (B, n, n) i32 next hops; f: (B, n, n) f32 slot traffic; delay: (n, n)
// f32 wire delay. Outputs: hops (B, n, n) i32, delay sums (B, n, n) f32,
// util (B, n, n) f32, visits (B, n) f32, all_done (B,) i32. n <= 1024.
extern "C" int walk_launch(const int* nh, const float* f, const float* delay,
                           int batch, int n, int max_hops, int* hops,
                           float* delay_sum, float* util, float* visits,
                           int* all_done, void* stream) {
  const size_t bytes = static_cast<size_t>(3) * n * sizeof(int);
  walk_kernel<<<batch, n, bytes, static_cast<cudaStream_t>(stream)>>>(
      nh, f, delay, n, max_hops, hops, delay_sum, util, visits, all_done);
  return static_cast<int>(cudaGetLastError());
}
