// Deterministic path walk over a batch of designs (K4): per-pair hop counts
// and wire-delay sums, f-weighted directed link utilization and f-weighted
// router visits (Eqs. 1, 2 and 8 of the objective stack).
//
// Replaces the Pallas kernel `walk_accumulate` in
// src/repro/kernels/link_util.py (and the scatter-add walk
// core/routing.walk_paths that the reference evaluator runs).
//
// Bound on the H100: latency of dependent next-hop reads and of the
// leaves-in flow levels, not bytes (B*N^2 int reads and 4 small outputs)
// nor operations. The reference walk is a scatter-add; float atomics on the
// card would make util and visits change from run to run and break the
// delta-on == delta-off bit-equality of the evaluator. So there are no float
// atomics, and the work runs parallel over (design, destination) in two
// passes of one launch each:
//
//   pass 1, one block per (design, group of destinations), one thread per
//   (slot u, destination d) of the group; the group's columns of nh are
//   staged in shared memory by row reads:
//     * thread (u, d) walks u -> d in path order through shared memory, as
//       the reference does, so hops, the delay sum (path-order f32 adds) and
//       all_done are bit-equal;
//     * the flow through u toward d is f[u,d] plus the flows of u's children
//       in d's in-tree (v with nh[v,d] == u, one hop further), added in
//       ascending v, level by level from the leaves in. Each thread finds
//       its next sibling (the next higher v with the same parent) once, so a
//       level walks a child list instead of scanning the column;
//     * (parent, flow) of every pair goes to a (B, N, N) scratch tensor;
//   pass 2, one warp per (design, slot u): the warp reads row u of the
//   scratch 32 destinations at a time and hands them out in ascending d by
//   shuffles; the lane that owns column p of util (p mod 32) adds flow[u,d]
//   into util[u, p] (a row of shared memory) where nh[u,d] == p, and every
//   lane adds it into visits[u]; then the column sum of f (s ascending) for
//   the destination router, and util's row goes out in one coalesced
//   store.
//
// Each f32 sum runs in a fixed order that does not depend on the launch
// shape (children ascending; destinations ascending; sources ascending). The
// plain version in kernels/ref.py repeats it, so the card and the CPU agree
// bit for bit on a connected design.

#include <cuda_runtime.h>

namespace {

// Threads of a pass-1 block below N = 512 (the group of destinations is
// 512 / N wide); above it one destination of N threads.
constexpr int kPass1Threads = 512;
// Warps (slots) of a pass-2 block.
constexpr int kPass2Warps = 8;

inline int dest_group(int n) {
  const int g = n >= kPass1Threads ? 1 : kPass1Threads / n;
  return g < n ? g : n;
}

__global__ void __launch_bounds__(1024)
walk_tree_kernel(const int* __restrict__ nh, const float* __restrict__ f,
                 const float* __restrict__ delay, int n, int group,
                 int max_hops, int* __restrict__ hops_out,
                 float* __restrict__ delay_out, int2* __restrict__ tree_out,
                 int* __restrict__ done_part) {
  extern __shared__ int smem[];
  const int cells = n * group;                    // == blockDim.x
  int* nh_s = smem;                               // [u][g] = nh[u, d0 + g]
  int* hop_s = nh_s + cells;                      // [u][g] hops u -> d
  int* first_s = hop_s + cells;                   // [u][g] lowest child or -1
  int* next_s = first_s + cells;                  // [v][g] next sibling or -1
  float* flow_s = reinterpret_cast<float*>(next_s + cells);
  __shared__ int max_level;

  const int groups = (n + group - 1) / group;
  const int b = blockIdx.x / groups;
  const int d0 = (blockIdx.x % groups) * group;
  const size_t mat = static_cast<size_t>(n) * n;
  const int tid = threadIdx.x;
  const int u = tid / group;
  const int g = tid % group;
  const int d = d0 + g;
  const bool live = d < n;
  const size_t cell = b * mat + static_cast<size_t>(u) * n + d;

  if (tid == 0) max_level = 0;
  nh_s[tid] = live ? __ldg(nh + cell) : -1;
  first_s[tid] = -1;
  __syncthreads();

  int h = 0;
  bool reached = true;
  if (live) {
    // Walk u -> d in path order.
    int cur = u;
    float dsum = 0.0f;
    for (int t = 0; t < max_hops && cur != d; ++t) {
      const int nxt = nh_s[cur * group + g];
      dsum += __ldg(delay + static_cast<size_t>(cur) * n + nxt);
      ++h;
      cur = nxt;
    }
    reached = cur == d;
    hops_out[cell] = h;
    delay_out[cell] = dsum;

    // Sibling links of d's in-tree: children of one parent in ascending v.
    const int parent = nh_s[tid];
    bool first = true;
    for (int v = 0; v < u; ++v)
      if (nh_s[v * group + g] == parent) {
        first = false;
        break;
      }
    int next = -1;
    for (int v = u + 1; v < n; ++v)
      if (nh_s[v * group + g] == parent) {
        next = v;
        break;
      }
    next_s[tid] = next;
    if (first) first_s[parent * group + g] = u;
    flow_s[tid] = __ldg(f + cell);
  } else {
    next_s[tid] = -1;
    flow_s[tid] = 0.0f;
  }
  hop_s[tid] = h;
  {
    const int lanes = min(32, static_cast<int>(blockDim.x) - (tid & ~31));
    const unsigned mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
    const int wmax = __reduce_max_sync(mask, h);
    if ((tid & 31) == 0) atomicMax(&max_level, wmax);
  }
  __syncthreads();

  // In-tree flows, leaves in: nodes one hop further are final when a level
  // pulls from them.
  for (int level = max_level - 1; level >= 1; --level) {
    if (live && h == level) {
      float acc = flow_s[tid];
      for (int v = first_s[tid]; v >= 0; v = next_s[v * group + g])
        if (hop_s[v * group + g] == level + 1) acc += flow_s[v * group + g];
      flow_s[tid] = acc;
    }
    __syncthreads();
  }

  if (live) tree_out[cell] = make_int2(nh_s[tid], __float_as_int(flow_s[tid]));
  const int all = __syncthreads_and(reached);
  if (tid == 0) done_part[blockIdx.x] = all;
}

__global__ void __launch_bounds__(kPass2Warps * 32)
walk_util_kernel(const float* __restrict__ f, const int2* __restrict__ tree,
                 int n, int groups, const int* __restrict__ done_part,
                 float* __restrict__ util_out, float* __restrict__ visits_out,
                 int* __restrict__ done_out) {
  extern __shared__ float util_s[];               // [warp][n]
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int u = blockIdx.x * kPass2Warps + warp;
  const size_t mat = static_cast<size_t>(n) * n;
  float* row = util_s + warp * n;

  if (u < n) {                                    // warp-uniform
    for (int j = lane; j < n; j += 32) row[j] = 0.0f;
    __syncwarp();
    const int2* tb = tree + b * mat + static_cast<size_t>(u) * n;
    float vis = 0.0f;
    for (int d0 = 0; d0 < n; d0 += 32) {
      const int2 c = d0 + lane < n ? __ldg(tb + d0 + lane) : make_int2(0, 0);
      const int m = min(32, n - d0);
      for (int t = 0; t < m; ++t) {
        const int p = __shfl_sync(0xffffffffu, c.x, t);
        const float x = __int_as_float(__shfl_sync(0xffffffffu, c.y, t));
        if (d0 + t == u) continue;
        if ((p & 31) == lane) row[p] += x;
        vis += x;
      }
    }
    // Destination router traversal: column sum of f, s ascending.
    const float* fb = f + b * mat + u;
    float col = 0.0f;
    for (int s0 = 0; s0 < n; s0 += 32) {
      const float v = s0 + lane < n
                          ? __ldg(fb + static_cast<size_t>(s0 + lane) * n)
                          : 0.0f;
      const int m = min(32, n - s0);
      for (int t = 0; t < m; ++t) col += __shfl_sync(0xffffffffu, v, t);
    }
    __syncwarp();
    float* ub = util_out + b * mat + static_cast<size_t>(u) * n;
    for (int j = lane; j < n; j += 32) ub[j] = row[j];
    if (lane == 0) visits_out[static_cast<size_t>(b) * n + u] = vis + col;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int all = 1;
    for (int i = 0; i < groups; ++i) all &= done_part[b * groups + i];
    done_out[b] = all;
  }
}

}  // namespace

// nh: (B, n, n) i32 next hops; f: (B, n, n) f32 slot traffic; delay: (n, n)
// f32 wire delay. Outputs: hops (B, n, n) i32, delay sums (B, n, n) f32,
// util (B, n, n) f32, visits (B, n) f32, all_done (B,) i32. scratch: at
// least B * (2 n^2 + n) i32. n <= 1024. Two launches on `stream`; returns
// cudaGetLastError() after them.
extern "C" int walk_launch(const int* nh, const float* f, const float* delay,
                           int batch, int n, int max_hops, int* hops,
                           float* delay_sum, float* util, float* visits,
                           int* all_done, int* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = dest_group(n);
  const int groups = (n + group - 1) / group;
  int2* tree = reinterpret_cast<int2*>(scratch);
  int* done_part = scratch + static_cast<size_t>(batch) * n * n * 2;
  const int cells = n * group;
  walk_tree_kernel<<<batch * groups, cells, 5 * cells * sizeof(int), s>>>(
      nh, f, delay, n, group, max_hops, hops, delay_sum, tree, done_part);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  dim3 grid((n + kPass2Warps - 1) / kPass2Warps, batch);
  walk_util_kernel<<<grid, kPass2Warps * 32, kPass2Warps * n * sizeof(float),
                     s>>>(f, tree, n, groups, done_part, util, visits,
                          all_done);
  return static_cast<int>(cudaGetLastError());
}
