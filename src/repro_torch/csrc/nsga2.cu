// NSGA-II selection scoring of one population in one launch: the
// nondominated rank and the crowding distance of each of n objective rows
// (m objectives, f32), as the plain version kernels/ref.py::nsga2_rank_ref
// computes them: the same ranks, the crowding distances bit for bit.
//
// Replaces the reference's jitted jnp twin `_rank_crowd_jnp_fn`
// (src/repro/core/nsga2.py:90), not a Pallas kernel. On the card the plain
// version is a chain of some 600 small PyTorch launches a call (a peeling
// round of ~7 ops for each of the n rows, ~10 ops per objective for the
// crowding), a few microseconds of device work behind milliseconds of host
// launch overhead.
//
// Bound on the H100: latency. A call reads n*m*4 bytes and writes 8n; its
// compares, O(n^2 m), are ~40 000 at n = 64, m = 5. So one block does the
// whole call, every phase block-synchronous, the workspace in shared memory
// (in a global scratch buffer from the wrapper where it exceeds 48 KB:
// n > ~400 at m = 5):
//
//   1. dominance: bits[j] is the set of rows that dominate row j, one
//      __ballot_sync per 32-row word. Row i dominates row j when it is <= in
//      every objective and < in one, or equal in all and i < j (the plain
//      version's tie-break for duplicate rows, which keeps the relation
//      acyclic);
//   2. rank by peeling: round r gives rank r to every unranked row whose
//      dominators all hold a rank < r; the rounds stop as soon as no row is
//      left (__syncthreads_or), at most n of them;
//   3. crowding: per (row, objective) the row's place in the objective's
//      stable ascending order, by counting the rows before it (NaN after
//      every number, ties by index: torch.argsort(stable=True)); then per
//      row, objective by objective in order, the plain version's
//      (next - previous) / ((last - first) + 1e-12) added to its sum, the
//      two end rows set to inf after each add. The arithmetic is
//      __fsub_rn / __fadd_rn / __fdiv_rn, which no contraction or fast-math
//      flag can change.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kMaxThreads = 1024;
// Largest workspace (bytes) kept in shared memory; the wrapper passes a
// global scratch buffer above it (kernels/ops.py::NSGA2_SMEM_MAX).
constexpr size_t kSmemMax = 48 * 1024;

// torch's ascending order of floats: every number before NaN.
__device__ __forceinline__ bool before(float a, float b) {
  return a < b || (isnan(b) && !isnan(a));
}

__global__ void __launch_bounds__(kMaxThreads)
nsga2_rank_kernel(const float* __restrict__ objs, int n, int m,
                  unsigned* scratch, int* __restrict__ out) {
  extern __shared__ unsigned smem[];
  unsigned* ws = scratch != nullptr ? scratch : smem;
  const int words = (n + 31) / 32;
  const size_t nm = static_cast<size_t>(n) * m;
  float* obj_t = reinterpret_cast<float*>(ws);        // [j][i]
  int* pos = reinterpret_cast<int*>(ws + nm);         // [j][i] place of i
  int* order = pos + nm;                              // [j][p] row at p
  unsigned* bits = reinterpret_cast<unsigned*>(order + nm);  // [j][w]
  unsigned* ranked = bits + static_cast<size_t>(n) * words;  // [w]
  int* rank = reinterpret_cast<int*>(ranked + words);        // [i]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;

  for (size_t q = tid; q < nm; q += nthreads)
    obj_t[(q % m) * n + q / m] = objs[q];
  for (int w = tid; w < words; w += nthreads) ranked[w] = 0u;
  for (int i = tid; i < n; i += nthreads) rank[i] = -1;
  __syncthreads();

  // 1. bits[j][w], bit l: row 32 w + l dominates row j.
  const size_t n_words = static_cast<size_t>(n) * words;
  for (size_t q = warp; q < n_words; q += nwarps) {
    const int j = static_cast<int>(q / words);
    const int i = static_cast<int>(q % words) * 32 + lane;
    bool dom = false;
    if (i < n) {
      bool le = true, lt = false;
      for (int k = 0; k < m; ++k) {
        const float a = obj_t[static_cast<size_t>(k) * n + i];
        const float b = obj_t[static_cast<size_t>(k) * n + j];
        le = le && a <= b;
        lt = lt || a < b;
      }
      dom = le && (lt || i < j);
    }
    const unsigned word = __ballot_sync(0xffffffffu, dom);
    if (lane == 0) bits[q] = word;
  }
  __syncthreads();

  // 2. Peeling: `ranked` holds the rows ranked before round r.
  for (int r = 0; r < n; ++r) {
    int left = 0;
    for (int j = tid; j < n; j += nthreads) {
      if (rank[j] >= 0) continue;
      const unsigned* dj = bits + static_cast<size_t>(j) * words;
      bool ready = true;
      for (int w = 0; w < words && ready; ++w)
        ready = (dj[w] & ~ranked[w]) == 0u;
      if (ready)
        rank[j] = r;
      else
        left = 1;
    }
    if (!__syncthreads_or(left)) break;
    for (int w = warp; w < words; w += nwarps) {
      const int i = w * 32 + lane;
      const unsigned word = __ballot_sync(0xffffffffu, i < n && rank[i] == r);
      if (lane == 0) ranked[w] |= word;
    }
    __syncthreads();
  }

  // 3a. The place of row i in objective j's stable ascending order.
  for (size_t q = tid; q < nm; q += nthreads) {
    const int i = static_cast<int>(q % n);
    const float* col = obj_t + (q - i);
    const float x = col[i];
    int p = 0;
    for (int k = 0; k < n; ++k) {
      const float y = col[k];
      p += before(y, x) || (k < i && !before(x, y));
    }
    pos[q] = p;
    order[q - i + p] = i;
  }
  __syncthreads();

  // 3b. Each row's sum over the objectives, in the plain version's order.
  const float eps = static_cast<float>(1e-12);
  for (int i = tid; i < n; i += nthreads) {
    float c = 0.0f;
    for (int j = 0; j < m; ++j) {
      const size_t base = static_cast<size_t>(j) * n;
      const float* col = obj_t + base;
      const int* ord = order + base;
      const int p = pos[base + i];
      float contrib = 0.0f;
      if (p > 0 && p < n - 1) {
        const float range =
            __fadd_rn(__fsub_rn(col[ord[n - 1]], col[ord[0]]), eps);
        contrib =
            __fdiv_rn(__fsub_rn(col[ord[p + 1]], col[ord[p - 1]]), range);
      }
      c = __fadd_rn(c, contrib);
      if (p == 0 || p == n - 1) c = INFINITY;
    }
    out[i] = rank[i];
    out[n + i] = __float_as_int(c);
  }
}

// Words of the kernel's workspace for n rows of m objectives, as
// kernels/ops.py::nsga2_workspace_words counts them.
size_t workspace_words(int n, int m) {
  const size_t words = (static_cast<size_t>(n) + 31) / 32;
  return 3 * static_cast<size_t>(n) * m + n * words + words + n;
}

}  // namespace

// objs: (n, m) f32 rows. out: (2, n) i32, row 0 the ranks, row 1 the
// crowding distances' f32 bits. scratch: null, the workspace then in
// shared memory (at most 48 KB), or workspace_words(n, m) words of
// device memory. One launch on `stream`; returns cudaGetLastError().
extern "C" int nsga2_rank_launch(const float* objs, int n, int m,
                                 unsigned* scratch, int* out, void* stream) {
  const size_t smem =
      scratch != nullptr ? 0 : workspace_words(n, m) * sizeof(unsigned);
  if (n < 1 || m < 0 || smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = static_cast<long long>(n) * (m > 0 ? m : 1);
  const int threads = pairs >= kMaxThreads
                          ? kMaxThreads
                          : static_cast<int>((pairs + 31) / 32 * 32);
  nsga2_rank_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      objs, n, m, scratch, out);
  return static_cast<int>(cudaGetLastError());
}
