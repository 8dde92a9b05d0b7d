// Batched min-plus product out[b,i,j] = min_k a[b,i,k] + b[b,k,j] (K1).
//
// Replaces the Pallas kernel `minplus` in src/repro/kernels/minplus.py, the
// APSP inner loop of design evaluation (routing.apsp_batched squares the
// hop-cost matrices ceil(log2 N)+1 times).
//
// Bound on the H100: operations. Min-plus has no tensor-core form, so each
// output costs N add+min pairs on the CUDA cores (B*N^3 pairs per product)
// against 3*B*N^2*4 bytes of traffic. The design keeps those operations fed
// from shared memory: one 64x64 output tile per block, the k-loop stages a
// 64x16 A tile and a 16x64 B tile in shared memory, and each of the 256
// threads keeps a 4x4 block of outputs in registers. The batch runs on
// gridDim.z. The ragged edge is padded with INF exactly as the reference
// pads: a phantom k costs INF + INF = 2e9, which no real candidate of
// inputs <= INF exceeds, so the result is the true minimum over the real k
// (the accumulator starts at +infinity, as the plain version's min does).
//
// Results are bit-equal to any other evaluation order: every value is an
// f32 sum of two inputs and a min, nothing else touches it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kInf = 1.0e9f;
constexpr int kTile = 64;
constexpr int kBk = 16;
constexpr int kThreads = 256;  // 16 x 16, each thread owns 4 x 4 outputs

__global__ void __launch_bounds__(kThreads)
minplus_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ out, int n) {
  __shared__ float as[kBk][kTile];  // as[k][i] = a[row0 + i, k0 + k]
  __shared__ float bs[kBk][kTile];  // bs[k][j] = b[k0 + k, col0 + j]

  const size_t mat = static_cast<size_t>(n) * n;
  const float* ab = a + blockIdx.z * mat;
  const float* bb = b + blockIdx.z * mat;
  float* ob = out + blockIdx.z * mat;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = INFINITY;

  for (int k0 = 0; k0 < n; k0 += kBk) {
    for (int e = tid; e < kTile * kBk; e += kThreads) {
      const int r = e / kBk, k = e % kBk;
      const int gi = row0 + r, gk = k0 + k;
      as[k][r] = (gi < n && gk < n) ? ab[static_cast<size_t>(gi) * n + gk] : kInf;
    }
    for (int e = tid; e < kBk * kTile; e += kThreads) {
      const int k = e / kTile, c = e % kTile;
      const int gk = k0 + k, gj = col0 + c;
      bs[k][c] = (gk < n && gj < n) ? bb[static_cast<size_t>(gk) * n + gj] : kInf;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBk; ++k) {
      float ar[4], br[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ar[i] = as[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) br[j] = bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fminf(acc[i][j], ar[i] + br[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = row0 + ty * 4 + i;
    if (gi >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = col0 + tx * 4 + j;
      if (gj < n) ob[static_cast<size_t>(gi) * n + gj] = acc[i][j];
    }
  }
}

}  // namespace

// a, b, out: (batch, n, n) f32, contiguous, on the device; out must not
// alias a or b. Returns cudaGetLastError() after the launch.
extern "C" int minplus_launch(const float* a, const float* b, float* out,
                              int batch, int n, void* stream) {
  const int tiles = (n + kTile - 1) / kTile;
  dim3 grid(tiles, tiles, batch);
  minplus_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, n);
  return static_cast<int>(cudaGetLastError());
}
