// Batched min-plus product out[b,i,j] = min_k a[b,i,k] + b[b,k,j], and the
// whole APSP by repeated squaring in one launch (K1).
//
// Replaces the Pallas kernel `minplus` in src/repro/kernels/minplus.py and
// its `apsp` loop there, the APSP inside every design evaluation
// (routing.apsp_batched squares the hop-cost matrices ceil(log2 N)+1
// times).
//
// Bound on the H100: operations. Min-plus has no tensor-core form, so each
// output costs N add+min pairs on the CUDA cores (B*N^3 pairs per product)
// against 3*B*N^2*4 bytes of traffic for one product, 2*B*N^2*4 for a whole
// APSP.
//
// apsp_kernel (N <= 128): one block per design holds the matrix and a second
// buffer in shared memory for every squaring. Each squaring reads one buffer
// and writes the other, so every intermediate value is the one an
// out-of-place loop of single products gives. A squaring that changes no
// entry (block-wide __syncthreads_or over the bits) is a fixed point, and
// every later squaring would return the same bits, so the block stops there.
// Each of the (N/4)^2 threads keeps a 4x4 block of outputs in registers and
// reads 4-wide rows of the source for both operands. A squaring is bound by
// its add and min instructions on the one SM of its block (register tiles
// of 2x2 to 4x4 outputs timed alike); a cluster of 2 or 4 blocks per design
// that push their new rows to each other through distributed shared
// memory ran slower at N = 64, so a design keeps one block.
//
// minplus_kernel (one product, and the APSP above N = 128, one launch per
// squaring): one 64x64 output tile per block, the k-loop stages a 64x16 A
// tile and a 16x64 B tile in shared memory, and each of the 256 threads
// keeps a 4x4 block of outputs in registers. The batch runs on gridDim.z.
//
// Padding on the ragged edge is +infinity: a phantom k costs inf + inf =
// inf, which never undercuts a real candidate, so every result is the true
// minimum over the real k whatever the inputs (also above INF = 1e9, as the
// squarings of a matrix without a zero diagonal produce); the accumulator
// starts at +infinity, as the plain version's min does. Results are bit-equal
// to any other evaluation order: every value is an f32 sum of two inputs and
// a min, nothing else touches it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

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
      as[k][r] = (gi < n && gk < n) ? ab[static_cast<size_t>(gi) * n + gk]
                                    : INFINITY;
    }
    for (int e = tid; e < kBk * kTile; e += kThreads) {
      const int k = e / kTile, c = e % kTile;
      const int gk = k0 + k, gj = col0 + c;
      bs[k][c] = (gk < n && gj < n) ? bb[static_cast<size_t>(gk) * n + gj]
                                    : INFINITY;
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

// Largest N the one-launch APSP holds in shared memory (two buffers of
// N x (N + 4) floats: 135 KB at 128).
constexpr int kApspMaxN = 128;

__device__ inline void minmax4(float (&acc)[4], float a, float4 b) {
  acc[0] = fminf(acc[0], a + b.x);
  acc[1] = fminf(acc[1], a + b.y);
  acc[2] = fminf(acc[2], a + b.z);
  acc[3] = fminf(acc[3], a + b.w);
}

__global__ void __launch_bounds__(1024)
apsp_kernel(const float* __restrict__ cost, float* __restrict__ out, int n,
            int n_iters) {
  extern __shared__ __align__(16) float sm[];
  const int np = (n + 3) & ~3;                    // N padded to 4
  const int ld = np + 4;                          // row stride, 16 B aligned
  float* src = sm;
  float* dst = sm + np * ld;
  const size_t mat = static_cast<size_t>(n) * n;
  const float* cb = cost + blockIdx.x * mat;
  float* ob = out + blockIdx.x * mat;
  const int tid = threadIdx.x;
  const int tiles = np / 4;
  const int i0 = (tid / tiles) * 4;
  const int j0 = (tid % tiles) * 4;

  const int q = n / 4;
  if (n == 4 * q) {
#pragma unroll 4
    for (int e = tid; e < n * q; e += blockDim.x)
      *reinterpret_cast<float4*>(src + (e / q) * ld + (e % q) * 4) =
          __ldg(reinterpret_cast<const float4*>(cb) + e);
  } else {
    for (int e = tid; e < n * n; e += blockDim.x)
      src[(e / n) * ld + e % n] = __ldg(cb + e);
  }
  if (n != np) {  // phantom rows and columns: +inf in both buffers
    for (int e = tid; e < np * np; e += blockDim.x) {
      const int i = e / np, j = e % np;
      if (i >= n || j >= n) src[i * ld + j] = dst[i * ld + j] = INFINITY;
    }
  }
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = INFINITY;
    for (int k = 0; k < np; k += 4) {
      float4 a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = *reinterpret_cast<const float4*>(src + (i0 + r) * ld + k);
      const float4 b0 = *reinterpret_cast<const float4*>(src + k * ld + j0);
#pragma unroll
      for (int r = 0; r < 4; ++r) minmax4(acc[r], a[r].x, b0);
      const float4 b1 =
          *reinterpret_cast<const float4*>(src + (k + 1) * ld + j0);
#pragma unroll
      for (int r = 0; r < 4; ++r) minmax4(acc[r], a[r].y, b1);
      const float4 b2 =
          *reinterpret_cast<const float4*>(src + (k + 2) * ld + j0);
#pragma unroll
      for (int r = 0; r < 4; ++r) minmax4(acc[r], a[r].z, b2);
      const float4 b3 =
          *reinterpret_cast<const float4*>(src + (k + 3) * ld + j0);
#pragma unroll
      for (int r = 0; r < 4; ++r) minmax4(acc[r], a[r].w, b3);
    }
    int changed = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (i0 + r < n && j0 + c < n) {
          const int e = (i0 + r) * ld + j0 + c;
          changed |= __float_as_uint(acc[r][c]) != __float_as_uint(src[e]);
          dst[e] = acc[r][c];
        }
    // The barrier also orders this squaring's reads of src before the next
    // one's writes into it.
    changed = __syncthreads_or(changed);
    float* t = src;
    src = dst;
    dst = t;
    if (!changed) break;
  }

  if (n == 4 * q) {
    for (int e = tid; e < n * q; e += blockDim.x)
      reinterpret_cast<float4*>(ob)[e] =
          *reinterpret_cast<const float4*>(src + (e / q) * ld + (e % q) * 4);
  } else {
    for (int e = tid; e < n * n; e += blockDim.x)
      ob[e] = src[(e / n) * ld + e % n];
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

// cost, out: (batch, n, n) f32, contiguous, on the device, n <= 128; out must
// not alias cost. One block per design runs up to n_iters squarings.
// Returns cudaGetLastError() after the launch.
extern "C" int apsp_launch(const float* cost, float* out, int batch, int n,
                           int n_iters, void* stream) {
  if (n < 1 || n > kApspMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const int np = (n + 3) & ~3;
  const int bytes = 2 * np * (np + 4) * static_cast<int>(sizeof(float));
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        apsp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  apsp_kernel<<<batch, (np / 4) * (np / 4), bytes,
                static_cast<cudaStream_t>(stream)>>>(cost, out, n, n_iters);
  return static_cast<int>(cudaGetLastError());
}
