// Mamba-2 SSD chunked scan, ngroups = 1 (K6).
//
// Replaces the Pallas kernel `ssd` in src/repro/kernels/ssd.py, the
// state-space core of every Mamba-2 layer's full-sequence pass. The
// recurrence
//     h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T,   y_t = C_t h_t + d x_t
// is evaluated chunk by chunk: inside a chunk of Q steps in its dual
// (attention-like) form, across chunks through the (N, P) state alone.
//
// Bound on the H100: operations. Per (batch row, head, chunk) the four
// products cost 2*Q*(Q*N + Q*P + 2*N*P) flops in f32 against
// 4*Q*(2*P + 2*N + 1) bytes, about 30 flops per byte at Q = N = P = 64, on
// the CUDA cores. One block of 256 threads per (head, batch row) walks the
// chunks in order with the state in shared memory (16 KB at N = P = 64).
// Per chunk it stages x, B, C and dt in shared memory, takes the inclusive
// cumsum s of dt*a by a warp scan (the Pallas kernel used a tril matmul
// only because TPU-Pallas has no cumsum), and runs
//     W = (C B^T) o exp(s_i - s_j) o dt_j o [j <= i]
//     y = W x + (C o exp(s)) h + d x
//     h = exp(s_last) h + (B o exp(s_last - s) dt)^T x
// each as a 64 x 64 output tile, 4 x 4 outputs per thread in registers. All
// exponents are <= 0 (a < 0, dt >= 0), and the mask is applied before the
// exponential. Rows past S load as zeros (dt = 0, x = B = C = 0): they decay
// by exp(0) = 1 and add 0, so a ragged tail is a padded chunk and the final
// state is unchanged; their y rows are not written. The final state is
// written when asked. No atomics: two runs are bit-identical.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;     // tile edge: max chunk, max P, rows of a state block
constexpr int kWs = kT + 1;  // stride of W rows
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

size_t smem_bytes(int n) {
  const int ns = n + 1;
  return sizeof(float) * (static_cast<size_t>(kT) * kT          // x
                          + 2 * static_cast<size_t>(kT) * ns    // B, C
                          + static_cast<size_t>(round_up(n, kT)) * kT  // h
                          + static_cast<size_t>(kT) * kWs       // W
                          + 4 * kT);                            // s, dt, u, e
}

__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const float* __restrict__ bm,
           const float* __restrict__ cm, const float* __restrict__ dskip,
           float* __restrict__ y, float* __restrict__ state_out, int seq,
           int n_heads, int p_dim, int n_dim, int chunk) {
  extern __shared__ float smem[];
  const int ns = n_dim + 1;  // odd stride: lanes read distinct banks
  const int np = round_up(n_dim, kT);
  float* xs = smem;             // kT x kT    x[j][p]
  float* bs = xs + kT * kT;     // kT x ns    B[j][n]
  float* cs = bs + kT * ns;     // kT x ns    C[i][n]
  float* hs = cs + kT * ns;     // np x kT    h[n][p]
  float* ws = hs + np * kT;     // kT x kWs   W[i][j]
  float* sv = ws + kT * kWs;    // s: inclusive cumsum of dt*a
  float* dv = sv + kT;          // dt
  float* uv = dv + kT;          // exp(s_last - s_j) dt_j
  float* ev = uv + kT;          // exp(s_i)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const float ah = a[h];
  const float dh = dskip[h];
  const long long hp = static_cast<long long>(n_heads) * p_dim;

  for (int e = tid; e < np * kT; e += kThreads) hs[e] = 0.f;

  for (int t0 = 0; t0 < seq; t0 += chunk) {
    __syncthreads();  // the previous chunk is no longer read
    for (int e = tid; e < kT * kT; e += kThreads) {
      const int j = e / kT, p = e % kT;
      const int t = t0 + j;
      xs[e] = (j < chunk && t < seq && p < p_dim)
                  ? x[(static_cast<long long>(b) * seq + t) * hp +
                      static_cast<long long>(h) * p_dim + p]
                  : 0.f;
    }
    for (int e = tid; e < kT * n_dim; e += kThreads) {
      const int j = e / n_dim, n = e % n_dim;
      const int t = t0 + j;
      const bool in = j < chunk && t < seq;
      const long long g = (static_cast<long long>(b) * seq + t) * n_dim + n;
      bs[j * ns + n] = in ? bm[g] : 0.f;
      cs[j * ns + n] = in ? cm[g] : 0.f;
    }
    if (tid < kT) {
      const int t = t0 + tid;
      dv[tid] = (tid < chunk && t < seq)
                    ? dt[(static_cast<long long>(b) * seq + t) * n_heads + h]
                    : 0.f;
    }
    __syncthreads();

    if (tid < 32) {  // inclusive scan of dt*a over the 64 rows
      float v0 = dv[tid] * ah, v1 = dv[tid + 32] * ah;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n0 = __shfl_up_sync(kFull, v0, off);
        const float n1 = __shfl_up_sync(kFull, v1, off);
        if (tid >= off) {
          v0 += n0;
          v1 += n1;
        }
      }
      const float first_half = __shfl_sync(kFull, v0, 31);
      sv[tid] = v0;
      sv[tid + 32] = v1 + first_half;
    }
    __syncthreads();
    const float s_last = sv[chunk - 1];
    if (tid < kT) {
      uv[tid] = expf(s_last - sv[tid]) * dv[tid];
      ev[tid] = expf(sv[tid]);
    }

    // W = (C B^T) o exp(s_i - s_j) o dt_j, lower triangle.
    {
      float acc[4][4] = {};
      for (int n = 0; n < n_dim; ++n) {
        float cr[4], br[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cr[r] = cs[(ty + 16 * r) * ns + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) br[c] = bs[(tx + 16 * c) * ns + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cr[r], br[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          ws[i * kWs + j] =
              j <= i ? acc[r][c] * expf(sv[i] - sv[j]) * dv[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // y = W x + exp(s) o (C h) + d x.
    {
      float acc[4][4] = {}, inter[4][4] = {};
      for (int j = 0; j < chunk; ++j) {
        float wr[4], xr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) wr[r] = ws[(ty + 16 * r) * kWs + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) xr[c] = xs[j * kT + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(wr[r], xr[c], acc[r][c]);
      }
      for (int n = 0; n < n_dim; ++n) {
        float cr[4], hr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cr[r] = cs[(ty + 16 * r) * ns + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) hr[c] = hs[n * kT + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            inter[r][c] = fmaf(cr[r], hr[c], inter[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        const int t = t0 + i;
        if (i >= chunk || t >= seq) continue;
        float* yrow = y + (static_cast<long long>(b) * seq + t) * hp +
                      static_cast<long long>(h) * p_dim;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx + 16 * c;
          if (p < p_dim)
            yrow[p] = acc[r][c] + ev[i] * inter[r][c] + dh * xs[i * kT + p];
        }
      }
    }

    // h = exp(s_last) h + (B o u)^T x, one 64-row block of the state at a
    // time; written back after every thread has read the old state.
    const float decay = expf(s_last);
    constexpr int kMaxBlocks = 2;  // n_dim <= 128
    float hn[kMaxBlocks][4][4];
#pragma unroll
    for (int blk = 0; blk < kMaxBlocks; ++blk) {
      if (blk * kT >= n_dim) continue;
      float acc[4][4] = {};
      for (int j = 0; j < chunk; ++j) {
        const float u = uv[j];
        float br[4], xr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = blk * kT + ty + 16 * r;
          br[r] = n < n_dim ? bs[j * ns + n] * u : 0.f;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) xr[c] = xs[j * kT + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(br[r], xr[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = blk * kT + ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          hn[blk][r][c] = decay * hs[n * kT + tx + 16 * c] + acc[r][c];
      }
    }
    __syncthreads();
#pragma unroll
    for (int blk = 0; blk < kMaxBlocks; ++blk) {
      if (blk * kT >= n_dim) continue;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = blk * kT + ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) hs[n * kT + tx + 16 * c] = hn[blk][r][c];
      }
    }
  }

  if (state_out != nullptr) {
    __syncthreads();
    float* sb = state_out + (static_cast<long long>(b) * n_heads + h) *
                                n_dim * p_dim;
    for (int e = tid; e < n_dim * p_dim; e += kThreads) {
      const int n = e / p_dim, p = e % p_dim;
      sb[e] = hs[n * kT + p];
    }
  }
}

}  // namespace

// x (B,S,H,P), dt (B,S,H), a (H,), b/c (B,S,N), d (H,): f32, contiguous, on
// the device. y (B,S,H,P) f32; state_out (B,H,N,P) f32 or null. 1 <= chunk
// <= 64, P <= 64, N <= 128. Returns the CUDA error of the launch.
extern "C" int ssd_launch(const float* x, const float* dt, const float* a,
                          const float* b, const float* c, const float* d,
                          float* y, float* state_out, int batch, int seq,
                          int n_heads, int p_dim, int n_dim, int chunk,
                          void* stream) {
  if (chunk < 1 || chunk > kT || p_dim < 1 || p_dim > kT || n_dim < 1 ||
      n_dim > 2 * kT)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n_dim);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_heads, batch);
  ssd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, dt, a, b, c, d, y, state_out, seq, n_heads, p_dim, n_dim, chunk);
  return static_cast<int>(cudaGetLastError());
}
