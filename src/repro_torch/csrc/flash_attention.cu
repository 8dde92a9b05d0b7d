// GQA attention forward with an online softmax: causal, sliding-window or
// full (K5).
//
// Replaces the Pallas kernel `flash_attention` in
// src/repro/kernels/flash_attention.py, the attention of every full-sequence
// pass (the shared attention block of the hybrid's prefill, the dense
// families' layers).
//
// Bound on the H100: operations. q (B,H,Sq,D) against k/v (B,KH,Sk,D) costs
// 4*B*H*Sq*Sk*D flops (halved by the causal mask) against
// (2*B*H*Sq + 2*B*KH*Sk)*D*bytes of traffic; at a 512-token prefill that is
// a few hundred flops per byte. This first version runs the products on the
// CUDA cores in f32 (no tensor cores yet): one block of 256 threads per
// (q tile, head, batch row). The q tile and one k/v tile at a time are
// staged in shared memory, converted to f32; each warp owns BQ/8 query rows,
// each lane 2 key columns of the logits and the head-dim columns lane+32*j
// of the output, whose f32 accumulators stay in registers. The logits never
// reach device memory. k tiles wholly outside the causal / window band are
// skipped (they would add p = 0 and leave m unchanged). Rows and columns
// past Sq / Sk are masked, so any length works.
//
// Semantics of the Pallas kernel: scale D^-0.5 applied to q.k; masked
// logits are -1e30 and their p is zeroed; m starts at -1e30, so a row whose
// first tiles are fully masked keeps alpha = exp(0) = 1 with l = acc = 0; a
// row with no valid key divides by 1 and comes out 0. q head h reads kv head
// h / (H/KH): repeated KV is never built. No atomics: every sum has a fixed
// order and two runs are bit-identical.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBk = 64;  // key rows per tile: 2 per lane
constexpr float kNegInf = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__host__ __device__ constexpr int block_q(int ncol) {
  return ncol <= 4 ? 64 : 32;
}

template <int NCOL>
size_t smem_bytes(int d) {
  constexpr int bq = block_q(NCOL);
  return sizeof(float) *
         (static_cast<size_t>(bq) * d + static_cast<size_t>(kBk) * (d + 1) +
          static_cast<size_t>(kBk) * d + static_cast<size_t>(bq) * kBk);
}

// NCOL = ceil(D / 32) output columns per lane.
template <typename T, int NCOL>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int n_heads,
             int group, int sq, int sk, int d, long long qsb, long long qsh,
             long long qss, long long ksb, long long ksh, long long kss,
             long long vsb, long long vsh, long long vss, float scale,
             int causal, int window) {
  constexpr int kBq = block_q(NCOL);
  constexpr int kRows = kBq / kWarps;  // query rows per warp
  constexpr int kCols = kBk / 32;      // key columns per lane
  extern __shared__ float smem[];
  const int dk = d + 1;  // odd stride: lanes read distinct banks of k rows
  float* qs = smem;              // kBq x d
  float* ks = qs + kBq * d;      // kBk x dk
  float* vs = ks + kBk * dk;     // kBk x d
  float* ps = vs + kBk * d;      // kBq x kBk

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kBq;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + (h / group) * ksh;
  const T* vb = v + b * vsb + (h / group) * vsh;

  for (int e = tid; e < kBq * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    const int qp = q0 + r;
    qs[e] = qp < sq ? to_f32(qb[qp * qss + c]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NCOL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) acc[r][c] = 0.f;
  }

  // The band of keys any row of this tile may see.
  int k_hi = sk;
  if (causal) k_hi = min(sk, q0 + kBq);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  k_lo = (k_lo / kBk) * kBk;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBk) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < kBk * d; e += kThreads) {
      const int r = e / d, c = e - r * d;
      const int kp = k0 + r;
      const bool in = kp < sk;
      ks[r * dk + c] = in ? to_f32(kb[kp * kss + c]) : 0.f;
      vs[e] = in ? to_f32(vb[kp * vss + c]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = 0.f;
    const float* qw = qs + warp * kRows * d;
    for (int x = 0; x < d; ++x) {
      float kv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = ks[(lane + 32 * c) * dk + x];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = qw[r * d + x];
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[r][c] = fmaf(qv, kv[c], s[r][c]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = warp * kRows + r;
      const int qp = q0 + row;
      bool ok[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int kp = k0 + lane + 32 * c;
        ok[c] = kp < sk && (!causal || kp <= qp) &&
                (window <= 0 || kp > qp - window);
        s[r][c] = ok[c] ? s[r][c] * scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = ok[c] ? expf(s[r][c] - m_new) : 0.f;
        ps[row * kBk + lane + 32 * c] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(kFull, psum, off);
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NCOL; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

    const float* pw = ps + warp * kRows * kBk;
    for (int j = 0; j < kBk; ++j) {
      float vv[NCOL];
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        const int x = lane + 32 * c;
        vv[c] = x < d ? vs[j * d + x] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = pw[r * kBk + j];
#pragma unroll
        for (int c = 0; c < NCOL; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
    __syncwarp();  // this warp's p rows are rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + warp * kRows + r;
    if (qp >= sq) continue;
    const float safe = l[r] == 0.f ? 1.f : l[r];
    T* orow = o + ((static_cast<long long>(b) * n_heads + h) * sq + qp) * d;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int x = lane + 32 * c;
      if (x < d) store(orow + x, acc[r][c] / safe);
    }
  }
}

template <typename T, int NCOL>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int n_heads, int n_kv_heads, int sq, int sk, int d,
           const long long* st, float scale, int causal, int window,
           cudaStream_t stream) {
  constexpr int bq = block_q(NCOL);
  const size_t smem = smem_bytes<NCOL>(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NCOL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + bq - 1) / bq, n_heads, batch);
  flash_kernel<T, NCOL><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n_heads,
      n_heads / n_kv_heads, sq, sk, d, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int ncol, const void* q, const void* k, const void* v, void* o,
             int batch, int n_heads, int n_kv_heads, int sq, int sk, int d,
             const long long* st, float scale, int causal, int window,
             cudaStream_t s) {
#define K5_CASE(N)                                                        \
  case N:                                                                 \
    return launch<T, N>(q, k, v, o, batch, n_heads, n_kv_heads, sq, sk, d, \
                        st, scale, causal, window, s);
  switch (ncol) {
    K5_CASE(1) K5_CASE(2) K5_CASE(3) K5_CASE(4)
    K5_CASE(5) K5_CASE(6) K5_CASE(7) K5_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K5_CASE
}

}  // namespace

// q (B,H,Sq,D), k/v (B,KH,Sk,D) of one dtype (0 = f32, 1 = bf16) on the
// device, last dimension contiguous, the other strides (in elements) in
// `strides` = {q: b,h,s; k: b,h,s; v: b,h,s}. o (B,H,Sq,D) contiguous, same
// dtype. 1 <= D <= 256, H % KH == 0; window <= 0 means no window. Returns
// the CUDA error of the launch (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int n_heads, int n_kv_heads, int sq, int sk, int d,
    long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss, float scale,
    int causal, int window, void* stream) {
  if (d < 1 || d > 256 || n_kv_heads < 1 || n_heads % n_kv_heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  const int ncol = (d + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(ncol, q, k, v, o, batch, n_heads, n_kv_heads, sq,
                           sk, d, st, scale, causal, window, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(ncol, q, k, v, o, batch, n_heads,
                                   n_kv_heads, sq, sk, d, st, scale, causal,
                                   window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
