// GQA attention forward with an online softmax: causal, sliding-window or
// full (K5).
//
// Replaces the Pallas kernel `flash_attention` in
// src/repro/kernels/flash_attention.py, the attention of every full-sequence
// pass (the shared attention block of the hybrid's prefill, the dense
// families' layers).
//
// Bound on the H100: bytes at the serving shape. q (B,H,Sq,D) against k/v
// (B,KH,Sk,D) costs 4*D flops per (q, k) pair under the mask against
// (2*B*H*Sq + 2*B*KH*Sk)*D*bytes of traffic; at the zamba2 prefill (8, 32,
// 512, 80) bf16 that is 0.025 ms of bytes and 0.011 ms of bf16 tensor-core
// operations.
//
// bf16 inputs (the serving path) run on the tensor cores: mma.sync
// m16n8k16 with bf16 operands and f32 accumulators. One block of 4 warps
// per (q tile of 64 rows, head, batch row); each warp owns 16 query rows.
// The q tile and a double-buffered ring of k/v tiles of 64 keys sit in
// shared memory as bf16 (D zero-padded to a multiple of 16, rows padded by
// 16 bytes so that ldmatrix reads distinct banks), filled by 16-byte
// cp.async with zero-fill past Sq/Sk/D while the previous tile multiplies
// (plain loads where D or a stride is not a multiple of 8 elements). S =
// q k^T stays in registers as mma accumulator fragments; the online
// softmax works on them (a row's max and sum reduce over the 4 lanes of a
// quad), and the same fragments, split into two bf16 terms (p = hi + lo
// to about 2^-16: one bf16 rounding of p moved a next-token argmax of the
// full-width zamba2 prefill, whose plain top-2 margin is one bf16 ulp), are
// the A operand of P v: the probabilities never touch shared memory. Masks
// are evaluated only on tiles that cross an edge of the band or of Sk. The
// q tile is the slowest grid index, walked from the last: the heaviest
// causal tiles are issued first and the tail of the grid is short.
//
// f32 inputs keep the CUDA-core kernel below (products in f32 FMAs from
// shared memory): one bf16 rounding of an operand would miss the f32
// tolerance. The wrapper chooses by dtype only.
//
// Semantics of the Pallas kernel, in both: scale D^-0.5 applied to q.k;
// masked logits are -1e30 and their p is zeroed; m starts at -1e30, so a
// row whose first tiles are fully masked keeps alpha = exp(0) = 1 with l =
// acc = 0; a row with no valid key divides by 1 and comes out 0. k tiles
// wholly outside the causal / window band are skipped; any Sq / Sk. q head
// h reads kv head h / (H/KH): repeated KV is never built. No atomics: every
// sum has a fixed order and two runs are bit-identical.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA-core kernel.

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBk = 64;  // key rows per tile: 2 per lane
constexpr float kNegInf = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;

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
template <int NCOL>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int n_heads,
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
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + (h / group) * ksh;
  const float* vb = v + b * vsb + (h / group) * vsh;

  for (int e = tid; e < kBq * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    const int qp = q0 + r;
    qs[e] = qp < sq ? qb[qp * qss + c] : 0.f;
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
      ks[r * dk + c] = in ? kb[kp * kss + c] : 0.f;
      vs[e] = in ? vb[kp * vss + c] : 0.f;
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
    float* orow =
        o + ((static_cast<long long>(b) * n_heads + h) * sq + qp) * d;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int x = lane + 32 * c;
      if (x < d) orow[x] = acc[r][c] / safe;
    }
  }
}

template <int NCOL>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int n_heads, int n_kv_heads, int sq, int sk, int d,
           const long long* st, float scale, int causal, int window,
           cudaStream_t stream) {
  constexpr int bq = block_q(NCOL);
  const size_t smem = smem_bytes<NCOL>(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<NCOL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + bq - 1) / bq, n_heads, batch);
  flash_kernel<NCOL><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), n_heads,
      n_heads / n_kv_heads, sq, sk, d, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int ncol, const void* q, const void* k, const void* v, void* o,
             int batch, int n_heads, int n_kv_heads, int sq, int sk, int d,
             const long long* st, float scale, int causal, int window,
             cudaStream_t s) {
#define K5_CASE(N)                                                        \
  case N:                                                                 \
    return launch<N>(q, k, v, o, batch, n_heads, n_kv_heads, sq, sk, d,    \
                     st, scale, causal, window, s);
  switch (ncol) {
    K5_CASE(1) K5_CASE(2) K5_CASE(3) K5_CASE(4)
    K5_CASE(5) K5_CASE(6) K5_CASE(7) K5_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K5_CASE
}


// ---------------------------------------------------------------------------
// bf16: tensor-core kernel (mma.sync m16n8k16, ldmatrix, cp.async).
namespace tc {

constexpr int kThreads = 128;  // 4 warps, 16 query rows each
constexpr int kBq = 64;
constexpr int kBk = 64;
constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Row stride in elements of a (64 x DP) bf16 tile: 16 bytes of padding make
// the eight 16-byte rows read by one ldmatrix fall in distinct banks.
template <int DP>
__host__ __device__ constexpr int ld() { return DP + 8; }

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * 5 * static_cast<size_t>(kBq) * ld<DP>();
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Two neighbouring probabilities as bf16 pairs: hi = bf16(p), lo =
// bf16(p - hi).
__device__ __forceinline__ void split_bf16(float p0, float p1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(p0 - hf.x, p1 - hf.y);
}

// Stage rows [r0, r0 + 64) of a (rows x d) bf16 matrix with row stride
// `rs` into a zero-padded (64 x DP) tile. vec: 16-byte cp.async (d, the
// strides and the base are multiples of 8 elements); else plain loads.
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* src, int r0,
                                          int rows, int d, long long rs,
                                          bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kChunks = DP / 8;
    for (int e = tid; e < kBq * kChunks; e += kThreads) {
      const int r = e / kChunks, c = (e - r * kChunks) * 8;
      const bool ok = r0 + r < rows && c < d;
      cp_async16(tile + r * ld<DP>() + c,
                 ok ? src + (r0 + r) * rs + c : src, ok);
    }
  } else {
    for (int e = tid; e < kBq * DP; e += kThreads) {
      const int r = e / DP, c = e - r * DP;
      tile[r * ld<DP>() + c] = (r0 + r < rows && c < d)
                                   ? src[(r0 + r) * rs + c]
                                   : __float2bfloat16_rn(0.f);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int batch, int n_heads,
                int group, int sq, int sk, int d, long long qsb,
                long long qsh, long long qss, long long ksb, long long ksh,
                long long kss, long long vsb, long long vsh, long long vss,
                float scale, int causal, int window, int vec) {
  constexpr int L = ld<DP>();
  constexpr int kNt = DP / 8;  // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBq * L;      // 2 buffers
  __nv_bfloat16* vs = ks + 2 * kBk * L;  // 2 buffers

  // The heaviest causal q tiles are issued first: the q tile is the
  // slowest index of the grid, walked from the last tile down.
  const int nq = (sq + kBq - 1) / kBq;
  const int hb = n_heads * batch;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / hb;
  const int rem = static_cast<int>(blockIdx.x) % hb;
  const int h = rem % n_heads;
  const int b = rem / n_heads;
  const int q0 = qt * kBq;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + (h / group) * ksh;
  const __nv_bfloat16* vb = v + b * vsb + (h / group) * vsh;

  int k_hi = sk;
  if (causal) k_hi = min(sk, q0 + kBq);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  k_lo = (k_lo / kBk) * kBk;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBk - 1) / kBk : 0;

  load_tile<DP>(qs, qb, q0, sq, d, qss, vec);
  if (n_tiles > 0) {
    load_tile<DP>(ks, kb, k_lo, sk, d, kss, vec);
    load_tile<DP>(vs, vb, k_lo, sk, d, vss, vec);
  }
  cp_async_commit();

  float acc[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  const float sl2 = scale * kLog2e;  // logits in log2 units: exp2 = exp
  const int row0 = q0 + warp * 16 + g;  // and row0 + 8
  const __nv_bfloat16* qw = qs + (warp * 16) * L;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_lo + it * kBk;
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<DP>(ks + (buf ^ 1) * kBk * L, kb, k0 + kBk, sk, d, kss, vec);
      load_tile<DP>(vs + (buf ^ 1) * kBk * L, vb, k0 + kBk, sk, d, vss, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = ks + buf * kBk * L;
    const __nv_bfloat16* vt = vs + buf * kBk * L;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles in registers.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      unsigned a[4];
      ldsm_x4(a, qw + ((lane % 8) + 8 * ((lane / 8) % 2)) * L + kk * 16 +
                     8 * (lane / 16));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bk[4];
        ldsm_x4(bk, kt + (np * 16 + (lane % 8) + 8 * (lane / 16)) * L +
                        kk * 16 + 8 * ((lane / 8) % 2));
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // Mask (only on tiles that cross an edge of the band or of Sk), then
    // the online softmax on the fragments: each row lives in the 4 lanes
    // of one quad.
    const bool full = k0 + kBk <= sk &&
                      (!causal || k0 + kBk - 1 <= q0) &&
                      (window <= 0 || k0 > q0 + kBq - 1 - window);
    unsigned ok = 0xffffffffu;
    if (!full) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
          const int qp = row0 + 8 * (e >> 1);
          const bool in = kp < sk && (!causal || kp <= qp) &&
                          (window <= 0 || kp > qp - window);
          if (!in) ok &= ~(1u << (4 * j + e));
        }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = (ok >> (4 * j + e)) & 1u ? s[j][e] * sl2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (ok >> (4 * j + e)) & 1u
                            ? exp2f(s[j][e] - m[e >> 1]) : 0.f;
        s[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: the logits' accumulator fragments are the A fragments of
    // this product, split into two bf16 terms (p = hi + lo to about 2^-16)
    // and multiplied lo first; V^T fragments come by ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned ah[4], al[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int dn = 0; dn < DP / 16; ++dn) {
        unsigned bv[4];
        ldsm_x4_t(bv, vt + (kk * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * L +
                          dn * 16 + 8 * (lane / 16));
        mma_bf16(acc[2 * dn], al, bv[0], bv[1]);
        mma_bf16(acc[2 * dn + 1], al, bv[2], bv[3]);
        mma_bf16(acc[2 * dn], ah, bv[0], bv[1]);
        mma_bf16(acc[2 * dn + 1], ah, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const bool pairs = (d % 2) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    if (qp >= sq) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    __nv_bfloat16* orow =
        o + ((static_cast<long long>(b) * n_heads + h) * sq + qp) * d;
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      const int c = 8 * n + 2 * t4;
      const float v0 = acc[n][2 * r] * inv, v1 = acc[n][2 * r + 1] * inv;
      if (pairs && c + 1 < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (c < d) orow[c] = __float2bfloat16_rn(v0);
        if (c + 1 < d) orow[c + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int n_heads, int n_kv_heads, int sq, int sk, int d,
           const long long* st, float scale, int causal, int window, int vec,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>((sq + kBq - 1) / kBq) * n_heads * batch;
  flash_tc_kernel<DP><<<static_cast<unsigned>(blocks), kThreads, smem,
                        stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      batch, n_heads, n_heads / n_kv_heads, sq, sk, d, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], scale, causal, window, vec);
  return static_cast<int>(cudaGetLastError());
}

// D zero-padded to DP = 16 * ceil(D / 16).
int dispatch(const void* q, const void* k, const void* v, void* o,
             int batch, int n_heads, int n_kv_heads, int sq, int sk, int d,
             const long long* st, float scale, int causal, int window,
             cudaStream_t s) {
  bool vec = d % 8 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && st[i] % 8 == 0;
  const void* bases[3] = {q, k, v};
  for (const void* p : bases)
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
#define K5_TC_CASE(N)                                                       \
  case N:                                                                   \
    return launch<16 * N>(q, k, v, o, batch, n_heads, n_kv_heads, sq, sk, d, \
                          st, scale, causal, window, vec ? 1 : 0, s);
  switch ((d + 15) / 16) {
    K5_TC_CASE(1) K5_TC_CASE(2) K5_TC_CASE(3) K5_TC_CASE(4)
    K5_TC_CASE(5) K5_TC_CASE(6) K5_TC_CASE(7) K5_TC_CASE(8)
    K5_TC_CASE(9) K5_TC_CASE(10) K5_TC_CASE(11) K5_TC_CASE(12)
    K5_TC_CASE(13) K5_TC_CASE(14) K5_TC_CASE(15) K5_TC_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K5_TC_CASE
}

}  // namespace tc

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch((d + 31) / 32, q, k, v, o, batch, n_heads, n_kv_heads,
                    sq, sk, d, st, scale, causal, window, s);
  if (dtype == 1)
    return tc::dispatch(q, k, v, o, batch, n_heads, n_kv_heads, sq, sk, d, st,
                        scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
