// Mamba-2 SSD chunked scan, ngroups = 1 (K6).
//
// Replaces the Pallas kernel `ssd` in src/repro/kernels/ssd.py, the
// state-space core of every Mamba-2 layer's full-sequence pass. The
// recurrence
//     h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T,   y_t = C_t h_t + d x_t
// is evaluated chunk by chunk: inside a chunk of Q steps in its dual
// (attention-like) form, across chunks through the (N, P) state alone.
// Per chunk, with s the inclusive cumsum of dt*a:
//     G = C B^T                                  (shared by every head)
//     W = G o exp(s_i - s_j) o dt_j o [j <= i]   (per head)
//     y = W x + exp(s) o (C h) + d x
//     h = exp(s_last) h + (B o u)^T x,   u_j = exp(s_last - s_j) dt_j
//
// Bound on the H100 at one zamba2 layer (B=8, S=512, H=80, P=N=Q=64):
// 182 MB of f32 in and out, 0.054 ms at 3.35 TB/s; the products, as this
// kernel runs them (three TF32 products per f32 product, 495/3 TFLOP/s),
// 0.049 ms. On the CUDA cores in f32 the operations alone take 0.121 ms.
// The design follows:
//
// - Head groups. One block of 8 warps per (group of HG heads, batch row)
//   walks the chunks in order. Each chunk's B, C and dt are loaded once
//   for the group and G = C B^T is computed once (it was recomputed by
//   every head); then each head of the group in turn builds its W and
//   runs its three products. HG is 3 up to N = 64 and 2 above (the
//   states of the group's heads live in registers, and more would spill);
//   H need not be a multiple of it (the last group is partial). Each
//   head's (N, P) state stays in registers as mma accumulator fragments
//   from chunk to chunk, staged in shared memory only as the B operand of
//   C h.
// - Tensor cores at f32 accuracy ("3xTF32"). mma.sync m16n8k8 TF32 with
//   f32 accumulators; every f32 operand v is split v = hi + lo (hi: v
//   rounded to TF32; lo = v - hi, exact, whose own low bits the tensor
//   core does not read), and lo*hi + hi*lo + hi*hi is summed in a fixed
//   order: about 2^-21 relative per product, where one TF32 rounding of
//   W, h or B o u (2^-11) misses the 2e-4 tolerance. The split assumes
//   nothing of the inputs (they are full f32 in tests).
// - Overlap by occupancy. Shared memory holds one buffer per tile (about
//   110 KB at N = 64) and registers are capped at 128, so two blocks share
//   an SM: the next tile is fetched by cp.async (16-byte where N, P and
//   the bases allow, else 4-byte, zero-filled past S, N and P) as soon as
//   its buffer is free, and the other block computes while it lands.
//
// All exponents are <= 0 (a < 0, dt >= 0), and the mask is applied before
// the exponential. Rows past S load as zeros (dt = 0, x = B = C = 0): they
// decay by exp(0) = 1 and add 0, so a ragged tail is a padded chunk and the
// final state is unchanged; their y rows are not written. The final state
// is written when asked. No atomics: two runs are bit-identical.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;       // max chunk and P; rows of a state block
constexpr int kLx = kT + 8;  // row stride of x and the staged state
constexpr int kLw = kT + 4;  // row stride of G and W
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Shared memory in floats, in this order: B and C (2 x kT x lb, lb =
// nk + 4), x (kT x kLx), G and W (kT x kLw each), the staged state
// (NB*kT x kLx), dt, s, u, e (HG x kT each).
__host__ __device__ inline int smem_floats(int nk, int nb, int hg) {
  return 2 * kT * (nk + 4) + kT * kLx + 2 * kT * kLw + nb * kT * kLx +
         4 * hg * kT;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// v = hi + lo: hi is v rounded to TF32 (half an ulp added to the 13 low
// mantissa bits, which are then cleared: nearest, ties away from zero, for
// finite v below the largest TF32), lo = v - hi exactly. lo goes to the
// tensor core as it is: a TF32 operand's low 13 bits are not read, so lo
// is truncated there, within 2^-21 |v| of the rest. Three instructions:
// cvt.rna.tf32.f32 is emulated by several integer ones on sm_90.
__device__ __forceinline__ uint2 split_tf32(float v) {
  const unsigned hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  return make_uint2(hi, __float_as_uint(v - __uint_as_float(hi)));
}

// c += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (this warp's 16 x 32 tile at rows m0, columns n0, as 4 m16n8
// fragments) += A (16 x k_end) B (k_end x 32) in 3xTF32: lo*hi + hi*lo +
// hi*hi, in that order. fa(row, k) and fb(k, col) return an operand's
// (hi, lo) split as it is read from shared memory.
template <typename FA, typename FB>
__device__ __forceinline__ void mma3(float (&acc)[4][4], int k_end, int m0,
                                     int n0, FA fa, FB fb) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll 2
  for (int k0 = 0; k0 < k_end; k0 += 8) {
    const uint2 a0 = fa(m0 + g, k0 + t), a1 = fa(m0 + g + 8, k0 + t);
    const uint2 a2 = fa(m0 + g, k0 + t + 4), a3 = fa(m0 + g + 8, k0 + t + 4);
    const unsigned ah[4] = {a0.x, a1.x, a2.x, a3.x};
    const unsigned al[4] = {a0.y, a1.y, a2.y, a3.y};
    uint2 b[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j][0] = fb(k0 + t, n0 + 8 * j + g);
      b[j][1] = fb(k0 + t + 4, n0 + 8 * j + g);
    }
    // Four independent accumulators per term, so that the three dependent
    // products of one fragment do not issue back to back.
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(acc[j], al, b[j][0].x, b[j][1].x);
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(acc[j], ah, b[j][0].y, b[j][1].y);
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(acc[j], ah, b[j][0].x, b[j][1].x);
  }
}

// Blocks per SM the launch asks registers for: two up to N = 64 (each
// block's shared memory is about 110 KB there), one above.
template <int NB>
constexpr int min_blocks() { return NB == 1 ? 2 : 1; }

template <int NB, int HG>
__global__ void __launch_bounds__(kThreads, min_blocks<NB>())
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const float* __restrict__ bm,
           const float* __restrict__ cm, const float* __restrict__ dskip,
           float* __restrict__ y, float* __restrict__ state_out, int seq,
           int n_heads, int p_dim, int n_dim, int chunk, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int nk = round_up(n_dim, 16);  // K of G and C h; rows of h used
  const int lb = nk + 4;               // row stride of B and C
  float* bsm = smem;                   // [kT][lb]
  float* csm = bsm + kT * lb;          // [kT][lb]
  float* xs = csm + kT * lb;           // [kT][kLx]
  float* gs = xs + kT * kLx;           // [kT][kLw]
  float* ws = gs + kT * kLw;           // [kT][kLw]
  float* hst = ws + kT * kLw;          // [NB*kT][kLx]
  float* dtv = hst + NB * kT * kLx;    // [HG][kT]
  float* sv = dtv + HG * kT;           // [HG][kT]
  float* uv = sv + HG * kT;
  float* ev = uv + HG * kT;

  const int h0 = blockIdx.x * HG;
  const int nh = min(HG, n_heads - h0);
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  // Warp tile of every 64 x 64 product: 16 rows x 32 columns. Warps w and
  // w + 4 share a scheduler; pairing m-tiles w and 3 - w evens out the
  // triangular W x.
  const int mt = warp < 4 ? warp : 7 - warp;
  const int m0 = 16 * mt, n0 = 32 * (warp / 4);
  const long long hpd = static_cast<long long>(n_heads) * p_dim;
  const int n_chunks = (seq + chunk - 1) / chunk;

  auto load_bc = [&](int c) {
    const int t0 = c * chunk;
    if (vec) {
      const int per = nk / 4;
      for (int e = tid; e < 2 * kT * per; e += kThreads) {
        const int which = e / (kT * per), r = (e / per) % kT;
        const int n = (e % per) * 4;
        const int t = t0 + r;
        const bool ok = r < chunk && t < seq && n < n_dim;
        const float* base = which ? cm : bm;
        cp_async16(bsm + (which * kT + r) * lb + n,
                   ok ? base + (static_cast<long long>(b) * seq + t) * n_dim + n
                      : base,
                   ok);
      }
    } else {
      for (int e = tid; e < 2 * kT * nk; e += kThreads) {
        const int which = e / (kT * nk), r = (e / nk) % kT, n = e % nk;
        const int t = t0 + r;
        const bool ok = r < chunk && t < seq && n < n_dim;
        const float* base = which ? cm : bm;
        cp_async4(bsm + (which * kT + r) * lb + n,
                  ok ? base + (static_cast<long long>(b) * seq + t) * n_dim + n
                     : base,
                  ok);
      }
    }
    for (int e = tid; e < HG * kT; e += kThreads) {
      const int hh = e / kT, r = e % kT;
      const int t = t0 + r;
      const bool ok = hh < nh && r < chunk && t < seq;
      cp_async4(dtv + hh * kT + r,
                ok ? dt + (static_cast<long long>(b) * seq + t) * n_heads +
                         h0 + hh
                   : dt,
                ok);
    }
  };
  auto load_x = [&](int c, int h) {
    const int t0 = c * chunk;
    if (vec) {
      for (int e = tid; e < kT * (kT / 4); e += kThreads) {
        const int r = e / (kT / 4), p = (e % (kT / 4)) * 4;
        const int t = t0 + r;
        const bool ok = r < chunk && t < seq && p < p_dim;
        cp_async16(xs + r * kLx + p,
                   ok ? x + (static_cast<long long>(b) * seq + t) * hpd +
                            static_cast<long long>(h) * p_dim + p
                      : x,
                   ok);
      }
    } else {
      for (int e = tid; e < kT * kT; e += kThreads) {
        const int r = e / kT, p = e % kT;
        const int t = t0 + r;
        const bool ok = r < chunk && t < seq && p < p_dim;
        cp_async4(xs + r * kLx + p,
                  ok ? x + (static_cast<long long>(b) * seq + t) * hpd +
                           static_cast<long long>(h) * p_dim + p
                     : x,
                  ok);
      }
    }
  };
  auto split_at = [](const float* m, int ld) {
    return [=](int r, int k) { return split_tf32(m[r * ld + k]); };
  };

  float state[HG][NB][4][4];
#pragma unroll
  for (int hh = 0; hh < HG; ++hh)
#pragma unroll
    for (int rb = 0; rb < NB; ++rb)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) state[hh][rb][j][e] = 0.f;

  // Each tile has one buffer: the next one is fetched as soon as its
  // buffer is free, and the other block on the SM computes meanwhile.
  load_bc(0);
  load_x(0, h0);
  cp_async_commit();

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * chunk;
    const int k_chunk = round_up(chunk, 8);
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      if (hh >= nh) break;
      if (hh == 0) {
        cp_async_wait_all();
        __syncthreads();  // this chunk's B, C, dt and first x landed
        // Per head: inclusive scan of dt*a over the 64 rows, then u and e.
        if (warp < nh) {
          const float ah = a[h0 + warp];
          const float* dw = dtv + warp * kT;
          float v0 = dw[lane] * ah, v1 = dw[lane + 32] * ah;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const float n0v = __shfl_up_sync(kFull, v0, off);
            const float n1v = __shfl_up_sync(kFull, v1, off);
            if (lane >= off) {
              v0 += n0v;
              v1 += n1v;
            }
          }
          v1 += __shfl_sync(kFull, v0, 31);
          float* sw = sv + warp * kT;
          sw[lane] = v0;
          sw[lane + 32] = v1;
          __syncwarp();
          const float s_last = sw[chunk - 1];
          uv[warp * kT + lane] = expf(s_last - v0) * dw[lane];
          uv[warp * kT + lane + 32] = expf(s_last - v1) * dw[lane + 32];
          ev[warp * kT + lane] = expf(v0);
          ev[warp * kT + lane + 32] = expf(v1);
        }
        // G = C B^T, once for the group.
        float acc[4][4] = {};
        mma3(acc, nk, m0, n0, split_at(csm, lb),
             [&](int n, int j) { return split_tf32(bsm[j * lb + n]); });
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* gr = gs + (m0 + g) * kLw + n0 + 8 * j + 2 * t4;
          gr[0] = acc[j][0];
          gr[1] = acc[j][1];
          gr[8 * kLw] = acc[j][2];
          gr[8 * kLw + 1] = acc[j][3];
        }
        __syncthreads();
      }

      // This head's W (masked before the exponential), and its state
      // staged as the B operand of C h; meanwhile its x tile lands.
      const float* sh = sv + hh * kT;
      const float* dh = dtv + hh * kT;
      for (int e = tid; e < kT * kT; e += kThreads) {
        const int i = e / kT, j = e % kT;
        ws[i * kLw + j] =
            j <= i ? gs[i * kLw + j] * __expf(sh[i] - sh[j]) * dh[j] : 0.f;
      }
#pragma unroll
      for (int rb = 0; rb < NB; ++rb)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* hr = hst + (rb * kT + m0 + g) * kLx + n0 + 8 * j + 2 * t4;
          hr[0] = state[hh][rb][j][0];
          hr[1] = state[hh][rb][j][1];
          hr[8 * kLx] = state[hh][rb][j][2];
          hr[8 * kLx + 1] = state[hh][rb][j][3];
        }
      cp_async_wait_all();
      __syncthreads();

      // y = exp(s) o (C h) + W x + d x, in one accumulator.
      const float* eh = ev + hh * kT;
      float acc[4][4] = {};
      mma3(acc, nk, m0, n0, split_at(csm, lb), split_at(hst, kLx));
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= eh[m0 + g + 8 * (e / 2)];
      mma3(acc, 16 * (mt + 1), m0, n0, split_at(ws, kLw), split_at(xs, kLx));
      const int h = h0 + hh;
      const float d_h = dskip[h];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = m0 + g + 8 * r;
        const int t = t0 + i;
        if (i >= chunk || t >= seq) continue;
        float* yrow = y + (static_cast<long long>(b) * seq + t) * hpd +
                      static_cast<long long>(h) * p_dim;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int p = n0 + 8 * j + 2 * t4 + q;
            if (p < p_dim)
              yrow[p] = acc[j][2 * r + q] + d_h * xs[i * kLx + p];
          }
      }

      // h = exp(s_last) h + (B o u)^T x, in the registers that hold h.
      const float decay = expf(sh[chunk - 1]);
      const float* uh = uv + hh * kT;
#pragma unroll
      for (int rb = 0; rb < NB; ++rb) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) state[hh][rb][j][e] *= decay;
        if (rb * kT + m0 < nk)
          mma3(state[hh][rb], k_chunk, rb * kT + m0, n0,
               [&](int n, int j) { return split_tf32(bsm[j * lb + n] * uh[j]); },
               split_at(xs, kLx));
      }
      __syncthreads();  // x, W and the staged state are free
      if (hh + 1 < nh) {
        load_x(c, h0 + hh + 1);
        cp_async_commit();
      } else if (c + 1 < n_chunks) {  // and B, C, dt of this chunk
        load_bc(c + 1);
        load_x(c + 1, h0);
        cp_async_commit();
      }
    }
  }

  if (state_out != nullptr) {
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      if (hh >= nh) break;
      float* sb = state_out + (static_cast<long long>(b) * n_heads + h0 + hh) *
                                  n_dim * p_dim;
#pragma unroll
      for (int rb = 0; rb < NB; ++rb)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = rb * kT + m0 + g + 8 * (e / 2);
            const int p = n0 + 8 * j + 2 * t4 + e % 2;
            if (n < n_dim && p < p_dim)
              sb[n * p_dim + p] = state[hh][rb][j][e];
          }
    }
  }
}

struct Args {
  const float *x, *dt, *a, *b, *c, *d;
  float *y, *state_out;
  int batch, seq, n_heads, p_dim, n_dim, chunk, vec;
};

// Heads per block: their states live in registers, and more spill.
template <int NB>
constexpr int head_group() { return NB == 1 ? 3 : 2; }

template <int NB>
int launch(const Args& g, cudaStream_t stream) {
  constexpr int HG = head_group<NB>();
  // The instantiation's shared-memory limit is raised once per device to
  // the most any N it takes needs.
  static int ready_dev = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && ready_dev != dev) {
    err = cudaFuncSetAttribute(
        ssd_kernel<NB, HG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * smem_floats(NB * kT, NB, HG)));
    if (err == cudaSuccess) ready_dev = dev;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      sizeof(float) * smem_floats(round_up(g.n_dim, 16), NB, HG);
  dim3 grid((g.n_heads + HG - 1) / HG, g.batch);
  ssd_kernel<NB, HG><<<grid, kThreads, smem, stream>>>(
      g.x, g.dt, g.a, g.b, g.c, g.d, g.y, g.state_out, g.seq, g.n_heads,
      g.p_dim, g.n_dim, g.chunk, g.vec);
  return static_cast<int>(cudaGetLastError());
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
      n_dim > 2 * kT || n_heads < 1 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n_dim % 4 == 0 && p_dim % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  const Args g{x, dt, a, b, c, d, y, state_out, batch, seq, n_heads, p_dim,
               n_dim, chunk, vec ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n_dim <= kT ? launch<1>(g, s) : launch<2>(g, s);
}
