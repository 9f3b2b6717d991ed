// Mamba-1 selective scan on Hopper (sm_90a).
//
// ssm_scan_fwd  replaces  src/repro/kernels/ssm_scan/kernel.py:ssm_scan
//   h_t[c,n] = exp(dt_t[c] * a[c,n]) * h_{t-1}[c,n] + (dt_t[c] * u_t[c]) * b_t[n]
//   y_t[c]   = sum_n c_t[n] * h_t[c,n] + d_skip[c] * u_t[c]
// per batch row, from h0 (zeros when it is null), and returns y in u's
// dtype and the final state h (B, D_in, N) in f32. The state stays f32 and
// y is rounded to u's dtype only after the skip term, as in the reference.
//
// Inputs are read where they lie: u (B, S, D_in) f32 or bf16, dt (B, S,
// D_in) f32, b and c (B, S, N) f32, a (D_in, N) f32 (already negative),
// d_skip (D_in) f32, h0 (B, D_in, N) f32 or null, all contiguous. Nothing
// is padded: ragged S and D_in are masked by bounds here; offsets are
// 64-bit.
//
// What bounds it. At the serving path's prefill shape (B 8, S 1024, D_in
// 8192, N 16): bytes 811 MB with f32 u and y (u and dt read, y written;
// 0.24 ms at 3.35 TB/s), 543 MB with bf16 (0.16 ms); 6.6e9 FLOP (0.10 ms
// at 67 TFLOP/s); and B * S * D_in * N = 1.07e9 exponentials, one MUFU.EX2
// each at 16 per clock per SM on 132 SMs: 0.26 ms at 1.98 GHz. The
// exponentials bound it. At decode (S = 1, h0 given) it is bytes: the
// state read and written (8.4 MB) with a, u, dt and y, 9.7 MB: 2.9 us.
//
// This first kernel is plain and right. Its design:
//   * one thread per (batch row, channel) walks time with its N states in
//     registers (what the TPU kernel kept in VMEM scratch across its
//     sequential time grid); a block is 128 channels of one batch row, so
//     the grid is (ceil(D_in / 128), B) and blocks share nothing;
//   * b_t and c_t are the same for every channel of a row: the block
//     stages kChunk time steps of them (contiguous in (B, S, N)) in shared
//     memory and every thread reads them as broadcasts;
//   * u_t and dt_t are read coalesced across the block's channels, the
//     next step's before this step's arithmetic;
//   * h0 and h_final pass through shared memory (row stride N + 1, no bank
//     conflicts), so the block's 128 x N contiguous floats are read and
//     written coalesced;
//   * the plain version's rounding, step for step: expf (not __expf,
//     whose error would also eat the reference's 2e-4 over a thousand
//     steps), products and sums rounded one by one (__fmul_rn, __fadd_rn:
//     nothing is contracted into an FMA) and c . h summed as the same
//     pairwise tree over the states, zero-padded to a power of two. So y
//     and h equal the plain version's on the card bit for bit, and a bf16
//     model does not drift from its plain path through 1-ulp flips of y
//     amplified over 64 layers.
//
// Plain C interface for ctypes; the entry point launches on the stream it
// is given and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kChunk = 64;      // time steps of b and c staged at once
constexpr int kMaxState = 32;   // the largest N an instance takes

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int NMAX>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ dskip,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ hout, int s, int d_in, int n) {
  __shared__ float bc_s[2][kChunk][NMAX];
  __shared__ float h_s[kThreads * (NMAX + 1)];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kThreads;
  const int ch = c0 + tid;
  const int64_t row = blockIdx.y;
  const bool live = ch < d_in;
  const int nch = min(kThreads, d_in - c0);   // channels of this block

  // the block's state slice h[row, c0:c0+nch, :] is contiguous
  const int64_t hbase = (row * d_in + c0) * n;
  if (h0 != nullptr) {
    for (int i = tid; i < nch * n; i += kThreads)
      h_s[(i / n) * (NMAX + 1) + i % n] = h0[hbase + i];
    __syncthreads();
  }
  float h[NMAX], av[NMAX];
#pragma unroll
  for (int k = 0; k < NMAX; ++k) {
    const bool on = live && k < n;
    h[k] = (on && h0 != nullptr) ? h_s[tid * (NMAX + 1) + k] : 0.f;
    av[k] = on ? a[(int64_t)ch * n + k] : 0.f;
  }
  const float dsk = live ? dskip[ch] : 0.f;

  const int64_t xbase = row * (int64_t)s * d_in + ch;   // u, dt, y at t = 0
  const int64_t bcbase = row * (int64_t)s * n;          // b, c at t = 0
  float u_next = 0.f, dt_next = 0.f;
  if (live) {
    u_next = to_f32(u[xbase]);
    dt_next = dt[xbase];
  }
  for (int t0 = 0; t0 < s; t0 += kChunk) {
    const int steps = min(kChunk, s - t0);
    __syncthreads();                 // the previous chunk has been read
    for (int i = tid; i < steps * n; i += kThreads) {
      const int64_t at = bcbase + (int64_t)t0 * n + i;
      bc_s[0][i / n][i % n] = bm[at];
      bc_s[1][i / n][i % n] = cm[at];
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < steps; ++tt) {
      const int64_t off = xbase + (int64_t)(t0 + tt) * d_in;
      const float ut = u_next, dtt = dt_next;
      if (t0 + tt + 1 < s) {
        u_next = to_f32(u[off + d_in]);
        dt_next = dt[off + d_in];
      }
      const float du = __fmul_rn(dtt, ut);
      float p[NMAX];                 // c_t[n] * h_t[n], zero past n
#pragma unroll
      for (int k = 0; k < NMAX; ++k) {
        p[k] = 0.f;
        if (k < n) {
          const float decay = expf(__fmul_rn(dtt, av[k]));
          h[k] = __fadd_rn(__fmul_rn(h[k], decay),
                           __fmul_rn(du, bc_s[0][tt][k]));
          p[k] = __fmul_rn(h[k], bc_s[1][tt][k]);
        }
      }
#pragma unroll
      for (int w = NMAX / 2; w >= 1; w /= 2)     // the plain version's tree
#pragma unroll
        for (int k = 0; k < w; ++k) p[k] = __fadd_rn(p[k], p[k + w]);
      store(y + off, __fadd_rn(p[0], __fmul_rn(dsk, ut)));
    }
  }

  __syncthreads();                   // h_s is free again
  if (live) {
#pragma unroll
    for (int k = 0; k < NMAX; ++k)
      if (k < n) h_s[tid * (NMAX + 1) + k] = h[k];
  }
  __syncthreads();
  for (int i = tid; i < nch * n; i += kThreads)
    hout[hbase + i] = h_s[(i / n) * (NMAX + 1) + i % n];
}

template <typename T, int NMAX>
int launch(const void* u, const void* dt, const void* b, const void* c,
           const void* a, const void* dskip, const void* h0, void* y,
           void* hout, int batch, int s, int d_in, int n,
           cudaStream_t stream) {
  const dim3 grid((unsigned)((d_in + kThreads - 1) / kThreads),
                  (unsigned)batch);
  ssm_scan_kernel<T, NMAX><<<grid, kThreads, 0, stream>>>(
      (const T*)u, (const float*)dt, (const float*)b, (const float*)c,
      (const float*)a, (const float*)dskip, (const float*)h0, (T*)y,
      (float*)hout, s, d_in, n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* u, const void* dt, const void* b, const void* c,
             const void* a, const void* dskip, const void* h0, void* y,
             void* hout, int batch, int s, int d_in, int n,
             cudaStream_t stream) {
  if (n <= 4)
    return launch<T, 4>(u, dt, b, c, a, dskip, h0, y, hout, batch, s, d_in,
                        n, stream);
  if (n <= 8)
    return launch<T, 8>(u, dt, b, c, a, dskip, h0, y, hout, batch, s, d_in,
                        n, stream);
  if (n <= 16)
    return launch<T, 16>(u, dt, b, c, a, dskip, h0, y, hout, batch, s,
                         d_in, n, stream);
  return launch<T, kMaxState>(u, dt, b, c, a, dskip, h0, y, hout, batch, s,
                              d_in, n, stream);
}

}  // namespace

extern "C" {

// u (batch, s, d_in) of dtype 0 = f32 or 1 = bf16; dt (batch, s, d_in),
// b and c (batch, s, n), a (d_in, n), dskip (d_in), h0 (batch, d_in, n) or
// null, all f32 and contiguous -> y (batch, s, d_in) of u's dtype and hout
// (batch, d_in, n) f32. 1 <= n <= kMaxState (32).
int ssm_scan_fwd(const void* u, const void* dt, const void* b, const void* c,
                 const void* a, const void* dskip, const void* h0, void* y,
                 void* hout, int dtype, int batch, int s, int d_in, int n,
                 void* stream) {
  if (batch < 1 || batch > 65535 || s < 1 || d_in < 1 || n < 1 ||
      n > kMaxState)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(u, dt, b, c, a, dskip, h0, y, hout, batch, s,
                           d_in, n, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(u, dt, b, c, a, dskip, h0, y, hout, batch,
                                   s, d_in, n, st);
  return (int)cudaErrorInvalidValue;
}

const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
