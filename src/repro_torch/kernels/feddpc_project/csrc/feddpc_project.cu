// FedDPC's server step on Hopper (sm_90a): the reduction pass and the
// whole-cohort epilogue over a flat (K, N) f32 stack of client deltas.
//
// feddpc_dots  replaces src/repro/kernels/feddpc_project/kernel.py:fused_dots
//   For every client row j: <d_j, p>, <d_j, d_j> and <p, p>, as per-block
//   partials (K, G, 3); the caller sums over G (one small reduction), as
//   the reference sums its (G, 3) partials outside the kernel.
//
// feddpc_batched_epilogue  replaces
//   src/repro/kernels/feddpc_project/kernel.py:batched_epilogue
//   dt = mean_j scale_j * (d_j - coef_j * p);  w' = w - eta_g * dt.
//
// Both are bound by HBM bytes: a few flops per element against 4 bytes
// read, far below the card's ~20 flops per byte of f32 ridge. So each
// moves only what it must:
//   * one block owns a tile of columns and walks ALL K rows for it, so
//     p (and w) are read once — not once per client — and each delta row
//     is read exactly once;
//   * sums stay in registers (warp shuffles, then a small shared-memory
//     step for the cross-warp sum); no intermediate goes to HBM, and the
//     dots write only K * G * 3 partials;
//   * no atomics: every sum has a fixed order, so results repeat bitwise
//     from run to run;
//   * the ragged tail (N arbitrary) is masked here — no (M, 128) padding
//     as on the TPU.
// coefs and scales are device pointers, so the reduction pass, the scalar
// math and the epilogue queue on one stream with no host sync between.
//
// Plain C interface for ctypes; every entry point launches on the stream
// it is given and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                 // columns per thread
constexpr int kTile = kThreads * kItems;  // columns per block
constexpr int kRowChunk = 32;             // rows per shared-memory round

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
dots_kernel(const float* __restrict__ d, const float* __restrict__ p,
            float* __restrict__ out, int64_t k, int64_t n) {
  __shared__ float red[kRowChunk][kWarps][2];
  __shared__ float red_pp[kWarps];
  const int64_t g = blockIdx.x;
  const int64_t nblocks = gridDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // thread t owns columns col0 + i * kThreads: neighbouring threads read
  // neighbouring addresses
  const int64_t col0 = g * kTile + threadIdx.x;

  float pv[kItems];
  float pp = 0.f;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t c = col0 + (int64_t)i * kThreads;
    pv[i] = c < n ? __ldg(p + c) : 0.f;
    pp = fmaf(pv[i], pv[i], pp);
  }
  pp = warp_sum(pp);
  if (lane == 0) red_pp[warp] = pp;

  for (int64_t j0 = 0; j0 < k; j0 += kRowChunk) {
    const int rows = (k - j0) < kRowChunk ? (int)(k - j0) : kRowChunk;
    for (int r = 0; r < rows; ++r) {
      const float* dj = d + (j0 + r) * n;
      float dp = 0.f, dd = 0.f;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int64_t c = col0 + (int64_t)i * kThreads;
        const float dv = c < n ? __ldg(dj + c) : 0.f;
        dp = fmaf(dv, pv[i], dp);
        dd = fmaf(dv, dv, dd);
      }
      dp = warp_sum(dp);
      dd = warp_sum(dd);
      if (lane == 0) {
        red[r][warp][0] = dp;
        red[r][warp][1] = dd;
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < rows * 3; t += kThreads) {
      const int r = t / 3;
      const int col = t % 3;
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += col < 2 ? red[r][w][col] : red_pp[w];
      out[((j0 + r) * nblocks + g) * 3 + col] = s;
    }
    __syncthreads();  // red is reused by the next chunk of rows
  }
}

__global__ void __launch_bounds__(kThreads)
epilogue_kernel(const float* __restrict__ d, const float* __restrict__ p,
                const float* __restrict__ w,
                const float* __restrict__ coefs,
                const float* __restrict__ scales, float eta_g,
                float* __restrict__ w_out, float* __restrict__ dt_out,
                int64_t k, int64_t n) {
  const int64_t col0 = (int64_t)blockIdx.x * kTile + threadIdx.x;
  float pv[kItems];
  float acc[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t c = col0 + (int64_t)i * kThreads;
    pv[i] = c < n ? __ldg(p + c) : 0.f;
    acc[i] = 0.f;
  }
  // the _rn intrinsics keep nvcc from contracting into FMAs, so each
  // element rounds as the plain version's separate ops do; the sum over
  // j runs in row order
  for (int64_t j = 0; j < k; ++j) {
    const float cj = __ldg(coefs + j);
    const float sj = __ldg(scales + j);
    const float* dj = d + j * n;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t c = col0 + (int64_t)i * kThreads;
      if (c < n) {
        const float r = __fsub_rn(__ldg(dj + c), __fmul_rn(cj, pv[i]));
        acc[i] = __fadd_rn(acc[i], __fmul_rn(sj, r));
      }
    }
  }
  const float kf = (float)k;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t c = col0 + (int64_t)i * kThreads;
    if (c < n) {
      const float dt = __fdiv_rn(acc[i], kf);
      dt_out[c] = dt;
      w_out[c] = __fsub_rn(__ldg(w + c), __fmul_rn(eta_g, dt));
    }
  }
}

}  // namespace

extern "C" {

int64_t feddpc_num_blocks(int64_t n) { return (n + kTile - 1) / kTile; }

// d (k, n), p (n,) -> out (k, feddpc_num_blocks(n), 3) partials
int feddpc_dots(const void* d, const void* p, void* out, int64_t k, int64_t n,
                void* stream) {
  if (k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  dots_kernel<<<(unsigned)feddpc_num_blocks(n), kThreads, 0,
                (cudaStream_t)stream>>>(
      (const float*)d, (const float*)p, (float*)out, k, n);
  return (int)cudaGetLastError();
}

// d (k, n), p, w (n,), coefs, scales (k,) -> w_out, dt_out (n,); outputs
// must not alias the inputs
int feddpc_batched_epilogue(const void* d, const void* p, const void* w,
                            const void* coefs, const void* scales,
                            float eta_g, void* w_out, void* dt_out, int64_t k,
                            int64_t n, void* stream) {
  if (k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  epilogue_kernel<<<(unsigned)feddpc_num_blocks(n), kThreads, 0,
                    (cudaStream_t)stream>>>(
      (const float*)d, (const float*)p, (const float*)w,
      (const float*)coefs, (const float*)scales, eta_g, (float*)w_out,
      (float*)dt_out, k, n);
  return (int)cudaGetLastError();
}

const char* feddpc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
