// FedDPC's server step on Hopper (sm_90a): the reduction pass and the
// four server folds over a flat (K, N) stack of client deltas (K = B
// buffered arrivals in the async regime).
//
// feddpc_dots  replaces src/repro/kernels/feddpc_project/kernel.py:fused_dots
//   For every client row j: <d_j, p>, <d_j, d_j> and <p, p>, as per-block
//   partials (K, G, 3); the caller sums over G (one small reduction), as
//   the reference sums its (G, 3) partials outside the kernel.
//
// feddpc_guard_dots  replaces kernel.py:guard_dots
//   the same pass for the update guard: the dots on d with its non-finite
//   entries zeroed, plus the count of those entries, as (K, G, 4)
//   partials. Without p (the guard's route: it needs only ||d~||^2 and
//   the count) p is not read and columns 0 and 2 are 0.
//
// feddpc_batched_epilogue  replaces
//   src/repro/kernels/feddpc_project/kernel.py:batched_epilogue
//   dt = mean_j scale_j * (d_j - coef_j * p);  w' = w - eta_g * dt.
//
// feddpc_buffer_fold  replaces kernel.py:buffer_fold
//   the same with scale_j * wgt_j: the buffered-async fold, wgt_j the
//   staleness discount (1+s_j)^(-alpha).
//
// feddpc_dequant_batched_epilogue, feddpc_dequant_buffer_fold  replace
//   kernel.py:dequant_batched_epilogue and kernel.py:dequant_buffer_fold
//   the two folds reading the codec's int8 or bf16 payload q with
//   d_j = q_j * qscale[j, leaf] + qzero[j, leaf], one (scale, zero) pair
//   per client and parameter leaf; the f32 deltas never reach HBM.
//
// feddpc_fused_epilogue  replaces kernel.py:fused_epilogue
//   one client's epilogue, out = scale * (d - coef * p), cast to d's type
//   (f32 or bf16; p f32) — projection.project_and_scale's second pass.
//
// The two reduction passes are one templated kernel (guard column or
// not), the four folds another (payload type, dequant, weights). All
// seven kernels are bound by HBM bytes: a few flops per element against 4 bytes
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                 // columns per thread
constexpr int kTile = kThreads * kItems;  // columns per block
constexpr int kRowChunk = 32;             // rows per shared-memory round
constexpr int64_t kMaxLeaves = 6143;      // (L+1) offsets in 48 KB of smem

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The reduction pass. kGuard adds the update guard's column: non-finite
// entries of d count (in integers, per thread, then per warp and block:
// a block's count is at most kTile, so its f32 partial is exact, and so
// are the caller's sums over G for any N below 2^24) and are zeroed
// before they enter the dots. p == nullptr (kGuard only) reads no p:
// every p value is 0, so columns 0 and 2 come out 0.
template <bool kGuard>
__global__ void __launch_bounds__(kThreads)
dots_kernel(const float* __restrict__ d, const float* __restrict__ p,
            float* __restrict__ out, int64_t k, int64_t n) {
  constexpr int kCols = kGuard ? 4 : 3;
  __shared__ float red[kRowChunk][kWarps][2];
  __shared__ int red_nf[kGuard ? kRowChunk : 1][kWarps];
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
    pv[i] = (c < n && (!kGuard || p != nullptr)) ? __ldg(p + c) : 0.f;
    pp = fmaf(pv[i], pv[i], pp);
  }
  pp = warp_sum(pp);
  if (lane == 0) red_pp[warp] = pp;

  for (int64_t j0 = 0; j0 < k; j0 += kRowChunk) {
    const int rows = (k - j0) < kRowChunk ? (int)(k - j0) : kRowChunk;
    for (int r = 0; r < rows; ++r) {
      const float* dj = d + (j0 + r) * n;
      float dp = 0.f, dd = 0.f;
      int nf = 0;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int64_t c = col0 + (int64_t)i * kThreads;
        float dv = c < n ? __ldg(dj + c) : 0.f;
        if constexpr (kGuard) {
          // non-finite: all exponent bits set (Inf or NaN)
          const bool bad =
              (__float_as_uint(dv) & 0x7f800000u) == 0x7f800000u;
          nf += bad;
          dv = bad ? 0.f : dv;
        }
        dp = fmaf(dv, pv[i], dp);
        dd = fmaf(dv, dv, dd);
      }
      dp = warp_sum(dp);
      dd = warp_sum(dd);
      if constexpr (kGuard) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          nf += __shfl_xor_sync(0xffffffffu, nf, o);
      }
      if (lane == 0) {
        red[r][warp][0] = dp;
        red[r][warp][1] = dd;
        if constexpr (kGuard) red_nf[r][warp] = nf;
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < rows * kCols; t += kThreads) {
      const int r = t / kCols;
      const int col = t % kCols;
      float s = 0.f;
      if (col == 3) {
        int cnt = 0;
        for (int w = 0; w < kWarps; ++w) cnt += red_nf[kGuard ? r : 0][w];
        s = (float)cnt;
      } else {
        for (int w = 0; w < kWarps; ++w)
          s += col < 2 ? red[r][w][col] : red_pp[w];
      }
      out[((j0 + r) * nblocks + g) * kCols + col] = s;
    }
    __syncthreads();  // red is reused by the next chunk of rows
  }
}

// One column of a payload row as f32: the f32 stack as it is; int8 and
// bf16 codes converted exactly (the codec's dequant then applies the
// leaf's scale and zero-point).
__device__ __forceinline__ float load_value(const float* __restrict__ row,
                                            int64_t c) {
  return __ldg(row + c);
}
__device__ __forceinline__ float load_value(const int8_t* __restrict__ row,
                                            int64_t c) {
  return (float)row[c];
}
__device__ __forceinline__ float load_value(
    const __nv_bfloat16* __restrict__ row, int64_t c) {
  return __bfloat162float(row[c]);
}

// The fold behind all four epilogues:
//   dt = (1/K) sum_j s_j * (d_j - coef_j * p),   w' = w - eta_g * dt
// with s_j = wgt_j * scale_j when kWeighted (the staleness discount
// multiplies the adaptive scale; coef_j stays raw), and, when kDequant,
// d_j = q_j * qscale[j, leaf] + qzero[j, leaf] for the leaf that owns
// the column. The sum over j runs in row order and ends in one division
// by K — the order of the plain versions in ref.py (scales * wgts, then
// a mean), not the reference kernel's per-arrival multiply by 1/B.
// The _rn intrinsics keep nvcc from contracting into FMAs, so each
// element rounds as the plain version's separate ops do.
//
// Leaf lookup on the flat layout: a 2,048-column tile can span several
// leaves (ResNet18-GN's GroupNorm leaves hold 64 elements). The (L+1)
// leaf offsets sit in shared memory; each thread finds the leaf of its
// first column by binary search and walks forward, since its columns
// col0 + i * kThreads increase. qscale and qzero, (K, L) f32, are read
// through the read-only cache: a few KB that stay in L1/L2.
template <typename T, bool kDequant, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const T* __restrict__ d, const float* __restrict__ qscale,
            const float* __restrict__ qzero,
            const int64_t* __restrict__ offsets, int nleaves,
            const float* __restrict__ p, const float* __restrict__ w,
            const float* __restrict__ coefs,
            const float* __restrict__ scales,
            const float* __restrict__ wgts, float eta_g,
            float* __restrict__ w_out, float* __restrict__ dt_out,
            int64_t k, int64_t n) {
  extern __shared__ int64_t s_off[];  // nleaves + 1 offsets (kDequant)
  const int64_t col0 = (int64_t)blockIdx.x * kTile + threadIdx.x;
  float pv[kItems];
  float acc[kItems];
  int leaf[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t c = col0 + (int64_t)i * kThreads;
    pv[i] = c < n ? __ldg(p + c) : 0.f;
    acc[i] = 0.f;
    leaf[i] = 0;
  }
  if constexpr (kDequant) {
    for (int t = threadIdx.x; t <= nleaves; t += kThreads) s_off[t] = offsets[t];
    __syncthreads();
    // masked tail columns look up the last column's leaf (never read)
    const int64_t first = col0 < n ? col0 : n - 1;
    int lo = 0, hi = nleaves - 1;  // largest l with s_off[l] <= first
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_off[mid] <= first) lo = mid; else hi = mid - 1;
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      int64_t c = col0 + (int64_t)i * kThreads;
      c = c < n ? c : n - 1;
      while (s_off[lo + 1] <= c) ++lo;
      leaf[i] = lo;
    }
  }
  for (int64_t j = 0; j < k; ++j) {
    const float cj = __ldg(coefs + j);
    float sj = __ldg(scales + j);
    if constexpr (kWeighted) sj = __fmul_rn(sj, __ldg(wgts + j));
    const T* dj = d + j * n;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t c = col0 + (int64_t)i * kThreads;
      if (c < n) {
        float v = load_value(dj, c);
        if constexpr (kDequant) {
          const int64_t at = j * nleaves + leaf[i];
          v = __fadd_rn(__fmul_rn(v, __ldg(qscale + at)), __ldg(qzero + at));
        }
        const float r = __fsub_rn(v, __fmul_rn(cj, pv[i]));
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

template <typename T, bool kDequant, bool kWeighted>
int launch_fold(const void* d, const void* qscale, const void* qzero,
                const void* offsets, int64_t nleaves, const void* p,
                const void* w, const void* coefs, const void* scales,
                const void* wgts, float eta_g, void* w_out, void* dt_out,
                int64_t k, int64_t n, void* stream) {
  if (k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  if (kDequant && (nleaves < 1 || nleaves > kMaxLeaves))
    return (int)cudaErrorInvalidValue;
  const size_t smem = kDequant ? (size_t)(nleaves + 1) * sizeof(int64_t) : 0;
  fold_kernel<T, kDequant, kWeighted>
      <<<(unsigned)((n + kTile - 1) / kTile), kThreads, smem,
         (cudaStream_t)stream>>>(
          (const T*)d, (const float*)qscale, (const float*)qzero,
          (const int64_t*)offsets, (int)nleaves, (const float*)p,
          (const float*)w, (const float*)coefs, (const float*)scales,
          (const float*)wgts, eta_g, (float*)w_out, (float*)dt_out, k, n);
  return (int)cudaGetLastError();
}

// out = scale * (d - coef * p), one element per column, in d's type.
// coef and scale are one f32 each in device memory (written by the
// reduction pass's scalar math, no host sync). The _rn intrinsics keep
// the plain version's three roundings (no FMA contraction).
__device__ __forceinline__ void store_value(float* __restrict__ row,
                                            int64_t c, float v) {
  row[c] = v;
}
__device__ __forceinline__ void store_value(__nv_bfloat16* __restrict__ row,
                                            int64_t c, float v) {
  row[c] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
epilogue_kernel(const T* __restrict__ d, const float* __restrict__ p,
                const float* __restrict__ coef,
                const float* __restrict__ scale, T* __restrict__ out,
                int64_t n) {
  const float cj = __ldg(coef);
  const float sj = __ldg(scale);
  const int64_t col0 = (int64_t)blockIdx.x * kTile + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t c = col0 + (int64_t)i * kThreads;
    if (c < n) {
      const float r = __fsub_rn(load_value(d, c), __fmul_rn(cj, __ldg(p + c)));
      store_value(out, c, __fmul_rn(sj, r));
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
  dots_kernel<false><<<(unsigned)feddpc_num_blocks(n), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)d, (const float*)p, (float*)out, k, n);
  return (int)cudaGetLastError();
}

// d (k, n), p (n,) or null -> out (k, feddpc_num_blocks(n), 4) partials
// of <d~, p>, <d~, d~>, <p, p>, nonfinite(d) with d~ = d, non-finite
// entries zeroed; null p gives 0 in columns 0 and 2
int feddpc_guard_dots(const void* d, const void* p, void* out, int64_t k,
                      int64_t n, void* stream) {
  if (k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  dots_kernel<true><<<(unsigned)feddpc_num_blocks(n), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const float*)d, (const float*)p, (float*)out, k, n);
  return (int)cudaGetLastError();
}

// All folds: p, w (n,), coefs, scales (k,) -> w_out, dt_out (n,);
// outputs must not alias the inputs.

// d (k, n) f32
int feddpc_batched_epilogue(const void* d, const void* p, const void* w,
                            const void* coefs, const void* scales,
                            float eta_g, void* w_out, void* dt_out, int64_t k,
                            int64_t n, void* stream) {
  return launch_fold<float, false, false>(
      d, nullptr, nullptr, nullptr, 0, p, w, coefs, scales, nullptr, eta_g,
      w_out, dt_out, k, n, stream);
}

// d (b, n) f32, wgts (b,) staleness discounts
int feddpc_buffer_fold(const void* d, const void* p, const void* w,
                       const void* coefs, const void* scales,
                       const void* wgts, float eta_g, void* w_out,
                       void* dt_out, int64_t b, int64_t n, void* stream) {
  return launch_fold<float, false, true>(
      d, nullptr, nullptr, nullptr, 0, p, w, coefs, scales, wgts, eta_g,
      w_out, dt_out, b, n, stream);
}

// q (k, n) int8 (qtype 0) or bf16 (qtype 1); qscale, qzero (k, nleaves)
// f32; offsets (nleaves + 1,) int64 on the device, 0 ... n increasing
int feddpc_dequant_batched_epilogue(const void* q, int qtype,
                                    const void* qscale, const void* qzero,
                                    const void* offsets, int64_t nleaves,
                                    const void* p, const void* w,
                                    const void* coefs, const void* scales,
                                    float eta_g, void* w_out, void* dt_out,
                                    int64_t k, int64_t n, void* stream) {
  if (qtype == 0)
    return launch_fold<int8_t, true, false>(
        q, qscale, qzero, offsets, nleaves, p, w, coefs, scales, nullptr,
        eta_g, w_out, dt_out, k, n, stream);
  if (qtype == 1)
    return launch_fold<__nv_bfloat16, true, false>(
        q, qscale, qzero, offsets, nleaves, p, w, coefs, scales, nullptr,
        eta_g, w_out, dt_out, k, n, stream);
  return (int)cudaErrorInvalidValue;
}

// as above over an arrival buffer of b rows, with wgts (b,)
int feddpc_dequant_buffer_fold(const void* q, int qtype, const void* qscale,
                               const void* qzero, const void* offsets,
                               int64_t nleaves, const void* p, const void* w,
                               const void* coefs, const void* scales,
                               const void* wgts, float eta_g, void* w_out,
                               void* dt_out, int64_t b, int64_t n,
                               void* stream) {
  if (qtype == 0)
    return launch_fold<int8_t, true, true>(
        q, qscale, qzero, offsets, nleaves, p, w, coefs, scales, wgts, eta_g,
        w_out, dt_out, b, n, stream);
  if (qtype == 1)
    return launch_fold<__nv_bfloat16, true, true>(
        q, qscale, qzero, offsets, nleaves, p, w, coefs, scales, wgts, eta_g,
        w_out, dt_out, b, n, stream);
  return (int)cudaErrorInvalidValue;
}

// d (n,) f32 (dtype 0) or bf16 (dtype 1), p (n,) f32, coef and scale one
// f32 each on the device -> out (n,) of d's type; out must not alias
int feddpc_fused_epilogue(const void* d, int dtype, const void* p,
                          const void* coef, const void* scale, void* out,
                          int64_t n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)feddpc_num_blocks(n);
  if (dtype == 0)
    epilogue_kernel<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)d, (const float*)p, (const float*)coef,
        (const float*)scale, (float*)out, n);
  else if (dtype == 1)
    epilogue_kernel<__nv_bfloat16>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const __nv_bfloat16*)d, (const float*)p, (const float*)coef,
            (const float*)scale, (__nv_bfloat16*)out, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* feddpc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
