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
// not), the two f32 folds another (weights), the two dequant folds a
// third (payload type, weights). All seven kernels are bound by HBM
// bytes: a few flops per element against 1-4 bytes read, far below the
// card's ~20 flops per byte of f32 ridge. So each moves only what it
// must:
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
// The dequant folds move 26 (int8) or 36 (bf16) bytes a column at K = 10
// against the f32 folds' 56, so their loads must be wide to keep as many
// bytes in flight: a lane owns a run of 32 payload bytes a row, staged as
// 16-byte cp.async words through a per-warp ring in shared memory; a row
// that starts off a 16-byte boundary (any N not a multiple of 16, or a
// view at an odd offset) is read as aligned words and shifted into place
// by the row's byte shift, and each run reads its leaf's (scale, zero)
// once a row. See "The two dequant folds" below.
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

// One column of a row as f32: the f32 stack as it is, a bf16 delta
// converted exactly.
__device__ __forceinline__ float load_value(const float* __restrict__ row,
                                            int64_t c) {
  return __ldg(row + c);
}
__device__ __forceinline__ float load_value(
    const __nv_bfloat16* __restrict__ row, int64_t c) {
  return __bfloat162float(row[c]);
}

// The f32 folds:
//   dt = (1/K) sum_j s_j * (d_j - coef_j * p),   w' = w - eta_g * dt
// with s_j = wgt_j * scale_j when kWeighted (the staleness discount
// multiplies the adaptive scale; coef_j stays raw). The sum over j runs
// in row order and ends in one division by K — the order of the plain
// versions in ref.py (scales * wgts, then a mean), not the reference
// kernel's per-arrival multiply by 1/B. The _rn intrinsics keep nvcc
// from contracting into FMAs, so each element rounds as the plain
// version's separate ops do.
template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const float* __restrict__ d, const float* __restrict__ p,
            const float* __restrict__ w, const float* __restrict__ coefs,
            const float* __restrict__ scales,
            const float* __restrict__ wgts, float eta_g,
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
  for (int64_t j = 0; j < k; ++j) {
    const float cj = __ldg(coefs + j);
    float sj = __ldg(scales + j);
    if constexpr (kWeighted) sj = __fmul_rn(sj, __ldg(wgts + j));
    const float* dj = d + j * n;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t c = col0 + (int64_t)i * kThreads;
      if (c < n) {
        const float r = __fsub_rn(load_value(dj, c), __fmul_rn(cj, pv[i]));
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

template <bool kWeighted>
int launch_fold(const void* d, const void* p, const void* w,
                const void* coefs, const void* scales, const void* wgts,
                float eta_g, void* w_out, void* dt_out, int64_t k, int64_t n,
                void* stream) {
  if (k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  fold_kernel<kWeighted>
      <<<(unsigned)((n + kTile - 1) / kTile), kThreads, 0,
         (cudaStream_t)stream>>>(
          (const float*)d, (const float*)p, (const float*)w,
          (const float*)coefs, (const float*)scales, (const float*)wgts,
          eta_g, (float*)w_out, (float*)dt_out, k, n);
  return (int)cudaGetLastError();
}

// ---- The two dequant folds ----
//
// The same fold over the codec's payload: d_j = q_j * qscale[j, leaf] +
// qzero[j, leaf], q int8 or bf16, one (scale, zero) pair per client row
// and parameter leaf. Per column the fold moves K*s bytes of q (s = 1 or
// 2) and 16 bytes of p, w, w' and dt — 26 (int8) or 36 (bf16) bytes at
// K = 10 — against ~6K flops: bound by HBM bytes like the f32 folds,
// with 2.6-4x fewer bytes a column to hide the same latency behind.
//
// 16-byte loads. A lane owns a contiguous run of kRunBytes = 32 payload
// bytes a row (32 int8 or 16 bf16 columns), neighbouring lanes
// neighbouring runs, and walks all K rows for it. p, w, w' and dt move
// as coalesced float4s through shared memory (tile_load, tile_store):
// a lane's own float4s lie 128 (int8) or 64 (bf16) bytes from its
// neighbour's, so a warp access would touch 32 or 16 cache lines (on an
// H100 that alone held the int8 fold at 0.19 ms, against 0.13 with the
// tiles). A warp's 32 runs of a row are one 1 KB tile, staged by the
// warp's own lanes into a kRing-deep ring in shared memory with 16-byte
// cp.async copies, kRing - 1 rows ahead of the row being folded: the
// rows in flight hold no registers, and only __syncwarp orders a warp's
// ring. Row j begins at byte j*N*s of q, which for most N (ResNet18-GN's
// N = 11,220,132 is 4 mod 16) and for a view at an odd offset is not
// 16-byte aligned — but its shift sh = address mod 16 is the same for
// every run of the row. So the ring holds the aligned 16-byte words that
// cover the tile (65 a row: one past the 1 KB for the shift), each lane
// reads the three that cover its run (two when sh = 0) and assembles the
// run with two selects and a funnel shift a word (shift_window). A word
// that reaches past either end of the buffer — the first when q's base
// is unaligned, the last of the last row — is read byte by byte, so no
// byte outside [q, q + K*N*s) is read.
//
// One (scale, zero) read a leaf run. The (L+1) leaf offsets sit in
// shared memory; each lane finds its first column's leaf by binary
// search once, and a bit for every later column of its run that starts
// a leaf (`starts`; a leaf has at least one column, so each set bit is
// the next leaf). A run inside one leaf (starts == 0: every run of
// ResNet18-GN's 62 leaves but the ~60 that straddle a boundary) reads
// qscale[j, leaf] and qzero[j, leaf] once a row, a row ahead; a run that
// straddles reads the next pair at each set bit.
//
// Rounding as the f32 fold (and the first dequant body) bit for bit:
// __fmul_rn(q, qs) then __fadd_rn(., qz), then the f32 fold's steps with
// the rows in order and one division by K.
constexpr int kRunBytes = 32;                // payload bytes a lane a row
constexpr int kRunWords = kRunBytes / 4;     // as 32-bit words
constexpr int kWinWords = kRunWords + 4;     // ... plus one 16-byte word
constexpr int kQThreads = 256;
constexpr int kQWarps = kQThreads / 32;
constexpr int kQMinBlocks = 2;               // <= 128 registers a thread
constexpr int kRing = 4;                     // rows in a warp's ring
constexpr int kWarpWords = 32 * kRunBytes / 16 + 1;  // 16-byte words a row
constexpr size_t kRingBytes = (size_t)kQWarps * kRing * kWarpWords * 16;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// payload word -> f32 column values (exact conversions)
__device__ __forceinline__ float payload_value(const int8_t*, uint32_t word,
                                               int at) {
  return (float)(int8_t)(word >> (8 * at));
}
__device__ __forceinline__ float payload_value(const __nv_bfloat16*,
                                               uint32_t word, int at) {
  return __uint_as_float(at ? word & 0xffff0000u : word << 16);
}

// One row of a warp's tile into the ring: the aligned 16-byte words from
// the tile's first byte `at` rounded down, by cp.async where a word lies
// inside [lo, hi), else byte by byte with the bytes outside as 0.
__device__ __forceinline__ void stage_row(uint4* dst, uintptr_t at,
                                          uintptr_t lo, uintptr_t hi,
                                          int lane) {
  const uintptr_t w0 = at & ~(uintptr_t)15;
  for (int m = lane; m < kWarpWords; m += 32) {
    const uintptr_t a = w0 + 16 * (uintptr_t)m;
    if (a >= lo && a + 16 <= hi) {
      cp_async16(dst + m, reinterpret_cast<const void*>(a));
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (a + b >= lo && a + b < hi)
          v[b / 4] |= (uint32_t)__ldg(reinterpret_cast<const uint8_t*>(a + b))
                      << (8 * (b % 4));
      dst[m] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The run's kRunWords words from a window at byte shift sh: by 8, by 4
// (selects on the row-uniform sh), then by 0-3 bytes (funnel shift).
__device__ __forceinline__ void shift_window(
    const uint32_t (&win)[kWinWords], uint32_t sh,
    uint32_t (&run)[kRunWords]) {
  uint32_t t[kRunWords + 2], u[kRunWords + 1];
#pragma unroll
  for (int i = 0; i < kRunWords + 2; ++i) t[i] = (sh & 8) ? win[i + 2] : win[i];
#pragma unroll
  for (int i = 0; i < kRunWords + 1; ++i) u[i] = (sh & 4) ? t[i + 1] : t[i];
#pragma unroll
  for (int i = 0; i < kRunWords; ++i)
    run[i] = __funnelshift_r(u[i], u[i + 1], 8 * (sh & 3));
}

// A lane's run outside a whole aligned warp tile (the ragged last warp,
// or vectors at unaligned addresses): scalar accesses, the columns past
// cols read as 0 and not written.
template <int kRun>
__device__ __forceinline__ void load_run(float (&v)[kRun],
                                         const float* __restrict__ ptr,
                                         int cols) {
#pragma unroll
  for (int i = 0; i < kRun; ++i) v[i] = i < cols ? __ldg(ptr + i) : 0.f;
}

template <int kRun>
__device__ __forceinline__ void store_run(float* __restrict__ ptr,
                                          const float (&v)[kRun], int cols) {
#pragma unroll
  for (int i = 0; i < kRun; ++i)
    if (i < cols) ptr[i] = v[i];
}

__device__ __forceinline__ bool aligned16(const void* ptr) {
  return ((uintptr_t)ptr & 15) == 0;
}

// A warp's tile of an f32 vector — its 32 lanes' runs of kRun columns —
// between global memory and the lanes' registers through shared memory:
// globally coalesced float4s (lane l moves float4 u * 32 + l of the tile;
// a lane's own run, float4 by float4, would touch 32 cache lines an
// access), and each lane's run stored swizzled (float4 v of lane l at
// slot l * G + (v ^ (l / (8 / G)) % G)) so that neither side's 16-byte
// accesses meet on a bank.
template <int kRun>
__device__ __forceinline__ int tile_slot(int g) {
  constexpr int G = kRun / 4;                  // float4s a run
  static_assert(8 % G == 0, "a run of 4, 8, 16 or 32 floats");
  const int l = g / G, v = g % G;
  return l * G + (v ^ ((l / (8 / G)) % G));
}

template <int kRun>
__device__ __forceinline__ void tile_load(float (&v)[kRun],
                                          const float* __restrict__ src,
                                          float4* buf, int lane) {
  constexpr int G = kRun / 4;
#pragma unroll
  for (int u = 0; u < G; ++u)
    buf[tile_slot<kRun>(u * 32 + lane)] =
        __ldg(reinterpret_cast<const float4*>(src) + u * 32 + lane);
  __syncwarp();
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const float4 x = buf[tile_slot<kRun>(lane * G + u)];
    v[4 * u] = x.x; v[4 * u + 1] = x.y; v[4 * u + 2] = x.z; v[4 * u + 3] = x.w;
  }
  __syncwarp();
}

template <int kRun>
__device__ __forceinline__ void tile_store(float* __restrict__ dst,
                                           const float (&v)[kRun],
                                           float4* buf, int lane) {
  constexpr int G = kRun / 4;
#pragma unroll
  for (int u = 0; u < G; ++u)
    buf[tile_slot<kRun>(lane * G + u)] =
        make_float4(v[4 * u], v[4 * u + 1], v[4 * u + 2], v[4 * u + 3]);
  __syncwarp();
#pragma unroll
  for (int u = 0; u < G; ++u)
    reinterpret_cast<float4*>(dst)[u * 32 + lane] =
        buf[tile_slot<kRun>(u * 32 + lane)];
  __syncwarp();
}

template <typename T, bool kWeighted>
__global__ void __launch_bounds__(kQThreads, kQMinBlocks)
dequant_fold_kernel(const T* __restrict__ q,
                    const float* __restrict__ qscale,
                    const float* __restrict__ qzero,
                    const int64_t* __restrict__ offsets, int nleaves,
                    const float* __restrict__ p, const float* __restrict__ w,
                    const float* __restrict__ coefs,
                    const float* __restrict__ scales,
                    const float* __restrict__ wgts, float eta_g,
                    float* __restrict__ w_out, float* __restrict__ dt_out,
                    int64_t k, int64_t n) {
  constexpr int kRun = kRunBytes / (int)sizeof(T);  // columns of a run
  constexpr int kPerWord = 4 / (int)sizeof(T);
  // the warps' rings, then the nleaves + 1 offsets
  extern __shared__ uint4 q_smem[];
  int64_t* s_off = reinterpret_cast<int64_t*>(q_smem + kRingBytes / 16);
  for (int t = threadIdx.x; t <= nleaves; t += kQThreads) s_off[t] = offsets[t];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  uint4* ring = q_smem + (threadIdx.x / 32) * kRing * kWarpWords;
  const int64_t c0 = ((int64_t)blockIdx.x * kQThreads + threadIdx.x) * kRun;
  const int64_t cw = c0 - (int64_t)lane * kRun;     // the warp's first column
  if (cw >= n) return;                              // the whole warp
  const int cols = c0 >= n ? 0 : n - c0 < kRun ? (int)(n - c0) : kRun;

  int leaf0 = 0;                     // largest l with s_off[l] <= c0
  uint32_t starts = 0;               // bit i: column c0 + i starts a leaf
  if (cols > 0) {
    int hi = nleaves - 1;
    while (leaf0 < hi) {
      const int mid = (leaf0 + hi + 1) >> 1;
      if (s_off[mid] <= c0) leaf0 = mid; else hi = mid - 1;
    }
    for (int l = leaf0 + 1; l < nleaves && s_off[l] < c0 + cols; ++l)
      starts |= 1u << (int)(s_off[l] - c0);
  }

  // p, w, w' and dt: a whole warp tile at 16-byte aligned addresses
  // moves through shared memory (the ring's space, before and after the
  // row loop), anything else lane by lane
  const bool tile = aligned16(p) && aligned16(w) && aligned16(w_out) &&
                    aligned16(dt_out) && cw + 32 * kRun <= n;
  float4* tbuf = reinterpret_cast<float4*>(ring);
  static_assert(kRing * kWarpWords * 16 >= 32 * kRunBytes * 4 / (int)sizeof(T),
                "a warp's tile of floats fits in its ring");
  float pv[kRun], acc[kRun];
  if (tile) tile_load<kRun>(pv, p + cw, tbuf, lane);
  else load_run<kRun>(pv, p + c0, cols);
#pragma unroll
  for (int i = 0; i < kRun; ++i) acc[i] = 0.f;

  const uintptr_t lo = (uintptr_t)q;
  const uintptr_t hi = lo + (uintptr_t)(k * n) * sizeof(T);
  const uintptr_t row_bytes = (uintptr_t)n * sizeof(T);
  const uintptr_t tile0 = lo + (uintptr_t)cw * sizeof(T);  // row 0's tile
#pragma unroll
  for (int r = 0; r < kRing - 1; ++r) {
    if (r < k) stage_row(ring + r * kWarpWords, tile0 + r * row_bytes, lo, hi,
                         lane);
    cp_async_commit();
  }
  float cj = __ldg(coefs), sj = __ldg(scales);
  if constexpr (kWeighted) sj = __fmul_rn(sj, __ldg(wgts));
  float qs = __ldg(qscale + leaf0), qz = __ldg(qzero + leaf0);
  const float* qs_row = qscale;
  const float* qz_row = qzero;
  int slot = 0;                      // the ring slot of row j

#pragma unroll 1
  for (int64_t j = 0; j < k; ++j) {
    cp_async_wait<kRing - 2>();      // row j has landed (this lane's words)
    __syncwarp();                    // ... every lane's; row j-1 was read
    const int64_t js = j + kRing - 1;
    if (js < k)
      stage_row(ring + (slot + kRing - 1) % kRing * kWarpWords,
                tile0 + js * row_bytes, lo, hi, lane);
    cp_async_commit();
    // the next row's scalars (the last row reads its own again)
    const int64_t jn = j + 1 < k ? j + 1 : j;
    const float ncj = __ldg(coefs + jn);
    float nsj = __ldg(scales + jn);
    if constexpr (kWeighted) nsj = __fmul_rn(nsj, __ldg(wgts + jn));
    const float nqs = __ldg(qscale + jn * nleaves + leaf0);
    const float nqz = __ldg(qzero + jn * nleaves + leaf0);

    if (cols > 0) {
      const uint32_t sh = (uint32_t)((tile0 + j * row_bytes) & 15);
      const uint4* src = ring + slot * kWarpWords + 2 * lane;
      uint4 x[3];
      x[0] = src[0];
      x[1] = src[1];
      x[2] = sh ? src[2] : make_uint4(0u, 0u, 0u, 0u);
      uint32_t win[kWinWords], run[kRunWords];
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        win[4 * v] = x[v].x; win[4 * v + 1] = x[v].y;
        win[4 * v + 2] = x[v].z; win[4 * v + 3] = x[v].w;
      }
      shift_window(win, sh, run);
      if (starts == 0) {
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          const float xv = payload_value(q, run[i / kPerWord], i % kPerWord);
          const float v = __fadd_rn(__fmul_rn(xv, qs), qz);
          const float r = __fsub_rn(v, __fmul_rn(cj, pv[i]));
          acc[i] = __fadd_rn(acc[i], __fmul_rn(sj, r));
        }
      } else {
        int leaf = leaf0;
        float s = qs, z = qz;
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          if ((starts >> i) & 1u) {
            ++leaf;
            s = __ldg(qs_row + leaf);
            z = __ldg(qz_row + leaf);
          }
          const float xv = payload_value(q, run[i / kPerWord], i % kPerWord);
          const float v = __fadd_rn(__fmul_rn(xv, s), z);
          const float r = __fsub_rn(v, __fmul_rn(cj, pv[i]));
          acc[i] = __fadd_rn(acc[i], __fmul_rn(sj, r));
        }
      }
    }
    cj = ncj; sj = nsj; qs = nqs; qz = nqz;
    qs_row += nleaves;
    qz_row += nleaves;
    slot = (slot + 1) % kRing;
  }
  const float kf = (float)k;
  float wv[kRun];
  if (tile) {
    cp_async_wait<0>();              // the ring is idle ...
    __syncwarp();                    // ... and every lane has read it
    tile_load<kRun>(wv, w + cw, tbuf, lane);
  } else {
    if (cols == 0) return;
    load_run<kRun>(wv, w + c0, cols);
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    acc[i] = __fdiv_rn(acc[i], kf);               // dt
    wv[i] = __fsub_rn(wv[i], __fmul_rn(eta_g, acc[i]));
  }
  if (tile) {
    tile_store<kRun>(dt_out + cw, acc, tbuf, lane);
    tile_store<kRun>(w_out + cw, wv, tbuf, lane);
  } else {
    store_run<kRun>(dt_out + c0, acc, cols);
    store_run<kRun>(w_out + c0, wv, cols);
  }
}

template <typename T, bool kWeighted>
int launch_dequant_fold(const void* q, const void* qscale, const void* qzero,
                        const void* offsets, int64_t nleaves, const void* p,
                        const void* w, const void* coefs, const void* scales,
                        const void* wgts, float eta_g, void* w_out,
                        void* dt_out, int64_t k, int64_t n, void* stream) {
  if (k < 1 || n < 1 || nleaves < 1 || nleaves > kMaxLeaves)
    return (int)cudaErrorInvalidValue;
  constexpr int64_t kCols = (int64_t)kQThreads * (kRunBytes / sizeof(T));
  const size_t smem = kRingBytes + (size_t)(nleaves + 1) * sizeof(int64_t);
  // past 48 KB (more than ~1,900 leaves) only when asked for
  const cudaError_t attr = cudaFuncSetAttribute(
      dequant_fold_kernel<T, kWeighted>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dequant_fold_kernel<T, kWeighted>
      <<<(unsigned)((n + kCols - 1) / kCols), kQThreads, smem,
         (cudaStream_t)stream>>>(
          (const T*)q, (const float*)qscale, (const float*)qzero,
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
  return launch_fold<false>(d, p, w, coefs, scales, nullptr, eta_g, w_out,
                           dt_out, k, n, stream);
}

// d (b, n) f32, wgts (b,) staleness discounts
int feddpc_buffer_fold(const void* d, const void* p, const void* w,
                       const void* coefs, const void* scales,
                       const void* wgts, float eta_g, void* w_out,
                       void* dt_out, int64_t b, int64_t n, void* stream) {
  return launch_fold<true>(d, p, w, coefs, scales, wgts, eta_g, w_out,
                          dt_out, b, n, stream);
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
    return launch_dequant_fold<int8_t, false>(
        q, qscale, qzero, offsets, nleaves, p, w, coefs, scales, nullptr,
        eta_g, w_out, dt_out, k, n, stream);
  if (qtype == 1)
    return launch_dequant_fold<__nv_bfloat16, false>(
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
    return launch_dequant_fold<int8_t, true>(
        q, qscale, qzero, offsets, nleaves, p, w, coefs, scales, wgts, eta_g,
        w_out, dt_out, b, n, stream);
  if (qtype == 1)
    return launch_dequant_fold<__nv_bfloat16, true>(
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
