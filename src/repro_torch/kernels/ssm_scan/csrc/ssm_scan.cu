// Mamba-1 selective scan on Hopper (sm_90a).
//
// ssm_scan_fwd  replaces  src/repro/kernels/ssm_scan/kernel.py:ssm_scan
//   h_t[c,n] = exp(dt_t[c] * a[c,n]) * h_{t-1}[c,n] + (dt_t[c] * u_t[c]) * b_t[n]
//   y_t[c]   = sum_n c_t[n] * h_t[c,n] + d_skip[c] * u_t[c]
// per batch row, from h0 (zeros when it is null), and returns y in u's
// dtype and the final state h (B, D_in, N) in f32. The state stays f32 and
// y is rounded to u's dtype only after the skip term, as in the reference.
//
// Two optional inputs fold the Mamba mixer's prologue and gate into the
// one launch (as Mamba's own CUDA scan takes delta_bias, delta_softplus
// and z):
//   * dt_bias (D_in) f32: dt = raw + bias, and with dt_softplus dt =
//     softplus(dt), rounded as the eager torch.clamp(x, min=0) +
//     torch.log1p(torch.exp(-x.abs())) rounds it on the card (expf,
//     log1pf, the add not contracted). raw is x_proj's dt rows times W_dt.
//   * z (B, S, D_in) in u's dtype: the kernel returns y * silu(z), rounded
//     as the eager y * F.silu(z): y rounded to u's dtype, silu(z) as
//     torch's CUDA silu computes it (x / (1 + expf(-x)) in f32) rounded to
//     u's dtype, then the product rounded to u's dtype.
// h_final is the same either way.
//
// Inputs: u (B, S, D_in) f32 or bf16 and dt (B, S, D_in) f32, contiguous;
// b and c (B, S, N) f32 and z with any batch and step strides (elements)
// and a contiguous last dim, so the model's slices of one projection are
// read in place; a (D_in, N) f32 (already negative), d_skip (D_in) f32,
// h0 (B, D_in, N) f32 or null. Nothing is padded: ragged S and D_in are
// masked by bounds here; offsets are 64-bit.
//
// What bounds it. At the serving path's prefill shape (B 8, S 1024, D_in
// 8192, N 16): bytes 811 MB with f32 u and y (u and dt read, y written;
// 0.24 ms at 3.35 TB/s), 543 MB with bf16 (0.16 ms); and B * S * D_in * N
// = 1.07e9 exponentials, one MUFU.EX2 each at 16 per clock per SM on 132
// SMs: 0.26 ms at 1.98 GHz. Each expf without fast math is also about six
// FP32 instructions beside the MUFU, and each state step five more
// (dt * a, h * decay, du * b, the add, h * c): ~11 of the FP32 pipe's 128
// lanes a clock per SM, ~0.35 ms. The fused form adds per (b, t, c) a
// softplus (expf and log1pf) and a gate (expf and a division). At decode
// (S = 1, h0 given) it is bytes: the state read and written (8.4 MB) with
// a, u, dt and y, 9.7 MB: 2.9 us.
//
// Design.
//   * A channel's N states are split over kLanes = NMAX / kPer lanes,
//     kPer = 8 states each (N = 16: 2 lanes; N <= 8: one lane): a
//     128-thread block holds 128 / kLanes channels of one batch row, so
//     the prefill grid has twice the threads of one thread per channel.
//     Lane j holds the states j + kLanes * i (i < kPer), so the plain
//     version's pairwise tree over n (pairs k, k + w for w = NMAX/2 ...
//     1) is log2(kPer) levels of adds in the thread (w = kLanes kPer/2
//     ... kLanes) and then __shfl_xor_sync levels (w = kLanes/2 ... 1):
//     the same operand pairs, the same roundings. On the H100, 2 lanes x
//     8 states beat 4 x 4 at the prefill shape (PERF.md): fewer shuffles
//     and loads of b and c per state step, and 5 warps a scheduler are
//     enough.
//   * u, dt (raw), z, b and c are staged in shared memory kChunk steps at
//     a time through a kStages-deep ring of 16-byte cp.async copies, so a
//     load's latency hides behind whole chunks and f32 and bf16 u differ
//     only in bytes; a whole chunk's steps are unrolled. Between the
//     chunk barriers the block turns the chunk's raw dt into dt (bias,
//     softplus) and lays b and c out in the lanes' order (float4 reads),
//     and writes the previous chunk's y (and gate) out as 16-byte
//     stores, each once per (b, t, c) rather than once per lane. Rows
//     that are not 16-byte aligned (odd D_in, odd strides) are copied
//     element by element instead.
//   * Decode (S = 1) is its own kernel: 64-thread blocks, lane j holds
//     the states 4j ... 4j+3, so h0, a, b, c and h_final are one float4
//     each, read and written straight from and to global memory; the tree
//     runs its __shfl_xor_sync levels first (w = NMAX/2 ... 4) and its two
//     in-thread levels last.
//   * The plain version's rounding, step for step: expf (not __expf),
//     products and sums rounded one by one (__fmul_rn, __fadd_rn: nothing
//     contracted into an FMA), c . h summed as its pairwise tree over the
//     states zero-padded to NMAX. So y and h equal the plain version's on
//     the card bit for bit, and a bf16 model does not drift from its plain
//     path through 1-ulp flips amplified over 64 layers.
//
// Plain C interface for ctypes; the entry point launches on the stream it
// is given and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // a scan block: channels x lanes
constexpr int kStepThreads = 64;   // a decode block
constexpr int kChunk = 16;         // time steps staged at once
constexpr int kStages = 2;         // chunks in the cp.async ring
constexpr int kMinBlocks = 5;      // scan blocks an SM holds (<= 96 registers)
constexpr int kScanPer = 8;        // states per lane in the scan (N >= it)
constexpr int kStepPer = 4;        // ... and in the decode step
constexpr int kMaxState = 32;      // the largest N an instance takes

struct Params {
  const void* u;
  const float* dt;
  const float* b;
  const float* c;
  const float* a;
  const float* dskip;
  const float* h0;     // or null: zeros
  const float* bias;   // dt_bias, or null
  const void* z;       // the gate, or null
  void* y;
  float* hout;
  int s, d_in, n, softplus;
  long long b_sb, b_st, c_sb, c_st, z_sb, z_st;   // strides in elements
  int vec_x;    // u, dt, z and y rows in 16-byte pieces
  int vec_bc;   // b and c rows in 16-byte pieces
  int vec_h;    // a, h0 and h_final as float4
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs())), op for op
__device__ __forceinline__ float softplus(float x) {
  const float m = isnan(x) ? x : fmaxf(x, 0.f);
  return __fadd_rn(m, log1pf(expf(-fabsf(x))));
}

// dt from x_proj's raw dt (the bias add, then softplus, as asked)
__device__ __forceinline__ float make_dt(const Params& p, float raw,
                                         float bias) {
  float x = p.bias != nullptr ? __fadd_rn(raw, bias) : raw;
  return p.softplus ? softplus(x) : x;
}

// the output in T from y (f32, after the skip term): y itself, or y *
// silu(z) with each factor and the product rounded to T
template <typename T>
__device__ __forceinline__ T gate(float y, bool has_z, T z) {
  const T yt = from_f32<T>(y);
  if (!has_z) return yt;
  const float zf = to_f32(z);
  const T s = from_f32<T>(__fdiv_rn(zf, __fadd_rn(1.f, expf(-zf))));
  return from_f32<T>(__fmul_rn(to_f32(yt), to_f32(s)));
}

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

template <typename T, int NMAX>
struct ScanSmem {
  static constexpr int kPer = NMAX < kScanPer ? NMAX : kScanPer;
  static constexpr int kLanes = NMAX / kPer;
  static constexpr int kCh = kThreads / kLanes;   // channels per block
  struct alignas(16) Stage {
    T u[kChunk][kCh];
    T z[kChunk][kCh];
    float dt[kChunk][kCh];
    float b[kChunk][NMAX];
    float c[kChunk][NMAX];
  };
  Stage st[kStages];
  alignas(16) float bl[kChunk][NMAX];   // b and c in the lanes' order,
  alignas(16) float cl[kChunk][NMAX];   // zero past n
  float y[kChunk][kCh];                 // y after the skip term, f32
  float bias[kCh];
};

// Queue the copies of the chunk from step t0 into one ring stage.
template <typename T, int NMAX>
__device__ __forceinline__ void stage_chunk(
    const Params& p, typename ScanSmem<T, NMAX>::Stage& st, int64_t row,
    int t0, int c0, int nch) {
  constexpr int C = ScanSmem<T, NMAX>::kCh;
  const int steps = min(kChunk, p.s - t0);
  const int tid = threadIdx.x;
  const T* u = static_cast<const T*>(p.u);
  const T* z = static_cast<const T*>(p.z);
  const int64_t x0 = (row * p.s + t0) * (int64_t)p.d_in + c0;
  const int64_t z0 = row * p.z_sb + (int64_t)t0 * p.z_st + c0;
  if (p.vec_x) {
    constexpr int VT = 16 / (int)sizeof(T), QT = C / VT, QF = C / 4;
    for (int i = tid; i < steps * QT; i += kThreads) {
      const int tt = i / QT, q = (i % QT) * VT;
      if (q < nch) {
        cp_async16(&st.u[tt][q], u + x0 + (int64_t)tt * p.d_in + q);
        if (z != nullptr)
          cp_async16(&st.z[tt][q], z + z0 + tt * p.z_st + q);
      }
    }
    for (int i = tid; i < steps * QF; i += kThreads) {
      const int tt = i / QF, q = (i % QF) * 4;
      if (q < nch)
        cp_async16(&st.dt[tt][q], p.dt + x0 + (int64_t)tt * p.d_in + q);
    }
  } else {
    for (int i = tid; i < steps * C; i += kThreads) {
      const int tt = i / C, q = i % C;
      if (q < nch) {
        st.u[tt][q] = u[x0 + (int64_t)tt * p.d_in + q];
        st.dt[tt][q] = p.dt[x0 + (int64_t)tt * p.d_in + q];
        if (z != nullptr) st.z[tt][q] = z[z0 + tt * p.z_st + q];
      }
    }
  }
  const int64_t b0 = row * p.b_sb + (int64_t)t0 * p.b_st;
  const int64_t cc0 = row * p.c_sb + (int64_t)t0 * p.c_st;
  if (p.vec_bc) {
    const int qn = p.n / 4;
    for (int i = tid; i < steps * qn; i += kThreads) {
      const int tt = i / qn, q = (i % qn) * 4;
      cp_async16(&st.b[tt][q], p.b + b0 + tt * p.b_st + q);
      cp_async16(&st.c[tt][q], p.c + cc0 + tt * p.c_st + q);
    }
  } else {
    for (int i = tid; i < steps * p.n; i += kThreads) {
      const int tt = i / p.n, q = i % p.n;
      st.b[tt][q] = p.b[b0 + tt * p.b_st + q];
      st.c[tt][q] = p.c[cc0 + tt * p.c_st + q];
    }
  }
}

// The staged chunk's raw dt -> dt in place, and b, c in the lanes' order.
template <typename T, int NMAX>
__device__ __forceinline__ void prepare_chunk(
    const Params& p, ScanSmem<T, NMAX>& sm,
    typename ScanSmem<T, NMAX>::Stage& st, int nch) {
  constexpr int L = ScanSmem<T, NMAX>::kLanes, C = ScanSmem<T, NMAX>::kCh;
  constexpr int kPer = ScanSmem<T, NMAX>::kPer;
  const int tid = threadIdx.x;
  if (p.bias != nullptr || p.softplus) {
    for (int i = tid; i < kChunk * C; i += kThreads) {
      const int tt = i / C, q = i % C;
      if (q < nch) st.dt[tt][q] = make_dt(p, st.dt[tt][q], sm.bias[q]);
    }
  }
  for (int i = tid; i < kChunk * NMAX; i += kThreads) {
    const int tt = i / NMAX, k = i % NMAX;
    const int at = (k % L) * kPer + k / L;   // lane k % L, its state k / L
    const bool on = k < p.n;
    sm.bl[tt][at] = on ? st.b[tt][k] : 0.f;
    sm.cl[tt][at] = on ? st.c[tt][k] : 0.f;
  }
}

// Write the chunk from step t0 out of sm.y (with the gate's z of its stage).
template <typename T, int NMAX>
__device__ __forceinline__ void write_chunk(
    const Params& p, const ScanSmem<T, NMAX>& sm,
    const typename ScanSmem<T, NMAX>::Stage& st, int64_t row, int t0,
    int c0, int nch) {
  constexpr int C = ScanSmem<T, NMAX>::kCh;
  const int steps = min(kChunk, p.s - t0);
  const int tid = threadIdx.x;
  const bool has_z = p.z != nullptr;
  T* y = static_cast<T*>(p.y) + (row * p.s + t0) * (int64_t)p.d_in + c0;
  if (p.vec_x) {
    constexpr int VT = 16 / (int)sizeof(T), QT = C / VT;
    for (int i = tid; i < steps * QT; i += kThreads) {
      const int tt = i / QT, q = (i % QT) * VT;
      if (q < nch) {
        union {
          uint4 v;
          T e[VT];
        } o;
#pragma unroll
        for (int e = 0; e < VT; ++e)
          o.e[e] = gate<T>(sm.y[tt][q + e], has_z, st.z[tt][q + e]);
        *reinterpret_cast<uint4*>(y + (int64_t)tt * p.d_in + q) = o.v;
      }
    }
  } else {
    for (int i = tid; i < steps * C; i += kThreads) {
      const int tt = i / C, q = i % C;
      if (q < nch)
        y[(int64_t)tt * p.d_in + q] = gate<T>(sm.y[tt][q], has_z,
                                              st.z[tt][q]);
    }
  }
}

// One time step of one lane: its kPer states, then c . h over the
// channel's lanes; lane 0 keeps y (after the skip term) for write_chunk.
template <typename T, int NMAX>
__device__ __forceinline__ void scan_step(
    ScanSmem<T, NMAX>& sm, const typename ScanSmem<T, NMAX>::Stage& st,
    int tt, int lane, int cl, const float* av, float dsk, float* h) {
  constexpr int L = ScanSmem<T, NMAX>::kLanes;
  constexpr int kPer = ScanSmem<T, NMAX>::kPer;
  const float dtt = st.dt[tt][cl];
  const float ut = to_f32(st.u[tt][cl]);
  const float du = __fmul_rn(dtt, ut);
  float bb[kPer], cc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; i += 4) {
    const float4 bv = *reinterpret_cast<const float4*>(&sm.bl[tt][lane * kPer + i]);
    const float4 cv = *reinterpret_cast<const float4*>(&sm.cl[tt][lane * kPer + i]);
    bb[i] = bv.x, bb[i + 1] = bv.y, bb[i + 2] = bv.z, bb[i + 3] = bv.w;
    cc[i] = cv.x, cc[i + 1] = cv.y, cc[i + 2] = cv.z, cc[i + 3] = cv.w;
  }
  float q[kPer];                     // c_t[k] * h_t[k], zero past n
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float decay = expf(__fmul_rn(dtt, av[i]));
    h[i] = __fadd_rn(__fmul_rn(h[i], decay), __fmul_rn(du, bb[i]));
    q[i] = __fmul_rn(h[i], cc[i]);
  }
  // the tree's levels w = L kPer/2 ... L in the thread (state i pairs
  // with i + w/L), then L/2 ... 1 across the lanes
#pragma unroll
  for (int w = kPer / 2; w >= 1; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) q[i] = __fadd_rn(q[i], q[i + w]);
#pragma unroll
  for (int w = L / 2; w >= 1; w /= 2)
    q[0] = __fadd_rn(q[0], __shfl_xor_sync(0xffffffffu, q[0], w));
  if (lane == 0) sm.y[tt][cl] = __fadd_rn(q[0], __fmul_rn(dsk, ut));
}

template <typename T, int NMAX>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssm_scan_kernel(const Params p) {
  using S = ScanSmem<T, NMAX>;
  constexpr int L = S::kLanes, C = S::kCh, kPer = S::kPer;
  extern __shared__ __align__(16) unsigned char smem[];
  S& sm = *reinterpret_cast<S*>(smem);
  const int tid = threadIdx.x;
  const int lane = tid % L;
  const int cl = tid / L;                  // channel within the block
  const int c0 = blockIdx.x * C;
  const int ch = c0 + cl;
  const int64_t row = blockIdx.y;
  const bool live = ch < p.d_in;
  const int nch = min(C, p.d_in - c0);
  const int n = p.n;

  float h[kPer], av[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = lane + L * i;
    const bool on = live && k < n;
    h[i] = (on && p.h0 != nullptr) ? p.h0[(row * p.d_in + ch) * n + k] : 0.f;
    av[i] = on ? p.a[(int64_t)ch * n + k] : 0.f;
  }
  const float dsk = live ? p.dskip[ch] : 0.f;
  if (tid < nch) sm.bias[tid] = p.bias != nullptr ? p.bias[c0 + tid] : 0.f;

  const int nchunks = (p.s + kChunk - 1) / kChunk;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < nchunks) stage_chunk<T, NMAX>(p, sm.st[k], row, k * kChunk, c0,
                                          nch);
    cp_async_commit();
  }
  for (int k = 0; k < nchunks; ++k) {
    typename S::Stage& st = sm.st[k % kStages];
    const int t0 = k * kChunk;
    cp_async_wait<kStages - 2>();    // chunk k has landed (this thread's)
    __syncthreads();                 // ... everyone's; chunk k-1 computed
    prepare_chunk<T, NMAX>(p, sm, st, nch);
    if (k > 0)
      write_chunk<T, NMAX>(p, sm, sm.st[(k - 1) % kStages], row,
                           t0 - kChunk, c0, nch);
    __syncthreads();                 // stage k-1 and sm.y are free
    const int kn = k + kStages - 1;
    if (kn < nchunks)
      stage_chunk<T, NMAX>(p, sm.st[kn % kStages], row, kn * kChunk, c0,
                           nch);
    cp_async_commit();

    const int steps = min(kChunk, p.s - t0);
    if (steps == kChunk) {           // a whole chunk: offsets known here
#pragma unroll
      for (int tt = 0; tt < kChunk; ++tt)
        scan_step<T, NMAX>(sm, st, tt, lane, cl, av, dsk, h);
    } else {
      for (int tt = 0; tt < steps; ++tt)
        scan_step<T, NMAX>(sm, st, tt, lane, cl, av, dsk, h);
    }
  }
  __syncthreads();
  write_chunk<T, NMAX>(p, sm, sm.st[(nchunks - 1) % kStages], row,
                       (nchunks - 1) * kChunk, c0, nch);
  if (live) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = lane + L * i;
      if (k < n) p.hout[(row * p.d_in + ch) * n + k] = h[i];
    }
  }
}

// cnt (<= 4) floats from src (zeros past them, or all zeros when src is
// null), as one float4 when allowed
__device__ __forceinline__ void load4(float* d, const float* src, int cnt,
                                      int vec) {
  if (src != nullptr && vec && cnt == kStepPer) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < kStepPer; ++i)
    d[i] = (src != nullptr && i < cnt) ? src[i] : 0.f;
}

// One step (S = 1) from h0: lane j of a channel's group holds the states
// 4j ... 4j+3.
template <typename T, int NMAX>
__global__ void __launch_bounds__(kStepThreads)
ssm_step_kernel(const Params p) {
  constexpr int L = NMAX / kStepPer, C = kStepThreads / L;
  const int lane = threadIdx.x % L;
  const int ch = blockIdx.x * C + threadIdx.x / L;
  const int64_t row = blockIdx.y;
  const bool live = ch < p.d_in;
  const int n = p.n, k0 = lane * kStepPer;
  const int cnt = live ? max(0, min(kStepPer, n - k0)) : 0;
  const int64_t hb = (row * p.d_in + ch) * n + k0;
  float h[kStepPer], av[kStepPer], bv[kStepPer], cv[kStepPer];
  load4(h, p.h0 != nullptr ? p.h0 + hb : nullptr, cnt, p.vec_h);
  load4(av, p.a + (int64_t)ch * n + k0, cnt, p.vec_h);
  load4(bv, p.b + row * p.b_sb + k0, cnt, p.vec_bc);
  load4(cv, p.c + row * p.c_sb + k0, cnt, p.vec_bc);
  const int64_t x = row * p.d_in + ch;
  float dtt = 0.f, ut = 0.f, dsk = 0.f;
  if (live) {
    dtt = make_dt(p, p.dt[x], p.bias != nullptr ? p.bias[ch] : 0.f);
    ut = to_f32(static_cast<const T*>(p.u)[x]);
    dsk = p.dskip[ch];
  }
  const float du = __fmul_rn(dtt, ut);
  float q[kStepPer];
#pragma unroll
  for (int i = 0; i < kStepPer; ++i) {
    const float decay = expf(__fmul_rn(dtt, av[i]));
    h[i] = __fadd_rn(__fmul_rn(h[i], decay), __fmul_rn(du, bv[i]));
    q[i] = __fmul_rn(h[i], cv[i]);
  }
  // the tree's levels w = NMAX/2 ... 4 across the lanes, then 2 and 1
#pragma unroll
  for (int m = L / 2; m >= 1; m /= 2)
#pragma unroll
    for (int i = 0; i < kStepPer; ++i)
      q[i] = __fadd_rn(q[i], __shfl_xor_sync(0xffffffffu, q[i], m));
  q[0] = __fadd_rn(q[0], q[2]);
  q[1] = __fadd_rn(q[1], q[3]);
  q[0] = __fadd_rn(q[0], q[1]);
  if (!live) return;                 // after the shuffles: all lanes take part
  if (lane == 0) {
    const bool has_z = p.z != nullptr;
    const T zv = has_z ? static_cast<const T*>(p.z)[row * p.z_sb + ch]
                       : from_f32<T>(0.f);
    static_cast<T*>(p.y)[x] = gate<T>(__fadd_rn(q[0], __fmul_rn(dsk, ut)),
                                      has_z, zv);
  }
  float* out = p.hout + hb;
  if (p.vec_h && cnt == kStepPer) {
    *reinterpret_cast<float4*>(out) = make_float4(h[0], h[1], h[2], h[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kStepPer; ++i)
      if (i < cnt) out[i] = h[i];
  }
}

template <typename T, int NMAX>
int launch(const Params& p, int batch, cudaStream_t stream) {
  if (p.s == 1) {
    constexpr int C = kStepThreads / (NMAX / kStepPer);
    const dim3 grid((unsigned)((p.d_in + C - 1) / C), (unsigned)batch);
    ssm_step_kernel<T, NMAX><<<grid, kStepThreads, 0, stream>>>(p);
  } else {
    using S = ScanSmem<T, NMAX>;
    // past 48 KB (N <= 4: 128 channels a block) only when asked for, on
    // the current device
    const cudaError_t attr = cudaFuncSetAttribute(
        ssm_scan_kernel<T, NMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(S));
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((unsigned)((p.d_in + S::kCh - 1) / S::kCh),
                    (unsigned)batch);
    ssm_scan_kernel<T, NMAX><<<grid, kThreads, sizeof(S), stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int batch, cudaStream_t stream) {
  if (p.n <= 4) return launch<T, 4>(p, batch, stream);
  if (p.n <= 8) return launch<T, 8>(p, batch, stream);
  if (p.n <= 16) return launch<T, 16>(p, batch, stream);
  return launch<T, kMaxState>(p, batch, stream);
}

bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

}  // namespace

extern "C" {

// u (batch, s, d_in) of dtype 0 = f32 or 1 = bf16 and dt (batch, s, d_in)
// f32, contiguous; b, c (batch, s, n) f32 and z (batch, s, d_in) of u's
// dtype (or null) at element strides *_sb (batch) and *_st (step), last
// dim contiguous; a (d_in, n), dskip (d_in), h0 (batch, d_in, n) or null
// and dt_bias (d_in) or null, f32 and contiguous -> y (batch, s, d_in) of
// u's dtype (y * silu(z) when z is given) and hout (batch, d_in, n) f32.
// dt_softplus != 0 applies softplus to dt (after the bias). 1 <= n <=
// kMaxState (32).
int ssm_scan_fwd(const void* u, const void* dt, const void* b, const void* c,
                 const void* a, const void* dskip, const void* h0,
                 const void* dt_bias, const void* z, void* y, void* hout,
                 int dtype, int batch, int s, int d_in, int n,
                 int dt_softplus, long long b_sb, long long b_st,
                 long long c_sb, long long c_st, long long z_sb,
                 long long z_st, void* stream) {
  if (batch < 1 || batch > 65535 || s < 1 || d_in < 1 || n < 1 ||
      n > kMaxState || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long esz = dtype == 0 ? 4 : 2, vt = 16 / esz;
  Params p;
  p.u = u;
  p.dt = static_cast<const float*>(dt);
  p.b = static_cast<const float*>(b);
  p.c = static_cast<const float*>(c);
  p.a = static_cast<const float*>(a);
  p.dskip = static_cast<const float*>(dskip);
  p.h0 = static_cast<const float*>(h0);
  p.bias = static_cast<const float*>(dt_bias);
  p.z = z;
  p.y = y;
  p.hout = static_cast<float*>(hout);
  p.s = s, p.d_in = d_in, p.n = n, p.softplus = dt_softplus != 0;
  p.b_sb = b_sb, p.b_st = b_st, p.c_sb = c_sb, p.c_st = c_st;
  p.z_sb = z_sb, p.z_st = z_st;
  p.vec_x = d_in % vt == 0 && aligned16(u) && aligned16(dt) &&
            aligned16(y) &&
            (z == nullptr || (aligned16(z) && (z_sb * esz) % 16 == 0 &&
                              (z_st * esz) % 16 == 0));
  p.vec_bc = n % 4 == 0 && aligned16(b) && aligned16(c) && b_sb % 4 == 0 &&
             b_st % 4 == 0 && c_sb % 4 == 0 && c_st % 4 == 0;
  p.vec_h = n % 4 == 0 && aligned16(a) && aligned16(hout) &&
            (h0 == nullptr || aligned16(h0));
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(p, batch, st);
  return dispatch<__nv_bfloat16>(p, batch, st);
}

const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
