// Causal / sliding-window GQA flash attention on Hopper (sm_90a).
//
// flash_attention_fwd  replaces
//   src/repro/kernels/flash_attention/kernel.py:flash_attention_gqa
//   out[b,q,h,:] = sum_k softmax_k(s) v[b,k,h/G,:],
//   s = cap * tanh(<q[b,q,h,:] / sqrt(D), k[b,k,h/G,:]> / cap)  (cap > 0)
//   over the keys with k_pos <= q_pos, k_pos >= 0 and (window = 0 or
//   q_pos - k_pos < window); a row with no such key gives 0 (p = 0 where
//   masked, l floored at 1e-30), as the reference kernel does.
//
// Inputs are read where they lie: q (B, Sq, H, D), k and v (B, Sk, KV, D),
// contiguous, f32 or bf16; positions int32 (B, Sq) and (B, Sk), -1 = an
// empty cache slot. Nothing is padded or transposed: ragged tails are
// masked by bounds here.
//
// What bounds it. At the serving path's prefill shape (Sq ~ Sk ~ 1k) the
// work is ~4 D flops per query-key pair against a few bytes per pair:
// operations. At decode (Sq = 1) it is the K/V bytes. This first kernel
// is simple: CUDA-core FMAs in f32 for both dtypes (bf16 is widened on the
// way into shared memory), no tensor cores, no TMA, synchronous tile
// loads, no split over the keys for decode. Its design choices:
//   * one block per (batch, kv head, tile of rows), where a row is a
//     (query, group head) pair: the G = H / KV query heads that share a
//     K/V head read each K/V tile once from shared memory (the GQA saving
//     the TPU kernel had), and decode (Sq = 1) still fills G rows a block;
//   * each thread owns 4 rows x 4 keys of the score tile and 4 rows x
//     D / KG columns of the output; a row's KG threads are neighbouring
//     lanes of one warp, so the row max and sum are warp shuffles and the
//     probability tile is shared through shared memory with __syncwarp;
//   * online softmax (m, l, acc) in f32 registers; exp and tanh in full
//     precision (expf, tanhf) to stay within f32 rounding of the plain
//     version;
//   * a key tile no row of the block can see (causal, window, empty slots)
//     is skipped: the block's min / max q_pos decide it, so a causal
//     prefill does about half the tiles;
//   * two shapes of block: KG = 8 (64 rows x 32 keys) for prefill, and
//     KG = 32 (16 rows x 128 keys) when a block has at most 16 rows
//     (decode: G = 12 for StarCoder2) so that all four warps have rows.
//
// Plain C interface for ctypes; the entry point launches on the stream it
// is given and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF, not -inf

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  __align__(8) __nv_bfloat162 h[2];
  *reinterpret_cast<uint2*>(h) = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __align__(8) __nv_bfloat162 h[2];
  h[0] = __floats2bfloat162_rn(v.x, v.y);
  h[1] = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

template <int KG>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = KG / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// a butterfly: every lane of the group ends with the same bits
template <int KG>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = KG / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int KG>
struct Shape {
  static constexpr int kRowGroups = kThreads / KG;
  static constexpr int kRows = 4 * kRowGroups;  // rows per block
  static constexpr int kKeys = 4 * KG;          // keys per tile
};

// Shared memory in floats for head dim d: Q (rows), K and V (keys) with
// rows padded by 4 floats (16-byte aligned, fewer bank conflicts), the
// probability tile (keys x rows + 4) and the tile's key positions.
template <int KG>
size_t smem_bytes(int d) {
  using S = Shape<KG>;
  return sizeof(float) * ((size_t)(S::kRows + 2 * S::kKeys) * (d + 4) +
                          (size_t)S::kKeys * (S::kRows + 4) + S::kKeys);
}

// T: float or __nv_bfloat16. KG: threads per row (and keys / 4 per tile).
// DMAX: the largest head dim this instance takes (its output registers).
template <typename T, int KG, int DMAX>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ qpos,
              const int* __restrict__ kpos, T* __restrict__ out, int sq,
              int sk, int h, int kvh, int d, int window, float soft_cap) {
  using S = Shape<KG>;
  constexpr int BR = S::kRows, BK = S::kKeys;
  constexpr int DCH = DMAX / (4 * KG) > 0 ? DMAX / (4 * KG) : 1;
  const int g = h / kvh;
  const int b = blockIdx.z, j = blockIdx.y;        // batch, kv head
  const long long rows = (long long)sq * g;
  const long long row0 = (long long)blockIdx.x * BR;
  const int tid = threadIdx.x, rg = tid / KG, kg = tid % KG;
  const int ds = d + 4, ps = BR + 4, nch = d >> 2;

  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BR * ds;
  float* sV = sK + BK * ds;
  float* sP = sV + BK * ds;
  int* sKpos = reinterpret_cast<int*>(sP + BK * ps);
  __shared__ int s_qmin, s_qmax;

  // the block's rows of q, pre-divided by sqrt(D) as the reference does
  const float sqrt_d = sqrtf((float)d);
  for (int idx = tid; idx < BR * nch; idx += kThreads) {
    const int r = idx / nch, c = idx - r * nch;
    const long long row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows) {
      const long long qi = row / g;
      const int hh = j * g + (int)(row - qi * g);
      x = load4(q + (((long long)b * sq + qi) * h + hh) * d + c * 4);
      x = make_float4(x.x / sqrt_d, x.y / sqrt_d, x.z / sqrt_d, x.w / sqrt_d);
    }
    store4(sQ + r * ds + c * 4, x);
  }
  // this thread's rows: positions (-1 beyond the last row: masked)
  int qp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = row0 + rg * 4 + i;
    qp[i] = row < rows ? qpos[(long long)b * sq + row / g] : -1;
  }
  if (tid == 0) {
    s_qmin = INT_MAX;
    s_qmax = INT_MIN;
  }
  __syncthreads();
  if (kg == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (row0 + rg * 4 + i < rows) {
        atomicMin(&s_qmin, qp[i]);
        atomicMax(&s_qmax, qp[i]);
      }
    }
  }
  __syncthreads();
  const int qmin = s_qmin, qmax = s_qmax;
  // a warp whose first row is past the end has no row to compute
  const bool warp_live = row0 + (long long)(tid / 32) * (32 / KG) * 4 < rows;

  float m[4], l[4];
  float4 acc[4][DCH];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < DCH; ++cc) acc[i][cc] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = 0; k0 < sk; k0 += BK) {
    __syncthreads();   // the previous tile's shared memory is read
    int live = 0;
    for (int t = tid; t < BK; t += kThreads) {
      const int key = k0 + t;
      const int kp = key < sk ? kpos[(long long)b * sk + key] : -1;
      sKpos[t] = kp;
      live |= kp >= 0 && kp <= qmax &&
              (window <= 0 || (long long)kp + window > qmin);
    }
    if (!__syncthreads_or(live)) continue;   // no row sees this tile
    for (int idx = tid; idx < BK * nch; idx += kThreads) {
      const int r = idx / nch, c = idx - r * nch;
      const int key = k0 + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (key < sk) {   // zeros past the end: p = 0 must not meet NaN
        const long long off = (((long long)b * sk + key) * kvh + j) * d + c * 4;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      store4(sK + r * ds + c * 4, kx);
      store4(sV + r * ds + c * 4, vx);
    }
    __syncthreads();
    if (!warp_live) continue;

    // scores: rows rg*4 + i, keys kg + KG*jj of the tile
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    const float* qrow = sQ + rg * 4 * ds;
    for (int c = 0; c < nch; ++c) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = load4(qrow + i * ds + c * 4);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kb[jj] = load4(sK + (kg + KG * jj) * ds + c * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float x = s[i][jj];
          x = fmaf(qa[i].x, kb[jj].x, x);
          x = fmaf(qa[i].y, kb[jj].y, x);
          x = fmaf(qa[i].z, kb[jj].z, x);
          x = fmaf(qa[i].w, kb[jj].w, x);
          s[i][jj] = x;
        }
    }
    int kp[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) kp[jj] = sKpos[kg + KG * jj];
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mt = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        ok[jj] = kp[jj] >= 0 && kp[jj] <= qp[i] &&
                 (window <= 0 || qp[i] - kp[jj] < window);
        float x = s[i][jj];
        if (soft_cap != 0.f) x = soft_cap * tanhf(x / soft_cap);
        s[i][jj] = ok[jj] ? x : kNegInf;
        mt = fmaxf(mt, s[i][jj]);
      }
      const float mn = fmaxf(m[i], group_max<KG>(mt));
      corr[i] = expf(m[i] - mn);
      m[i] = mn;
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[i][jj] = ok[jj] ? expf(s[i][jj] - mn) : 0.f;
        psum += s[i][jj];
      }
      l[i] = l[i] * corr[i] + group_sum<KG>(psum);
    }
    // the probability tile, key-major, the 4 rows of a thread side by side
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      store4(sP + (kg + KG * jj) * ps + rg * 4,
             make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]));
    __syncwarp();      // a row's KG threads are lanes of this warp
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int cc = 0; cc < DCH; ++cc) acc[i][cc] = scale4(acc[i][cc], corr[i]);
    for (int key = 0; key < BK; ++key) {
      const float4 p4 = load4(sP + key * ps + rg * 4);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int cc = 0; cc < DCH; ++cc) {
        const int c = kg + KG * cc;
        if (c < nch) {
          const float4 vv = load4(sV + key * ds + c * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][cc].x = fmaf(pr[i], vv.x, acc[i][cc].x);
            acc[i][cc].y = fmaf(pr[i], vv.y, acc[i][cc].y);
            acc[i][cc].z = fmaf(pr[i], vv.z, acc[i][cc].z);
            acc[i][cc].w = fmaf(pr[i], vv.w, acc[i][cc].w);
          }
        }
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = row0 + rg * 4 + i;
    if (row >= rows) continue;
    const long long qi = row / g;
    const int hh = j * g + (int)(row - qi * g);
    T* dst = out + (((long long)b * sq + qi) * h + hh) * d;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < DCH; ++cc) {
      const int c = kg + KG * cc;
      if (c < nch) {
        const float4 a = acc[i][cc];
        store4(dst + c * 4, make_float4(a.x / li, a.y / li, a.z / li, a.w / li));
      }
    }
  }
}

template <typename T, int KG, int DMAX>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           const void* kpos, void* out, int b, int sq, int sk, int h, int kvh,
           int d, int window, float soft_cap, cudaStream_t stream) {
  using S = Shape<KG>;
  const size_t smem = smem_bytes<KG>(d);
  auto kernel = fa_fwd_kernel<T, KG, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)sq * (h / kvh);
  const dim3 grid((unsigned)((rows + S::kRows - 1) / S::kRows), kvh, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)qpos,
      (const int*)kpos, (T*)out, sq, sk, h, kvh, d, window, soft_cap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* qpos,
             const void* kpos, void* out, int b, int sq, int sk, int h,
             int kvh, int d, int window, float soft_cap, cudaStream_t stream) {
  const long long rows = (long long)sq * (h / kvh);
  if (d <= 128 && rows <= Shape<32>::kRows)
    return launch<T, 32, 128>(q, k, v, qpos, kpos, out, b, sq, sk, h, kvh, d,
                              window, soft_cap, stream);
  if (d <= 128)
    return launch<T, 8, 128>(q, k, v, qpos, kpos, out, b, sq, sk, h, kvh, d,
                             window, soft_cap, stream);
  return launch<T, 8, 256>(q, k, v, qpos, kpos, out, b, sq, sk, h, kvh, d,
                           window, soft_cap, stream);
}

}  // namespace

extern "C" {

// q (b, sq, h, d), k and v (b, sk, kvh, d), contiguous and 16-byte
// aligned, of dtype 0 = f32 or 1 = bf16; qpos (b, sq), kpos (b, sk) int32
// -> out (b, sq, h, d) of q's dtype. h % kvh == 0, d % 4 == 0, d <= 256.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* qpos, const void* kpos, void* out,
                        int dtype, int b, int sq, int sk, int h, int kvh,
                        int d, int window, float soft_cap, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || kvh < 1 || h < kvh || h % kvh != 0 ||
      d < 4 || d % 4 != 0 || d > 256 || b > 65535 || kvh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, qpos, kpos, out, b, sq, sk, h, kvh, d,
                           window, soft_cap, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, qpos, kpos, out, b, sq, sk, h,
                                   kvh, d, window, soft_cap, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
