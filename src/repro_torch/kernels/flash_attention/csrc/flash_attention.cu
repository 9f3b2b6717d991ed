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
// masked by bounds here. A row is a (query, group head) pair: the G = H /
// KV query heads that share a K/V head read each K/V tile once from shared
// memory (the GQA saving the TPU kernel had).
//
// What bounds it. At the serving path's prefill shape (Sq ~ Sk ~ 1k) the
// work is ~4 D flops per visible query-key pair against a few bytes per
// pair: operations (the tensor cores' in bf16, the CUDA cores' in f32).
// At decode (Sq = 1) it is the K/V bytes. Four bodies; the wrapper
// (ops.plan) picks one per call and names it:
//
//   route 0 "fma"  (f32 prefill, and bf16 with a head dim that has no mma
//     body): CUDA-core FMAs in f32, bf16 widened on its way into shared
//     memory; one block per 64 rows; each thread owns 4 rows x 4 keys of
//     the score tile; synchronous tile loads. f32 keeps exact f32
//     products: the port runs without TF32 to hold the reference.
//
//   route 1 "mma_bf16"  (bf16 prefill, D in 32/64/128/256, compiled for
//     the exact D so that every shared-memory offset is a constant):
//     tensor cores, FlashAttention-2's layout with mma.sync. Each of 8
//     warps owns 16 rows (128 a block, two blocks an SM); key tiles of 32
//     (64 for D <= 64) in a three-stage ring filled by cp.async (16 bytes
//     a thread), one barrier a tile; rows padded to D + 8 so that ldmatrix
//     is free of bank conflicts. S = Q K^T by mma.m16n8k16 (bf16 in, f32
//     out), Q and K fragments by ldmatrix; 1/sqrt(D) is applied to the f32
//     scores after the product (q stays exact in bf16); online softmax in
//     f32 on the accumulator fragments (row max and sum over the 4 lanes
//     of a row); P goes to bf16 A fragments in registers (the m16n8 C
//     layout is the A layout) and meets V through ldmatrix.trans, split
//     into P_hi + P_lo, each a P.V mma, so the product keeps
//     near-f32 probabilities as the reference's f32 P.V does. A tile that
//     every row sees whole skips the mask; the last row-blocks (most keys
//     under a causal mask) start first.
//
//   route 2 "split_decode" / route 3 "split_decode_mma"  (at most 16 rows
//     a (batch, kv head): decode): the grid is (splits, KV, B), each split
//     a contiguous chunk of keys, so a decode at B = 8, KV = 2 fills 132
//     SMs with hundreds of blocks instead of 16. Route 2 (f32, and bf16
//     without an mma body): each warp owns 4 rows and, in a 32-key
//     sub-tile, each lane one key, CUDA-core FMAs in f32, sub-tiles
//     through a three-slot cp.async ring. Route 3 (bf16, D in
//     32/64/128/256): the chunk's K and V are staged at once and each warp
//     takes 16-key tiles by mma with route 1's rounding; the warps' (m, l,
//     o) are combined in warp order. Each block writes its chunk's (m, l,
//     acc) in f32 to scratch; the last block of a (batch, kv head) to
//     arrive (a __threadfence and an atomicAdd on a counter the wrapper
//     keeps) merges the partials in split order and writes the output,
//     then resets the counter to 0: one launch, and two calls are bitwise
//     equal. A dark split (no row sees a key of it) loads nothing and
//     writes m = -1e30, l = 0, so its weight is 0; when every split is
//     dark the row is exactly 0.
//
// In every body a key tile no row of the block can see (causal, window,
// empty slots) is skipped: the block's min / max q_pos decide it, so a
// causal prefill does about half the tiles and a windowed decode only the
// window's. exp and tanh are full precision (expf, tanhf).
//
// Plain C interface for ctypes; the entry point launches on the stream it
// is given and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;   // the reference's NEG_INF, not -inf
constexpr int kMaskWords = 32;      // live-tile bits kept; later tiles: live
constexpr int kMaskTiles = 32 * kMaskWords;
constexpr int kMaxSplits = 1024;    // merge weights: 16 x splits floats

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  __align__(8) __nv_bfloat162 h[2];
  *reinterpret_cast<uint2*>(h) = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(bf16* p, float4 v) {
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

// ---- cp.async, ldmatrix and mma.sync ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !pred (src is
// then not read, but must be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a (16 x 16, row) . b (16 x 8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x: the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// the residual of (lo, hi) after rounding each to bf16, itself in bf16
__device__ __forceinline__ uint32_t pack_bf16_rest(float lo, float hi) {
  const float2 r = __bfloat1622float2(__floats2bfloat162_rn(lo, hi));
  return pack_bf16(lo - r.x, hi - r.y);
}

// ---- which key tiles a block's rows can see ----

__device__ __forceinline__ bool key_live(int kp, int qmin, int qmax,
                                         int window) {
  return kp >= 0 && kp <= qmax &&
         (window <= 0 || (long long)kp + window > qmin);
}

// Sets bit t of mask for each tile t (of bk keys, bk a multiple of 32,
// keys key0 + t * bk + ...) below key_end that holds a key some row in
// [qmin, qmax] may see, and bit t of notfull for each tile with a key that
// some row may not see (or past key_end): a tile live in mask and clear in
// notfull is seen whole by every row. Zeroes the masks first; ends with
// __syncthreads.
__device__ void mark_live_tiles(unsigned* mask, unsigned* notfull,
                                const int* kpos, int key0, int key_end,
                                int bk, int qmin, int qmax, int window) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  for (int w = tid; w < kMaskWords; w += nthreads) mask[w] = notfull[w] = 0u;
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int nkeys = key_end - key0;
  // 4 groups of 32 keys a warp at a time: their loads in flight together
  for (int base0 = warp * 32; base0 < nkeys; base0 += 4 * nwarps * 32) {
    int kp[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int key = key0 + base0 + u * nwarps * 32 + lane;
      kp[u] = key < key_end ? kpos[key] : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int base = base0 + u * nwarps * 32;
      if (base >= nkeys) break;
      const bool live = key_live(kp[u], qmin, qmax, window);
      const bool whole = kp[u] >= 0 && kp[u] <= qmin &&
                         (window <= 0 || (long long)qmax - kp[u] < window);
      const unsigned any = __ballot_sync(0xffffffffu, live);
      const unsigned all = __ballot_sync(0xffffffffu, whole);
      const int t = base / bk;
      if (lane == 0 && t < kMaskTiles) {
        if (any) atomicOr(&mask[t >> 5], 1u << (t & 31));
        if (all != 0xffffffffu) atomicOr(&notfull[t >> 5], 1u << (t & 31));
      }
    }
  }
  // a tile's keys past the last 32-key group of the range: not whole
  if (tid == 0) {
    const int t = nkeys / bk;
    if (nkeys % bk != 0 && t < kMaskTiles)
      atomicOr(&notfull[t >> 5], 1u << (t & 31));
  }
  __syncthreads();
}

// the first live tile after t (ntiles when none); tiles past the mask's
// reach count as live
__device__ __forceinline__ int next_live(const unsigned* mask, int t,
                                         int ntiles) {
  for (int u = t + 1; u < ntiles; ++u) {
    if (u >= kMaskTiles) return u;
    const unsigned w = mask[u >> 5] >> (u & 31);
    if (w) return u + __ffs(w) - 1;
    u |= 31;                                  // on to the next word
  }
  return ntiles;
}

// ============================= route 0: "fma" ============================

constexpr int kThreads = 128;

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

// T: float or bf16. KG: threads per row (and keys / 4 per tile).
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
      live |= key_live(kp, qmin, qmax, window);
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

template <typename T, int DMAX>
int launch_fma(const void* q, const void* k, const void* v, const void* qpos,
               const void* kpos, void* out, int b, int sq, int sk, int h,
               int kvh, int d, int window, float soft_cap,
               cudaStream_t stream) {
  constexpr int KG = 8;                 // 64 rows x 32 keys a tile
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

// ===================== route 1: "mma_bf16" (tensor cores) ================

constexpr int kMmaWarps = 8;
constexpr int kMmaRows = 16 * kMmaWarps;   // rows per block
constexpr int kStages = 3;                 // K/V ring

// keys a tile: 32 (64 for D <= 64)
template <int D>
struct MmaTile {
  static constexpr int kKeys = D <= 64 ? 64 : 32;
};

// Shared memory for head dim D: the block's Q rows, a ring of kStages K
// and V tiles (bf16, rows of D + 8), the tiles' key positions and the
// live / not-whole tile masks.
template <int D>
size_t mma_smem_bytes() {
  constexpr int BK = MmaTile<D>::kKeys;
  return ((size_t)kMmaRows + kStages * 2 * BK) * (D + 8) * sizeof(bf16) +
         kStages * BK * sizeof(int) + 2 * kMaskWords * sizeof(unsigned);
}

// D is the exact head dim: every shared-memory offset is a constant and
// no loop over it branches.
template <int D>
__global__ void __launch_bounds__(32 * kMmaWarps, D > 128 ? 1 : 2)
fa_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const int* __restrict__ qpos,
              const int* __restrict__ kpos, bf16* __restrict__ out, int sq,
              int sk, int h, int kvh, int window, float soft_cap,
              float scale) {
  constexpr int BK = MmaTile<D>::kKeys;
  constexpr int NT = BK / 8;        // n8 tiles of scores
  constexpr int KC = D / 16;        // k16 chunks of the head dim
  constexpr int OT = D / 8;         // n8 tiles of the output
  constexpr int PITCH = D + 8;      // bf16 a shared row: no bank conflicts
  constexpr int NCH = D / 8;        // 16-byte chunks a row
  constexpr int NTHREADS = 32 * kMmaWarps;
  const int g = h / kvh;
  const int b = blockIdx.z, j = blockIdx.y;
  const int rows = sq * g;
  // the last row-blocks see the most keys under a causal mask: they
  // start first, so the short ones fill the tail
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kMmaRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;   // C fragment: row, column pair
  // a row of the block -> its (query, head) row of q and out
  auto qrow_offset = [&](int row) {
    const int qi = row / g;
    return (((long long)b * sq + qi) * h + j * g + (row - qi * g)) * D;
  };

  extern __shared__ uint4 smem_u4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_u4);
  bf16* sRing = sQ + kMmaRows * PITCH;
  int* sKpos = reinterpret_cast<int*>(sRing + kStages * 2 * BK * PITCH);
  unsigned* sMask = reinterpret_cast<unsigned*>(sKpos + kStages * BK);
  unsigned* sNotFull = sMask + kMaskWords;
  __shared__ int s_qmin, s_qmax;

  // the block's Q rows (zeros past the last row)
#pragma unroll
  for (int i = 0; i < kMmaRows * NCH / NTHREADS; ++i) {
    const int idx = tid + i * NTHREADS, r = idx / NCH, c = idx % NCH;
    const bool ok = row0 + r < rows;
    cp_async16(sQ + r * PITCH + c * 8,
               ok ? q + qrow_offset(row0 + r) + c * 8 : q, ok);
  }
  cp_async_commit();

  // this thread's rows (gq and gq + 8 of its warp's 16) and the block's
  // range of query positions
  const int wrow = row0 + warp * 16;
  int qp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + gq + 8 * r;
    qp[r] = row < rows ? qpos[(long long)b * sq + row / g] : -1;
  }
  if (tid == 0) {
    s_qmin = INT_MAX;
    s_qmax = INT_MIN;
  }
  __syncthreads();
  if (tid < kMmaRows && row0 + tid < rows) {
    const int p = qpos[(long long)b * sq + (row0 + tid) / g];
    atomicMin(&s_qmin, p);
    atomicMax(&s_qmax, p);
  }
  __syncthreads();
  const int ntiles = (sk + BK - 1) / BK;
  const int* kpos_b = kpos + (long long)b * sk;
  mark_live_tiles(sMask, sNotFull, kpos_b, 0, sk, BK, s_qmin, s_qmax,
                  window);

  auto load_tile = [&](int t, int stage) {
    bf16* dk = sRing + stage * 2 * BK * PITCH;
    bf16* dv = dk + BK * PITCH;
#pragma unroll
    for (int i = 0; i < (BK * NCH + NTHREADS - 1) / NTHREADS; ++i) {
      const int idx = tid + i * NTHREADS, r = idx / NCH, c = idx % NCH;
      if (BK * NCH % NTHREADS == 0 || r < BK) {
        const int key = t * BK + r;
        const bool ok = key < sk;
        const long long off =
            ok ? (((long long)b * sk + key) * kvh + j) * D + c * 8 : 0;
        cp_async16(dk + r * PITCH + c * 8, k + off, ok);
        cp_async16(dv + r * PITCH + c * 8, v + off, ok);
      }
    }
    if (tid < BK) {
      const int key = t * BK + tid;
      if (key < sk)
        cp_async4(sKpos + stage * BK + tid, kpos_b + key);
      else
        sKpos[stage * BK + tid] = -1;
    }
  };

  // the ring: kStages - 1 live tiles in flight; tile i + kStages - 1
  // loads, after the barrier of tile i, into the stage tile i - 1 left
  int tl[kStages];                  // the live tiles in flight, in order
  tl[0] = next_live(sMask, -1, ntiles);
#pragma unroll
  for (int i = 1; i < kStages; ++i)
    tl[i] = next_live(sMask, tl[i - 1], ntiles);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (tl[i] < ntiles) load_tile(tl[i], i);
    cp_async_commit();
  }

  const bool warp_live = wrow < rows;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[OT][4];
#pragma unroll
  for (int ot = 0; ot < OT; ++ot)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[ot][e] = 0.f;
  // ldmatrix addresses: lane -> (matrix lane / 8, its row lane % 8)
  const int mi = lane >> 3, mr = lane & 7;
  const bf16* qfrag = sQ + (warp * 16 + (lane & 15)) * PITCH + (lane >> 4) * 8;
  const int koff = ((mi >> 1) * 8 + mr) * PITCH + (mi & 1) * 8;
  const int voff = ((mi & 1) * 8 + mr) * PITCH + (mi >> 1) * 8;

  int stage = 0;
  while (tl[0] < ntiles) {
    const int t = tl[0];
    cp_async_wait<kStages - 2>();   // tile t (and Q) have landed
    __syncthreads();
    {
      const int ahead = tl[kStages - 1];
      if (ahead < ntiles) load_tile(ahead, (stage + kStages - 1) % kStages);
      cp_async_commit();
#pragma unroll
      for (int i = 0; i < kStages - 1; ++i) tl[i] = tl[i + 1];
      tl[kStages - 1] = next_live(sMask, ahead, ntiles);
    }
    if (warp_live) {
      const bf16* sK = sRing + stage * 2 * BK * PITCH;
      const bf16* sV = sK + BK * PITCH;
      const int* kp = sKpos + stage * BK;
      const bool whole =
          t < kMaskTiles && !((sNotFull[t >> 5] >> (t & 31)) & 1u);
      // S = Q K^T: 16 rows x BK keys a warp
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t qf[4];
        ldmatrix_x4(qf, qfrag + kc * 16);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, sK + koff + np * 16 * PITCH + kc * 16);
          mma_bf16(s[2 * np], qf, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qf, bk[2], bk[3]);
        }
      }
      // cap (scores scaled first) or not (scores stay raw, and 1/sqrt(D)
      // is folded into the exp's argument: max commutes with a positive
      // scale); then, unless every row sees the whole tile, mask
      float sc = scale;
      if (soft_cap != 0.f) {
        sc = 1.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[nt][e] = soft_cap * tanhf(s[nt][e] * scale / soft_cap);
      }
      uint32_t okbits = 0xffffffffu;
      if (!whole) {
        okbits = 0u;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, kpv = kp[nt * 8 + 2 * tq + (e & 1)];
            const bool ok = kpv >= 0 && kpv <= qp[r] &&
                            (window <= 0 || qp[r] - kpv < window);
            okbits |= (ok ? 1u : 0u) << (nt * 4 + e);
            if (!ok) s[nt][e] = kNegInf;
          }
      }
      // the online softmax on the fragments: row max and sum over the 4
      // lanes of a row
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      float corr[2], lsum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r] == kNegInf ? kNegInf : mx[r] * sc);
        corr[r] = expf(m[r] - mn);
        m[r] = mn;
      }
      if (whole) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = expf(fmaf(s[nt][e], sc, -m[e >> 1]));
            s[nt][e] = p;
            lsum[e >> 1] += p;
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = (okbits >> (nt * 4 + e)) & 1u
                                ? expf(fmaf(s[nt][e], sc, -m[e >> 1]))
                                : 0.f;
            s[nt][e] = p;
            lsum[e >> 1] += p;
          }
      }
      // l is this thread's share of the row sum; the 4 lanes of a row add
      // theirs at the end
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + lsum[r];
      if (corr[0] != 1.f || corr[1] != 1.f) {
#pragma unroll
        for (int ot = 0; ot < OT; ++ot) {
          o[ot][0] *= corr[0];
          o[ot][1] *= corr[0];
          o[ot][2] *= corr[1];
          o[ot][3] *= corr[1];
        }
      }
      // O += P V: P's C fragments are the A fragments of the next
      // product; each V fragment meets P_hi, then P_lo
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t a_lo[4] = {
            pack_bf16_rest(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16_rest(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16_rest(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16_rest(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int op = 0; op < OT / 2; ++op) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, sV + voff + kk * 16 * PITCH + op * 16);
          mma_bf16(o[2 * op], a, bv[0], bv[1]);
          mma_bf16(o[2 * op + 1], a, bv[2], bv[3]);
          mma_bf16(o[2 * op], a_lo, bv[0], bv[1]);
          mma_bf16(o[2 * op + 1], a_lo, bv[2], bv[3]);
        }
      }
    }
    stage = stage == kStages - 1 ? 0 : stage + 1;
  }
  // Q's copies have landed in every thread (a block with no live tile
  // never passed the loop's barrier) before the epilogue reuses sQ
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (!warp_live) return;
  // the warp's 16 rows, normalized, through its own rows of sQ (only this
  // warp reads them), then out in 16-byte stores
  bf16* so = sQ + warp * 16 * PITCH;
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // one division a row, not one an element (a product by 1/l differs
    // from a quotient by at most an f32 ulp, far below a bf16 step)
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int ot = 0; ot < OT; ++ot)
      *reinterpret_cast<__nv_bfloat162*>(so + (gq + 8 * r) * PITCH + ot * 8 +
                                         2 * tq) =
          __floats2bfloat162_rn(o[ot][2 * r] * inv, o[ot][2 * r + 1] * inv);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * NCH / 32; ++i) {
    const int idx = lane + 32 * i, r = idx / NCH, c = idx % NCH;
    if (wrow + r < rows)
      *reinterpret_cast<uint4*>(out + qrow_offset(wrow + r) + c * 8) =
          *reinterpret_cast<const uint4*>(so + r * PITCH + c * 8);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* qpos,
               const void* kpos, void* out, int b, int sq, int sk, int h,
               int kvh, int window, float soft_cap, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>();
  auto kernel = fa_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = sq * (h / kvh);
  const dim3 grid((unsigned)((rows + kMmaRows - 1) / kMmaRows), kvh, b);
  kernel<<<grid, 32 * kMmaWarps, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)qpos,
      (const int*)kpos, (bf16*)out, sq, sk, h, kvh, window, soft_cap,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// ================== route 2: "split_decode" (split over keys) ============

constexpr int kSplitWarps = 4;
constexpr int kSplitRows = 4 * kSplitWarps;   // all rows of a (batch, kv)
constexpr int kSub = 32;                      // keys a sub-tile: one a lane
constexpr int kSubRing = 3;                   // sub-tiles in the ring

// Shared memory for head dim d and element size es: Q (16 rows of d + 4
// f32), the warps' probability tiles (32 keys x 4 rows), key positions,
// then a ring of K and V sub-tiles (rows of d + 4 elements), which the
// merge reuses for its weights (16 x splits f32 and 16 sums).
size_t split_smem_bytes(int d, int es, int splits) {
  const size_t ring = (size_t)kSubRing * 2 * kSub * (d + 4) * es;
  const size_t weights = (size_t)(kSplitRows * splits + kSplitRows) * 4;
  return (size_t)kSplitRows * (d + 4) * 4 + kSplitWarps * kSub * 4 * 4 +
         kSubRing * kSub * 4 + (ring > weights ? ring : weights);
}

// one vector of 4 elements global -> shared: 16 bytes f32, 8 bytes bf16
__device__ __forceinline__ void cp_async_vec4(float* dst, const float* src,
                                              bool pred) {
  cp_async16(dst, src, pred);
}
__device__ __forceinline__ void cp_async_vec4(bf16* dst, const bf16* src,
                                              bool pred) {
  cp_async8(dst, src, pred);
}

// The split decode's end, in every block of the grid (splits, KV, B) once
// it has written its chunk's partials: the last block of a (batch, kv
// head) to arrive (a __threadfence, then an atomicAdd on its counter)
// merges the chunks in split order — M = max m_i, w_i = exp(m_i - M),
// l = sum w_i l_i, o = sum w_i acc_i / max(l, 1e-30) — writes o and resets
// the counter to 0. sW: shared memory for 16 x splits + 16 floats.
template <typename T>
__device__ void merge_splits(const float* part, int* counters, T* out,
                             int sq, int h, int kvh, int d, int splits,
                             float* sW) {
  const int b = blockIdx.z, j = blockIdx.y, bj = b * kvh + j;
  const int g = h / kvh, rows = sq * g, nch = d >> 2;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counters + bj, 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  const long long nparts = (long long)gridDim.z * kvh * splits;
  const float* part_acc = part;
  const float* part_m = part + nparts * kSplitRows * d;
  const float* part_l = part_m + nparts * kSplitRows;
  float* sLi = sW + kSplitRows * splits;
  const long long first = (long long)bj * splits * kSplitRows;
  // weights: 8 lanes a row (rows <= 16), each over splits sub, sub + 8, ..
  for (int t0 = 0; t0 < kSplitRows * 8; t0 += nthreads) {
    const int r = (t0 + tid) >> 3, sub = tid & 7;
    float mx = kNegInf;
    if (r < rows) {
#pragma unroll 4
      for (int i = sub; i < splits; i += 8)
        mx = fmaxf(mx, __ldcg(part_m + first + (long long)i * kSplitRows + r));
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float lsum = 0.f;
    if (r < rows) {
#pragma unroll 4
      for (int i = sub; i < splits; i += 8) {
        const long long at = first + (long long)i * kSplitRows + r;
        const float w = expf(__ldcg(part_m + at) - mx);
        sW[r * splits + i] = w;
        lsum = fmaf(w, __ldcg(part_l + at), lsum);
      }
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
    if (r < rows && sub == 0) sLi[r] = fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  // o, in split order (deterministic): a thread's items (row, 4
  // columns) kItems at a time, 8 splits of each in flight
  constexpr int kItems = 3, kBatch = 8;
  const long long step = (long long)kSplitRows * d;
  const int items = rows * nch;
  for (int i0 = tid; i0 < items; i0 += kItems * nthreads) {
    float4 o[kItems];
    const float* src[kItems];
    int ir[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int idx = min(i0 + u * nthreads, items - 1);
      ir[u] = idx / nch;
      src[u] = part_acc + (first + ir[u]) * d + (idx - ir[u] * nch) * 4;
      o[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int s0 = 0; s0 < splits; s0 += kBatch) {
      float4 a[kItems][kBatch];
#pragma unroll
      for (int u = 0; u < kItems; ++u)
#pragma unroll
        for (int x = 0; x < kBatch; ++x)
          if (s0 + x < splits)
            a[u][x] = __ldcg(
                reinterpret_cast<const float4*>(src[u] + (s0 + x) * step));
#pragma unroll
      for (int u = 0; u < kItems; ++u)
#pragma unroll
        for (int x = 0; x < kBatch; ++x) {
          if (s0 + x < splits) {
            const float w = sW[ir[u] * splits + s0 + x];
            o[u].x = fmaf(w, a[u][x].x, o[u].x);
            o[u].y = fmaf(w, a[u][x].y, o[u].y);
            o[u].z = fmaf(w, a[u][x].z, o[u].z);
            o[u].w = fmaf(w, a[u][x].w, o[u].w);
          }
        }
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int idx = i0 + u * nthreads;
      if (idx >= items) continue;
      const int r = ir[u], c = idx - r * nch;
      const float li = sLi[r];
      const int qi = r / g, hh = j * g + r % g;
      store4(out + (((long long)b * sq + qi) * h + hh) * d + c * 4,
             make_float4(o[u].x / li, o[u].y / li, o[u].z / li,
                         o[u].w / li));
    }
  }
  if (tid == 0) counters[bj] = 0;           // ready for the next call
}

// The rows' range of query positions of a (batch, kv head) with at most
// 16 rows, in every lane of the warp (lane r reads row r's).
__device__ __forceinline__ void decode_qrange(const int* qpos, int b, int sq,
                                              int g, int rows, int* qmin,
                                              int* qmax) {
  const int lane = threadIdx.x & 31;
  int lo = INT_MAX, hi = INT_MIN;
  if (lane < rows) lo = hi = qpos[(long long)b * sq + lane / g];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  *qmin = lo;
  *qmax = hi;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(32 * kSplitWarps)
fa_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ qpos,
                const int* __restrict__ kpos, T* __restrict__ out, int sq,
                int sk, int h, int kvh, int d, int window, float soft_cap,
                int chunk, int splits, float* __restrict__ part,
                int* __restrict__ counters) {
  constexpr int DCH = DMAX / 128;             // 4-column groups a lane
  constexpr int NTHREADS = 32 * kSplitWarps;
  const int split = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int g = h / kvh, rows = sq * g;       // rows <= 16
  const int bj = b * kvh + j;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pitch = d + 4, nch = d >> 2;
  const int key_lo = split * chunk;
  const int key_hi = min(sk, key_lo + chunk);
  const int nsub = (key_hi - key_lo + kSub - 1) / kSub;

  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sP = sQ + kSplitRows * pitch;
  int* sKpos = reinterpret_cast<int*>(sP + kSplitWarps * kSub * 4);
  T* sRing = reinterpret_cast<T*>(sKpos + kSubRing * kSub);

  // The live sub-tiles of this chunk, in each warp alike (no barrier):
  // the rows' range of query positions (lane r reads row r's), then a
  // ballot over each sub-tile's keys. Bit t: sub-tile t may hold a key
  // some row sees; sub-tiles from 32 on count as live.
  const int* kpos_b = kpos + (long long)b * sk;
  int qmin, qmax;
  decode_qrange(qpos, b, sq, g, rows, &qmin, &qmax);
  unsigned live = 0u;
  for (int t0 = 0; t0 < nsub && t0 < 32; t0 += 4) {
    int kv[4];                       // 4 loads in flight, then 4 ballots
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int key = key_lo + (t0 + u) * kSub + lane;
      kv[u] = t0 + u < nsub && key < key_hi ? kpos_b[key] : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (t0 + u < nsub &&
          __ballot_sync(0xffffffffu, key_live(kv[u], qmin, qmax, window)))
        live |= 1u << (t0 + u);
  }
  auto next_sub = [&](int t) {       // the first live sub-tile after t
    for (int u = t + 1; u < nsub; ++u)
      if (u >= 32 || ((live >> u) & 1u)) return u;
    return nsub;
  };
  auto load_sub = [&](int t, int slot) {
    T* dk = sRing + slot * 2 * kSub * pitch;
    T* dv = dk + kSub * pitch;
    for (int idx = tid; idx < kSub * nch; idx += NTHREADS) {
      const int r = idx / nch, c = idx - r * nch;
      const int key = key_lo + t * kSub + r;
      const bool ok = key < key_hi;
      const long long off =
          ok ? (((long long)b * sk + key) * kvh + j) * d + c * 4 : 0;
      cp_async_vec4(dk + r * pitch + c * 4, k + off, ok);
      cp_async_vec4(dv + r * pitch + c * 4, v + off, ok);
    }
    if (tid < kSub) {
      const int key = key_lo + t * kSub + tid;
      if (key < key_hi)
        cp_async4(sKpos + slot * kSub + tid, kpos_b + key);
      else
        sKpos[slot * kSub + tid] = -1;
    }
  };
  // the ring: kSubRing - 1 live sub-tiles in flight before anything else
  int tl[kSubRing];
  tl[0] = next_sub(-1);
#pragma unroll
  for (int i = 1; i < kSubRing; ++i) tl[i] = next_sub(tl[i - 1]);
#pragma unroll
  for (int i = 0; i < kSubRing - 1; ++i) {
    if (tl[i] < nsub) load_sub(tl[i], i);
    cp_async_commit();
  }

  // the rows of q, pre-divided by sqrt(D) as the reference does
  const float sqrt_d = sqrtf((float)d);
#pragma unroll 4
  for (int idx = tid; idx < kSplitRows * nch; idx += NTHREADS) {
    const int r = idx / nch, c = idx - r * nch;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) {
      const int qi = r / g, hh = j * g + r % g;
      x = load4(q + (((long long)b * sq + qi) * h + hh) * d + c * 4);
      x = make_float4(x.x / sqrt_d, x.y / sqrt_d, x.z / sqrt_d, x.w / sqrt_d);
    }
    store4(sQ + r * pitch + c * 4, x);
  }

  // warp w owns rows 4w .. 4w + 3
  const int row0 = 4 * warp;
  int qp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + i;
    qp[i] = r < rows ? qpos[(long long)b * sq + r / g] : -1;
  }
  const bool warp_live = row0 < rows;
  float m[4], l[4];
  float4 acc[4][DCH];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < DCH; ++cc)
      acc[i][cc] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  int slot = 0;
  while (tl[0] < nsub) {
    cp_async_wait<kSubRing - 2>();  // sub-tile tl[0] has landed
    __syncthreads();                // (and Q, the first time)
    {
      const int ahead = tl[kSubRing - 1];
      if (ahead < nsub) load_sub(ahead, (slot + kSubRing - 1) % kSubRing);
      cp_async_commit();
#pragma unroll
      for (int i = 0; i < kSubRing - 1; ++i) tl[i] = tl[i + 1];
      tl[kSubRing - 1] = next_sub(ahead);
    }
    if (warp_live) {
      const T* sK = sRing + slot * 2 * kSub * pitch;
      const T* sV = sK + kSub * pitch;
      // scores: this warp's rows against the lane's key
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      const T* krow = sK + lane * pitch;
      const float* qrow = sQ + row0 * pitch;
#pragma unroll 4
      for (int c = 0; c < nch; ++c) {
        const float4 kx = load4(krow + c * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qx = load4(qrow + i * pitch + c * 4);
          float x = s[i];
          x = fmaf(qx.x, kx.x, x);
          x = fmaf(qx.y, kx.y, x);
          x = fmaf(qx.z, kx.z, x);
          x = fmaf(qx.w, kx.w, x);
          s[i] = x;
        }
      }
      const int kpv = sKpos[slot * kSub + lane];
      float corr[4], pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = kpv >= 0 && kpv <= qp[i] &&
                        (window <= 0 || qp[i] - kpv < window);
        float x = s[i];
        if (soft_cap != 0.f) x = soft_cap * tanhf(x / soft_cap);
        x = ok ? x : kNegInf;
        const float mn = fmaxf(m[i], group_max<32>(x));
        corr[i] = expf(m[i] - mn);
        m[i] = mn;
        pr[i] = ok ? expf(x - mn) : 0.f;
        l[i] = l[i] * corr[i] + group_sum<32>(pr[i]);
      }
      float* wp = sP + warp * kSub * 4;
      store4(wp + lane * 4, make_float4(pr[0], pr[1], pr[2], pr[3]));
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < DCH; ++cc)
          acc[i][cc] = scale4(acc[i][cc], corr[i]);
#pragma unroll 2
      for (int key = 0; key < kSub; ++key) {
        const float4 p4 = load4(wp + key * 4);
        const float pk[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int cc = 0; cc < DCH; ++cc) {
          const int col = 4 * lane + 128 * cc;
          if (col < d) {
            const float4 vv = load4(sV + key * pitch + col);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][cc].x = fmaf(pk[i], vv.x, acc[i][cc].x);
              acc[i][cc].y = fmaf(pk[i], vv.y, acc[i][cc].y);
              acc[i][cc].z = fmaf(pk[i], vv.z, acc[i][cc].z);
              acc[i][cc].w = fmaf(pk[i], vv.w, acc[i][cc].w);
            }
          }
        }
      }
      __syncwarp();                 // wp is read before the next sub-tile
    }
    slot = slot == kSubRing - 1 ? 0 : slot + 1;
  }
  cp_async_wait<0>();

  // this split's partials: (m, l, acc) of each row, f32
  const long long nparts = (long long)gridDim.z * kvh * splits;
  float* part_acc = part;
  float* part_m = part + nparts * kSplitRows * d;
  float* part_l = part_m + nparts * kSplitRows;
  const long long base = ((long long)bj * splits + split) * kSplitRows;
  if (warp_live) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + i;
      if (r >= rows) continue;
      if (lane == 0) {
        part_m[base + r] = m[i];
        part_l[base + r] = l[i];
      }
#pragma unroll
      for (int cc = 0; cc < DCH; ++cc) {
        const int col = 4 * lane + 128 * cc;
        if (col < d) store4(part_acc + (base + r) * d + col, acc[i][cc]);
      }
    }
  }

  merge_splits(part, counters, out, sq, h, kvh, d, splits,
               reinterpret_cast<float*>(sRing));
}


// ----- route 3: "split_decode_mma" (bf16, D % 16 == 0, decode) -----
//
// The split decode on tensor cores: a block stages its chunk's K and V
// (up to kDecWin keys at a time) and the 16 rows of Q (zeros past the
// last row) in shared memory by cp.async; warp w takes the chunk's
// 16-key tiles w, w + 4, ...: S = Q K^T and P V by mma.m16n8k16 with the
// mma_bf16 body's rounding (1/sqrt(D) after the product, P_hi + P_lo),
// an online softmax on the fragments. The 4 warps' (m, l, o) are combined
// in shared memory in warp order into the chunk's partial, then
// merge_splits as in route 2.

constexpr int kDecWin = 128;      // keys staged at once

size_t split_mma_smem_bytes(int d, int win, int splits) {  // d: exact
  const size_t kv = (size_t)2 * win * (d + 8) * sizeof(bf16);
  const size_t combine =
      (size_t)kSplitWarps * kSplitRows * (d + 2) * 4 + kSplitRows * 8 * 4;
  const size_t weights = (size_t)(kSplitRows * splits + kSplitRows) * 4;
  size_t big = kv > combine ? kv : combine;
  big = big > weights ? big : weights;
  return (size_t)kSplitRows * (d + 8) * sizeof(bf16) + win * sizeof(int) +
         big;
}

template <int D>
__global__ void __launch_bounds__(32 * kSplitWarps)
fa_split_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ qpos,
                    const int* __restrict__ kpos, bf16* __restrict__ out,
                    int sq, int sk, int h, int kvh, int d, int window,
                    float soft_cap, float scale, int chunk,
                    int splits, int win, float* __restrict__ part,
                    int* __restrict__ counters) {
  constexpr int KC = D / 16;        // k16 chunks of the head dim
  constexpr int OT = D / 8;         // n8 tiles of the output
  constexpr int NTHREADS = 32 * kSplitWarps;
  constexpr int pitch = D + 8, nch = D / 8;
  const int split = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int g = h / kvh, rows = sq * g;       // rows <= 16
  const int bj = b * kvh + j;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const int key_lo = split * chunk;
  const int key_hi = min(sk, key_lo + chunk);

  extern __shared__ uint4 smem_u4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_u4);
  int* sKpos = reinterpret_cast<int*>(sQ + kSplitRows * pitch);
  float* sBig = reinterpret_cast<float*>(sKpos + win);   // 16-byte aligned
  bf16* sK = reinterpret_cast<bf16*>(sBig);
  bf16* sV = sK + win * pitch;

  // is any key of the chunk visible to some row? (each warp alike; the
  // first 128 keys' positions load beside the rows')
  const int* kpos_b = kpos + (long long)b * sk;
  int kv4[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int key = key_lo + 32 * u + lane;
    kv4[u] = key < key_hi ? kpos_b[key] : -1;
  }
  int qmin, qmax;
  decode_qrange(qpos, b, sq, g, rows, &qmin, &qmax);
  bool live = false;
  for (int k0 = key_lo; k0 < key_hi && !live; k0 += 128) {
    if (k0 > key_lo) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int key = k0 + 32 * u + lane;
        kv4[u] = key < key_hi ? kpos_b[key] : -1;
      }
    }
    bool any = false;
#pragma unroll
    for (int u = 0; u < 4; ++u) any |= key_live(kv4[u], qmin, qmax, window);
    live = __any_sync(0xffffffffu, any);
  }

  int qp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = gq + 8 * r;
    qp[r] = row < rows ? qpos[(long long)b * sq + row / g] : -1;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[OT][4];
#pragma unroll
  for (int ot = 0; ot < OT; ++ot)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[ot][e] = 0.f;

  if (live) {
    for (int r = tid; r < kSplitRows * nch; r += NTHREADS) {
      const int row = r / nch, c = r - row * nch;
      const bool ok = row < rows;
      const bf16* src = q;
      if (ok)
        src = q + (((long long)b * sq + row / g) * h + j * g + row % g) * d +
              c * 8;
      cp_async16(sQ + row * pitch + c * 8, src, ok);
    }
    const bf16* qrow = sQ + (lane & 15) * pitch + (lane >> 4) * 8;
    for (int w0 = key_lo; w0 < key_hi; w0 += win) {
      const int nk = min(win, key_hi - w0);
      for (int idx = tid; idx < nk * nch; idx += NTHREADS) {
        const int r = idx / nch, c = idx - r * nch;
        const long long off =
            (((long long)b * sk + w0 + r) * kvh + j) * d + c * 8;
        cp_async16(sK + r * pitch + c * 8, k + off, true);
        cp_async16(sV + r * pitch + c * 8, v + off, true);
      }
      // a ragged last tile: zero rows, so p = 0 never meets NaN
      const int nk16 = (nk + 15) & ~15;
      for (int idx = tid; idx < (nk16 - nk) * nch; idx += NTHREADS) {
        const int r = nk + idx / nch, c = idx % nch;
        cp_async16(sK + r * pitch + c * 8, k, false);
        cp_async16(sV + r * pitch + c * 8, v, false);
      }
      for (int r = tid; r < nk16; r += NTHREADS) {
        if (r < nk)
          cp_async4(sKpos + r, kpos_b + w0 + r);
        else
          sKpos[r] = -1;
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int t16 = warp; t16 * 16 < nk; t16 += kSplitWarps) {
        float s[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t qf[4], kf[4];
          ldmatrix_x4(qf, qrow + kc * 16);
          ldmatrix_x4(kf, sK + (t16 * 16 + (mi >> 1) * 8 + mr) * pitch +
                              kc * 16 + (mi & 1) * 8);
          mma_bf16(s[0], qf, kf[0], kf[1]);
          mma_bf16(s[1], qf, kf[2], kf[3]);
        }
        float mt[2] = {kNegInf, kNegInf};
        uint32_t okbits = 0u;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int kpv = sKpos[t16 * 16 + nt * 8 + 2 * tq + (e & 1)];
            float x = s[nt][e] * scale;
            if (soft_cap != 0.f) x = soft_cap * tanhf(x / soft_cap);
            const bool ok = kpv >= 0 && kpv <= qp[r] &&
                            (window <= 0 || qp[r] - kpv < window);
            okbits |= (ok ? 1u : 0u) << (nt * 4 + e);
            s[nt][e] = ok ? x : kNegInf;
            mt[r] = fmaxf(mt[r], s[nt][e]);
          }
        float corr[2], lsum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
          mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
          const float mn = fmaxf(m[r], mt[r]);
          corr[r] = expf(m[r] - mn);
          m[r] = mn;
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float p =
                (okbits >> (nt * 4 + e)) & 1u ? expf(s[nt][e] - m[r]) : 0.f;
            s[nt][e] = p;
            lsum[r] += p;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + lsum[r];
#pragma unroll
        for (int ot = 0; ot < OT; ++ot) {
          o[ot][0] *= corr[0];
          o[ot][1] *= corr[0];
          o[ot][2] *= corr[1];
          o[ot][3] *= corr[1];
        }
        const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]),
                               pack_bf16(s[0][2], s[0][3]),
                               pack_bf16(s[1][0], s[1][1]),
                               pack_bf16(s[1][2], s[1][3])};
        const uint32_t a_lo[4] = {pack_bf16_rest(s[0][0], s[0][1]),
                                  pack_bf16_rest(s[0][2], s[0][3]),
                                  pack_bf16_rest(s[1][0], s[1][1]),
                                  pack_bf16_rest(s[1][2], s[1][3])};
        constexpr int OG = OT / 2 < 4 ? OT / 2 : 4;
#pragma unroll
        for (int g0 = 0; g0 < OT / 2; g0 += OG) {
          uint32_t bv[OG][4];
#pragma unroll
          for (int u = 0; u < OG; ++u) {
            const int op = g0 + u;
            ldmatrix_x4_trans(bv[u], sV + (t16 * 16 + (mi & 1) * 8 + mr) *
                                              pitch +
                                         op * 16 + (mi >> 1) * 8);
            mma_bf16(o[2 * op], a, bv[u][0], bv[u][1]);
            mma_bf16(o[2 * op + 1], a, bv[u][2], bv[u][3]);
          }
#pragma unroll
          for (int u = 0; u < OG; ++u) {
            const int op = g0 + u;
            mma_bf16(o[2 * op], a_lo, bv[u][0], bv[u][1]);
            mma_bf16(o[2 * op + 1], a_lo, bv[u][2], bv[u][3]);
          }
        }
      }
      __syncthreads();              // K and V read: free for what follows
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // the warps' (m, l, o) -> shared memory, then the chunk's partial
  float* sO = sBig;                                   // [warp][row][d]
  float* sM = sO + kSplitWarps * kSplitRows * d;      // [warp][row]
  float* sL = sM + kSplitWarps * kSplitRows;
  float* sWt = sL + kSplitWarps * kSplitRows;         // [row][warp]
  float* sMx = sWt + kSplitRows * kSplitWarps;        // [row]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = gq + 8 * r;
    if (tq == 0) {
      sM[warp * kSplitRows + row] = m[r];
      sL[warp * kSplitRows + row] = l[r];
    }
    float* dst = sO + (warp * kSplitRows + row) * D + 2 * tq;
#pragma unroll
    for (int ot = 0; ot < OT; ++ot)
      *reinterpret_cast<float2*>(dst + ot * 8) =
          make_float2(o[ot][2 * r], o[ot][2 * r + 1]);
  }
  __syncthreads();
  const long long nparts = (long long)gridDim.z * kvh * splits;
  float* part_acc = part;
  float* part_m = part + nparts * kSplitRows * d;
  float* part_l = part_m + nparts * kSplitRows;
  const long long base = ((long long)bj * splits + split) * kSplitRows;
  if (tid < kSplitRows) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w)
      mx = fmaxf(mx, sM[w * kSplitRows + tid]);
    float ls = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float wt = expf(sM[w * kSplitRows + tid] - mx);
      sWt[tid * kSplitWarps + w] = wt;
      ls = fmaf(wt, sL[w * kSplitRows + tid], ls);
    }
    sMx[tid] = mx;
    if (tid < rows) {
      part_m[base + tid] = mx;
      part_l[base + tid] = ls;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < rows * (d >> 2); idx += NTHREADS) {
    const int r = idx / (d >> 2), c = (idx - r * (d >> 2)) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float wt = sWt[r * kSplitWarps + w];
      const float4 x = load4(sO + (w * kSplitRows + r) * d + c);
      acc.x = fmaf(wt, x.x, acc.x);
      acc.y = fmaf(wt, x.y, acc.y);
      acc.z = fmaf(wt, x.z, acc.z);
      acc.w = fmaf(wt, x.w, acc.w);
    }
    store4(part_acc + (base + r) * d + c, acc);
  }
  __syncthreads();                  // sBig is read: the merge may reuse it
  merge_splits(part, counters, out, sq, h, kvh, d, splits, sBig);
}

template <typename T, int DMAX>
int launch_split(const void* q, const void* k, const void* v,
                 const void* qpos, const void* kpos, void* out, int b, int sq,
                 int sk, int h, int kvh, int d, int window, float soft_cap,
                 int chunk, int splits, void* part, void* counters,
                 cudaStream_t stream) {
  const size_t smem = split_smem_bytes(d, (int)sizeof(T), splits);
  auto kernel = fa_split_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)splits, kvh, b);
  kernel<<<grid, 32 * kSplitWarps, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)qpos,
      (const int*)kpos, (T*)out, sq, sk, h, kvh, d, window, soft_cap, chunk,
      splits, (float*)part, (int*)counters);
  return (int)cudaGetLastError();
}

template <int D>
int launch_split_mma(const void* q, const void* k, const void* v,
                     const void* qpos, const void* kpos, void* out, int b,
                     int sq, int sk, int h, int kvh, int window,
                     float soft_cap, int chunk, int splits,
                     void* part, void* counters, cudaStream_t stream) {
  const int win = chunk < kDecWin ? chunk : kDecWin;
  const size_t smem = split_mma_smem_bytes(D, win, splits);
  auto kernel = fa_split_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)splits, kvh, b);
  kernel<<<grid, 32 * kSplitWarps, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)qpos,
      (const int*)kpos, (bf16*)out, sq, sk, h, kvh, D, window, soft_cap,
      1.0f / sqrtf((float)D), chunk, splits, win, (float*)part,
      (int*)counters);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_split(const void* q, const void* k, const void* v,
                   const void* qpos, const void* kpos, void* out, int b,
                   int sq, int sk, int h, int kvh, int d, int window,
                   float soft_cap, int chunk, int splits, void* part,
                   void* counters, cudaStream_t stream) {
  if (d <= 128)
    return launch_split<T, 128>(q, k, v, qpos, kpos, out, b, sq, sk, h, kvh,
                                d, window, soft_cap, chunk, splits, part,
                                counters, stream);
  return launch_split<T, 256>(q, k, v, qpos, kpos, out, b, sq, sk, h, kvh, d,
                              window, soft_cap, chunk, splits, part, counters,
                              stream);
}

template <typename T>
int dispatch_fma(const void* q, const void* k, const void* v,
                 const void* qpos, const void* kpos, void* out, int b, int sq,
                 int sk, int h, int kvh, int d, int window, float soft_cap,
                 cudaStream_t stream) {
  if (d <= 128)
    return launch_fma<T, 128>(q, k, v, qpos, kpos, out, b, sq, sk, h, kvh, d,
                              window, soft_cap, stream);
  return launch_fma<T, 256>(q, k, v, qpos, kpos, out, b, sq, sk, h, kvh, d,
                            window, soft_cap, stream);
}

}  // namespace

extern "C" {

// q (b, sq, h, d), k and v (b, sk, kvh, d), contiguous and 16-byte
// aligned, of dtype 0 = f32 or 1 = bf16; qpos (b, sq), kpos (b, sk) int32
// -> out (b, sq, h, d) of q's dtype. h % kvh == 0, d % 4 == 0, d <= 256.
// route 0 "fma"; 1 "mma_bf16" (bf16, d in 32/64/128/256); 2
// "split_decode" and 3 "split_decode_mma" (bf16, d as route 1), both with
// sq * h / kvh <= 16, chunk a multiple of 32, splits = ceil(sk / chunk)
// <= 1024, part f32 scratch of b * kvh * splits * 16 * (d + 2), counters
// b * kvh int32 that are 0 and are left 0.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* qpos, const void* kpos, void* out,
                        int dtype, int b, int sq, int sk, int h, int kvh,
                        int d, int window, float soft_cap, int route,
                        int chunk, int splits, void* part, void* counters,
                        void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || kvh < 1 || h < kvh || h % kvh != 0 ||
      d < 4 || d % 4 != 0 || d > 256 || b > 65535 || kvh > 65535 ||
      (long long)sq * (h / kvh) >= INT_MAX || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 0) {
    if (dtype == 0)
      return dispatch_fma<float>(q, k, v, qpos, kpos, out, b, sq, sk, h, kvh,
                                 d, window, soft_cap, st);
    return dispatch_fma<bf16>(q, k, v, qpos, kpos, out, b, sq, sk, h, kvh, d,
                              window, soft_cap, st);
  }
  if (route == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    switch (d) {
      case 32:
        return launch_mma<32>(q, k, v, qpos, kpos, out, b, sq, sk, h, kvh,
                              window, soft_cap, st);
      case 64:
        return launch_mma<64>(q, k, v, qpos, kpos, out, b, sq, sk, h, kvh,
                              window, soft_cap, st);
      case 128:
        return launch_mma<128>(q, k, v, qpos, kpos, out, b, sq, sk, h, kvh,
                               window, soft_cap, st);
      case 256:
        return launch_mma<256>(q, k, v, qpos, kpos, out, b, sq, sk, h, kvh,
                               window, soft_cap, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (route == 2 || route == 3) {
    if ((long long)sq * (h / kvh) > kSplitRows || chunk < kSub ||
        chunk % kSub != 0 || splits < 1 || splits > kMaxSplits ||
        (long long)(splits - 1) * chunk >= sk ||
        (long long)splits * chunk < sk || part == nullptr ||
        counters == nullptr)
      return (int)cudaErrorInvalidValue;
    if (route == 3) {
      if (dtype != 1) return (int)cudaErrorInvalidValue;
      switch (d) {
        case 32:
          return launch_split_mma<32>(q, k, v, qpos, kpos, out, b, sq, sk, h,
                                      kvh, window, soft_cap, chunk, splits,
                                      part, counters, st);
        case 64:
          return launch_split_mma<64>(q, k, v, qpos, kpos, out, b, sq, sk, h,
                                      kvh, window, soft_cap, chunk, splits,
                                      part, counters, st);
        case 128:
          return launch_split_mma<128>(q, k, v, qpos, kpos, out, b, sq, sk, h,
                                       kvh, window, soft_cap, chunk, splits,
                                       part, counters, st);
        case 256:
          return launch_split_mma<256>(q, k, v, qpos, kpos, out, b, sq, sk, h,
                                       kvh, window, soft_cap, chunk, splits,
                                       part, counters, st);
      }
      return (int)cudaErrorInvalidValue;
    }
    if (dtype == 0)
      return dispatch_split<float>(q, k, v, qpos, kpos, out, b, sq, sk, h,
                                   kvh, d, window, soft_cap, chunk, splits,
                                   part, counters, st);
    return dispatch_split<bf16>(q, k, v, qpos, kpos, out, b, sq, sk, h, kvh,
                                d, window, soft_cap, chunk, splits, part,
                                counters, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
