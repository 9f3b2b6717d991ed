// The int8_sr codec's encode on Hopper (sm_90a): symmetric int8 with
// stochastic rounding over the flat (K, N) stack of client deltas, the
// rounding noise drawn in the kernel from the reference's PRNG.
//
// int8_sr_quantize  is not a TPU kernel: the reference leaves this step
//   to XLA (src/repro/codec/codecs.py, Int8Codec._encode_leaf with
//   jax.random.uniform). It is the port's way to draw the reference's
//   noise on the device: a numpy draw of a K = 10 round's 112 M uniforms
//   takes tens of seconds on the host.
//
//   For client row k and column c of parameter leaf i (leaf i owns
//   columns off[i]..off[i+1]-1, numel_i of them; j = c - off[i]):
//     u = the f32 uniform that jax.random.uniform(key_i, (K, *shape_i))
//         draws for element (k, j): threefry2x32 (20 rounds) of key_i at
//         the leaf draw's row-major counter n = k * numel_i + j, 32 bits
//         = word0 ^ word1 (JAX's partitionable layout), or word0 / word1
//         of the split-counter layout (JAX 0.4, ``partitionable = 0``);
//         u = float(bits >> 9 | 0x3f800000) - 1
//     q[k, c] = int8(clip(floor(x[k, c] / scale[k, i] + u), -127, 127)),
//         NaN -> 0 (as XLA converts NaN to an integer)
//   key_i = fold_in(fold_in(PRNGKey(seed), round), i) is computed on the
//   host (repro_torch/core/jax_prng.py) and read as (L, 2) words.
//   Division and add round to nearest (__fdiv_rn, __fadd_rn), as the
//   reference's f32 ops do: the codes are bitwise the reference's.
//
// What bounds it: 5 bytes an element (x read, q written: 0.17 ms at
// K = 10 x N = 11,220,132 on 3.35 TB/s) against ~90 32-bit integer
// operations (threefry's 20 rounds of add, rotate and xor, its 5 key
// injections, the counter and the leaf walk) at 64 an SM a clock:
// ~0.5 ms, so it is bound by issue, not bytes. The design does only
// what the draw needs: one thread an element, rotates as one funnel
// shift (SHF), the leaf found once by binary search and then walked
// forward, since a thread's columns only grow; x read and q written
// coalesced, 32 threads on 32 neighbouring columns.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocksX = 4096;

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

// threefry2x32 with 20 rounds, as jax.random's: (x0, x1) hashed in place
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r); \
  x1 ^= x0;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef TF_ROUND
}

// the random 32 bits of element n of a draw of `size` elements
__device__ __forceinline__ uint32_t draw_bits(uint32_t k0, uint32_t k1,
                                              uint64_t n, uint64_t size,
                                              int partitionable) {
  uint32_t x0, x1;
  if (partitionable) {
    x0 = (uint32_t)(n >> 32);
    x1 = (uint32_t)n;
    threefry2x32(k0, k1, x0, x1);
    return x0 ^ x1;
  }
  // split-counter layout: pairs (i, h + i), i < h = ceil(size / 2); the
  // counter past size - 1 is 0; word 0 for n < h, word 1 otherwise
  const uint64_t h = (size + 1) / 2;
  const bool first = n < h;
  x0 = (uint32_t)(first ? n : n - h);
  x1 = (uint32_t)(first ? (n + h < size ? n + h : 0) : n);
  threefry2x32(k0, k1, x0, x1);
  return first ? x0 : x1;
}

__global__ void __launch_bounds__(kThreads)
int8_sr_kernel(const float* __restrict__ x, const float* __restrict__ scale,
               const int64_t* __restrict__ off,
               const uint32_t* __restrict__ keys, int8_t* __restrict__ q,
               int64_t n, int nleaves, int partitionable) {
  const int64_t row = blockIdx.y;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (c >= n) return;
  // the leaf holding column c: off[leaf] <= c < off[leaf + 1]
  int lo = 0, hi = nleaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(off + mid) <= c) lo = mid; else hi = mid - 1;
  }
  int leaf = lo;
  const float* xr = x + row * n;
  int8_t* qr = q + row * n;
  const float* sr = scale + row * nleaves;
  const uint64_t rows = gridDim.y;
  for (; c < n; c += stride) {
    while (__ldg(off + leaf + 1) <= c) ++leaf;
    const int64_t start = __ldg(off + leaf);
    const uint64_t numel = (uint64_t)(__ldg(off + leaf + 1) - start);
    const uint64_t idx = (uint64_t)row * numel + (uint64_t)(c - start);
    const uint32_t bits = draw_bits(__ldg(keys + 2 * leaf),
                                    __ldg(keys + 2 * leaf + 1), idx,
                                    rows * numel, partitionable);
    const float u = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u),
                              1.0f);
    const float v = floorf(__fadd_rn(__fdiv_rn(xr[c], __ldg(sr + leaf)), u));
    qr[c] = isnan(v) ? (int8_t)0
                     : (int8_t)fminf(fmaxf(v, -127.0f), 127.0f);
  }
}

}  // namespace

extern "C" {

// x (k, n) f32, scale (k, nleaves) f32, off (nleaves + 1,) int64 on the
// device, keys (nleaves, 2) uint32 -> q (k, n) int8
int int8_sr_quantize(const void* x, const void* scale, const void* off,
                     const void* keys, void* q, int64_t k, int64_t n,
                     int nleaves, int partitionable, void* stream) {
  if (k < 1 || k > 65535 || n < 1 || nleaves < 1)
    return (int)cudaErrorInvalidValue;
  int64_t bx = (n + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  const dim3 grid((unsigned)bx, (unsigned)k);
  int8_sr_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)scale, (const int64_t*)off,
      (const uint32_t*)keys, (int8_t*)q, n, nleaves, partitionable);
  return (int)cudaGetLastError();
}

const char* int8_sr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
