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
//
//   A rank's block of the stack: the rank holds rows row0..row0+K-1 of
//   the padded cohort's rows_total rows and, on a model-sharded leaf,
//   only a strided slice of the leaf's elements. It draws the whole
//   stack's noise for its own (row, element) pairs: the counter is
//   n = (row0 + k) * numel_i + j and the split-counter layout's size is
//   rows_total * numel_i, where numel_i is the WHOLE leaf's element count
//   and j the shard element's row-major index within the whole leaf.
//   Both come from the leaf's block descriptor (blocks[i] = numel_i,
//   inner, stride, base; null: the block's own leaf width and
//   j = c - off[i]): the shard's p-th element of the leaf
//   (p = c - off[i]) is j = (p / inner) * stride + base + p % inner,
//   the leaf viewed as (pre, D, post) and the shard its rows lo..lo+per
//   of D (inner = per * post, stride = D * post, base = lo * post).
//   With row0 = 0, rows_total = K and no blocks this is the draw above.
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
// forward, since a thread's columns only grow (the leaf's bounds, key,
// scale and counter base are reloaded only when a column crosses into
// the next leaf); x read and q written coalesced, 32 threads on 32
// neighbouring columns.
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

// kShard: a model shard's block, whose leaves' whole element counts and
// elements' within-leaf indices come from the leaves' block descriptors;
// otherwise both follow from off, and the element loop is the one-stack
// draw's
template <bool kShard>
__global__ void __launch_bounds__(kThreads)
int8_sr_kernel(const float* __restrict__ x, const float* __restrict__ scale,
               const int64_t* __restrict__ off,
               const uint32_t* __restrict__ keys,
               const int64_t* __restrict__ blocks,
               int8_t* __restrict__ q,
               int64_t n, int nleaves, int partitionable, int64_t row0,
               int64_t rows_total) {
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
  const uint64_t grow = (uint64_t)(row0 + row);
  // the walked leaf's bounds, counter base, draw size, key, scale and
  // (kShard) slice descriptor, reloaded only when a thread's column
  // crosses into the next leaf
  int64_t start = -1, end = 0;
  uint64_t base = 0, size = 0, inner = 1, jstride = 0, jbase = 0;
  uint32_t k0 = 0, k1 = 0;
  float s = 1.0f;
  for (; c < n; c += stride) {
    if (c >= end) {
      while (__ldg(off + leaf + 1) <= c) ++leaf;
      start = __ldg(off + leaf);
      end = __ldg(off + leaf + 1);
      const uint64_t numel = kShard ? (uint64_t)__ldg(blocks + 4 * leaf)
                                    : (uint64_t)(end - start);
      if (kShard) {
        inner = (uint64_t)__ldg(blocks + 4 * leaf + 1);
        jstride = (uint64_t)__ldg(blocks + 4 * leaf + 2);
        jbase = (uint64_t)__ldg(blocks + 4 * leaf + 3);
      }
      base = grow * numel;
      size = (uint64_t)rows_total * numel;
      k0 = __ldg(keys + 2 * leaf);
      k1 = __ldg(keys + 2 * leaf + 1);
      s = __ldg(sr + leaf);
    }
    uint64_t j = (uint64_t)(c - start);
    if (kShard) {
      // 32-bit division where the leaf's slice allows it (almost always)
      uint64_t a, r;
      if (((j | inner) >> 32) == 0) {
        a = (uint32_t)j / (uint32_t)inner;
        r = (uint32_t)j - (uint32_t)a * (uint32_t)inner;
      } else {
        a = j / inner;
        r = j - a * inner;
      }
      j = a * jstride + jbase + r;
    }
    const uint32_t bits = draw_bits(k0, k1, base + j, size, partitionable);
    const float u = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u),
                              1.0f);
    const float v = floorf(__fadd_rn(__fdiv_rn(xr[c], s), u));
    qr[c] = isnan(v) ? (int8_t)0
                     : (int8_t)fminf(fmaxf(v, -127.0f), 127.0f);
  }
}

}  // namespace

extern "C" {

// x (k, n) f32, scale (k, nleaves) f32, off (nleaves + 1,) int64 on the
// device, keys (nleaves, 2) uint32, blocks (nleaves, 4) int64 (numel,
// inner, stride, base) or null -> q (k, n) int8; the block is rows
// row0..row0+k-1 of rows_total
int int8_sr_quantize(const void* x, const void* scale, const void* off,
                     const void* keys, const void* blocks, void* q,
                     int64_t k, int64_t n,
                     int nleaves, int partitionable, int64_t row0,
                     int64_t rows_total, void* stream) {
  if (k < 1 || k > 65535 || n < 1 || nleaves < 1 || row0 < 0 ||
      row0 + k > rows_total)
    return (int)cudaErrorInvalidValue;
  int64_t bx = (n + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  const dim3 grid((unsigned)bx, (unsigned)k);
  auto kernel = blocks ? int8_sr_kernel<true> : int8_sr_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)scale, (const int64_t*)off,
      (const uint32_t*)keys, (const int64_t*)blocks, (int8_t*)q, n,
      nleaves, partitionable, row0,
      rows_total);
  return (int)cudaGetLastError();
}

const char* int8_sr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
