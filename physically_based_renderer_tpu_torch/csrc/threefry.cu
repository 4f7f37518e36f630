// Threefry-2x32 (20 rounds), the counter RNG of core/rng.py, one launch per
// call.
//
// Replaces: no TPU kernel.  The reference draws its random numbers through
// its framework's threefry (the partitionable scheme), which XLA fuses into
// the surrounding computation; the port's plain version in core/rng.py
// spells each threefry as about 170 elementwise torch operations on int64
// tensors, each a launch of its own.  This source computes a whole call of
// fold_in / split / ray_keys, ray_uniform or random_bits / uniform in one
// launch, bit for bit the plain version's result.
//
// What bounds it on the H100: neither memory nor arithmetic.  A ray's
// ray_uniform at m = 5 reads a 16-byte key and writes 20 bytes; seven
// threefry blocks of ~100 32-bit integer operations each, a few
// microseconds over 262,144 rays.  The host's launch is the cost, so the
// design is one launch for each call the plain version spelled out op by
// op.
//
// Design: one thread per output lane (per output word for random_bits),
// working in uint32; rotations by __funnelshift_l.  Keys arrive as the
// port's int64 [..., 2] words and leave as int64 words in [0, 2^32), so
// every caller keeps its representation.  A key, and each count word, is
// either one value for the batch (a step of 0, or a value passed as an
// argument) or one value a lane; the wrapper (core/rng.py) expands any
// other broadcast.  A uniform is the plain version's exact mapping: the
// word's top 23 bits as the mantissa of a float in [1, 2), less 1.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr uint32_t kOneBits = 0x3F800000u;

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

// threefry2x32(k, (x0, x1)) in place: 20 rounds, 5 key injections.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (i % 2 == 0) {
      mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
    } else {
      mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + uint32_t(i + 1);
  }
}

// fold_in(k, x) = threefry2x32(k, (0, x)), both output words.
__device__ __forceinline__ void fold(uint32_t& k0, uint32_t& k1, uint32_t x) {
  uint32_t x0 = 0u, x1 = x;
  threefry2x32(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return __uint_as_float((bits >> 9) | kOneBits) - 1.0f;
}

// out[i] = threefry2x32(key_i, (x0_i, x1_i)).  key_i = keys[i * key_step];
// a count word is its array's [i * step] where the array is given, else
// its value (plus i for x1 with iota, split's counts).
__global__ void threefry_words_kernel(
    const long long* __restrict__ keys, int key_step,
    const long long* __restrict__ x0s, int x0_step, uint32_t x0_value,
    const long long* __restrict__ x1s, int x1_step, uint32_t x1_value,
    int x1_iota, long long n, long long* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long ki = key_step ? i : 0;
  uint32_t x0 = x0s ? uint32_t(x0s[x0_step ? i : 0]) : x0_value;
  uint32_t x1 = x1s ? uint32_t(x1s[x1_step ? i : 0])
                    : x1_value + (x1_iota ? uint32_t(i) : 0u);
  threefry2x32(uint32_t(keys[2 * ki]), uint32_t(keys[2 * ki + 1]), x0, x1);
  out[2 * i] = (long long)x0;
  out[2 * i + 1] = (long long)x1;
}

// ray_uniform: per lane, fold in `bounce`, then `stream`, then m uniforms
// from the words w0 ^ w1 of threefry2x32(k, (0, j)), j < m; out f32[n, m].
__global__ void threefry_ray_uniform_kernel(const long long* __restrict__ keys,
                                            long long n, uint32_t bounce,
                                            uint32_t stream, int m,
                                            float* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t k0 = uint32_t(keys[2 * i]), k1 = uint32_t(keys[2 * i + 1]);
  fold(k0, k1, bounce);
  fold(k0, k1, stream);
  for (int j = 0; j < m; ++j) {
    uint32_t x0 = 0u, x1 = uint32_t(j);
    threefry2x32(k0, k1, x0, x1);
    out[i * m + j] = bits_to_uniform(x0 ^ x1);
  }
}

// random_bits / uniform: a thread a word t < n * m, lane t / m, count t % m;
// the word w0 ^ w1 of threefry2x32(keys[lane], (0, count)), as int64 bits
// or as its uniform.
template <bool kUniform>
__global__ void threefry_bits_kernel(const long long* __restrict__ keys,
                                     long long n_words, long long m,
                                     void* __restrict__ out) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= n_words) return;
  const long long lane = t / m;
  uint32_t x0 = 0u, x1 = uint32_t(t - lane * m);
  threefry2x32(uint32_t(keys[2 * lane]), uint32_t(keys[2 * lane + 1]), x0, x1);
  const uint32_t bits = x0 ^ x1;
  if (kUniform) {
    static_cast<float*>(out)[t] = bits_to_uniform(bits);
  } else {
    static_cast<long long*>(out)[t] = (long long)bits;
  }
}

unsigned blocks_for(long long n) {
  return unsigned((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int pbr_threefry_words(const long long* keys, int key_step,
                                  const long long* x0s, int x0_step,
                                  unsigned x0_value, const long long* x1s,
                                  int x1_step, unsigned x1_value, int x1_iota,
                                  long long n, long long* out, void* stream) {
  if (n <= 0) return 0;
  threefry_words_kernel<<<blocks_for(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      keys, key_step, x0s, x0_step, x0_value, x1s, x1_step, x1_value, x1_iota,
      n, out);
  return int(cudaGetLastError());
}

extern "C" int pbr_threefry_ray_uniform(const long long* keys, long long n,
                                        unsigned bounce, unsigned stream_id,
                                        int m, float* out, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  threefry_ray_uniform_kernel<<<blocks_for(n), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      keys, n, bounce, stream_id, m, out);
  return int(cudaGetLastError());
}

extern "C" int pbr_threefry_bits(const long long* keys, long long n_keys,
                                 long long m, int uniform, void* out,
                                 void* stream) {
  const long long n_words = n_keys * m;
  if (n_words <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (uniform) {
    threefry_bits_kernel<true><<<blocks_for(n_words), kThreads, 0, s>>>(
        keys, n_words, m, out);
  } else {
    threefry_bits_kernel<false><<<blocks_for(n_words), kThreads, 0, s>>>(
        keys, n_words, m, out);
  }
  return int(cudaGetLastError());
}
