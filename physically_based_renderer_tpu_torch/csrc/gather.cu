// Row gather (K5a) and its backward, the scatter-add of cotangent rows (K5b).
//
//   K5a: out[i, c]      = table[idx[i], c]   (0 where idx[i] is outside [0, T))
//   K5b: d_table[k, c] += ct[i, c]           for every i with idx[i] == k
//
// Replaces: the reference package's ops/gather.py::_fwd_kernel (:47) and
// ::_bwd_kernel (:60), entered through _take_fwd / _take_bwd.  The TPU
// kernels build a [B, T] one-hot in VMEM and contract it on the MXU at
// HIGHEST precision, because the TPU has no fast dynamic gather; Hopper
// loads any row directly, so neither kernel carries the one-hot over.
//
// What bounds them on the H100: memory.  K5a writes N*W floats and reads N
// indices plus the rows it copies; the floor is the N*W*4-byte output at
// the HBM rate (262,144 x 86 floats = 90.2 MB, ~27 us).  K5b reads the
// same N*W cotangents and writes T*W floats.
//
// K5a's design: enough bytes in flight to cover the latency of HBM, and no
// per-element division.  The output N x W is contiguous, so every thread
// stores whole float4s of it: kFwdQuads of them a tile (neighbouring
// threads on neighbouring float4s), with all the tile's loads issued
// before its stores.  gather_fwd picks one of two routes from W and the
// table's address:
//  * quads, W % 4 == 0 and a 16-byte aligned table (the emitter table
//    W = 20, texture quads W = 16, env quads W = 12): a float4 of the
//    output is one 16-byte quarter of one table row, so a thread divides
//    once, loads idx, then one float4 of the row through the read-only
//    cache (__ldg);
//  * rows, any other W (tri_attrs, W = 86): a float4 of the output may
//    straddle rows (two at most when W >= 4): one division gives the first
//    element's (row, column), and each next element steps the column,
//    moving to the next row (and its index) when it wraps; elements are
//    read through __ldg, so a small table (cornell's [32, 86], 11 KB) stays
//    in L1 and a large one (helmet's [99,400, 86], 34 MB) in L2.  Copying
//    a small table into shared memory first, as the TPU kernel keeps its
//    table in VMEM, was measured slower at cornell's shape and is not done.
// The last N*W mod 4 elements are stored one by one.  K5a is a copy,
// bit-equal to the plain version.
//
// K5b's trouble is contention: in cornell, 262,144 x 86 cotangents land on
// 32 x 86 = 2,752 addresses.  One thread per (row, column) element; when
// the T*W table fits in kSharedMaxBytes, each block accumulates its share
// of the elements in a private copy in shared memory (shared-memory float
// atomics), then adds that copy to d_table with one global atomic per
// non-zero element; larger tables (helmet_proc's 100,352 x 86) use plain
// global atomics, which are spread over many addresses.  Atomics make the
// order of the sums, and so their last bits, vary from run to run.  The
// wrapper zeroes d_table before the launch.  Indices are int32 or int64
// (one instantiation each).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedMaxBytes = 48 * 1024;
constexpr long long kMaxBlocks = 1 << 20;
// Flat element counts below this use 32-bit index arithmetic (the
// grid-stride sum e + stride stays below 2^32).
constexpr long long kMax32 = 1LL << 31;
// Devices whose SM count is cached (queried once each, on first use).
constexpr int kMaxDevices = 64;

// K5a: the float4s a thread moves per tile.
constexpr int kFwdQuads = 4;
constexpr int kFwdTile = kThreads * kFwdQuads;

long long blocks_for(long long total) {
  const long long b = (total + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

// The current device's SM count, queried once per device and kept: the
// kernels run many times a frame, and the attribute query costs a
// runtime call each time (a benign race: concurrent first calls store the
// same value).
cudaError_t sm_count(int* sms) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices) cached[dev] = *sms;
  return err;
}

// Quads: out viewed as float4[n_quads], table as float4[T][W/4].  E is
// the type of the float4 index: 32-bit unsigned when N*W fits, so the
// division by W/4 is a 32-bit one (a 64-bit division is a long emulated
// sequence), else 64-bit.
template <typename I, typename E>
__global__ void __launch_bounds__(kThreads) gather_fwd_kernel_quads(
    const float4* __restrict__ table, const I* __restrict__ idx, E n_quads,
    int t, int w4, float4* __restrict__ out) {
  const E ww = E(w4);
  for (E base = E(blockIdx.x) * E(kFwdTile); base < n_quads;
       base += E(gridDim.x) * E(kFwdTile)) {
    float4 v[kFwdQuads];
#pragma unroll
    for (int u = 0; u < kFwdQuads; ++u) {
      const E q = base + E(u * kThreads) + E(threadIdx.x);
      v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (q < n_quads) {
        const E r = q / ww;
        const long long k = (long long)__ldg(idx + r);
        if (k >= 0 && k < t) v[u] = __ldg(table + k * w4 + (q - r * ww));
      }
    }
#pragma unroll
    for (int u = 0; u < kFwdQuads; ++u) {
      const E q = base + E(u * kThreads) + E(threadIdx.x);
      if (q < n_quads) out[q] = v[u];
    }
  }
}

// Rows: any W.  total = N*W elements; the float4s of out cover the first
// total / 4 * 4, the rest is stored element by element.
template <typename I, typename E>
__global__ void __launch_bounds__(kThreads) gather_fwd_kernel_rows(
    const float* __restrict__ table, const I* __restrict__ idx, E total,
    int t, int w, float* __restrict__ out) {
  auto value = [&](long long k, int c) -> float {
    return k >= 0 && k < t ? __ldg(table + k * w + c) : 0.0f;
  };
  const E ww = E(w);
  const E n_quads = total / 4;
  float4* out4 = reinterpret_cast<float4*>(out);
  for (E base = E(blockIdx.x) * E(kFwdTile); base < n_quads;
       base += E(gridDim.x) * E(kFwdTile)) {
    float4 v[kFwdQuads];
#pragma unroll
    for (int u = 0; u < kFwdQuads; ++u) {
      const E q = base + E(u * kThreads) + E(threadIdx.x);
      if (q < n_quads) {
        E r = (q * 4) / ww;
        int c = int(q * 4 - r * ww);
        long long k = (long long)__ldg(idx + r);
        float x[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (m > 0 && ++c == w) {
            c = 0;
            ++r;
            k = (long long)__ldg(idx + r);
          }
          x[m] = value(k, c);
        }
        v[u] = make_float4(x[0], x[1], x[2], x[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < kFwdQuads; ++u) {
      const E q = base + E(u * kThreads) + E(threadIdx.x);
      if (q < n_quads) out4[q] = v[u];
    }
  }
  const E tail = total - n_quads * 4;
  if (blockIdx.x == 0 && E(threadIdx.x) < tail) {
    const E e = n_quads * 4 + E(threadIdx.x);
    const E r = e / ww;
    out[e] = value((long long)__ldg(idx + r), int(e - r * ww));
  }
}

template <typename I, typename E>
int launch_fwd(const float* table, const I* idx, long long total, int t,
               int w, bool quads, float* out, cudaStream_t s) {
  const long long n_quads = total / 4;
  long long blocks = (n_quads + kFwdTile - 1) / kFwdTile;
  if (blocks < 1) blocks = 1;  // the tail alone
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (quads) {
    gather_fwd_kernel_quads<I, E><<<unsigned(blocks), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(table), idx, E(n_quads), t, w / 4,
        reinterpret_cast<float4*>(out));
  } else {
    gather_fwd_kernel_rows<I, E><<<unsigned(blocks), kThreads, 0, s>>>(
        table, idx, E(total), t, w, out);
  }
  return int(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename I>
int gather_fwd(const float* table, const I* idx, long long n, int t, int w,
               float* out, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  // Both routes store float4s of the output.
  if (!aligned16(out) || t < 0) return int(cudaErrorInvalidValue);
  const bool quads = w % 4 == 0 && aligned16(table);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = n * w;
  if (total < kMax32)
    return launch_fwd<I, unsigned>(table, idx, total, t, w, quads, out, s);
  return launch_fwd<I, long long>(table, idx, total, t, w, quads, out, s);
}

template <typename I, typename E>
__global__ void gather_bwd_shared_kernel(const I* __restrict__ idx,
                                         const float* __restrict__ ct,
                                         E total, int t, int w,
                                         float* __restrict__ d_table) {
  extern __shared__ float acc[];
  const int tw = t * w;
  for (int j = threadIdx.x; j < tw; j += blockDim.x) acc[j] = 0.0f;
  __syncthreads();
  const E ww = E(w);
  const E stride = E(gridDim.x) * E(blockDim.x);
  for (E e = E(blockIdx.x) * E(blockDim.x) + E(threadIdx.x); e < total;
       e += stride) {
    const E r = e / ww;
    const E c = e - r * ww;
    const long long k = (long long)__ldg(idx + r);
    if (k >= 0 && k < t) atomicAdd(&acc[k * w + c], __ldg(ct + e));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < tw; j += blockDim.x) {
    const float v = acc[j];
    if (v != 0.0f || v != v) atomicAdd(d_table + j, v);
  }
}

template <typename I, typename E>
__global__ void gather_bwd_global_kernel(const I* __restrict__ idx,
                                         const float* __restrict__ ct,
                                         E total, int t, int w,
                                         float* __restrict__ d_table) {
  const E ww = E(w);
  const E stride = E(gridDim.x) * E(blockDim.x);
  for (E e = E(blockIdx.x) * E(blockDim.x) + E(threadIdx.x); e < total;
       e += stride) {
    const E r = e / ww;
    const E c = e - r * ww;
    const long long k = (long long)__ldg(idx + r);
    if (k >= 0 && k < t) atomicAdd(d_table + k * w + c, __ldg(ct + e));
  }
}

template <typename I, typename E>
void launch_bwd(const I* idx, const float* ct, long long total, int t, int w,
                float* d_table, long long shared_bytes, int sms,
                cudaStream_t s) {
  if (shared_bytes <= kSharedMaxBytes) {
    // A few blocks per SM: each then covers many elements, so the flush of
    // its private table (t * w atomics) is amortised over many rays.
    long long blocks = blocks_for(total);
    if (blocks > 4LL * sms) blocks = 4LL * sms;
    gather_bwd_shared_kernel<I, E><<<unsigned(blocks), kThreads,
                                     size_t(shared_bytes), s>>>(
        idx, ct, E(total), t, w, d_table);
  } else {
    gather_bwd_global_kernel<I, E><<<unsigned(blocks_for(total)), kThreads,
                                     0, s>>>(idx, ct, E(total), t, w,
                                             d_table);
  }
}

template <typename I>
int gather_bwd(const I* idx, const float* ct, long long n, int t, int w,
               float* d_table, void* stream) {
  if (n <= 0 || w <= 0 || t <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = n * w;
  const long long shared_bytes = (long long)t * w * (long long)sizeof(float);
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return int(err);
  if (total < kMax32)
    launch_bwd<I, unsigned>(idx, ct, total, t, w, d_table, shared_bytes, sms,
                            s);
  else
    launch_bwd<I, long long>(idx, ct, total, t, w, d_table, shared_bytes,
                             sms, s);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int pbr_gather_fwd_i32(const float* table, const int* idx,
                                  long long n, int t, int w, float* out,
                                  void* stream) {
  return gather_fwd<int>(table, idx, n, t, w, out, stream);
}

extern "C" int pbr_gather_fwd_i64(const float* table, const long long* idx,
                                  long long n, int t, int w, float* out,
                                  void* stream) {
  return gather_fwd<long long>(table, idx, n, t, w, out, stream);
}

extern "C" int pbr_gather_bwd_i32(const int* idx, const float* ct,
                                  long long n, int t, int w, float* d_table,
                                  void* stream) {
  return gather_bwd<int>(idx, ct, n, t, w, d_table, stream);
}

extern "C" int pbr_gather_bwd_i64(const long long* idx, const float* ct,
                                  long long n, int t, int w, float* d_table,
                                  void* stream) {
  return gather_bwd<long long>(idx, ct, n, t, w, d_table, stream);
}
