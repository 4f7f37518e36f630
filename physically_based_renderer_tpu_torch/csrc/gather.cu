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
// indices plus the rows it copies; the table is small (11 KB for cornell's
// [32, 86] tri_attrs) and stays in L1/L2, so the floor is the N*W*4-byte
// output at the HBM rate (262,144 x 86 floats = 90.2 MB, ~27 us).  K5b
// reads the same N*W cotangents and writes T*W floats.
//
// Design.  One thread per (row, column) element, flat over N*W with a
// grid-stride loop, so neighbouring threads load and store neighbouring
// addresses along W (W is 86, 20, 16, 12 or 1 on the render path).  Table
// rows and indices are read through the read-only cache (__ldg).  K5a is a
// copy, bit-equal to the plain version.  K5b's trouble is contention: in
// cornell, 262,144 x 86 cotangents land on 32 x 86 = 2,752 addresses.  When
// the T*W table fits in kSharedMaxBytes, each block accumulates its share
// of the elements in a private copy in shared memory (shared-memory float
// atomics), then adds that copy to d_table with one global atomic per
// non-zero element; larger tables (helmet_proc's 100,352 x 86) use plain
// global atomics, which are spread over many addresses.  Atomics make the
// order of the sums, and so their last bits, vary from run to run.  The
// wrapper zeroes d_table before the launch.  Indices are int32 or int64
// (one instantiation each).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedMaxBytes = 48 * 1024;
constexpr long long kMaxBlocks = 1 << 20;
// Flat element counts below this use 32-bit index arithmetic (the
// grid-stride sum e + stride stays below 2^32).
constexpr long long kMax32 = 1LL << 31;
// Devices whose SM count is cached (queried once each, on first use).
constexpr int kMaxDevices = 64;

long long blocks_for(long long total) {
  const long long b = (total + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

// E is the type of the flat element index: 32-bit unsigned when N*W fits,
// so the per-element division by W is a 32-bit one (a 64-bit division is a
// long emulated sequence, and it set K5a's time at first), else 64-bit.
template <typename I, typename E>
__global__ void gather_fwd_kernel(const float* __restrict__ table,
                                  const I* __restrict__ idx, E total, int t,
                                  int w, float* __restrict__ out) {
  const E ww = E(w);
  const E stride = E(gridDim.x) * E(blockDim.x);
  for (E e = E(blockIdx.x) * E(blockDim.x) + E(threadIdx.x); e < total;
       e += stride) {
    const E r = e / ww;
    const E c = e - r * ww;
    const long long k = (long long)__ldg(idx + r);
    out[e] = (k >= 0 && k < t) ? __ldg(table + k * w + c) : 0.0f;
  }
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
void launch_fwd(const float* table, const I* idx, long long total, int t,
                int w, float* out, cudaStream_t s) {
  gather_fwd_kernel<I, E><<<unsigned(blocks_for(total)), kThreads, 0, s>>>(
      table, idx, E(total), t, w, out);
}

template <typename I>
int gather_fwd(const float* table, const I* idx, long long n, int t, int w,
               float* out, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = n * w;
  if (total < kMax32)
    launch_fwd<I, unsigned>(table, idx, total, t, w, out, s);
  else
    launch_fwd<I, long long>(table, idx, total, t, w, out, s);
  return int(cudaGetLastError());
}

// The current device's SM count, queried once per device and kept: the
// backward runs on every gradient step, and the attribute query costs a
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
