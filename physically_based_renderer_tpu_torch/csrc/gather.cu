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
// 32 x 86 = 2,752 addresses, and a gradient step's rows come in pixel
// order, so neighbouring rows often name the same triangle (3.9 rows a run
// of equal indices at tri_attrs, 2.0 at the emitter table).  A warp walks
// a run of rows and sums the columns of equal consecutive indices in
// registers, adding them to its accumulator once per run of equal indices
// (no per-element division).  The accumulator is a private table of the
// warp's own in shared memory where one for each of the block's 32 warps
// fits the card's opt-in shared memory (no atomics), else the block's one
// table (shared-memory atomics), else d_table (global atomics);
// gather_bwd_kernel below.  What is left is the latency of the rows'
// loads: 32 warps an SM with 8 rows each in flight beat 16 warps with
// private tables and deeper pipelines (PERF.md; tools/sweep.py).  Atomics
// and the warps' sums make the order of the sums, and so their last bits,
// vary from run to run.  The wrapper zeroes d_table before the launch.
// Indices are int32 or int64 (one instantiation each).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;
// Flat element counts below this use 32-bit index arithmetic (the
// grid-stride sum e + stride stays below 2^32).
constexpr long long kMax32 = 1LL << 31;
// Devices whose SM count is cached (queried once each, on first use).
constexpr int kMaxDevices = 64;

// K5a: the float4s a thread moves per tile.
constexpr int kFwdQuads = 4;
constexpr int kFwdTile = kThreads * kFwdQuads;

// An attribute of the current device (the SM count, the opt-in shared
// memory a block), queried once per device and kept: the kernels run many
// times a frame, and the attribute query costs a runtime call each time
// (a benign race: concurrent first calls store the same value).
cudaError_t device_attr(cudaDeviceAttr attr, int* value) {
  constexpr int kAttrs = 2;
  static int cached[kAttrs][kMaxDevices] = {};
  const int a = attr == cudaDevAttrMultiProcessorCount ? 0 : 1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[a][dev] > 0) {
    *value = cached[a][dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(value, attr, dev);
  if (err == cudaSuccess && dev < kMaxDevices) cached[a][dev] = *value;
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

// K5b.  A warp takes a run of kBwdRun consecutive rows of ct; its lanes own
// the columns c = col0 + lane + 32 j, j < J, so a row is one coalesced load.
// The run's indices are read once, one a lane, and handed round by
// shuffle.  The warp walks its rows in order and keeps each column's sum in
// registers while the index repeats; it adds the sums to its accumulator
// only when the index changes, or at the run's end.  kBwdAhead rows are
// loaded before any is added, to keep bytes in flight.  Three accumulators
// (Acc), the first that fits the card's opt-in shared memory:
//  * kWarp: a private T x W table for each warp of the block; one warp
//    writes it, so the adds are plain loads and stores (no atomics);
//  * kBlock: one T x W table for the block, shared-memory atomics;
//  * kGlobal: d_table itself, global atomics.
// A shared table is added to d_table at the block's end, one global atomic
// per non-zero element.
enum class Acc { kWarp, kBlock, kGlobal };

// Chosen by measurement on the card (PERF.md): 1024 threads (at most 64
// registers a thread), runs of 32 rows, 8 rows loaded ahead.
constexpr int kBwdThreads = 1024;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdRun = 32;
constexpr int kBwdAhead = 8;
constexpr unsigned kFull = 0xffffffffu;

template <Acc A, int J>
__device__ __forceinline__ void add_sums(float* tab, int k, int w, int col0,
                                         int lane, const float (&s)[J]) {
  float* row = tab + (long long)k * w;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = col0 + lane + 32 * j;
    if (c < w) {
      if (A == Acc::kWarp) {
        row[c] += s[j];
      } else {
        atomicAdd(row + c, s[j]);
      }
    }
  }
}

template <typename I, Acc A, int J>
__global__ void __launch_bounds__(kBwdThreads) gather_bwd_kernel(
    const I* __restrict__ idx, const float* __restrict__ ct, long long n,
    int t, int w, float* __restrict__ d_table) {
  extern __shared__ float tabs[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tw = t * w;
  constexpr int kTables = A == Acc::kWarp ? kBwdWarps : 1;
  float* tab = d_table;
  if (A != Acc::kGlobal) {
    for (int j = threadIdx.x; j < kTables * tw; j += kBwdThreads)
      tabs[j] = 0.0f;
    __syncthreads();
    tab = A == Acc::kWarp ? tabs + warp * tw : tabs;
  }
  const long long first =
      ((long long)blockIdx.x * kBwdWarps + warp) * kBwdRun;
  const long long stride = (long long)gridDim.x * kBwdWarps * kBwdRun;
  for (int col0 = 0; col0 < w; col0 += 32 * J) {
    for (long long r0 = first; r0 < n; r0 += stride) {
      const int len = int(n - r0 < kBwdRun ? n - r0 : kBwdRun);
      int cur = -1;  // the index whose sums s holds; -1: none
      float s[J];
#pragma unroll
      for (int j = 0; j < J; ++j) s[j] = 0.0f;
      for (int b = 0; b < len; b += 32) {
        // The batch's indices, one a lane; -1 outside [0, T).
        int kl = -1;
        if (b + lane < len) {
          const long long k = (long long)__ldg(idx + r0 + b + lane);
          kl = k >= 0 && k < t ? int(k) : -1;
        }
        const int m = len - b < 32 ? len - b : 32;
        for (int a = 0; a < m; a += kBwdAhead) {
          // kBwdAhead rows loaded before any is added; rows with an index
          // outside the table are not read.
          int ks[kBwdAhead];
          float v[kBwdAhead][J];
#pragma unroll
          for (int u = 0; u < kBwdAhead; ++u) {
            ks[u] = __shfl_sync(kFull, kl, a + u);
            const float* row = ct + (r0 + b + a + u) * w;
#pragma unroll
            for (int j = 0; j < J; ++j) {
              const int c = col0 + lane + 32 * j;
              v[u][j] = a + u < m && ks[u] >= 0 && c < w ? __ldg(row + c)
                                                         : 0.0f;
            }
          }
#pragma unroll
          for (int u = 0; u < kBwdAhead; ++u) {
            if (a + u < m) {
              if (ks[u] != cur) {
                if (cur >= 0) add_sums<A, J>(tab, cur, w, col0, lane, s);
                cur = ks[u];
#pragma unroll
                for (int j = 0; j < J; ++j) s[j] = 0.0f;
              }
#pragma unroll
              for (int j = 0; j < J; ++j) s[j] += v[u][j];
            }
          }
        }
      }
      if (cur >= 0) add_sums<A, J>(tab, cur, w, col0, lane, s);
    }
  }
  if (A != Acc::kGlobal) {
    __syncthreads();
    for (int j = threadIdx.x; j < tw; j += kBwdThreads) {
      float v = tabs[j];
      for (int q = 1; q < kTables; ++q) v += tabs[q * tw + j];
      if (v != 0.0f || v != v) atomicAdd(d_table + j, v);
    }
  }
}

template <typename I, Acc A, int J>
int launch_bwd(const I* idx, const float* ct, long long n, int t, int w,
               float* d_table, size_t smem, int sms, cudaStream_t s) {
  const auto kernel = &gather_bwd_kernel<I, A, J>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kBwdThreads, smem);
  if (err != cudaSuccess) return int(err);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  // As many blocks as fit at once, and no more than the runs need: every
  // block then flushes its table once.
  const long long runs = (n + kBwdRun - 1) / kBwdRun;
  long long blocks = (runs + kBwdWarps - 1) / kBwdWarps;
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  kernel<<<unsigned(blocks), kBwdThreads, smem, s>>>(idx, ct, n, t, w,
                                                     d_table);
  return int(cudaGetLastError());
}

template <typename I, Acc A>
int launch_bwd_j(const I* idx, const float* ct, long long n, int t, int w,
                 float* d_table, size_t smem, int sms, cudaStream_t s) {
  // Column groups of 32 a lane holds: W up to 128 in one pass over the
  // rows, wider tables in passes of 128 columns.
  if (w <= 32) return launch_bwd<I, A, 1>(idx, ct, n, t, w, d_table, smem,
                                          sms, s);
  if (w <= 64) return launch_bwd<I, A, 2>(idx, ct, n, t, w, d_table, smem,
                                          sms, s);
  if (w <= 96) return launch_bwd<I, A, 3>(idx, ct, n, t, w, d_table, smem,
                                          sms, s);
  return launch_bwd<I, A, 4>(idx, ct, n, t, w, d_table, smem, sms, s);
}

template <typename I>
int gather_bwd(const I* idx, const float* ct, long long n, int t, int w,
               float* d_table, void* stream) {
  if (n <= 0 || w <= 0 || t <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int sms = 0, optin = 0;
  cudaError_t err = device_attr(cudaDevAttrMultiProcessorCount, &sms);
  if (err == cudaSuccess)
    err = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, &optin);
  if (err != cudaSuccess) return int(err);
  const size_t table = size_t(t) * size_t(w) * sizeof(float);
  if (kBwdWarps * table <= size_t(optin))
    return launch_bwd_j<I, Acc::kWarp>(idx, ct, n, t, w, d_table,
                                       kBwdWarps * table, sms, s);
  if (table <= size_t(optin))
    return launch_bwd_j<I, Acc::kBlock>(idx, ct, n, t, w, d_table, table,
                                        sms, s);
  return launch_bwd_j<I, Acc::kGlobal>(idx, ct, n, t, w, d_table, 0, sms, s);
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
