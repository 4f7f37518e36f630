// Block-stream tracer (K1): closest-hit and any-hit Moller-Trumbore of ray
// blocks against their candidate clusters, streamed chunk by chunk.
//
// Replaces: the reference package's ops/pallas_trace.py::_mt_kernel_body
// (:54), entered through trace_blocks_pallas (:252).  On the TPU one grid
// step per ray block DMAs chunks of ch candidate clusters into VMEM, double
// buffered, and runs a dense [B, ch*K] array of tests with a min-reduction
// per ray.  Here one CTA owns one ray block and each of its B / R threads
// owns R rays; the CTA streams the chunks through shared memory and every
// thread tests its rays against the chunk's ch*K triangles.
//
// What bounds it on the H100: arithmetic.  A ray-triangle test is 46
// float operations and a reciprocal on 36 bytes of triangle data that
// every thread of the CTA reads at the same shared-memory address (a
// broadcast); a chunk of 4 x 128 triangles is 18 KB, fetched once per CTA,
// so device-memory traffic is small next to the tests.  What keeps a test
// loop from that bound is latency: each test is a chain of dependent
// operations, so a warp needs several independent tests in flight, and
// IEEE division compiles to a range check, a branch, a convergence
// barrier and a call to a slow path, which make every test that divides
// a basic block of its own that the scheduler cannot overlap with the
// next.  The early exit bounds how many chunks a block pays for.
//
// Design:
//  * grid = number of ray blocks, blockDim = B / R; thread tid owns rays
//    tid + i * (B / R), i < R, so the loads of o, d and t_max and the
//    stores of the results stay coalesced.  The launcher takes R = 2
//    where B % 64 == 0 (B / 2 threads are whole warps), else R = 1.  Four
//    rays a thread needed ~128 registers, left too few warps an SM, and
//    were slower on every shape measured (PERF.md), so R = 4 is not built;
//  * the reciprocal of det is rcp_rn (rcp.cuh): three instructions, no branch,
//    equal to 1.0f / det on every float with |det| in [1e-9, 2^126)
//    (checked exhaustively on the card, pbr_rcp_check).  A group of four
//    triangles in which some |det| reaches 2^126 is run again with the
//    division, from the state before the group, so results are always
//    those of 1.0f / det.  With no branch in a test, the 4 x R tests of a
//    group are one basic block and the scheduler interleaves them;
//  * shared memory holds two chunk buffers laid out [9][ch*K] (candidate i
//    at column offset i*K).  Chunk j + 1 is copied with 16-byte cp.async
//    (the soup's [9][K] rows are 16-byte aligned) while chunk j is tested;
//    a thread waits for its own copies (cp.async.wait_group) and a barrier
//    publishes everyone's.  The next write into a buffer comes after the
//    block reduction that follows its last reads, so one barrier a chunk
//    orders both.  An early exit drains the copy still in flight
//    (cp.async.wait_group 0) before the CTA leaves, as the reference waits
//    for its prefetch (pallas_trace.py:230-240);
//  * a thread reads four consecutive triangles' rows as nine float4s (9
//    LDS.128 for 4 x R tests, against 36 LDS.32 for 4 tests read word by
//    word) and tests them in flat order f, keeping a hit only on a strictly
//    smaller t: the reference's tie rule (lowest flat index among equal t).
//    Candidate slots past n_u refetch the last slot, as the reference
//    does; callers pad u_idx with the sentinel;
//  * the per-block early exit is tested at the same chunk boundaries as the
//    reference, as block reductions of the per-thread max over its R rays
//    (warp shuffles + shared memory, and __syncthreads_or), so every thread
//    leaves the loop together;
//  * lanes with t_max <= 0 (culled or padding) can never hit because
//    t > t_min >= 0 and t < t_max exclude each other; a thread none of
//    whose rays is live (any hit: still open) skips the chunk's tests;
//  * padding triangles and the sentinel have det = 0: the masked inverse is
//    0 and t = 0 fails t > t_min, with no id mask;
//  * rounding: the library is built with -fmad=false, so each product and
//    sum rounds once in the order of the plain torch version
//    (ops/trace_blocks.py::trace_blocks_plain), and t and the winner agree.

#include <cuda_runtime.h>

#include <cstdint>

#include "rcp.cuh"

namespace {

constexpr float kBig = 1e30f;
constexpr int kRows = 9;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float lane(const float4& a, int m) {
  return m == 0 ? a.x : m == 1 ? a.y : m == 2 ? a.z : a.w;
}

// The reciprocal of det: rcp_rn from rcp.cuh, equal to 1.0f / det for
// |det| in [kRcpLo, kRcpHi).
using pbr::kRcpHi;
using pbr::kRcpLo;
using pbr::rcp_rn;

// Four consecutive triangles (flat index flat .. flat + 3, their nine soup
// rows in a[]) against a thread's R rays, in flat order; returns whether
// some |det| lay at or above kRcpHi, where rcp_rn is not checked (kExact
// = false: the caller restores the state and runs the group again with
// kExact = true, which divides).
template <bool kAnyHit, bool kExact, int R>
__device__ __forceinline__ bool test_four(
    const float4 (&a)[kRows], const float (&rox)[R], const float (&roy)[R],
    const float (&roz)[R], const float (&rdx)[R], const float (&rdy)[R],
    const float (&rdz)[R], const float (&rtm)[R], float t_min, int flat,
    float (&best_t)[R], int (&best_flat)[R], bool (&occ)[R]) {
  bool outside = false;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float v0x = lane(a[0], m), v0y = lane(a[1], m);
    const float v0z = lane(a[2], m), e1x = lane(a[3], m);
    const float e1y = lane(a[4], m), e1z = lane(a[5], m);
    const float e2x = lane(a[6], m), e2y = lane(a[7], m);
    const float e2z = lane(a[8], m);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float px = rdy[r] * e2z - rdz[r] * e2y;
      const float py = rdz[r] * e2x - rdx[r] * e2z;
      const float pz = rdx[r] * e2y - rdy[r] * e2x;
      const float det = px * e1x + py * e1y + pz * e1z;
      const float ad = fabsf(det);
      float inv;
      if (kExact) {
        inv = ad > kRcpLo ? 1.0f / det : 0.0f;
      } else {
        outside |= ad >= kRcpHi;
        inv = ad > kRcpLo ? rcp_rn(det) : 0.0f;
      }
      const float tx = rox[r] - v0x;
      const float ty = roy[r] - v0y;
      const float tz = roz[r] - v0z;
      const float uu = (tx * px + ty * py + tz * pz) * inv;
      const float qx = ty * e1z - tz * e1y;
      const float qy = tz * e1x - tx * e1z;
      const float qz = tx * e1y - ty * e1x;
      const float vv = (rdx[r] * qx + rdy[r] * qy + rdz[r] * qz) * inv;
      const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv;
      const bool ok = uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f &&
                      tt > t_min && tt < rtm[r];
      if (kAnyHit) {
        occ[r] = occ[r] || ok;
      } else if (ok && tt < best_t[r]) {
        best_t[r] = tt;
        best_flat[r] = flat + m;
      }
    }
  }
  return outside;
}

// Max over the CTA of a non-negative value; every thread gets the result.
__device__ float block_max(float v, float* s_red) {
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) s_red[warp] = v;
  __syncthreads();
  float r = s_red[0];
  for (int w = 1; w < int(blockDim.x >> 5); ++w) r = fmaxf(r, s_red[w]);
  __syncthreads();
  return r;
}

// The widest CTA is B / R threads with B <= 1024, and one such CTA an SM
// is asked for: ptxas may then give a thread up to 65,536 / (1024 / R)
// registers, and at R = 2 takes 127.  Without the minimum it kept R = 2 to
// 84 registers, and the kernel ran up to 1.3x slower on the H100 (PERF.md).
template <bool kAnyHit, int R>
__global__ void __launch_bounds__(1024 / R, 1)
    trace_blocks_kernel(const int* __restrict__ u_idx,
                        const int* __restrict__ n_valid,
                        const float* __restrict__ entry,
                        const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ t_max,
                        const float* __restrict__ soup, int n_u, int k,
                        int ch, float t_min, float* __restrict__ best_t_out,
                        int* __restrict__ best_flat_out,
                        bool* __restrict__ occ_out) {
  extern __shared__ __align__(16) float s_mem[];
  const int w = ch * k;
  const int buf = kRows * w;           // floats of one chunk buffer
  float* s_red = s_mem + 2 * buf;      // [blockDim / 32]

  const int g = blockIdx.x;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const size_t first = size_t(g) * nt * R + tid;
  float rox[R], roy[R], roz[R], rdx[R], rdy[R], rdz[R], rtm[R];
  float best_t[R];
  int best_flat[R];
  bool occ[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t i = first + size_t(r) * nt;
    rox[r] = o[3 * i + 0];
    roy[r] = o[3 * i + 1];
    roz[r] = o[3 * i + 2];
    rdx[r] = d[3 * i + 0];
    rdy[r] = d[3 * i + 1];
    rdz[r] = d[3 * i + 2];
    rtm[r] = t_max[i];
    best_t[r] = kBig;
    best_flat[r] = -1;
    occ[r] = false;
  }

  const int nv = n_valid[g];
  const int n_chunks = (nv + ch - 1) / ch;
  const int nct = n_u / ch;
  const int* cand = u_idx + size_t(g) * n_u;

  // Chunk j's soup rows into dst, 16 bytes a copy: consecutive threads
  // take consecutive pieces of a row, so a warp reads whole 512 B rows.
  const int k4 = k >> 2;
  const int pieces = kRows * ch * k4;
  auto stage = [&](int j, float* dst) {
    for (int e = tid; e < pieces; e += nt) {
      const int rr = e / k4;           // slot * 9 + row
      const int col = (e - rr * k4) * 4;
      const int slot = rr / kRows;
      const int row = rr - slot * kRows;
      const int cl = cand[min(j * ch + slot, n_u - 1)];
      cp_async16(dst + row * w + slot * k + col,
                 soup + (size_t(cl) * kRows + row) * k + col);
    }
    cp_async_commit();
  };

  if (n_chunks > 0) stage(0, s_mem);
  for (int j = 0; j < n_chunks; ++j) {
    const float* cur = s_mem + (j & 1) * buf;
    if (j + 1 < n_chunks) {
      stage(j + 1, s_mem + ((j + 1) & 1) * buf);
      cp_async_wait<1>();  // this thread's copies of chunk j have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();       // ... and everyone else's

    bool busy = false;
#pragma unroll
    for (int r = 0; r < R; ++r) busy |= rtm[r] > 0.0f && !occ[r];
    if (busy) {
      for (int f = 0; f < w; f += 4) {
        float4 a[kRows];
#pragma unroll
        for (int row = 0; row < kRows; ++row)
          a[row] = *reinterpret_cast<const float4*>(cur + row * w + f);
        float saved_t[R];
        int saved_flat[R];
        bool saved_occ[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          saved_t[r] = best_t[r];
          saved_flat[r] = best_flat[r];
          saved_occ[r] = occ[r];
        }
        if (test_four<kAnyHit, false, R>(a, rox, roy, roz, rdx, rdy, rdz,
                                         rtm, t_min, j * w + f, best_t,
                                         best_flat, occ)) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            best_t[r] = saved_t[r];
            best_flat[r] = saved_flat[r];
            occ[r] = saved_occ[r];
          }
          test_four<kAnyHit, true, R>(a, rox, roy, roz, rdx, rdy, rdz, rtm,
                                      t_min, j * w + f, best_t, best_flat,
                                      occ);
        }
        if (kAnyHit) {
          bool open = false;
#pragma unroll
          for (int r = 0; r < R; ++r) open |= rtm[r] > 0.0f && !occ[r];
          if (!open) break;
        }
      }
    }

    // Early exit at the chunk boundary (uniform across the CTA).
    const float nxt = (j + 1) * ch < nv
                          ? entry[size_t(g) * n_u + min(j + 1, nct - 1) * ch]
                          : kBig;
    bool stop;
    if (kAnyHit) {
      bool open = false;
      float open_tmax = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (rtm[r] > 0.0f && !occ[r]) {
          open = true;
          open_tmax = fmaxf(open_tmax, rtm[r]);
        }
      }
      const bool rem = __syncthreads_or(open) != 0;
      const float rem_tmax = block_max(open_tmax, s_red);
      stop = !rem || nxt > rem_tmax;
    } else {
      float worst = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (rtm[r] > 0.0f) worst = fmaxf(worst, fminf(best_t[r], rtm[r]));
      }
      stop = block_max(worst, s_red) <= nxt;
    }
    if (stop) break;
  }
  cp_async_wait<0>();  // drain the prefetch an early exit left in flight

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t i = first + size_t(r) * nt;
    if (kAnyHit) {
      occ_out[i] = occ[r];
    } else {
      best_t_out[i] = best_t[r];
      best_flat_out[i] = best_flat[r];
    }
  }
}

template <bool kAnyHit, int R>
int launch_r(const int* u_idx, const int* n_valid, const float* entry,
             const float* o, const float* d, const float* t_max,
             const float* soup, int n_blocks, int block, int n_u, int k,
             int ch, float t_min, float* best_t, int* best_flat, bool* occ,
             cudaStream_t stream) {
  const int threads = block / R;
  const size_t smem =
      (2 * size_t(kRows) * ch * k + size_t(threads / 32)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        trace_blocks_kernel<kAnyHit, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  trace_blocks_kernel<kAnyHit, R><<<n_blocks, threads, smem, stream>>>(
      u_idx, n_valid, entry, o, d, t_max, soup, n_u, k, ch, t_min, best_t,
      best_flat, occ);
  return int(cudaGetLastError());
}

template <bool kAnyHit>
int launch(const int* u_idx, const int* n_valid, const float* entry,
           const float* o, const float* d, const float* t_max,
           const float* soup, int n_blocks, int block, int n_u, int k, int ch,
           float t_min, float* best_t, int* best_flat, bool* occ,
           void* stream) {
  if (n_blocks <= 0) return 0;
  // 16-byte copies need 16-byte aligned soup rows; the block must be whole
  // warps.
  if (k % 4 != 0 || reinterpret_cast<std::uintptr_t>(soup) % 16 != 0 ||
      block % 32 != 0 || block < 32 || block > 1024)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block % 64 == 0)
    return launch_r<kAnyHit, 2>(u_idx, n_valid, entry, o, d, t_max, soup,
                                n_blocks, block, n_u, k, ch, t_min, best_t,
                                best_flat, occ, s);
  return launch_r<kAnyHit, 1>(u_idx, n_valid, entry, o, d, t_max, soup,
                              n_blocks, block, n_u, k, ch, t_min, best_t,
                              best_flat, occ, s);
}

// Counts the floats x = bits lo .. lo + count - 1 for which rcp_rn(x) and
// 1.0f / x differ in any bit.
__global__ void rcp_check_kernel(unsigned lo, unsigned long long count,
                                 unsigned long long* bad) {
  unsigned long long n_bad = 0;
  for (unsigned long long i = blockIdx.x * 256ull + threadIdx.x; i < count;
       i += 256ull * gridDim.x) {
    const float x = __uint_as_float(unsigned(lo + i));
    n_bad += __float_as_uint(rcp_rn(x)) != __float_as_uint(1.0f / x);
  }
  if (n_bad) atomicAdd(bad, n_bad);
}

}  // namespace

// The reciprocal check over the floats with bit patterns lo .. lo + count
// - 1; adds the number that differ to *bad (a zeroed device counter).
extern "C" int pbr_rcp_check(unsigned lo, unsigned long long count,
                             unsigned long long* bad, void* stream) {
  rcp_check_kernel<<<4096, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      lo, count, bad);
  return int(cudaGetLastError());
}

extern "C" int pbr_trace_blocks_closest(
    const int* u_idx, const int* n_valid, const float* entry, const float* o,
    const float* d, const float* t_max, const float* soup, int n_blocks,
    int block, int n_u, int k, int ch, float t_min, float* best_t,
    int* best_flat, void* stream) {
  return launch<false>(u_idx, n_valid, entry, o, d, t_max, soup, n_blocks,
                       block, n_u, k, ch, t_min, best_t, best_flat, nullptr,
                       stream);
}

extern "C" int pbr_trace_blocks_any(
    const int* u_idx, const int* n_valid, const float* entry, const float* o,
    const float* d, const float* t_max, const float* soup, int n_blocks,
    int block, int n_u, int k, int ch, float t_min, bool* occ,
    void* stream) {
  return launch<true>(u_idx, n_valid, entry, o, d, t_max, soup, n_blocks,
                      block, n_u, k, ch, t_min, nullptr, nullptr, occ,
                      stream);
}
