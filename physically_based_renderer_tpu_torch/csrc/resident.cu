// Resident tracer (K2): closest-hit and any-hit Moller-Trumbore of a ray
// batch against a whole small triangle soup held in shared memory.
//
// Replaces: the reference package's ops/resident.py::_kernel (:54), entered
// through _impl / intersect_resident.  The TPU kernel lays triangles on
// sublanes and a block of rays on lanes and reduces a [T', B] array; here
// each thread owns one or two rays and walks the triangles itself.
//
// What bounds it on the H100: arithmetic.  One ray-triangle test is 46
// float operations and a reciprocal on 36 bytes of triangle data that every
// thread of the block reads at the same address (a shared-memory
// broadcast), while a ray costs 28 bytes of global traffic for the whole
// loop.  At Cornell size (32 triangles) a 262,144-ray call is ~390 MFLOP
// against ~10 MB of memory traffic, so the kernel is FP32-issue and latency
// bound, and launch cost is a visible share of it.  What keeps a test loop
// from that bound is latency: each test is a chain of dependent operations,
// and IEEE division compiles to a range check, a branch and a slow-path
// call, which make every test that divides a basic block of its own that
// the scheduler cannot overlap with the next.
//
// Design:
//  * closest-hit: 128 threads a block, two rays a thread, so that every
//    broadcast of a triangle serves two tests; any-hit: 256 threads, one
//    ray a thread (where a third of the lanes trace, more busy warps hide
//    more latency).  Ragged tail masked by n_rays;
//  * each block stages the soup as three float4s a triangle (v0, e1, e2,
//    each padded to 16 bytes) from the [T, 9] rows the wrapper passes,
//    rounded up to a multiple of four triangles with zero rows: 1.5 KB for
//    Cornell, 96 KB at the 2048-triangle cap, which needs the opt-in above
//    48 KB (cudaFuncSetAttribute).  A test reads three 16-byte broadcasts.
//    A zero triangle has det = 0 and never hits;
//  * the reciprocal of det is rcp_rn (rcp.cuh): three instructions, no
//    branch, equal to 1.0f / det for |det| in (1e-9, 2^126) (checked on
//    every float on the card, pbr_rcp_check).  Triangles are tested in
//    groups of four; a group in which some |det| reaches 2^126 restores the
//    rays' state from before it and runs again with the division, so
//    results are always those of 1.0f / det.  With no branch in a test, the
//    four or eight tests of a group are one basic block.  The plain
//    version's zero inv where |det| <= 1e-9 needs no select: that test
//    fails on `nonzero` whatever inv is;
//  * a lane whose t_max is not above t_min (a hopeless shadow ray gets
//    t_max = 0; NaN too) cannot hit: t > t_min and t < t_max exclude each
//    other.  Its answer, (1e30, -1) or false, is written without a test.
//    The block packs its live lanes to the front of a list in shared
//    memory (a ballot and one shared atomic a warp), and thread t traces
//    list entries first + R * t + r, in rounds of R * threads: where a
//    third of the lanes are live, as in a frame's shadow rays, an any-hit
//    block of 256 threads scans 512 lanes and keeps two thirds of its
//    warps busy for one round, where a lane a thread would leave two
//    thirds of them with nothing to trace (and 1,024 lanes a block too few
//    blocks for the card).  In any-hit a thread leaves the loop after the
//    group in which its last ray found an occluder, so a warp stops once
//    every lane has its answer;
//  * closest-hit loops in index order and takes a hit only below
//    min(t_max, best t), one compare for the plain version's two, so ties
//    go to the lowest triangle index: the reference's `tt <= tmin_row ->
//    min row` rule; miss = (-1, 1e30);
//  * rounding: the library is built with -fmad=false, so every product and
//    sum rounds once, in the same order as the plain torch version
//    (ops/resident.py::trace_plain); t and the winner then agree exactly.

#include <cuda_runtime.h>

#include "rcp.cuh"

namespace {

// Threads a block and rays a thread, closest-hit and any-hit; the lanes an
// any-hit block scans (traced in rounds of 256); threads an SM asked of
// ptxas (at most 65,536 / 768 = 85 registers a thread).  Two rays a thread
// pay where every lane traces; where a third does, one ray a thread and
// two lanes a thread keep more warps busy (PERF.md).
constexpr int kThreadsClosest = 128, kRaysClosest = 2;
constexpr int kThreadsAny = 256, kRaysAny = 1;
constexpr int kLanesAny = 512;
constexpr int kThreadsAnSm = 768;
constexpr float kBig = 1e30f;
constexpr int kSoupW = 9;
constexpr unsigned kFull = 0xffffffffu;

using pbr::kRcpHi;
using pbr::kRcpLo;
using pbr::rcp_rn;

// The soup's [n_tris, 9] rows as three float4s a triangle, padded with
// zero triangles to n_pad (a multiple of four).
__device__ __forceinline__ void stage(const float* __restrict__ soup,
                                      int n_tris, int n_pad, float4* s_tri) {
  for (int k = threadIdx.x; k < 3 * n_pad; k += blockDim.x) {
    const int tri = k / 3;
    const float* src = soup + kSoupW * tri + 3 * (k - 3 * tri);
    s_tri[k] = tri < n_tris ? make_float4(src[0], src[1], src[2], 0.0f)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Triangle k's v0, e1 and e2: three 16-byte broadcasts.
__device__ __forceinline__ void load_tri(const float4* s_tri, int k,
                                         float4& a, float4& b, float4& c) {
  a = s_tri[3 * k];
  b = s_tri[3 * k + 1];
  c = s_tri[3 * k + 2];
}

// Triangles first .. first + 3 against a thread's R rays, in index order;
// returns whether some |det| lay at or above kRcpHi, where rcp_rn is not
// checked (kExact = false: the caller restores the state and runs the
// group again with kExact = true, which divides).  lim is min(t_max,
// best t) of a closest-hit lane: a hit must lie below both.
template <bool kAnyHit, bool kExact, int R>
__device__ __forceinline__ bool test_four(
    const float4* s_tri, int first, const float (&rox)[R],
    const float (&roy)[R], const float (&roz)[R], const float (&rdx)[R],
    const float (&rdy)[R], const float (&rdz)[R], const float (&rtm)[R],
    float t_min, float (&lim)[R], int (&best)[R], bool (&occ)[R]) {
  float amax = 0.0f;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    float4 a, b, c;
    load_tri(s_tri, first + m, a, b, c);
    const float v0x = a.x, v0y = a.y, v0z = a.z;
    const float e1x = b.x, e1y = b.y, e1z = b.z;
    const float e2x = c.x, e2y = c.y, e2z = c.z;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float px = rdy[r] * e2z - rdz[r] * e2y;
      const float py = rdz[r] * e2x - rdx[r] * e2z;
      const float pz = rdx[r] * e2y - rdy[r] * e2x;
      const float det = px * e1x + py * e1y + pz * e1z;
      const float ad = fabsf(det);
      const bool nonzero = ad > kRcpLo;
      // The plain version zeroes inv where !nonzero; nonzero is in ok, so
      // what inv is there does not matter.
      float inv;
      if (kExact) {
        inv = 1.0f / det;
      } else {
        amax = fmaxf(amax, ad);
        inv = rcp_rn(det);
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
      const bool ok = nonzero && uu >= 0.0f && vv >= 0.0f &&
                      uu + vv <= 1.0f && tt > t_min;
      if (kAnyHit) {
        occ[r] = occ[r] || (ok && tt < rtm[r]);
      } else if (ok && tt < lim[r]) {
        lim[r] = tt;
        best[r] = first + m;
      }
    }
  }
  return amax >= kRcpHi;
}

// The packed lanes first + R * tid + r (< n_live; lane j of the block is
// ray block0 + j) traced against the staged soup, and their answers
// written.
template <bool kAnyHit, int R>
__device__ __forceinline__ void trace_lanes(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_max, const float4* s_tri, const int* s_lane,
    size_t block0, int first, int n_live, int n_pad, float t_min,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    bool* __restrict__ occ_out) {
  const int tid = threadIdx.x;
  float rox[R], roy[R], roz[R], rdx[R], rdy[R], rdz[R], rtm[R], lim[R];
  int best[R];
  bool occ[R], has[R];
  size_t ray[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int slot = first + R * tid + r;
    has[r] = slot < n_live;
    ray[r] = block0 + s_lane[has[r] ? slot : first + R * tid];
    const size_t i = ray[r];
    rox[r] = o[3 * i + 0];
    roy[r] = o[3 * i + 1];
    roz[r] = o[3 * i + 2];
    rdx[r] = d[3 * i + 0];
    rdy[r] = d[3 * i + 1];
    rdz[r] = d[3 * i + 2];
    rtm[r] = t_max[i];
    lim[r] = fminf(rtm[r], kBig);
    best[r] = -1;
    occ[r] = false;
  }

  for (int k = 0; k < n_pad; k += 4) {
    float saved_lim[R];
    int saved[R];
    bool saved_occ[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      saved_lim[r] = lim[r];
      saved[r] = best[r];
      saved_occ[r] = occ[r];
    }
    if (test_four<kAnyHit, false>(s_tri, k, rox, roy, roz, rdx, rdy, rdz,
                                  rtm, t_min, lim, best, occ)) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        lim[r] = saved_lim[r];
        best[r] = saved[r];
        occ[r] = saved_occ[r];
      }
      test_four<kAnyHit, true>(s_tri, k, rox, roy, roz, rdx, rdy, rdz, rtm,
                               t_min, lim, best, occ);
    }
    if (kAnyHit) {
      bool open = false;
#pragma unroll
      for (int r = 0; r < R; ++r) open |= has[r] && !occ[r];
      if (!open) break;
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!has[r]) continue;
    if (kAnyHit) {
      occ_out[ray[r]] = occ[r];
    } else {
      // lim is the winner's t once there is one
      t_out[ray[r]] = best[r] >= 0 ? lim[r] : kBig;
      tri_out[ray[r]] = best[r];
    }
  }
}

// A block scans kLanes lanes (lane j = s * kThreads + tid is ray block0 +
// j), answers the dead ones, packs the live ones and traces them in rounds
// of R * kThreads.
template <bool kAnyHit, int kThreads, int R, int kLanes>
__global__ void __launch_bounds__(kThreads, kThreadsAnSm / kThreads)
    resident_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_max,
                    const float* __restrict__ soup, int n_rays, int n_tris,
                    float t_min, float* __restrict__ t_out,
                    int* __restrict__ tri_out, bool* __restrict__ occ_out) {
  constexpr int kScan = kLanes / kThreads;
  extern __shared__ float4 s_tri[];
  __shared__ int s_lane[kLanes];   // the live lanes, packed
  __shared__ int s_live;
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t block0 = size_t(blockIdx.x) * kLanes;
  if (tid == 0) s_live = 0;

  bool live[kScan];
#pragma unroll
  for (int s = 0; s < kScan; ++s) {
    const size_t i = block0 + s * kThreads + tid;
    const bool in = i < size_t(n_rays);
    live[s] = in && t_max[i] > t_min;
    if (in && !live[s]) {
      if (kAnyHit) {
        occ_out[i] = false;
      } else {
        t_out[i] = kBig;
        tri_out[i] = -1;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kScan; ++s) {
    const unsigned ballot = __ballot_sync(kFull, live[s]);
    int base = 0;
    if (lane == 0 && ballot) base = atomicAdd(&s_live, __popc(ballot));
    base = __shfl_sync(kFull, base, 0);
    if (live[s])
      s_lane[base + __popc(ballot & ((1u << lane) - 1u))] = s * kThreads + tid;
  }
  const int n_pad = (n_tris + 3) & ~3;
  stage(soup, n_tris, n_pad, s_tri);
  __syncthreads();
  const int n_live = s_live;
  for (int first = 0; first + R * tid < n_live; first += R * kThreads)
    trace_lanes<kAnyHit, R>(o, d, t_max, s_tri, s_lane, block0, first,
                            n_live, n_pad, t_min, t_out, tri_out, occ_out);
}

template <bool kAnyHit>
int launch(const float* o, const float* d, const float* t_max,
           const float* soup, int n_rays, int n_tris, float t_min,
           float* t_out, int* tri_out, bool* occ_out, void* stream) {
  constexpr int kThreads = kAnyHit ? kThreadsAny : kThreadsClosest;
  constexpr int R = kAnyHit ? kRaysAny : kRaysClosest;
  constexpr int kLanes = kAnyHit ? kLanesAny : R * kThreads;
  const auto kernel = resident_kernel<kAnyHit, kThreads, R, kLanes>;
  if (n_rays <= 0) return 0;
  const size_t smem = size_t((n_tris + 3) & ~3) * 3 * sizeof(float4);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const int blocks = int((n_rays + (long long)(kLanes) - 1) / kLanes);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, t_max, soup, n_rays, n_tris, t_min, t_out, tri_out, occ_out);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int pbr_resident_closest(const float* o, const float* d,
                                    const float* t_max, const float* soup,
                                    int n_rays, int n_tris, float t_min,
                                    float* t_out, int* tri_out,
                                    void* stream) {
  return launch<false>(o, d, t_max, soup, n_rays, n_tris, t_min, t_out,
                       tri_out, nullptr, stream);
}

extern "C" int pbr_resident_any(const float* o, const float* d,
                                const float* t_max, const float* soup,
                                int n_rays, int n_tris, float t_min,
                                bool* occ_out, void* stream) {
  return launch<true>(o, d, t_max, soup, n_rays, n_tris, t_min, nullptr,
                      nullptr, occ_out, stream);
}

extern "C" const char* pbr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
