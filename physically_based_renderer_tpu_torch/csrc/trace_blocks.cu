// Block-stream tracer (K1): closest-hit and any-hit Moller-Trumbore of ray
// blocks against their candidate clusters, streamed chunk by chunk.
//
// Replaces: the reference package's ops/pallas_trace.py::_mt_kernel_body
// (:54), entered through trace_blocks_pallas (:252).  On the TPU one grid
// step per ray block DMAs chunks of ch candidate clusters into VMEM and runs
// a dense [B, ch*K] array of tests with a min-reduction per ray.  Here one
// CTA owns one ray block and one thread owns one ray: the CTA stages the
// chunk into shared memory and every thread walks its ch*K triangles.
//
// What bounds it on the H100: arithmetic and latency.  A ray-triangle test
// is ~30 f32 operations on 36 bytes of triangle data that every thread of
// the CTA reads at the same shared-memory address (a broadcast); a chunk of
// 4 x 128 triangles is 18 KB staged once per CTA, so device-memory traffic
// is small next to the tests.  The early exit bounds how many chunks a
// block pays for.
//
// Design:
//  * grid = number of ray blocks, blockDim = B rays (a multiple of 32);
//    the block's candidate list u_idx, its valid count n_valid and the
//    candidates' entry distances are read from global memory;
//  * per chunk j: __syncthreads, a cooperative plain load of the ch
//    clusters' 9 x K soup rows into shared memory laid out [9][ch*K]
//    (candidate i at column offset i*K), __syncthreads, then each live
//    thread tests the ch*K triangles in flat order f and keeps a hit only
//    on a strictly smaller t, which gives the reference's tie rule (lowest
//    flat index among equal t).  Candidate slots past n_u refetch the last
//    slot, as the reference does; callers pad u_idx with the sentinel;
//  * the per-block early exit is tested at the same chunk boundaries as the
//    reference, as block reductions (warp shuffles + shared memory, and
//    __syncthreads_or), so every thread leaves the loop together;
//  * lanes with t_max <= 0 (culled or padding) can never hit because
//    t > t_min >= 0 and t < t_max exclude each other, so they skip the tests;
//  * padding triangles and the sentinel have det = 0: the masked inverse is
//    0 and t = 0 fails t > t_min, with no id mask;
//  * loads are synchronous, so an early exit leaves nothing in flight;
//  * rounding: the library is built with -fmad=false, so each product and
//    sum rounds once in the order of the plain torch version
//    (ops/trace_blocks.py::trace_blocks_plain), and t and the winner agree.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;
constexpr int kRows = 9;
constexpr unsigned kFull = 0xffffffffu;

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

template <bool kAnyHit>
__global__ void trace_blocks_kernel(
    const int* __restrict__ u_idx, const int* __restrict__ n_valid,
    const float* __restrict__ entry, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ t_max,
    const float* __restrict__ soup, int n_u, int k, int ch, float t_min,
    float* __restrict__ best_t_out, int* __restrict__ best_flat_out,
    bool* __restrict__ occ_out) {
  extern __shared__ float s_mem[];
  const int w = ch * k;
  float* s_soup = s_mem;              // [9][w]
  float* s_red = s_mem + kRows * w;   // [blockDim / 32]

  const int g = blockIdx.x;
  const int b = blockDim.x;
  const int tid = threadIdx.x;
  const size_t i = size_t(g) * b + tid;
  const float rox = o[3 * i + 0], roy = o[3 * i + 1], roz = o[3 * i + 2];
  const float rdx = d[3 * i + 0], rdy = d[3 * i + 1], rdz = d[3 * i + 2];
  const float rtm = t_max[i];
  const bool live = rtm > 0.0f;

  const int nv = n_valid[g];
  const int n_chunks = (nv + ch - 1) / ch;
  const int nct = n_u / ch;
  const int* cand = u_idx + size_t(g) * n_u;

  float best_t = kBig;
  int best_flat = -1;
  bool occ = false;
  for (int j = 0; j < n_chunks; ++j) {
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < kRows * w; e += b) {
      const int slot = e / (kRows * k);
      const int rem = e - slot * (kRows * k);
      const int row = rem / k;
      const int col = rem - row * k;
      const int cl = cand[min(j * ch + slot, n_u - 1)];
      s_soup[row * w + slot * k + col] =
          soup[(size_t(cl) * kRows + row) * k + col];
    }
    __syncthreads();

    if (live && !occ) {
      for (int f = 0; f < w; ++f) {
        const float v0x = s_soup[0 * w + f], v0y = s_soup[1 * w + f];
        const float v0z = s_soup[2 * w + f], e1x = s_soup[3 * w + f];
        const float e1y = s_soup[4 * w + f], e1z = s_soup[5 * w + f];
        const float e2x = s_soup[6 * w + f], e2y = s_soup[7 * w + f];
        const float e2z = s_soup[8 * w + f];
        const float px = rdy * e2z - rdz * e2y;
        const float py = rdz * e2x - rdx * e2z;
        const float pz = rdx * e2y - rdy * e2x;
        const float det = px * e1x + py * e1y + pz * e1z;
        const float inv = fabsf(det) > 1e-9f ? 1.0f / det : 0.0f;
        const float tx = rox - v0x;
        const float ty = roy - v0y;
        const float tz = roz - v0z;
        const float uu = (tx * px + ty * py + tz * pz) * inv;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float vv = (rdx * qx + rdy * qy + rdz * qz) * inv;
        const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv;
        const bool ok = uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f &&
                        tt > t_min && tt < rtm;
        if (kAnyHit) {
          if (ok) {
            occ = true;
            break;
          }
        } else if (ok && tt < best_t) {
          best_t = tt;
          best_flat = j * w + f;
        }
      }
    }

    // Early exit at the chunk boundary (uniform across the CTA).
    const float nxt = (j + 1) * ch < nv
                          ? entry[size_t(g) * n_u + min(j + 1, nct - 1) * ch]
                          : kBig;
    bool stop;
    if (kAnyHit) {
      const bool open = live && !occ;
      const bool rem = __syncthreads_or(open) != 0;
      const float rem_tmax = block_max(open ? rtm : 0.0f, s_red);
      stop = !rem || nxt > rem_tmax;
    } else {
      const float worst = block_max(live ? fminf(best_t, rtm) : 0.0f, s_red);
      stop = worst <= nxt;
    }
    if (stop) break;
  }
  if (kAnyHit) {
    occ_out[i] = occ;
  } else {
    best_t_out[i] = best_t;
    best_flat_out[i] = best_flat;
  }
}

template <bool kAnyHit>
int launch(const int* u_idx, const int* n_valid, const float* entry,
           const float* o, const float* d, const float* t_max,
           const float* soup, int n_blocks, int block, int n_u, int k, int ch,
           float t_min, float* best_t, int* best_flat, bool* occ,
           void* stream) {
  if (n_blocks <= 0) return 0;
  const size_t smem =
      (size_t(kRows) * ch * k + size_t(block / 32)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        trace_blocks_kernel<kAnyHit>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  trace_blocks_kernel<kAnyHit><<<n_blocks, block, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      u_idx, n_valid, entry, o, d, t_max, soup, n_u, k, ch, t_min, best_t,
      best_flat, occ);
  return int(cudaGetLastError());
}

}  // namespace

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
    int block, int n_u, int k, int ch, float t_min, bool* occ, void* stream) {
  return launch<true>(u_idx, n_valid, entry, o, d, t_max, soup, n_blocks,
                      block, n_u, k, ch, t_min, nullptr, nullptr, occ, stream);
}
