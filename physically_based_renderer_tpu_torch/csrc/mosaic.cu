// The last four probes (P5-P8): what a repeated in-kernel gather, a scalar
// tree walk, the tracer's per-chunk arithmetic and a stream of small
// double-buffered copies cost on an H100.
//
// Replaces: the reference repository's tools/probe_mosaic.py and
// tools/exp_subtile_dma.py kernels
//   P5  probe_gather       probe_mosaic.py:37   sum over i < reps of
//                          take_along_axis(x, (idx + i) % size, axis)
//   P6  probe_scalar_stack probe_mosaic.py:83   a scalar walk of an implicit
//                          binary tree with a stack; counts the nodes visited
//   P7  probe_chunk        probe_mosaic.py:148  Moller-Trumbore-shaped products
//                          of b rays x w columns per chunk, masked, min
//   P8  kernel / run       exp_subtile_dma.py:14, :48  double-buffered copies
//                          of [16, 32] tiles picked by an index list, summed
// Each asked on the TPU whether a primitive of a whole-frame kernel or of the
// block tracer's redesign was cheap enough.  The same questions are asked of
// this card; none of the kernels is carried over block by block.
//
// What bounds them on the H100:
//   P5  bytes (table, indices, output once each); the tables are 4 KB to
//       2 MB, so at most shapes the launch.  What costs is the gathered
//       read: a warp's 32 lanes along axis 0 read 32 random rows, 32
//       sectors of 32 bytes for 4 useful bytes each, so a gather through
//       L1/L2 moves ~8x the table's bytes a rep at the L2's rate.  Staged
//       slabs move the table's bytes a few times in all, in whole sectors.
//   P6  latency: the count of visited nodes needs no chain (csrc/tree.cuh),
//       so the bound is the tree's depth in shared-memory round trips,
//       and at these sizes the launch.
//   P7  operations: ten float adds, multiplies and a division per test.
//   P8  bytes: each 2 KB tile read from device memory (8.4 MB of distinct
//       tiles, 67.1 MB counting every copy; all of it fits in the 50 MB L2
//       only as distinct tiles).
//
// Design.  P5: the slab route of csrc/slab.cuh (shared with P4): a CTA
// stages, once, the slab of x its outputs can reach, 16 columns over all
// rows along axis 0 (two lanes a bank, for half the bytes a 32-column
// slab restages) or whole rows along axis 1, with 16-byte cp.async where
// the rows allow it (L % 4 == 0, x 16-byte aligned), else 4-byte cp.async.
// The direct route reads x through L1/L2, one thread an output: it takes
// the small calls, which are as short as their launch and where a slab's
// staging round trip costs more than it saves, and the tables no slab fits
// (an axis-0 table above 14,528 rows, a row above 58,112 lanes).  The plan
// (route, C or rows a slab, outputs a CTA, threads) is
// ops/probes.py::mosaic_gather_plan's.
// Each index is reduced into range once (floor modulo, as jnp's %) and
// stepped by one a rep, wrapping at the axis' size; the sum runs in rep
// order from 0.0f, as the plain version's loop does, so the kernel equals
// it on any float data.  P6: the open flags of the inner nodes only (a
// leaf's own test never changes the count) by csrc/tree.cuh, shared with
// P1, in one CTA of 512 threads; every open inner node pushes both
// children, so the walk visits 1 + 2 x (open inner nodes), summed by one
// block reduction.  P7: one CTA per ray, its
// threads over the columns; each keeps a running min and the CTA reduces
// it by warp shuffles (min is exact in any order; the masked value is
// never NaN).  1/det is an IEEE division (no fast math) and -fmad=false
// keeps every product and sum rounded as in the plain version, so the two
// agree bit for bit.  P8: one CTA per block g of ch x 32 threads; each step
// j issues ch copies of 2 KB as 16-byte cp.async into one of two
// shared-memory slots, commits the group, and waits for the previous group
// (wait_group 1) while the next one flies; thread t sums lane t % 32 of
// tile t / 32 over its 16 rows in order and adds that to its running sum.

#include <cuda_runtime.h>

#include "slab.cuh"
#include "tree.cuh"

namespace {

constexpr int kScalarThreads = 512;  // P6: one CTA
constexpr int kChunkThreads = 128;   // P7 threads per ray
constexpr int kTileRows = 16;        // P8 tile: 16 rows
constexpr int kTileLanes = 32;       //          x 32 lanes = 2 KB
constexpr int kTileFloats = kTileRows * kTileLanes;
constexpr int kTileChunks = kTileFloats / 4;  // 16-byte pieces of a tile
// P5's routes: ops/probes.py::GATHER_ROUTES.
constexpr int kRouteSlab = 0, kRouteDirect = 1;

using pbr::allow_smem;
using pbr::cp_async16;
using pbr::cp_async_commit;
using pbr::cp_async_wait;

// ---------------------------------------------------------------- P5
// The slab route: csrc/slab.cuh's body, summing reps with floor-modulo
// indices.
template <int kAxis>
__global__ void __launch_bounds__(1024)
    mosaic_gather_kernel_slab(const float* __restrict__ x,
                              const int* __restrict__ idx, int rows,
                              int lanes, int reps, int tile, int per,
                              int piece, float* __restrict__ out) {
  pbr::slab_gather<kAxis, false>(x, idx, rows, lanes, reps, tile, per, piece,
                                 out);
}

// The L1/L2 route: one thread an output, x read through the caches.
template <int kAxis>
__global__ void mosaic_gather_kernel_direct(const float* __restrict__ x,
                                            const int* __restrict__ idx,
                                            int rows, int lanes, int reps,
                                            float* __restrict__ out) {
  const unsigned total = unsigned(rows) * unsigned(lanes);
  const unsigned e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const unsigned row = e / unsigned(lanes);
  const unsigned col = e - row * unsigned(lanes);
  const int size = kAxis == 0 ? rows : lanes;
  int k = __ldg(idx + e) % size;
  if (k < 0) k += size;
  float acc = 0.0f;
  for (int i = 0; i < reps; ++i) {
    const unsigned at = kAxis == 0 ? unsigned(k) * unsigned(lanes) + col
                                   : row * unsigned(lanes) + unsigned(k);
    acc = acc + __ldg(x + at);
    if (++k == size) k = 0;
  }
  out[e] = acc;
}

// ---------------------------------------------------------------- P6
__global__ void __launch_bounds__(kScalarThreads)
    mosaic_scalar_stack_kernel(const float* __restrict__ boxes, int n_nodes,
                               int* __restrict__ out) {
  __shared__ unsigned char s_open[pbr::kTreeMaxNodes / 2];
  __shared__ int s_open_count;
  const int m = (n_nodes - 1) / 2;  // inner nodes: both children exist
  pbr::tree_pass_bits(boxes, m, s_open);
  if (threadIdx.x == 0) s_open_count = 0;
  __syncthreads();
  pbr::tree_levels(m, s_open);
  int open = 0;
  for (int i = threadIdx.x; i < m; i += blockDim.x) open += s_open[i];
  pbr::block_add(open, &s_open_count);
  __syncthreads();
  if (threadIdx.x == 0) out[0] = 1 + 2 * s_open_count;
}

// ---------------------------------------------------------------- P7
__global__ void mosaic_chunk_kernel(const float* __restrict__ o,
                                    const float* __restrict__ t, int b, int w,
                                    int n_chunks, float* __restrict__ out) {
  __shared__ float warp_min[kChunkThreads / 32];
  const int ray = blockIdx.x;
  const float rox = o[ray];  // row 0 of o
  float best = 1e30f;
  for (int j = 0; j < n_chunks; ++j) {
    const float scale = float(j) + 1.0f;
    for (int c = threadIdx.x; c < w; c += blockDim.x) {
      const float e0 = (t[c] * scale) * 1.0001f;
      const float e1 = (t[w + c] * scale) * 1.0001f;
      const float px = rox * e0;
      const float det = px * e1 + px;
      const float inv = fabsf(det) > 1e-9f ? 1.0f / det : 0.0f;
      const float uu = px * inv;
      const float vv = uu * inv + px;
      const float tt = vv * uu + uu;
      const bool ok = uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f &&
                      tt > 0.0f;
      best = fminf(best, ok ? tt : 1e30f);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    best = fminf(best, __shfl_down_sync(0xffffffffu, best, off));
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_min[0];
    for (int k = 1; k < int(blockDim.x >> 5); ++k) m = fminf(m, warp_min[k]);
    out[ray] = m;
  }
}

// ---------------------------------------------------------------- P8
__global__ void subtile_copy_kernel(const float* __restrict__ src,
                                    const int* __restrict__ idx, int n_src,
                                    int n_iters, int ch,
                                    float* __restrict__ out) {
  extern __shared__ float4 slots4[];  // [2][ch][16][32] floats
  float* slots = reinterpret_cast<float*>(slots4);
  const int g = blockIdx.x;
  const int slot_floats = ch * kTileFloats;
  const int* my_idx = idx + size_t(g) * n_iters * ch;

  auto issue = [&](int j) {
    float4* dst = slots4 + size_t(j & 1) * (slot_floats / 4);
    for (int q = threadIdx.x; q < ch * kTileChunks; q += blockDim.x) {
      const int i = q / kTileChunks;
      const int piece = q - i * kTileChunks;
      const int tile = min(max(my_idx[j * ch + i], 0), n_src - 1);
      cp_async16(dst + i * kTileChunks + piece,
                 reinterpret_cast<const float4*>(src) +
                     size_t(tile) * kTileChunks + piece);
    }
    cp_async_commit();
  };

  const int i = threadIdx.x / kTileLanes;  // tile of this thread's lane
  const int lane = threadIdx.x % kTileLanes;
  float acc = 0.0f;
  issue(0);
  for (int j = 0; j < n_iters; ++j) {
    if (j + 1 < n_iters) {
      issue(j + 1);
      cp_async_wait<1>();  // step j's copies have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* tile = slots + size_t(j & 1) * slot_floats +
                        i * kTileFloats + lane;
    float rows = tile[0];
    for (int r = 1; r < kTileRows; ++r) rows = rows + tile[r * kTileLanes];
    acc = acc + rows;
    __syncthreads();  // slot j & 1 is refilled at step j + 2
  }
  out[size_t(g) * ch * kTileLanes + threadIdx.x] = acc;
}

}  // namespace

// x f32[rows, lanes], idx i32[rows, lanes] -> out f32[rows, lanes],
// out[r, c] = sum over i < reps of x[(idx[r, c] + i) mod rows, c] (axis 0) or
// x[r, (idx[r, c] + i) mod lanes] (axis 1), the modulo a floor modulo.  The
// plan (ops/probes.py::mosaic_gather_plan): route (kRouteSlab, kRouteDirect),
// tile (slab: C columns for axis 0, a power of two in [2, 32]; rows for
// axis 1), per (slab: output rows a CTA for axis 0, columns for axis 1) and
// threads a CTA (a multiple of 32 up to 1024).
extern "C" int pbr_mosaic_gather(const float* x, const int* idx, int rows,
                                 int lanes, int axis, int reps, int route,
                                 int tile, int per, int threads, float* out,
                                 void* stream) {
  const long long total = (long long)rows * lanes;
  if (total <= 0) return 0;
  if (total >= (1LL << 31) || (axis != 0 && axis != 1) || reps < 0 ||
      threads < 32 || threads > 1024 || threads % 32)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteDirect) {
    const unsigned blocks = unsigned((total + threads - 1) / threads);
    if (axis == 0)
      mosaic_gather_kernel_direct<0><<<blocks, threads, 0, s>>>(
          x, idx, rows, lanes, reps, out);
    else
      mosaic_gather_kernel_direct<1><<<blocks, threads, 0, s>>>(
          x, idx, rows, lanes, reps, out);
    return int(cudaGetLastError());
  }
  dim3 grid;
  size_t smem;
  cudaError_t err = route == kRouteSlab
      ? pbr::slab_shape(rows, lanes, axis, tile, per, &grid, &smem)
      : cudaErrorInvalidValue;
  if (err != cudaSuccess) return int(err);
  // 16-byte pieces where the rows allow them, else 4-byte ones.
  const bool aligned = (reinterpret_cast<size_t>(x) & 15) == 0;
  const int piece = aligned && lanes % 4 == 0 ? 4 : 1;
  if (axis == 0)
    err = pbr::launch_slab(mosaic_gather_kernel_slab<0>, grid, threads, smem,
                           s, x, idx, rows, lanes, reps, tile, per, piece,
                           out);
  else
    err = pbr::launch_slab(mosaic_gather_kernel_slab<1>, grid, threads, smem,
                           s, x, idx, rows, lanes, reps, tile, per, piece,
                           out);
  return int(err);
}

// boxes f32[n_nodes * 6] (lo xyz | hi xyz per node; n_nodes odd, at most
// pbr::kTreeMaxNodes) -> out i32[1]: the nodes the walk visits.
extern "C" int pbr_mosaic_scalar_stack(const float* boxes, int n_nodes,
                                       int* out, void* stream) {
  if (n_nodes < 1 || n_nodes > pbr::kTreeMaxNodes || n_nodes % 2 == 0)
    return int(cudaErrorInvalidValue);
  mosaic_scalar_stack_kernel<<<1, kScalarThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      boxes, n_nodes, out);
  return int(cudaGetLastError());
}

// o f32[8, b] (row 0 read), t f32[16, w] (rows 0 and 1 read) ->
// out f32[b]: the least masked t over n_chunks chunks of w columns.
extern "C" int pbr_mosaic_chunk(const float* o, const float* t, int b, int w,
                                int n_chunks, float* out, void* stream) {
  if (b <= 0) return 0;
  mosaic_chunk_kernel<<<b, kChunkThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(o, t, b, w,
                                                             n_chunks, out);
  return int(cudaGetLastError());
}

// src f32[n_src, 16, 32], idx i32[nb * n_iters * ch] -> out f32[nb, ch * 32]:
// out[g, 32 i + l] = sum over j of (sum over r of
// src[idx[g n_iters ch + j ch + i], r, l]), rows summed in order.
extern "C" int pbr_subtile_copy(const float* src, const int* idx, int n_src,
                                int nb, int n_iters, int ch, float* out,
                                void* stream) {
  if (nb <= 0) return 0;
  if (n_src <= 0 || n_iters <= 0 || ch <= 0 || ch * kTileLanes > 1024)
    return int(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * 2 * size_t(ch) * kTileFloats;
  const cudaError_t err = allow_smem(subtile_copy_kernel, smem);
  if (err != cudaSuccess) return int(err);
  subtile_copy_kernel<<<nb, ch * kTileLanes, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      src, idx, n_src, n_iters, ch, out);
  return int(cudaGetLastError());
}
