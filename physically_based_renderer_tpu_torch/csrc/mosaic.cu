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
//   P7  operations: ten float adds, multiplies and a reciprocal per test,
//       1,048,576 tests at the tool's shape: under a microsecond over the
//       card's float32 lanes, below the launch itself.  What costs is the
//       dependent chain of a test and, with IEEE division, a basic block a
//       test.
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
// block reduction.
// P7: a CTA owns kChunkRays rays, and its threads split the (column,
// group of eight or four chunks) items, so e0 and e1 are computed once an
// item for all the CTA's rays from registers; a group's tests (16 at the
// tool's 8 chunks) are one basic block: the reciprocal is rcp_rn (csrc/rcp.cuh, equal to
// 1.0f / det on (1e-9, 2^126)), and a group in which some |det| reaches
// 2^126 runs again with the division.  Each thread keeps a running min a
// ray, reduced by warp shuffles and then across the warps in shared
// memory: min is exact in any order and a masked test gives 1e30, never
// NaN, so the output is exact without atomics (a ray's columns never
// leave its CTA).  -fmad=false keeps every product and sum rounded as in
// the plain version, so the two agree bit for bit.
// P8 has two routes (ops/probes.py::subtile_copy_route).  Row sums first,
// from two copies a table tile (where the two tie): the function needs
// each tile's row sums once, R[k, l] = sum over r of src[k, r, l], so one
// cooperative launch sums every tile's rows once into R f32[C, 32] (8 lanes
// a tile, 16-byte loads), waits at a grid-wide barrier, and gathers
// 128-byte rows of R, summing the steps in order (8 lanes a copy): 8.4 MB
// and 4.2 MB from L2 where the copies were 67.1 MB.  Direct, with fewer
// copies: one CTA per block g of ch x 32 threads;
// each step j issues ch copies of 2 KB as 16-byte cp.async into one of two
// shared-memory slots, commits the group, and waits for the previous group
// (wait_group 1) while the next one flies; thread t sums lane t % 32 of
// tile t / 32 over its 16 rows in order and adds that to its running sum.
// Both do the plain version's additions in its order: bit-equal to it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "rcp.cuh"
#include "slab.cuh"
#include "tree.cuh"

namespace {

constexpr int kScalarThreads = 512;  // P6: one CTA
constexpr int kChunkRays = 2;        // P7 rays a thread (and a CTA)
constexpr int kChunkThreads = 512;   // P7 threads a CTA
constexpr int kTileRows = 16;        // P8 tile: 16 rows
constexpr int kTileLanes = 32;       //          x 32 lanes = 2 KB
constexpr int kTileFloats = kTileRows * kTileLanes;
constexpr int kTileChunks = kTileFloats / 4;  // 16-byte pieces of a tile
constexpr int kRowQuads = kTileLanes / 4;     // 16-byte pieces of a row
constexpr int kRowSumThreads = 256;  // P8 row-sum-first route
// P5's routes: ops/probes.py::GATHER_ROUTES.
constexpr int kRouteSlab = 0, kRouteDirect = 1;

using pbr::allow_smem;
using pbr::cp_async16;
using pbr::cp_async_commit;
using pbr::cp_async_wait;
using pbr::kRcpHi;
using pbr::kRcpLo;
using pbr::rcp_rn;

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
// Chunks j0 .. j0 + kGroup - 1 of one column (e0[m], e1[m]: its e at
// chunk j0 + m) against a thread's rays: g[r] = the least masked tt, 1e30
// where no test passes.  kExact divides; else the reciprocal is
// rcp_rn, and the return value says whether some |det| reached kRcpHi,
// where the caller runs the group again with kExact.  A test with
// |det| <= 1e-9 is masked whatever inv is: the plain version's inv = 0
// gives u = +-0 and tt = +-0 (or NaN), which fail tt > 0, so `nonzero` in
// ok stands for its select.  A chunk at or past n_chunks is masked.
template <bool kExact, int kGroup>
__device__ __forceinline__ bool chunk_group(const float (&rox)[kChunkRays],
                                            const float (&e0)[kGroup],
                                            const float (&e1)[kGroup], int j0,
                                            int n_chunks,
                                            float (&g)[kChunkRays]) {
  float amax = 0.0f;
#pragma unroll
  for (int r = 0; r < kChunkRays; ++r) g[r] = 1e30f;
#pragma unroll
  for (int m = 0; m < kGroup; ++m) {
    const bool live = j0 + m < n_chunks;
#pragma unroll
    for (int r = 0; r < kChunkRays; ++r) {
      const float px = rox[r] * e0[m];
      const float det = px * e1[m] + px;
      const float ad = fabsf(det);
      const bool nonzero = ad > kRcpLo;
      float inv;
      if (kExact) {
        inv = 1.0f / det;
      } else {
        amax = fmaxf(amax, ad);
        inv = rcp_rn(det);
      }
      const float uu = px * inv;
      const float vv = uu * inv + px;
      const float tt = vv * uu + uu;
      const bool ok = live && nonzero && uu >= 0.0f && vv >= 0.0f &&
                      uu + vv <= 1.0f && tt > 0.0f;
      g[r] = fminf(g[r], ok ? tt : 1e30f);
    }
  }
  return amax >= kRcpHi;
}

// A CTA owns kChunkRays rays; its threads split the (column, group of
// kGroup chunks) items, consecutive threads on consecutive columns.  The
// rays' minima: warp shuffles, then one warp over the warps' minima.
template <int kGroup>
__global__ void __launch_bounds__(kChunkThreads)
    mosaic_chunk_kernel(const float* __restrict__ o,
                        const float* __restrict__ t, int b, int w,
                        int n_chunks, float* __restrict__ out) {
  __shared__ float s_min[kChunkRays][kChunkThreads / 32];
  const int ray0 = blockIdx.x * kChunkRays;
  float rox[kChunkRays], best[kChunkRays];
#pragma unroll
  for (int r = 0; r < kChunkRays; ++r) {
    rox[r] = __ldg(o + min(ray0 + r, b - 1));  // row 0 of o
    best[r] = 1e30f;
  }
  const int items = w * ((n_chunks + kGroup - 1) / kGroup);
  // An item's column entries are loaded while the previous item's tests
  // run.
  float t0 = 0.0f, t1 = 0.0f;
  if (threadIdx.x < items) {
    const int c = threadIdx.x % w;
    t0 = __ldg(t + c);
    t1 = __ldg(t + w + c);
  }
  for (int q = threadIdx.x; q < items; q += kChunkThreads) {
    const int j0 = (q / w) * kGroup;
    float e0[kGroup], e1[kGroup];
#pragma unroll
    for (int m = 0; m < kGroup; ++m) {
      const float scale = float(j0 + m) + 1.0f;
      e0[m] = (t0 * scale) * 1.0001f;
      e1[m] = (t1 * scale) * 1.0001f;
    }
    if (q + kChunkThreads < items) {
      const int c = (q + kChunkThreads) % w;
      t0 = __ldg(t + c);
      t1 = __ldg(t + w + c);
    }
    float g[kChunkRays];
    if (chunk_group<false>(rox, e0, e1, j0, n_chunks, g))
      chunk_group<true>(rox, e0, e1, j0, n_chunks, g);
#pragma unroll
    for (int r = 0; r < kChunkRays; ++r) best[r] = fminf(best[r], g[r]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kChunkRays; ++r) {
    for (int off = 16; off > 0; off >>= 1)
      best[r] = fminf(best[r], __shfl_xor_sync(0xffffffffu, best[r], off));
    if (lane == 0) s_min[r][warp] = best[r];
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int r = 0; r < kChunkRays; ++r) {
    float m = lane < kChunkThreads / 32 ? s_min[r][lane] : 1e30f;
    for (int off = 16; off > 0; off >>= 1)
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0 && ray0 + r < b) out[ray0 + r] = m;
  }
}

// ---------------------------------------------------------------- P8
// The direct route: a CTA a block g, its copies streamed through two
// shared-memory slots.
__global__ void subtile_copy_kernel_direct(const float* __restrict__ src,
                                           const int* __restrict__ idx,
                                           int n_src, int n_iters, int ch,
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

// The row-sum-first route, pass 1: rows[k, 4q .. 4q + 3] = the sum over
// r in order of src[k, r, 4q .. 4q + 3], unit u = 8 k + q a thread (a
// warp: four tiles, each load four whole 128-byte rows), the 16 rows'
// loads issued before the first add.
__device__ __forceinline__ void tile_row_sums(const float4* __restrict__ src,
                                              int n_src,
                                              float4* __restrict__ rows) {
  const int stride = gridDim.x * blockDim.x;
  for (int u = blockIdx.x * blockDim.x + threadIdx.x; u < n_src * kRowQuads;
       u += stride) {
    const float4* s = src + size_t(u >> 3) * kTileChunks + (u & 7);
    float4 v[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) v[r] = __ldg(s + r * kRowQuads);
    float4 a = v[0];
#pragma unroll
    for (int r = 1; r < kTileRows; ++r) {
      a.x = a.x + v[r].x;
      a.y = a.y + v[r].y;
      a.z = a.z + v[r].z;
      a.w = a.w + v[r].w;
    }
    rows[u] = a;
  }
}

// Pass 2: out[g, 32 i + 4q .. 4q + 3] = the sum over j in order, from
// 0.0f, of rows[idx[g, j, i], 4q .. 4q + 3], unit u = 8 (g ch + i) + q a
// thread (a warp: four copies' 128-byte rows a step).  rows was written
// by other CTAs in this launch: it is read through L2 (ld.global.cg), not
// the read-only path.
__device__ __forceinline__ void gather_row_sums(
    const int* __restrict__ idx, const float4* rows, int n_src, int nb,
    int n_iters, int ch, float4* __restrict__ out) {
  const int stride = gridDim.x * blockDim.x;
  for (int u = blockIdx.x * blockDim.x + threadIdx.x; u < nb * ch * kRowQuads;
       u += stride) {
    const int gi = u >> 3;
    const int g = gi / ch;
    const int* my = idx + size_t(g) * n_iters * ch + (gi - g * ch);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
    for (int j = 0; j < n_iters; ++j) {
      const int k = min(max(__ldg(my + j * ch), 0), n_src - 1);
      const float4 v = __ldcg(rows + k * kRowQuads + (u & 7));
      acc.x = acc.x + v.x;
      acc.y = acc.y + v.y;
      acc.z = acc.z + v.z;
      acc.w = acc.w + v.w;
    }
    out[u] = acc;
  }
}

// Both passes in one cooperative launch, a grid-wide barrier between.
__global__ void __launch_bounds__(kRowSumThreads)
    subtile_copy_kernel_row_sums(const float* __restrict__ src,
                                 const int* __restrict__ idx, int n_src,
                                 int nb, int n_iters, int ch, float* rows,
                                 float* __restrict__ out) {
  tile_row_sums(reinterpret_cast<const float4*>(src), n_src,
                reinterpret_cast<float4*>(rows));
  cooperative_groups::this_grid().sync();
  gather_row_sums(idx, reinterpret_cast<const float4*>(rows), n_src, nb,
                  n_iters, ch, reinterpret_cast<float4*>(out));
}

// The every-copy read ceiling under the direct route (ports nothing): a
// CTA a block g reads its copies in the direct route's order, thread t
// the 16-byte piece t of each (row t / 8, lanes 4 (t % 8) ..), through L2
// and with no float arithmetic: out[g, l] = the XOR over steps, copies
// and rows of the bits of src[idx[g, j, i], r, l].
__global__ void __launch_bounds__(kTileChunks)
    subtile_read_kernel(const int4* __restrict__ src,
                        const int* __restrict__ idx, int n_src, int n_iters,
                        int ch, int* __restrict__ out) {
  __shared__ int4 s_x[kTileChunks];
  const int t = threadIdx.x;
  const int* my = idx + size_t(blockIdx.x) * n_iters * ch;
  int4 x = make_int4(0, 0, 0, 0);
#pragma unroll 8
  for (int c = 0; c < n_iters * ch; ++c) {
    const int k = min(max(__ldg(my + c), 0), n_src - 1);
    const int4 v = __ldcg(src + size_t(k) * kTileChunks + t);
    x.x ^= v.x;
    x.y ^= v.y;
    x.z ^= v.z;
    x.w ^= v.w;
  }
  for (int off = 8; off < 32; off <<= 1) {  // the warp's four rows
    x.x ^= __shfl_xor_sync(0xffffffffu, x.x, off);
    x.y ^= __shfl_xor_sync(0xffffffffu, x.y, off);
    x.z ^= __shfl_xor_sync(0xffffffffu, x.z, off);
    x.w ^= __shfl_xor_sync(0xffffffffu, x.w, off);
  }
  s_x[t] = x;
  __syncthreads();
  if (t < kRowQuads) {
    int4 a = s_x[t];
    for (int wq = 1; wq < kTileChunks / 32; ++wq) {
      const int4 b = s_x[32 * wq + t];
      a = make_int4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
    }
    reinterpret_cast<int4*>(out)[size_t(blockIdx.x) * kRowQuads + t] = a;
  }
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
// Groups of eight chunks where n_chunks is a multiple of eight (the
// tool's 8: one item a column), else of four.
extern "C" int pbr_mosaic_chunk(const float* o, const float* t, int b, int w,
                                int n_chunks, float* out, void* stream) {
  if (b <= 0) return 0;
  if (w < 0 || n_chunks < 0 || (long long)w * (n_chunks + 3) >= (1LL << 33))
    return int(cudaErrorInvalidValue);
  const unsigned blocks = unsigned((b + kChunkRays - 1) / kChunkRays);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks % 8 == 0)
    mosaic_chunk_kernel<8><<<blocks, kChunkThreads, 0, s>>>(o, t, b, w,
                                                            n_chunks, out);
  else
    mosaic_chunk_kernel<4><<<blocks, kChunkThreads, 0, s>>>(o, t, b, w,
                                                            n_chunks, out);
  return int(cudaGetLastError());
}

// src f32[n_src, 16, 32], idx i32[nb * n_iters * ch] -> out f32[nb, ch * 32]:
// out[g, 32 i + l] = sum over j of (sum over r of
// src[idx[g n_iters ch + j ch + i], r, l]), rows summed in order, steps in
// order from 0.0f; indices clamped into [0, n_src).  The direct route.
extern "C" int pbr_subtile_copy(const float* src, const int* idx, int n_src,
                                int nb, int n_iters, int ch, float* out,
                                void* stream) {
  if (nb <= 0) return 0;
  if (n_src <= 0 || n_iters <= 0 || ch <= 0 || ch * kTileLanes > 1024)
    return int(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * 2 * size_t(ch) * kTileFloats;
  const cudaError_t err = allow_smem(subtile_copy_kernel_direct, smem);
  if (err != cudaSuccess) return int(err);
  subtile_copy_kernel_direct<<<nb, ch * kTileLanes, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      src, idx, n_src, n_iters, ch, out);
  return int(cudaGetLastError());
}

// The same function by the row-sum-first route, rows f32[n_src, 32] the
// scratch of its row sums: one cooperative launch of at most the CTAs the
// card holds at once.
extern "C" int pbr_subtile_copy_row_sums(const float* src, const int* idx,
                                         int n_src, int nb, int n_iters,
                                         int ch, float* rows, float* out,
                                         void* stream) {
  if (nb <= 0) return 0;
  if (n_src <= 0 || n_iters <= 0 || ch <= 0 ||
      (long long)n_src * kRowQuads >= (1LL << 31) ||
      (long long)nb * ch * kRowQuads >= (1LL << 31))
    return int(cudaErrorInvalidValue);
  // CTAs the card holds at once, by device (queried once).
  static int resident[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= 64) return int(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, subtile_copy_kernel_row_sums, kRowSumThreads, 0);
    if (err != cudaSuccess) return int(err);
    resident[dev] = sms * per_sm;
  }
  const long long units =
      std::max<long long>((long long)n_src, (long long)nb * ch) * kRowQuads;
  const int blocks = int(std::min<long long>(
      resident[dev], (units + kRowSumThreads - 1) / kRowSumThreads));
  void* args[] = {&src, &idx, &n_src, &nb, &n_iters, &ch, &rows, &out};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(subtile_copy_kernel_row_sums), blocks,
      kRowSumThreads, args, 0, static_cast<cudaStream_t>(stream));
  return int(err != cudaSuccess ? err : cudaGetLastError());
}

// src f32[n_src, 16, 32] (16-byte aligned), idx i32[nb * n_iters * ch] ->
// out i32[nb, 32]: the every-copy read ceiling under the direct route.
extern "C" int pbr_subtile_read(const float* src, const int* idx, int n_src,
                                int nb, int n_iters, int ch, int* out,
                                void* stream) {
  if (nb <= 0) return 0;
  if (n_src <= 0 || n_iters <= 0 || ch <= 0)
    return int(cudaErrorInvalidValue);
  subtile_read_kernel<<<nb, kTileChunks, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(src), idx, n_src, n_iters, ch, out);
  return int(cudaGetLastError());
}
