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
//   P5  bytes (table, indices, output once each); the tables are small, so
//       at most shapes the launch.  Where the table fits in shared memory
//       (up to 227 KB: [8, 4096] is 128 KB and takes the opt-in) every CTA
//       stages all of it and its threads gather from there; larger tables
//       ([256, 512] and up, 512 KB to 2 MB) are read through L1/L2.
//   P6  latency: every step depends on the pop before it (a shared-memory
//       load of the stack top, then of the node's six floats); one lane.
//   P7  operations: ten float adds, multiplies and a division per test.
//   P8  bytes: each 2 KB tile read from device memory (8.4 MB of distinct
//       tiles, 67.1 MB counting every copy; all of it fits in the 50 MB L2
//       only as distinct tiles).
//
// Design.  P5: one thread per output element loops over the reps; the index
// is reduced into range once (floor modulo, as jnp's %) and stepped by one
// each rep, wrapping at the axis' size.  With arange data every partial sum
// is an integer below 2^24, so the kernel is exact in any order.  P6: P1 of
// csrc/probes.cu without the leaf list, with its own entry point: 256 threads
// stage the boxes, thread 0 walks with the TPU kernel's LIFO order (push
// left, left + 1; pop the top).  P7: one CTA per ray, its threads over the
// columns; each keeps a running min and the CTA reduces it by warp shuffles
// (min is exact in any order; the masked value is never NaN).  1/det is an
// IEEE division (no fast math) and -fmad=false keeps every product and sum
// rounded as in the plain version, so the two agree bit for bit.  P8: one CTA
// per block g of ch x 32 threads; each step j issues ch copies of 2 KB as
// 16-byte cp.async into one of two shared-memory slots, commits the group,
// and waits for the previous group (wait_group 1) while the next one flies;
// thread t sums lane t % 32 of tile t / 32 over its 16 rows in order and adds
// that to its running sum.

#include <cuda_runtime.h>

namespace {

constexpr int kStack = 64;           // P6 stack entries (depth + 1 suffices)
constexpr int kWalkThreads = 256;    // P6 staging threads
constexpr int kStagedThreads = 1024;  // P5 with the table in shared memory
constexpr int kDirectThreads = 256;   // P5 reading the table through L1/L2
constexpr int kChunkThreads = 128;   // P7 threads per ray
constexpr int kTileRows = 16;        // P8 tile: 16 rows
constexpr int kTileLanes = 32;       //          x 32 lanes = 2 KB
constexpr int kTileFloats = kTileRows * kTileLanes;
constexpr int kTileChunks = kTileFloats / 4;  // 16-byte pieces of a tile
constexpr size_t kMaxSmem = 227 * 1024;

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

// ---------------------------------------------------------------- P5
template <int kAxis, bool kStaged>
__global__ void mosaic_gather_kernel(const float* __restrict__ x,
                                     const int* __restrict__ idx, int rows,
                                     int lanes, int reps,
                                     float* __restrict__ out) {
  extern __shared__ float4 staged4[];
  const float* staged = reinterpret_cast<const float*>(staged4);
  const unsigned total = unsigned(rows) * unsigned(lanes);
  if (kStaged) {
    float4* dst = staged4;
    const float4* src = reinterpret_cast<const float4*>(x);
    for (unsigned q = threadIdx.x; q < total / 4; q += blockDim.x)
      dst[q] = __ldg(src + q);
    float* dst1 = reinterpret_cast<float*>(staged4);
    for (unsigned e = total / 4 * 4 + threadIdx.x; e < total; e += blockDim.x)
      dst1[e] = __ldg(x + e);
    __syncthreads();
  }
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
    acc = acc + (kStaged ? staged[at] : __ldg(x + at));
    if (++k == size) k = 0;
  }
  out[e] = acc;
}

// ---------------------------------------------------------------- P6
__global__ void mosaic_scalar_stack_kernel(const float* __restrict__ boxes,
                                           int n_nodes,
                                           int* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  float* sb = reinterpret_cast<float*>(smem);
  int* stack = reinterpret_cast<int*>(sb + size_t(n_nodes) * 6);
  for (int i = threadIdx.x; i < n_nodes * 6; i += blockDim.x) sb[i] = boxes[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  int sp = 1, visited = 0;
  stack[0] = 0;
  while (sp > 0) {
    const int node = stack[--sp];
    const float* b = sb + node * 6;
    const float t_near = fmaxf(fmaxf(b[0], b[1]), b[2]);
    const float t_far = fminf(fminf(b[3], b[4]), b[5]);
    const int left = 2 * node + 1;
    if (t_near <= t_far && left < n_nodes) {
      stack[sp] = left;
      stack[sp + 1] = left + 1;
      sp += 2;
    }
    ++visited;
  }
  out[0] = visited;
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
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = unsigned(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

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
// x[r, (idx[r, c] + i) mod lanes] (axis 1), the modulo a floor modulo.
extern "C" int pbr_mosaic_gather(const float* x, const int* idx, int rows,
                                 int lanes, int axis, int reps, float* out,
                                 void* stream) {
  const long long total = (long long)rows * lanes;
  if (total <= 0) return 0;
  if (total >= (1LL << 31) || (axis != 0 && axis != 1) || reps < 0)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * size_t(total);
  if (smem <= kMaxSmem) {
    const unsigned blocks = unsigned((total + kStagedThreads - 1) /
                                     kStagedThreads);
    cudaError_t err;
    if (axis == 0) {
      err = allow_smem(mosaic_gather_kernel<0, true>, smem);
      if (err != cudaSuccess) return int(err);
      mosaic_gather_kernel<0, true><<<blocks, kStagedThreads, smem, s>>>(
          x, idx, rows, lanes, reps, out);
    } else {
      err = allow_smem(mosaic_gather_kernel<1, true>, smem);
      if (err != cudaSuccess) return int(err);
      mosaic_gather_kernel<1, true><<<blocks, kStagedThreads, smem, s>>>(
          x, idx, rows, lanes, reps, out);
    }
  } else {
    const unsigned blocks = unsigned((total + kDirectThreads - 1) /
                                     kDirectThreads);
    if (axis == 0)
      mosaic_gather_kernel<0, false><<<blocks, kDirectThreads, 0, s>>>(
          x, idx, rows, lanes, reps, out);
    else
      mosaic_gather_kernel<1, false><<<blocks, kDirectThreads, 0, s>>>(
          x, idx, rows, lanes, reps, out);
  }
  return int(cudaGetLastError());
}

// boxes f32[n_nodes * 6] (lo xyz | hi xyz per node) -> out i32[1]: the
// nodes the walk visits.
extern "C" int pbr_mosaic_scalar_stack(const float* boxes, int n_nodes,
                                       int* out, void* stream) {
  const size_t smem = sizeof(float) * 6 * size_t(n_nodes) +
                      sizeof(int) * size_t(kStack);
  const cudaError_t err = allow_smem(mosaic_scalar_stack_kernel, smem);
  if (err != cudaSuccess) return int(err);
  mosaic_scalar_stack_kernel<<<1, kWalkThreads, smem,
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
