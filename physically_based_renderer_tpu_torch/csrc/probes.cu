// Four primitive probes (P1-P4): what a scalar tree walk, a register
// relayout, a gather done as a one-hot product and a direct gather cost on
// an H100.
//
// Replaces: the reference repository's tools/probe2.py kernels
//   P1  scalar_stack :36   a scalar walk of an implicit binary tree of boxes
//   P2  relayout     :103  an [8,128] tile moved to a [1024,1] column 10 times
//   P3  onehot_mm    :133  winner-attribute rows taken by a one-hot product
//   P4  _gather      :166  take_along_axis(x, idx, axis)
// Each asked whether a primitive was cheap enough on the TPU to build a
// whole-frame kernel from.  The same questions are asked of this card; none
// of the kernels is carried over block by block.
//
// What bounds them on the H100:
//   P1  latency.  The TPU kernel walks with a stack, one dependent pop after
//       another; what it computes needs no chain: a node is visited when all
//       its ancestors pass, a leaf is found when it is visited and passes,
//       and the walk pops the leaves in an order fixed by the tree's shape.
//       So the bound is the tree's depth in shared-memory round trips (13
//       levels at most), and at these sizes the launch itself.
//   P2  latency of 11 shared-memory exchanges with a block barrier each; the
//       data is 4 KB.
//   P3  operations: N x R x L multiply-adds on the CUDA cores (33.5M single
//       operations at the probe's shape), against 4 KB + 64 KB of input.
//   P4  bytes: one index read, one gathered read, one write per element.
//
// Design.  P1: one CTA of 512 threads, no serial walk; its first two
// stages are csrc/tree.cuh's, shared with P6.  A thread takes
// two nodes at a time (48 bytes: three 16-byte loads where the boxes are
// 16-byte aligned) and writes their pass bits (max(lo) <= min(hi)) to shared
// memory; then, a level at a time with a barrier a level, each node's flag
// becomes "passes and its parent's flag is set" (open: the walk pushes its
// children, or finds it as a leaf), and a node whose parent's flag is set
// (or the root) counts as visited; a block reduction sums the counts.  The
// LIFO walk (push left, left + 1; pop the top) goes right child first, so
// it pops the leaves from right to left: with D = floor(log2 n), the leaves
// above the last level (index < 2^D - 1) first, highest index first, then
// the last level's, highest index first (tests/test_torch_probes.py holds
// this order against the walk).  The open leaves are compacted in that
// order: a thread counts a run of consecutive leaf slots, and one block
// prefix sum of the counts (warp shuffles, two barriers) places them.  P2: one
// CTA of 1024 threads; "tile" ownership is thread t <-> element (t % 8,
// t / 8) (eight sublanes by 128 lanes, as a TPU register holds it), "column"
// ownership thread t <-> flat element t; every move goes through shared
// memory with a row pitch of 132 words so that neither side has bank
// conflicts.  A second instantiation without the exchange gives the time
// of everything else.  P3: a CTA of 32 x 32 threads computes 32 output rows;
// `rows` is staged once per CTA with a pitch of L + 1 words, the mask is
// built in registers, and with -fmad=false the sum of one value and L - 1
// zeros is exact.  P4: one thread per output element, coalesced over the
// last axis; indices are clamped into range, so no input can read outside x.

#include <cuda_runtime.h>

#include "tree.cuh"

namespace {

constexpr int kMaxNodes = pbr::kTreeMaxNodes;
constexpr int kStackThreads = 512;  // P1 threads (one CTA)
constexpr int kTileRows = 8;        // P2 tile: 8 sublanes
constexpr int kTileLanes = 128;     //          x 128 lanes
constexpr int kTileN = kTileRows * kTileLanes;
constexpr int kTilePitch = kTileLanes + 4;  // words per sublane row in shared
constexpr int kRelayoutMoves = 10;
constexpr int kMmRows = 32;         // P3 outputs rows per CTA (threadIdx.y)
constexpr int kMmCols = 32;         // P3 attribute rows per CTA (threadIdx.x)
constexpr int kGatherThreads = 256;
constexpr size_t kMaxSmem = 227 * 1024;

// ---------------------------------------------------------------- P1
__global__ void __launch_bounds__(kStackThreads)
    probe_scalar_stack_kernel(const float* __restrict__ boxes, int n_nodes,
                              int cap, int* __restrict__ out,
                              int* __restrict__ cand_out) {
  __shared__ unsigned char s_open[kMaxNodes];
  __shared__ int s_warp[kStackThreads / 32];
  __shared__ int s_visited;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;

  // The open flags of every node and the count of the visited ones
  // (csrc/tree.cuh).
  pbr::tree_pass_bits(boxes, n_nodes, s_open);
  if (tid == 0) s_visited = 0;
  __syncthreads();
  pbr::block_add(pbr::tree_levels(n_nodes, s_open), &s_visited);

  // The open leaves in pop order.  Slot j < upper holds leaf f - 1 - j (the
  // leaves above the last level, descending), slot j >= upper leaf
  // n - 1 - (j - upper) (the last level, descending).  A thread takes a run
  // of consecutive slots; one block scan of the runs' counts places them.
  const int f = (1 << (31 - __clz(n_nodes))) - 1;  // first node of level D
  const int upper = f - (n_nodes - 1) / 2;
  auto leaf_at = [&](int j) {
    return j < upper ? f - 1 - j : n_nodes - 1 - (j - upper);
  };
  const int per = (cap + nt - 1) / nt;
  const int j0 = min(tid * per, cap), j1 = min(j0 + per, cap);
  int mine = 0;
  for (int j = j0; j < j1; ++j) mine += s_open[leaf_at(j)];
  int incl = mine;                      // inclusive scan within the warp
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {                      // ... and across the warps
    int w = lane < nt / 32 ? s_warp[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += v;
    }
    if (lane < nt / 32) s_warp[lane] = w;
  }
  __syncthreads();
  const int total = s_warp[nt / 32 - 1];
  int pos = (warp ? s_warp[warp - 1] : 0) + incl - mine;
  for (int j = j0; j < j1; ++j) {
    const int leaf = leaf_at(j);
    if (s_open[leaf]) cand_out[pos++] = leaf;
  }
  for (int i = total + tid; i < cap; i += nt) cand_out[i] = -1;
  if (tid == 0) {
    out[0] = s_visited;
    out[1] = total;
  }
}

// The launch floor: a kernel of one warp that does nothing.
__global__ void probe_empty_kernel() {}

// ---------------------------------------------------------------- P2
__device__ __forceinline__ int tile_slot(int flat) {
  // flat = sublane * 128 + lane -> padded shared-memory word
  return (flat / kTileLanes) * kTilePitch + (flat % kTileLanes);
}

template <bool kExchange>
__global__ void probe_relayout_kernel(const float* __restrict__ x,
                                      float* __restrict__ out) {
  __shared__ float buf[kTileRows * kTilePitch];
  const int t = threadIdx.x;
  // Tile ownership: thread t holds element (t % 8, t / 8).
  const int mine = (t % kTileRows) * kTileLanes + t / kTileRows;
  const float v = x[mine];
  float acc = 0.0f;
  for (int i = 0; i < kRelayoutMoves; ++i) {
    const float w = v + float(i);
    if (kExchange) {
      buf[tile_slot(mine)] = w;           // tile -> column: owner of flat t
      __syncthreads();                    // reads what the tile owner wrote
      acc = acc + buf[tile_slot(t)];
      __syncthreads();
    } else {
      acc = acc + w;
    }
  }
  if (kExchange) {
    buf[tile_slot(t)] = acc;              // column -> tile
    __syncthreads();
    acc = buf[tile_slot(mine)];
  }
  out[mine] = acc;
}

// ---------------------------------------------------------------- P3
__global__ void probe_onehot_mm_kernel(const int* __restrict__ win,
                                       const float* __restrict__ rows, int n,
                                       int r, int l, float* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  float* rs = reinterpret_cast<float*>(smem);
  const int pitch = l + 1;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int e = tid; e < r * l; e += blockDim.x * blockDim.y)
    rs[(e / l) * pitch + (e % l)] = rows[e];
  __syncthreads();
  const int i = blockIdx.x * kMmRows + threadIdx.y;
  const int c = threadIdx.x;
  if (i >= n || c >= r) return;
  const int w = win[i];
  const float* row = rs + c * pitch;
  float acc = 0.0f;
  for (int lane = 0; lane < l; ++lane) {
    const float mask = (lane == w) ? 1.0f : 0.0f;
    acc = acc + mask * row[lane];
  }
  out[i * r + c] = acc;
}

// ---------------------------------------------------------------- P4
template <int kAxis>
__global__ void probe_gather_kernel(const float* __restrict__ x,
                                    const int* __restrict__ idx, int rows,
                                    int lanes, float* __restrict__ out) {
  const unsigned total = unsigned(rows) * unsigned(lanes);
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const unsigned row = e / unsigned(lanes);
    const unsigned col = e - row * unsigned(lanes);
    const int hi = (kAxis == 0 ? rows : lanes) - 1;
    const int k = min(max(__ldg(idx + e), 0), hi);
    out[e] = kAxis == 0 ? __ldg(x + unsigned(k) * unsigned(lanes) + col)
                        : __ldg(x + row * unsigned(lanes) + unsigned(k));
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

}  // namespace

// boxes f32[n_nodes * 6] (lo xyz | hi xyz per node; n_nodes odd, at most
// kMaxNodes) -> out i32[2] (visited, leaves), cand_out i32[cap] (the leaves
// in the walk's pop order, then -1).
extern "C" int pbr_probe_scalar_stack(const float* boxes, int n_nodes, int cap,
                                      int* out, int* cand_out, void* stream) {
  if (n_nodes < 1 || n_nodes > kMaxNodes || n_nodes % 2 == 0 ||
      cap != (n_nodes + 1) / 2)
    return int(cudaErrorInvalidValue);
  probe_scalar_stack_kernel<<<1, kStackThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      boxes, n_nodes, cap, out, cand_out);
  return int(cudaGetLastError());
}

// A launch of a kernel that does nothing: the floor under every small
// kernel's device time.
extern "C" int pbr_probe_empty(void* stream) {
  probe_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return int(cudaGetLastError());
}

// x f32[8, 128] -> out f32[8, 128] = sum over i < 10 of (x + i), moved tile
// -> column ten times and back once (exchange != 0) or kept in registers.
extern "C" int pbr_probe_relayout(const float* x, float* out, int exchange,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (exchange)
    probe_relayout_kernel<true><<<1, kTileN, 0, s>>>(x, out);
  else
    probe_relayout_kernel<false><<<1, kTileN, 0, s>>>(x, out);
  return int(cudaGetLastError());
}

// win i32[n], rows f32[r, l] (r <= 32) -> out f32[n, r],
// out[i, c] = sum over lane of (lane == win[i]) * rows[c, lane].
extern "C" int pbr_probe_onehot_mm(const int* win, const float* rows, int n,
                                   int r, int l, float* out, void* stream) {
  if (n <= 0 || r <= 0) return 0;
  if (r > kMmCols) return int(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * size_t(r) * size_t(l + 1);
  const cudaError_t err = allow_smem(probe_onehot_mm_kernel, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 block(kMmCols, kMmRows);
  probe_onehot_mm_kernel<<<(n + kMmRows - 1) / kMmRows, block, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      win, rows, n, r, l, out);
  return int(cudaGetLastError());
}

// x f32[rows, lanes], idx i32[rows, lanes] -> out f32[rows, lanes]:
// out[r, c] = x[idx[r, c], c] (axis 0) or x[r, idx[r, c]] (axis 1).
extern "C" int pbr_probe_gather(const float* x, const int* idx, int rows,
                                int lanes, int axis, float* out,
                                void* stream) {
  const long long total = (long long)rows * lanes;
  if (total <= 0) return 0;
  if (total >= (1LL << 31) || (axis != 0 && axis != 1))
    return int(cudaErrorInvalidValue);
  const unsigned blocks = unsigned((total + kGatherThreads - 1) /
                                   kGatherThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (axis == 0)
    probe_gather_kernel<0><<<blocks, kGatherThreads, 0, s>>>(x, idx, rows,
                                                             lanes, out);
  else
    probe_gather_kernel<1><<<blocks, kGatherThreads, 0, s>>>(x, idx, rows,
                                                             lanes, out);
  return int(cudaGetLastError());
}
