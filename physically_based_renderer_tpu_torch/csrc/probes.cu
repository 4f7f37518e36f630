// Four primitive probes (P1-P4): what a scalar tree walk, a register
// relayout, a gather done as a one-hot product and a direct gather cost on
// an H100.
//
// Replaces: the reference repository's tools/probe2.py kernels
//   P1  scalar_stack :36   one scalar walk of an implicit binary tree of boxes
//   P2  relayout     :103  an [8,128] tile moved to a [1024,1] column 10 times
//   P3  onehot_mm    :133  winner-attribute rows taken by a one-hot product
//   P4  _gather      :166  take_along_axis(x, idx, axis)
// Each asked whether a primitive was cheap enough on the TPU to build a
// whole-frame kernel from.  The same questions are asked of this card; none
// of the kernels is carried over block by block.
//
// What bounds them on the H100:
//   P1  latency: every step depends on the pop before it (shared-memory load
//       of the stack top, then of the node's six floats), so one lane runs
//       at visited nodes x one shared-memory round trip; no other thread can
//       help.  The boxes (2047 x 6 floats = 49,128 B, just above the 48 KB a
//       kernel gets without the opt-in) sit in dynamic shared memory beside
//       the stack and the leaf list.
//   P2  latency of 11 shared-memory exchanges with a block barrier each; the
//       data is 4 KB.
//   P3  operations: N x R x L multiply-adds on the CUDA cores (33.5M single
//       operations at the probe's shape), against 4 KB + 64 KB of input.
//   P4  bytes: one index read, one gathered read, one write per element.
//
// Design.  P1: one CTA; its threads stage the boxes, then thread 0 alone
// walks with the same LIFO order as the TPU kernel (push left, left + 1; pop
// the top), so visited, leaves and the leaf list are equal to it.  P2: one
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

namespace {

constexpr int kStack = 64;          // P1 stack entries (depth + 1 suffices)
constexpr int kWalkThreads = 256;   // P1 staging threads
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
__global__ void probe_scalar_stack_kernel(const float* __restrict__ boxes,
                                          int n_nodes, int cap,
                                          int* __restrict__ out,
                                          int* __restrict__ cand_out) {
  extern __shared__ unsigned char smem[];
  float* sb = reinterpret_cast<float*>(smem);
  int* stack = reinterpret_cast<int*>(sb + size_t(n_nodes) * 6);
  int* cand = stack + kStack;
  __shared__ int n_cand;
  for (int i = threadIdx.x; i < n_nodes * 6; i += blockDim.x) sb[i] = boxes[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    int sp = 1, nc = 0, visited = 0;
    stack[0] = 0;
    while (sp > 0) {
      const int node = stack[--sp];
      const float* b = sb + node * 6;
      const float t_near = fmaxf(fmaxf(b[0], b[1]), b[2]);
      const float t_far = fminf(fminf(b[3], b[4]), b[5]);
      const bool hit = t_near <= t_far;
      const int left = 2 * node + 1;
      if (hit) {
        if (left < n_nodes) {
          stack[sp] = left;
          stack[sp + 1] = left + 1;
          sp += 2;
        } else {
          cand[nc++] = node;
        }
      }
      ++visited;
    }
    out[0] = visited;
    out[1] = nc;
    n_cand = nc;
  }
  __syncthreads();
  const int nc = n_cand;
  for (int i = threadIdx.x; i < cap; i += blockDim.x)
    cand_out[i] = i < nc ? cand[i] : -1;
}

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

// boxes f32[n_nodes * 6] (lo xyz | hi xyz per node) -> out i32[2] (visited,
// leaves), cand_out i32[cap] (the leaves in visiting order, then -1).
extern "C" int pbr_probe_scalar_stack(const float* boxes, int n_nodes, int cap,
                                      int* out, int* cand_out, void* stream) {
  const size_t smem = sizeof(float) * 6 * size_t(n_nodes) +
                      sizeof(int) * (size_t(kStack) + size_t(cap));
  const cudaError_t err = allow_smem(probe_scalar_stack_kernel, smem);
  if (err != cudaSuccess) return int(err);
  probe_scalar_stack_kernel<<<1, kWalkThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      boxes, n_nodes, cap, out, cand_out);
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
