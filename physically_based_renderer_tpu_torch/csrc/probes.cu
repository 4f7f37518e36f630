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
//   P2  the launch.  In row-major memory the tile and the column views have
//       the same flat order, so what P2 computes is elementwise:
//       out[f] = ((0 + (x[f] + 0)) + (x[f] + 1)) + ... + (x[f] + 9); 4 KB
//       in and out and 20 adds an element, far below an empty kernel.
//   P3  bytes: the product computes rows.T[win], so the work is one read
//       of win and of the rows and one write of the output (200,704 bytes
//       at the probe's shape, far below a launch); the product's N x R x L
//       multiply-adds are not needed.
//   P4  bytes: one index read, one gathered read, one write per element.
//       What costs is the gathered read: along axis 0 a warp's 32 lanes
//       read 32 random rows, a 32-byte sector for each useful 4 bytes.
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
// prefix sum of the counts (warp shuffles, two barriers) places them.  P2
// (route "elementwise"): a thread owns four consecutive flat elements, which
// are the same four in the tile and in the column view, so no value crosses
// a thread: one CTA of 256 threads, a float4 load, the ten adds in the
// plain version's order, a float4 store; no shared memory, no barrier.
// Route "exchange" keeps the first port's kernel, which prices a real
// cross-thread relayout of a tile on this card: one CTA of 1024 threads,
// "tile" ownership thread t <-> element (t % 8, t / 8) (eight sublanes by
// 128 lanes, as a TPU register holds it), "column" ownership thread t <->
// flat element t, every move through shared memory with a row pitch of 132
// words (no bank conflicts on either side) and two barriers a move.  P3:
// the product without the product.  out[i, c] =
// sum over lane of (lane == w) * rows[c, lane] is rows[c, w] + 0.0f (the
// sum starts from +0.0, so -0.0 comes out as +0.0), except that 0 * inf
// and 0 * NaN are NaN: out[i, c] is NaN where row c holds a non-finite
// entry at any lane but w, and for a w outside [0, L) (every lane's mask
// 0) it is NaN where row c holds one at all, else +0.0.  So a CTA counts
// the non-finite entries of its 8 attribute rows once (16-byte loads, a
// shared-memory atomic for each piece that holds one), gathers rows[c, w]
// directly, and writes out[i, c] for 128 output rows x those 8 columns:
// one 32-byte sector of each output row, a float4 a thread.  No CTA reads
// more of the rows than its own 8.  P4: two routes, and
// ops/probes.py::gather_plan picks one by P5's byte model.  The slab route
// is csrc/slab.cuh's (shared with P5) at one gather an output: a CTA
// stages the columns its outputs reach and gathers from shared memory.
// The direct route is a thread an output, x read through L1/L2.  At
// [16384, 128] no slab of 4 or more columns fits a CTA, and the direct
// route runs at the card's random-sector read ceiling (a 32-byte sector
// for each gathered value; `probe_sector_read_kernel` measures it):
// four consecutive outputs a thread (an int4 index load, four gathers in
// flight, a float4 store) gathers the same sectors in the same time and
// touches four times the lines a warp load at the small tables, and
// 2-column slabs stage a line for each 8-byte piece (tools/sweep.py,
// `p4_direct4`, `p4_slab2`).  Indices are clamped into range, so no input
// can read outside x, and a gathered value is copied as it is (-0.0
// stays -0.0).

#include <cuda_runtime.h>

#include "slab.cuh"
#include "tree.cuh"

namespace {

constexpr int kMaxNodes = pbr::kTreeMaxNodes;
constexpr int kStackThreads = 512;  // P1 threads (one CTA)
constexpr int kTileRows = 8;        // P2 tile: 8 sublanes
constexpr int kTileLanes = 128;     //          x 128 lanes
constexpr int kTileN = kTileRows * kTileLanes;
constexpr int kTilePitch = kTileLanes + 4;  // words per sublane row in shared
constexpr int kRelayoutMoves = 10;
constexpr int kRelayoutThreads = 256;  // P2 elementwise: a float4 a thread
constexpr int kOhCols = 8;          // P3 attribute rows a CTA
constexpr int kOhOuts = 128;        // P3 output rows a CTA, two threads a row
constexpr int kOhThreads = 2 * kOhOuts;
constexpr int kTakeThreads = 256;   // P4 direct route and sector reads

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

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

// x and out 16-byte aligned.
__global__ void __launch_bounds__(kRelayoutThreads)
    probe_relayout_kernel(const float4* __restrict__ x,
                          float4* __restrict__ out) {
  for (int q = threadIdx.x; q < kTileN / 4; q += kRelayoutThreads) {
    const float4 v = x[q];
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < kRelayoutMoves; ++i) {
      const float c = float(i);
      acc.x = acc.x + (v.x + c);
      acc.y = acc.y + (v.y + c);
      acc.z = acc.z + (v.z + c);
      acc.w = acc.w + (v.w + c);
    }
    out[q] = acc;
  }
}

__global__ void probe_relayout_exchange_kernel(const float* __restrict__ x,
                                               float* __restrict__ out) {
  __shared__ float buf[kTileRows * kTilePitch];
  const int t = threadIdx.x;
  // Tile ownership: thread t holds element (t % 8, t / 8).
  const int mine = (t % kTileRows) * kTileLanes + t / kTileRows;
  const float v = x[mine];
  float acc = 0.0f;
  for (int i = 0; i < kRelayoutMoves; ++i) {
    buf[tile_slot(mine)] = v + float(i);  // tile -> column: owner of flat t
    __syncthreads();                      // reads what the tile owner wrote
    acc = acc + buf[tile_slot(t)];
    __syncthreads();
  }
  buf[tile_slot(t)] = acc;                // column -> tile
  __syncthreads();
  out[mine] = buf[tile_slot(mine)];
}

// ---------------------------------------------------------------- P3
__device__ __forceinline__ int non_finite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;
}

// CTA (bx, by) writes out[i, c] for c in [bx kOhCols, bx kOhCols + kOhCols)
// and i in [by kOhOuts, by kOhOuts + kOhOuts); thread t the four columns
// 4 (t % 2) + [0, 4) of the group at output row t / 2.  vec_rows: L % 4 ==
// 0 and rows 16-byte aligned; vec_out: R % 4 == 0 and out 16-byte aligned.
__global__ void __launch_bounds__(kOhThreads)
    probe_onehot_mm_kernel(const int* __restrict__ win,
                           const float* __restrict__ rows, int n, int r,
                           int l, int vec_rows, int vec_out,
                           float* __restrict__ out) {
  __shared__ int s_bad[kOhCols];  // non-finite entries of each row
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kOhCols, nc = min(kOhCols, r - c0);
  const int i = blockIdx.y * kOhOuts + tid / 2;
  const int cq = (tid & 1) * 4;
  const float* grp = rows + size_t(c0) * l;
  if (tid < kOhCols) s_bad[tid] = 0;
  const int w = i < n ? __ldg(win + i) : -1;
  __syncthreads();
  if (vec_rows) {
    const int q = l >> 2;
    const float4* g4 = reinterpret_cast<const float4*>(grp);
    for (int p = tid; p < nc * q; p += kOhThreads) {
      const float4 v = __ldg(g4 + p);
      const int bad = non_finite(v.x) + non_finite(v.y) + non_finite(v.z) +
                      non_finite(v.w);
      if (bad) atomicAdd(&s_bad[p / q], bad);
    }
  } else {
    for (int p = tid; p < nc * l; p += kOhThreads)
      if (non_finite(__ldg(grp + p))) atomicAdd(&s_bad[p / l], 1);
  }
  const bool in = unsigned(w) < unsigned(l);
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = in && cq + k < nc ? __ldg(grp + size_t(cq + k) * l + w) : 0.0f;
  __syncthreads();
  if (i >= n || cq >= nc) return;
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // non-finite entries of row cq + k at lanes other than w
    const int others = s_bad[cq + k] - (in ? non_finite(v[k]) : 0);
    o[k] = others > 0 ? __int_as_float(0x7fffffff) : v[k] + 0.0f;
  }
  float* dst = out + size_t(i) * r + c0 + cq;
  if (vec_out) {
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
    for (int k = 0; k < 4 && cq + k < nc; ++k) dst[k] = o[k];
  }
}

// ---------------------------------------------------------------- P4
// The direct route: a thread an output, the lanes of a warp on consecutive
// outputs (so the columns a warp gathers from a row share its lines), x
// read through L1/L2.
template <int kAxis>
__global__ void __launch_bounds__(kTakeThreads)
    probe_gather_kernel_direct(const float* __restrict__ x,
                               const int* __restrict__ idx, int rows,
                               int lanes, float* __restrict__ out) {
  const unsigned total = unsigned(rows) * unsigned(lanes);
  const unsigned e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const unsigned row = e / unsigned(lanes);
  const unsigned col = e - row * unsigned(lanes);
  const int hi = (kAxis == 0 ? rows : lanes) - 1;
  const unsigned k = unsigned(min(max(__ldg(idx + e), 0), hi));
  out[e] = __ldg(x + (kAxis == 0 ? k * unsigned(lanes) + col
                                 : row * unsigned(lanes) + k));
}

// The slab route: csrc/slab.cuh's body, one gather an output, the index
// clamped.
template <int kAxis>
__global__ void __launch_bounds__(1024)
    probe_gather_kernel_slab(const float* __restrict__ x,
                             const int* __restrict__ idx, int rows,
                             int lanes, int tile, int per, int piece,
                             float* __restrict__ out) {
  pbr::slab_gather<kAxis, true>(x, idx, rows, lanes, 1, tile, per, piece,
                                out);
}

// The card's random-sector read ceiling (no port of a TPU kernel): out[t]
// = ((table[a0] + table[a1]) + table[a2]) + table[a3], (a0..a3) = addr[4 t
// .. 4 t + 3], the addresses read as one int4 and used as they are.
__global__ void __launch_bounds__(kTakeThreads)
    probe_sector_read_kernel(const float* __restrict__ table,
                             const int* __restrict__ addr, int n4,
                             float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n4) return;
  const int4 a = __ldg(reinterpret_cast<const int4*>(addr) + t);
  const float v0 = __ldg(table + a.x), v1 = __ldg(table + a.y);
  const float v2 = __ldg(table + a.z), v3 = __ldg(table + a.w);
  out[t] = ((v0 + v1) + v2) + v3;
}

// The widest cp.async piece, in floats (4, 2 or 1), that every staged row
// of a slab of x allows: its width (tile columns along axis 0, a whole row
// along axis 1), the row pitch and x's alignment.
int slab_piece(const float* x, int lanes, int axis, int tile) {
  const int w = axis == 0 ? tile : lanes;
  const size_t at = reinterpret_cast<size_t>(x);
  for (int p = 4; p > 1; p /= 2)
    if (w % p == 0 && lanes % p == 0 && at % (4 * p) == 0) return p;
  return 1;
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

// x f32[8, 128] -> out f32[8, 128] = sum over i < 10 of (x + i): element by
// element (exchange == 0; x and out 16-byte aligned), or each term moved
// tile -> column across threads and the sum moved back (exchange != 0).
extern "C" int pbr_probe_relayout(const float* x, float* out, int exchange,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (exchange) {
    probe_relayout_exchange_kernel<<<1, kTileN, 0, s>>>(x, out);
  } else {
    if (!aligned16(x) || !aligned16(out)) return int(cudaErrorInvalidValue);
    probe_relayout_kernel<<<1, kRelayoutThreads, 0, s>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out));
  }
  return int(cudaGetLastError());
}

// win i32[n], rows f32[r, l] -> out f32[n, r],
// out[i, c] = sum over lane of (lane == win[i]) * rows[c, lane].
extern "C" int pbr_probe_onehot_mm(const int* win, const float* rows, int n,
                                   int r, int l, float* out, void* stream) {
  if (n <= 0 || r <= 0) return 0;
  const dim3 grid((r + kOhCols - 1) / kOhCols, (n + kOhOuts - 1) / kOhOuts);
  if (l < 1 || grid.y > 65535) return int(cudaErrorInvalidValue);
  probe_onehot_mm_kernel<<<grid, kOhThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      win, rows, n, r, l, l % 4 == 0 && aligned16(rows),
      r % 4 == 0 && aligned16(out), out);
  return int(cudaGetLastError());
}

// x f32[rows, lanes], idx i32[rows, lanes] -> out f32[rows, lanes]:
// out[r, c] = x[idx[r, c], c] (axis 0) or x[r, idx[r, c]] (axis 1), the
// index clamped into range; the direct route.
extern "C" int pbr_probe_gather(const float* x, const int* idx, int rows,
                                int lanes, int axis, float* out,
                                void* stream) {
  const long long total = (long long)rows * lanes;
  if (total <= 0) return 0;
  if (total >= (1LL << 31) || (axis != 0 && axis != 1))
    return int(cudaErrorInvalidValue);
  const unsigned blocks = unsigned((total + kTakeThreads - 1) /
                                   kTakeThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (axis == 0)
    probe_gather_kernel_direct<0><<<blocks, kTakeThreads, 0, s>>>(
        x, idx, rows, lanes, out);
  else
    probe_gather_kernel_direct<1><<<blocks, kTakeThreads, 0, s>>>(
        x, idx, rows, lanes, out);
  return int(cudaGetLastError());
}

// The same function by the slab route, with a plan of
// ops/probes.py::gather_plan: tile (C columns for axis 0, a power of two in
// [2, 32]; rows for axis 1), per (output rows a CTA for axis 0, columns
// for axis 1) and threads a CTA (a multiple of 32 up to 1024).
extern "C" int pbr_probe_gather_slab(const float* x, const int* idx,
                                     int rows, int lanes, int axis, int tile,
                                     int per, int threads, float* out,
                                     void* stream) {
  const long long total = (long long)rows * lanes;
  if (total <= 0) return 0;
  if (total >= (1LL << 31) || (axis != 0 && axis != 1) || threads < 32 ||
      threads > 1024 || threads % 32)
    return int(cudaErrorInvalidValue);
  dim3 grid;
  size_t smem;
  cudaError_t err = pbr::slab_shape(rows, lanes, axis, tile, per, &grid,
                                    &smem);
  if (err != cudaSuccess) return int(err);
  const int piece = slab_piece(x, lanes, axis, tile);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (axis == 0)
    err = pbr::launch_slab(probe_gather_kernel_slab<0>, grid, threads, smem,
                           s, x, idx, rows, lanes, tile, per, piece, out);
  else
    err = pbr::launch_slab(probe_gather_kernel_slab<1>, grid, threads, smem,
                           s, x, idx, rows, lanes, tile, per, piece, out);
  return int(err);
}

// table f32[...], addr i32[n] (n % 4 == 0, 16-byte aligned, every entry an
// index into table) -> out f32[n / 4]: the random-sector read ceiling.
extern "C" int pbr_probe_sector_read(const float* table, const int* addr,
                                     int n, float* out, void* stream) {
  if (n <= 0) return 0;
  if (n % 4 || !aligned16(addr)) return int(cudaErrorInvalidValue);
  const int n4 = n / 4;
  probe_sector_read_kernel<<<(n4 + kTakeThreads - 1) / kTakeThreads,
                             kTakeThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      table, addr, n4, out);
  return int(cudaGetLastError());
}
