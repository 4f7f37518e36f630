// The level-parallel search of an implicit binary tree of boxes (children
// 2i + 1 and 2i + 2), shared by P1 (probes.cu, with its leaf list) and P6
// (mosaic.cu, the count alone).
//
// A LIFO walk from the root pops a node, tests its box (max(lo) <= min(hi)
// in float32) and, where it passes, pushes its children.  What the walk
// finds needs no chain: a node is "open" when it and all its ancestors
// pass, and a node is visited when its parent is open.  So a block writes
// every node's pass bit at once, then fixes the open flags a level at a
// time with a barrier a level: the bound is the tree's depth in
// shared-memory round trips, not its size.

#pragma once

namespace pbr {

constexpr int kTreeMaxNodes = 8191;  // ops/probes.py::MAX_NODES

__device__ __forceinline__ unsigned char box_passes(float l0, float l1,
                                                    float l2, float h0,
                                                    float h1, float h2) {
  return fmaxf(fmaxf(l0, l1), l2) <= fminf(fminf(h0, h1), h2);
}

// s_open[i] = node i's pass bit for i < m, two nodes (twelve floats) a
// thread at a time, with 16-byte loads where the boxes are 16-byte
// aligned; node m - 1 alone where m is odd.  No barrier.
__device__ __forceinline__ void tree_pass_bits(const float* __restrict__ boxes,
                                               int m,
                                               unsigned char* s_open) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if ((reinterpret_cast<size_t>(boxes) & 15) == 0) {
    const float4* q = reinterpret_cast<const float4*>(boxes);
    for (int p = tid; p < m / 2; p += nt) {
      const float4 x = q[3 * p], y = q[3 * p + 1], z = q[3 * p + 2];
      s_open[2 * p] = box_passes(x.x, x.y, x.z, x.w, y.x, y.y);
      s_open[2 * p + 1] = box_passes(y.z, y.w, z.x, z.y, z.z, z.w);
    }
  } else {
    for (int p = tid; p < m / 2; p += nt) {
      const float* b = boxes + 12 * p;
      s_open[2 * p] = box_passes(b[0], b[1], b[2], b[3], b[4], b[5]);
      s_open[2 * p + 1] = box_passes(b[6], b[7], b[8], b[9], b[10], b[11]);
    }
  }
  if (tid == 0 && (m & 1)) {
    const float* b = boxes + 6 * (m - 1);
    s_open[m - 1] = box_passes(b[0], b[1], b[2], b[3], b[4], b[5]);
  }
}

// With the pass bits of nodes [0, m) in s_open and a barrier behind them:
// level by level, open(i) = pass(i) && open(parent), so that on return
// (after the last level's barrier) s_open holds the open flags.  Returns
// the nodes of [1, m) this thread found with an open parent, plus the root
// for thread 0.  Level l holds nodes [2^l - 1, 2^(l+1) - 1).
__device__ __forceinline__ int tree_levels(int m, unsigned char* s_open) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int visited = tid == 0;
  for (int lo = 1, width = 2; lo < m; lo += width, width *= 2) {
    const int hi = min(lo + width, m);
    for (int i = lo + tid; i < hi; i += nt) {
      const unsigned char up = s_open[(i - 1) >> 1];
      visited += up;
      s_open[i] &= up;
    }
    __syncthreads();
  }
  return visited;
}

// Adds every thread's v into *s_sum, which the block zeroed behind a
// barrier: a warp sum, then one shared-memory atomic a warp.  The sum is
// complete after the caller's next barrier.  blockDim.x is a multiple of
// 32.
__device__ __forceinline__ void block_add(int v, int* s_sum) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(s_sum, v);
}

}  // namespace pbr
