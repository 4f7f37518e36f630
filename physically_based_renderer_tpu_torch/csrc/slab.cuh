// The slab gather shared by P5 (mosaic.cu: a sum over reps of gathers, the
// indices wrapped by floor modulo) and P4's slab route (probes.cu: one
// gather, the indices clamped into range).
//
// A CTA owns a tile of outputs and stages, once, the slab of x those
// outputs can reach: along axis 0 an output reaches only its own column
// (over all rows), along axis 1 only its own row.  Axis 0: the slab is C
// columns (a power of two, 2 to 32) over all R rows, row pitch C words; a
// thread owns one column and steps down the CTA's output rows, so lane j of
// a warp reads bank j mod C.  Several CTAs split a slab's output rows to
// fill the SMs, each staging the slab again from L2.  Axis 1: the slab is
// whole rows, and the CTAs of one slab split its columns.  Staging is
// cp.async in pieces of `piece` floats (4, 2 or 1: 16, 8 or 4 bytes, the
// widest the rows and x's alignment allow); each thread's first index is
// loaded while the copies fly.  The indices and outputs are read and
// written a word a thread, coalesced along the columns: a thread owning
// four outputs would have four lanes of a warp share a column, and so a
// bank, on every gathered read.  The plan (C or rows a slab, outputs a
// CTA, threads) is ops/probes.py::slab_plan's.

#pragma once

#include <cuda_runtime.h>

namespace pbr {

constexpr size_t kMaxSmem = 227 * 1024;

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = unsigned(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = unsigned(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = unsigned(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Copies n_rows rows of w floats (source row pitch src_pitch floats) into
// shared memory at row pitch dst_pitch in pieces of kPiece floats (w, both
// pitches and src multiples of the piece).
template <int kPiece>
__device__ __forceinline__ void stage_pieces(float* dst, int dst_pitch,
                                             const float* __restrict__ src,
                                             int src_pitch, int n_rows,
                                             int w) {
  const int q = w / kPiece;
  for (int p = threadIdx.x; p < n_rows * q; p += blockDim.x) {
    const int r = p / q, k = (p - r * q) * kPiece;
    float* d = dst + r * dst_pitch + k;
    const float* g = src + size_t(r) * src_pitch + k;
    if (kPiece == 4)
      cp_async16(d, g);
    else if (kPiece == 2)
      cp_async8(d, g);
    else
      cp_async4(d, g);
  }
}

// The same as one cp.async group, in pieces of `piece` floats (4, 2 or 1).
__device__ __forceinline__ void stage_rows(float* dst, int dst_pitch,
                                           const float* __restrict__ src,
                                           int src_pitch, int n_rows, int w,
                                           int piece) {
  if (piece == 4)
    stage_pieces<4>(dst, dst_pitch, src, src_pitch, n_rows, w);
  else if (piece == 2)
    stage_pieces<2>(dst, dst_pitch, src, src_pitch, n_rows, w);
  else
    stage_pieces<1>(dst, dst_pitch, src, src_pitch, n_rows, w);
  cp_async_commit();
}

// kTake (P4): slab[base + k * stride], k = idx clamped into [0, size).
// Else (P5): sum over i < reps of slab[base + k_i * stride], k_0 = idx mod
// size (floor modulo), k_{i+1} = k_i + 1 wrapping at size; in rep order
// from 0.0f, as the plain version's loop.
template <bool kTake>
__device__ __forceinline__ float slab_read(const float* slab, int base,
                                           int stride, int idx, int size,
                                           int reps) {
  if (kTake) return slab[base + min(max(idx, 0), size - 1) * stride];
  int k = idx % size;
  if (k < 0) k += size;
  float acc = 0.0f;
  for (int i = 0; i < reps; ++i) {
    acc = acc + slab[base + k * stride];
    if (++k == size) k = 0;
  }
  return acc;
}

// The body of a slab kernel.  Axis 0: CTA (bx, by) owns columns [bx C,
// bx C + C) and output rows [by per, by per + per); its slab is those
// columns over all rows.  Axis 1: CTA (bx, by) owns rows [bx tile, bx tile
// + tile) and output columns [by per, by per + per); its slab is those
// rows.  tile is C for axis 0.
template <int kAxis, bool kTake>
__device__ __forceinline__ void slab_gather(const float* __restrict__ x,
                                            const int* __restrict__ idx,
                                            int rows, int lanes, int reps,
                                            int tile, int per, int piece,
                                            float* __restrict__ out) {
  extern __shared__ float4 slab4[];
  float* slab = reinterpret_cast<float*>(slab4);
  const int tid = threadIdx.x, nt = blockDim.x;
  if (kAxis == 0) {
    const int c0 = blockIdx.x * tile, w = min(tile, lanes - c0);
    const int r1 = min(int(blockIdx.y) * per + per, rows);
    stage_rows(slab, tile, x + c0, lanes, rows, w, piece);
    const int j = tid & (tile - 1);       // this thread's column
    const int step = nt / tile;
    int r = blockIdx.y * per + tid / tile;
    const bool live = j < w;
    const int* src = idx + c0 + j;
    float* dst = out + c0 + j;
    int next = live && r < r1 ? __ldg(src + size_t(r) * lanes) : 0;
    cp_async_wait<0>();
    __syncthreads();
    if (!live) return;
    for (; r < r1; r += step) {
      const int k = next;
      if (r + step < r1) next = __ldg(src + size_t(r + step) * lanes);
      dst[size_t(r) * lanes] = slab_read<kTake>(slab, j, tile, k, rows, reps);
    }
  } else {
    const int q0 = blockIdx.x * tile, n_rows = min(tile, rows - q0);
    const int c0 = blockIdx.y * per, width = min(per, lanes - c0);
    stage_rows(slab, lanes, x + size_t(q0) * lanes, lanes, n_rows, lanes,
               piece);
    // Output e of the CTA: row e / width of the slab, column c0 + e % width.
    const int n_out = n_rows * width;
    const int dr = nt / width, dc = nt - dr * width;
    int rr = tid / width, cc = tid - rr * width;
    const size_t base = size_t(q0) * lanes + c0;
    int next = tid < n_out ? __ldg(idx + base + size_t(rr) * lanes + cc) : 0;
    cp_async_wait<0>();
    __syncthreads();
    for (int e = tid; e < n_out; e += nt) {
      const int k = next, r = rr, c = cc;
      rr += dr;
      cc += dc;
      if (cc >= width) {
        cc -= width;
        ++rr;
      }
      if (e + nt < n_out) next = __ldg(idx + base + size_t(rr) * lanes + cc);
      out[base + size_t(r) * lanes + c] =
          slab_read<kTake>(slab, r * lanes, 1, k, lanes, reps);
    }
  }
}

// The grid and shared-memory bytes of a slab plan (tile: C columns for
// axis 0, a power of two in [2, 32]; rows for axis 1; per: output rows a
// CTA for axis 0, columns for axis 1), or cudaErrorInvalidValue where the
// plan cannot be launched.
inline cudaError_t slab_shape(int rows, int lanes, int axis, int tile,
                              int per, dim3* grid, size_t* smem) {
  if (tile < 1 || per < 1 ||
      (axis == 0 && (tile < 2 || tile > 32 || (tile & (tile - 1)))))
    return cudaErrorInvalidValue;
  *grid = dim3(axis == 0 ? (lanes + tile - 1) / tile
                         : (rows + tile - 1) / tile,
               axis == 0 ? (rows + per - 1) / per
                         : (lanes + per - 1) / per);
  *smem = sizeof(float) * (axis == 0
      ? size_t(rows) * tile : size_t(tile < rows ? tile : rows) * lanes);
  if (grid->y > 65535 || *smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Launches a slab kernel (the slab in dynamic shared memory).
template <typename K, typename... Args>
cudaError_t launch_slab(K kernel, dim3 grid, int threads, size_t smem,
                        cudaStream_t s, Args... args) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

}  // namespace pbr
